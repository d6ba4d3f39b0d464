"""PyTorch/CUDA port of ``vjf_tpu`` for one NVIDIA H100.

The JAX package ``vjf_tpu`` stays the reference; this package mirrors its
module layout and names. The main path is the fused filter-then-learn epoch
(``models.vjf.run_epochs`` -> ``ops.fused_step.run_epoch_fused``); the
exact-sync sharded epoch (``parallel.sharded``) splits its trials over the
ranks of a ``torch.distributed`` group. The dynamics are the RBF system
(``models.dynamics``) or the sparse GP (``gp.sgp``), their weight posterior
in precision, covariance or Newton-Schulz form (``models.regression``),
learned by RLS or the weight-diffusion Kalman step. The three kernels are
hand-written CUDA in ``csrc/fused_step.cu``. On CPU tensors the kernels'
plain PyTorch versions run instead. Ragged trials and missing channels ride
the trial mask and the channel mask (``fit(mask=..., channel_mask=...)``);
:func:`pad_trials` builds them from a list of trials. :class:`VJF` is the
user-facing facade (``make_model``, ``fit``, ``fit_ensemble``, ``filter``,
``filter_stream``, ``forecast``, ``save``/``load``); ``native`` streams
recordings from a file or FIFO to the card. ``parallel.fit_ensemble`` trains
N independent members in one launch stream (a member axis on the kernels).
A trained model is smoothed post hoc by the associative-scan Kalman smoother
(``ops.pkalman``, ``models.smoothing``; iterated Laplace for Poisson) and
scored by co-smoothing, the held-out channels' bits per spike
(``models.evaluate``; ``VJF.smooth``, ``evaluate``, ``evaluate_kfold``).
"""
from .api import VJF
from .config import StepFlags, VJFConfig
from .types import Gaussian
from .utils.ragged import pad_trials, split_trials

__all__ = ["VJF", "StepFlags", "VJFConfig", "Gaussian", "pad_trials", "split_trials"]
