"""VJF orchestrator: state, epochs (counterpart of ``vjf_tpu/models/vjf.py``).

The port has the fused epoch only: ``run_epoch`` routes to
``ops.fused_step.run_epoch_fused`` and raises for the configurations that
the JAX package sends to its autograd XLA step (not ported yet). The
multi-rank route is ``parallel.sharded.run_epoch_fused_sharded``, whose
phase-1 kernel ``ops.fused_step.forward_sums_call`` is the counterpart of
the JAX ``forward_sums_call``. ``init_state`` builds the model on the card
unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from ..config import StepFlags, VJFConfig
from ..ops import fused_step as _fused
from ..types import Gaussian
from . import dynamics as dyn
from .decoder import init_decoder
from .likelihoods import init_gaussian_lik, init_poisson_lik
from .recognition import Recognition, init_recognition


_XLA_TODO = "autograd filter_step: ROADMAP Queue 1 item 4"


class PriorParams(NamedTuple):
    """Initial-state prior: never trained, stays at zero."""

    mean: torch.Tensor     # (xdim,)
    logvar: torch.Tensor   # (xdim,)


class Params(NamedTuple):
    """The gradient-trained parameters (SGD + value clip)."""

    recognition: Recognition
    decoder: nn.Linear
    likelihood: object            # GaussianLikParams | PoissonLikParams
    prior: PriorParams


class TrainState(NamedTuple):
    """Everything that evolves during training."""

    params: Params
    dynamics: dyn.DynamicsState
    lik_n_sample: torch.Tensor    # float counter


class Metrics(NamedTuple):
    """Per-step ELBO components (recon/dynamics/entropy are ELBO terms, loss
    the negative ELBO) and the Newton-Schulz residual bound ``tau``."""

    loss: torch.Tensor
    recon: torch.Tensor
    dynamics: torch.Tensor
    entropy: torch.Tensor
    tau: Optional[torch.Tensor] = None


def _generator(seed: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def init_state(
    seed: Union[int, torch.Generator],
    cfg: VJFConfig,
    device=torch.device("cuda"),
    backend: Optional[str] = None,
    batch_hint: Optional[int] = None,
) -> TrainState:
    """Build a fresh model on ``device`` from a seed or a CPU generator. The
    model goes to the card unless the caller asks for ``device="cpu"``;
    without CUDA, a call that names no device raises."""
    gen = _generator(seed)
    dtype = cfg.tdtype
    if cfg.likelihood == "gaussian":
        lik = init_gaussian_lik(cfg.init_obs_logvar, dtype=dtype, device=device)
    elif cfg.likelihood == "poisson":
        lik = init_poisson_lik()
    else:
        raise ValueError(f"unknown likelihood: {cfg.likelihood}")
    if cfg.dynamics != "rbf":
        raise NotImplementedError(_fused._SGP_TODO)
    params = Params(
        recognition=init_recognition(gen, cfg.ydim, cfg.xdim, cfg.udim,
                                     cfg.hidden_sizes, dtype=dtype, device=device),
        decoder=init_decoder(gen, cfg.xdim, cfg.ydim, dtype=dtype, device=device),
        likelihood=lik,
        prior=PriorParams(
            mean=torch.zeros(cfg.xdim, dtype=dtype, device=device),
            logvar=torch.zeros(cfg.xdim, dtype=dtype, device=device),
        ),
    )
    backend = backend or dyn.resolve_backend(cfg, batch_hint=batch_hint)
    dynamics = dyn.init_dynamics(gen, cfg, backend=backend, device=device)
    return TrainState(params=params, dynamics=dynamics,
                      lik_n_sample=torch.zeros((), dtype=dtype, device=device))


def prior(params: Params, n_batch: int) -> Gaussian:
    """The prior broadcast over the batch."""
    m, lv = params.prior.mean, params.prior.logvar
    return Gaussian(m.expand(n_batch, m.shape[-1]), lv.expand(n_batch, lv.shape[-1]))


class EpochResult(NamedTuple):
    state: TrainState
    q_means: torch.Tensor    # (T, B, xdim)
    q_logvars: torch.Tensor  # (T, B, xdim)
    metrics: Metrics         # per-step tensors, each (T,)


def epoch_seed(seed: Union[int, torch.Generator]) -> int:
    """An epoch's Philox key: the int itself, or one draw from ``seed`` when
    it is a generator (a draw from a CUDA generator waits for the device)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2**31 - 1, (), generator=seed, device=seed.device))
    return int(seed)


def run_epoch(
    cfg: VJFConfig,
    flags: StepFlags,
    state: TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seed: Union[int, torch.Generator],
    lr,
    noise=None,
    q0: Optional[Gaussian] = None,
    mask=None,
    channel_mask=None,
) -> EpochResult:
    """One pass over time (ys: (T, B, ydim), us: (T, B, udim)).

    ``seed`` (an int, or a generator to draw it from) keys the in-kernel
    Philox noise; ``noise=(eps_s, eps_t)``, each (T, B, xdim), injects it
    instead.
    """
    if ys.dtype != cfg.tdtype:
        ys = ys.to(cfg.tdtype)
    if us.dtype != cfg.tdtype:
        us = us.to(cfg.tdtype)
    if not _fused.fused_enabled(cfg, state, n_batch=ys.shape[1]):
        raise NotImplementedError(_XLA_TODO)
    with torch.no_grad():
        return _fused.run_epoch_fused(cfg, flags, state, ys, us, epoch_seed(seed), lr,
                                      noise=noise, q0=q0, mask=mask,
                                      channel_mask=channel_mask)


class EpochsResult(NamedTuple):
    state: TrainState
    q_means: torch.Tensor        # (T, B, xdim), LAST epoch only
    q_logvars: torch.Tensor      # (T, B, xdim)
    epoch_loss: torch.Tensor     # (n_epochs,) mean loss per epoch
    epoch_metrics: Metrics       # each (n_epochs,) epoch means
    max_tau: torch.Tensor        # (n_epochs,)
    hot_frac: torch.Tensor       # (n_epochs,) fraction of post-prefix steps
    #                              at or above the Newton-Schulz skip ceiling


def epoch_tau_stats(cfg: VJFConfig, metrics: Metrics, t_len: int, dtype):
    """(max finite tau, hot fraction) over the post-prefix segment.

    Skipped steps carry an inf marker in the tau stream. Deliberate deviation
    from the JAX package, which counts ``tau >= NS_TAU_MAX`` only: a NaN tau
    also counts as hot here (every non-finite tau does).
    """
    dev = metrics.loss.device
    if metrics.tau is not None and t_len > cfg.ns_prefix:
        tau_seg = metrics.tau[cfg.ns_prefix:]
        finite = torch.isfinite(tau_seg)
        max_tau = torch.max(torch.where(finite, tau_seg, torch.zeros_like(tau_seg)))
        hot = torch.mean(((tau_seg >= _fused.NS_TAU_MAX) | ~finite).to(dtype))
    else:
        max_tau = torch.zeros((), dtype=dtype, device=dev)
        hot = torch.zeros((), dtype=dtype, device=dev)
    return max_tau.to(dtype), hot


def run_epochs(
    cfg: VJFConfig,
    flags: StepFlags,
    state: TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seeds: Sequence[Union[int, torch.Generator]],
    lrs,
    q0: Optional[Gaussian] = None,
) -> EpochsResult:
    """``len(seeds)`` consecutive epochs over the same data, one seed (or
    generator) and one learning rate per epoch. With int seeds nothing here
    waits for the device."""
    if q0 is None:
        q0 = prior(state.params, ys.shape[1])

    def epoch(st, seed, lr):
        return run_epoch(cfg, flags, st, ys, us, seed, lr, q0=q0)

    return chain_epochs(cfg, epoch, state, ys.shape[0], seeds, lrs)


def chain_epochs(cfg: VJFConfig, epoch, state: TrainState, t_len: int, seeds,
                 lrs) -> EpochsResult:
    """``epoch(state, seed, lr) -> EpochResult`` once per seed, each from the
    previous one's state: the epoch means, the tau statistics and the last
    epoch's posteriors."""
    means, max_taus, hots = [], [], []
    res = None
    for i, seed in enumerate(seeds):
        res = epoch(state, seed, lrs[i])
        state = res.state
        means.append(Metrics(*(torch.mean(m) for m in res.metrics)))
        max_tau, hot = epoch_tau_stats(cfg, res.metrics, t_len, cfg.tdtype)
        max_taus.append(max_tau)
        hots.append(hot)
    mean_metrics = Metrics(*(torch.stack(f) for f in zip(*means)))
    return EpochsResult(
        state=state,
        q_means=res.q_means,
        q_logvars=res.q_logvars,
        epoch_loss=mean_metrics.loss,
        epoch_metrics=mean_metrics,
        max_tau=torch.stack(max_taus),
        hot_frac=torch.stack(hots),
    )
