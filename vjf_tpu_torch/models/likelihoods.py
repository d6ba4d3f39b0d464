"""GLM observation likelihoods (counterpart of
``vjf_tpu/models/likelihoods.py``): the parameter containers, the losses
and the Gaussian observation-noise update of the autograd step. The fused
step computes the same inside the kernel."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.functional import gaussian_loss, running_var


class GaussianLikParams(NamedTuple):
    logvar: torch.Tensor   # scalar, SGD-trained AND running-var overwritten


class PoissonLikParams(NamedTuple):
    """No parameters."""

    empty: None = None


def init_gaussian_lik(init_logvar: float, dtype=torch.float32,
                      device=None) -> GaussianLikParams:
    return GaussianLikParams(logvar=torch.tensor(init_logvar, dtype=dtype, device=device))


def init_poisson_lik() -> PoissonLikParams:
    return PoissonLikParams()


def gaussian_nll(params: GaussianLikParams, eta: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """``gaussian_loss(target, eta, logvar)``."""
    return gaussian_loss(target, eta, params.logvar)


def poisson_nll(eta: torch.Tensor, target: torch.Tensor, clamp: float = 10.0) -> torch.Tensor:
    """Canonical-link Poisson NLL ``exp(eta) - target * eta`` with the log
    rate clamped at ``clamp``: summed over channels, averaged over trials."""
    eta = torch.clamp(eta, max=clamp)
    return torch.mean(torch.sum(torch.exp(eta) - target * eta, dim=-1))


def gaussian_lik_update(params: GaussianLikParams, n_sample: torch.Tensor,
                        eta: torch.Tensor, target: torch.Tensor, size_cap: int = 1000,
                        logvar_clamp: float = 30.0) -> Tuple[GaussianLikParams, torch.Tensor]:
    """Running-variance overwrite of the observation noise: the batch's mse
    over trials and channels enters with weight ``B`` (rows), the history
    with its count capped at ``size_cap``. Skipped (on the device) where the
    variance is not finite; a zero variance clamps to the floor."""
    mse = torch.mean(torch.square(target - eta))
    var, n_new = running_var(torch.exp(params.logvar), n_sample, mse, eta.shape[0],
                             size_cap=size_cap)
    logvar = torch.clamp(torch.log(var), -logvar_clamp, logvar_clamp)
    ok = torch.isfinite(var)
    return (GaussianLikParams(logvar=torch.where(ok, logvar, params.logvar)),
            torch.where(ok, n_new.to(n_sample.dtype), n_sample))
