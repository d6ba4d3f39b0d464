"""GLM observation likelihoods (counterpart of
``vjf_tpu/models/likelihoods.py``): the parameter containers, the losses
and the Gaussian observation-noise update of the autograd step. The fused
step computes the same inside the kernel."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.functional import batch_weighted_mean, gaussian_loss, running_var


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


def gaussian_nll(params: GaussianLikParams, eta: torch.Tensor, target: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 channel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gaussian_loss(target, eta, logvar)``; ``weights`` (B,) and
    ``channel_mask`` (B, ydim) as there."""
    return gaussian_loss(target, eta, params.logvar, weights=weights, channel_mask=channel_mask)


def poisson_nll(eta: torch.Tensor, target: torch.Tensor, clamp: float = 10.0,
                weights: Optional[torch.Tensor] = None,
                channel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Canonical-link Poisson NLL ``exp(eta) - target * eta`` with the log
    rate clamped at ``clamp``: summed over channels (a masked channel
    selected out of the sum), averaged over the valid trials of the 0/1
    ``weights``."""
    eta = torch.clamp(eta, max=clamp)
    nll = torch.exp(eta) - target * eta
    if channel_mask is not None:
        nll = torch.where(channel_mask > 0, nll, torch.zeros_like(nll))
    return batch_weighted_mean(torch.sum(nll, dim=-1), weights)


def gaussian_lik_update(params: GaussianLikParams, n_sample: torch.Tensor,
                        eta: torch.Tensor, target: torch.Tensor, size_cap: int = 1000,
                        logvar_clamp: float = 30.0, weights: Optional[torch.Tensor] = None,
                        channel_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[GaussianLikParams, torch.Tensor]:
    """Running-variance overwrite of the observation noise: the batch's mse
    over trials and channels enters with weight ``B`` (rows), the history
    with its count capped at ``size_cap``. Skipped (on the device) where the
    variance is not finite; a zero variance clamps to the floor. With the
    0/1 trial mask ``weights`` the masked rows leave the mse and the count;
    with ``channel_mask`` (folded with ``weights``) the mse runs over the
    observed entries and the count is the fractional row count
    ``sum(mask) / ydim``."""
    if channel_mask is not None:
        m = channel_mask.to(eta.dtype)
        if weights is not None:
            m = m * weights.to(eta.dtype)[:, None]
        sq = torch.where(m > 0, torch.square(target - eta), torch.zeros_like(eta)) * m
        mse = torch.sum(sq) / torch.clamp(torch.sum(m), min=1.0)
        count = torch.sum(m) / eta.shape[-1]
    elif weights is None:
        mse = torch.mean(torch.square(target - eta))
        count = eta.shape[0]
    else:
        mse = batch_weighted_mean(torch.mean(torch.square(target - eta), dim=-1), weights)
        count = torch.sum(weights.to(eta.dtype))
    var, n_new = running_var(torch.exp(params.logvar), n_sample, mse, count,
                             size_cap=size_cap)
    logvar = torch.clamp(torch.log(var), -logvar_clamp, logvar_clamp)
    ok = torch.isfinite(var)
    return (GaussianLikParams(logvar=torch.where(ok, logvar, params.logvar)),
            torch.where(ok, n_new.to(n_sample.dtype), n_sample))
