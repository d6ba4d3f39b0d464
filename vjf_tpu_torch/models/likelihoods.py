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
                 channel_mask: Optional[torch.Tensor] = None, count=None) -> torch.Tensor:
    """``gaussian_loss(target, eta, logvar)``; ``weights`` (B,),
    ``channel_mask`` (B, ydim) and ``count`` as there."""
    return gaussian_loss(target, eta, params.logvar, weights=weights, channel_mask=channel_mask,
                         count=count)


def poisson_nll(eta: torch.Tensor, target: torch.Tensor, clamp: float = 10.0,
                weights: Optional[torch.Tensor] = None,
                channel_mask: Optional[torch.Tensor] = None, count=None) -> torch.Tensor:
    """Canonical-link Poisson NLL ``exp(eta) - target * eta`` with the log
    rate clamped at ``clamp``: summed over channels (a masked channel
    selected out of the sum; over ``tp`` this rank's channels), averaged
    over the valid trials of the 0/1 ``weights`` (``count``: this rank's
    part, as in ``ops.functional.batch_weighted_mean``)."""
    eta = torch.clamp(eta, max=clamp)
    nll = torch.exp(eta) - target * eta
    if channel_mask is not None:
        nll = torch.where(channel_mask > 0, nll, torch.zeros_like(nll))
    return batch_weighted_mean(torch.sum(nll, dim=-1), weights, count)


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
    return gaussian_lik_apply(params, n_sample, mse, count, size_cap, logvar_clamp)


def gaussian_lik_apply(params: GaussianLikParams, n_sample: torch.Tensor, mse, count,
                       size_cap: int = 1000, logvar_clamp: float = 30.0
                       ) -> Tuple[GaussianLikParams, torch.Tensor]:
    """The running-variance overwrite from the batch's ``mse`` and row
    ``count`` (:func:`gaussian_lik_update`'s second half)."""
    var, n_new = running_var(torch.exp(params.logvar), n_sample, mse, count,
                             size_cap=size_cap)
    logvar = torch.clamp(torch.log(var), -logvar_clamp, logvar_clamp)
    ok = torch.isfinite(var)
    return (GaussianLikParams(logvar=torch.where(ok, logvar, params.logvar)),
            torch.where(ok, n_new.to(n_sample.dtype), n_sample))


def gaussian_lik_sums(eta: torch.Tensor, target: torch.Tensor, ydim: int,
                      weights: Optional[torch.Tensor] = None,
                      channel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's part of :func:`gaussian_lik_update`'s batch mse over
    several ranks, ``[squared residuals, observed entries]``: its trials and
    (over ``tp``) its channels of ``ydim``; the ranks' sum completes both.
    With ``channel_mask`` the first is the masked sum and the second the
    observed entries (:func:`gaussian_lik_from_sums` divides); otherwise the
    first is the sum over trials of each row's mean over ``ydim`` (the 0/1
    ``weights`` selecting rows) and the second 0."""
    sq = torch.square(target - eta)
    if channel_mask is not None:
        m = channel_mask.to(eta.dtype)
        if weights is not None:
            m = m * weights.to(eta.dtype)[:, None]
        sq = torch.where(m > 0, sq, torch.zeros_like(sq)) * m
        return torch.stack([torch.sum(sq), torch.sum(m)])
    rows = torch.sum(sq, dim=-1) / ydim
    if weights is not None:
        w = weights.to(eta.dtype)
        rows = torch.where(w > 0, rows, torch.zeros_like(rows)) * w
    return torch.stack([torch.sum(rows), torch.zeros((), dtype=eta.dtype, device=eta.device)])


def gaussian_lik_from_sums(sums: torch.Tensor, ydim: int, n_rows, channel_mask: bool):
    """``(mse, count)`` of :func:`gaussian_lik_update` from every rank's
    :func:`gaussian_lik_sums` summed: ``n_rows`` is the whole batch's valid
    row count (B without a trial mask)."""
    if channel_mask:
        return sums[0] / torch.clamp(sums[1], min=1.0), sums[1] / ydim
    div = n_rows if isinstance(n_rows, int) else torch.clamp(n_rows, min=1.0)
    return sums[0] / div, n_rows
