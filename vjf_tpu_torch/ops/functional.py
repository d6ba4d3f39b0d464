"""Elementwise and reduction math of the step outside the kernels
(counterpart of ``vjf_tpu/ops/functional.py``): RBF features, Gaussian
losses, the reparametrised sample, the running variance. Pure functions of
tensors; every non-finite guard is a ``torch.where``, so nothing waits for
the device."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..types import Gaussian


def rbf(x: torch.Tensor, centroid: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """``exp(-0.5 * (||x - c|| / w)^2)`` over (..., batch, basis), the squared
    distance expanded as ``|x|^2 + |c|^2 - 2 x c^T`` and clamped at 0."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centroid * centroid, dim=-1)
    d2 = torch.clamp(x2 + c2 - 2.0 * (x @ centroid.T), min=0.0)
    return torch.exp(-0.5 * d2 / (width * width))


def batch_weighted_mean(per_trial: torch.Tensor, weights: Optional[torch.Tensor],
                        count=None) -> torch.Tensor:
    """Mean over trials; with 0/1 ``weights`` the masked entries are
    selected out (NaN-safe) and the mean runs over the valid count (an
    all-masked batch gives 0).

    ``count``: over several ranks, the whole batch's (valid) trial count,
    at least 1: this rank's part of the mean, its sum over ``count``, which
    the ranks' sum completes."""
    if count is not None:
        if weights is not None:
            w = weights.to(per_trial.dtype)
            per_trial = torch.where(w > 0, per_trial, torch.zeros_like(per_trial)) * w
        return torch.sum(per_trial) / count
    if weights is None:
        return torch.mean(per_trial)
    w = weights.to(per_trial.dtype)
    kept = torch.where(w > 0, per_trial, torch.zeros_like(per_trial)) * w
    return torch.sum(kept) / torch.clamp(torch.sum(w), min=1.0)


def gaussian_entropy(q: Gaussian, weights: Optional[torch.Tensor] = None,
                     count=None) -> torch.Tensor:
    """``0.5 * sum_dim logvar`` averaged over the batch (constants dropped);
    ``count`` as in :func:`batch_weighted_mean`."""
    return batch_weighted_mean(0.5 * torch.sum(torch.atleast_2d(q.logvar), dim=-1), weights,
                               count)


def gaussian_loss(
    a: Union[torch.Tensor, Gaussian],
    b: Union[torch.Tensor, Gaussian],
    logvar: torch.Tensor,
    *,
    trace_quirk: bool = True,
    weights: Optional[torch.Tensor] = None,
    channel_mask: Optional[torch.Tensor] = None,
    count=None,
) -> torch.Tensor:
    """Expected negative Gaussian log-likelihood, constants dropped, summed
    over the last axis and averaged over the batch. A Gaussian argument adds
    its trace term; with both Gaussian, ``trace_quirk`` keeps the reference's
    ``exp(lv1 + lv2 - logvar)`` (the corrected form adds the two).
    ``weights``: (B,) 0/1 trial mask and ``count`` as in
    :func:`batch_weighted_mean`; ``channel_mask``: (B, d) 0/1, a masked
    entry is selected out of the sum over the last axis (no
    renormalisation). Over ``tp`` the last axis may be this rank's
    channels: the sum is then partial too."""
    m1, lv1 = (a.mean, a.logvar) if isinstance(a, Gaussian) else (a, None)
    m2, lv2 = (b.mean, b.logvar) if isinstance(b, Gaussian) else (b, None)
    m1, m2 = torch.atleast_2d(m1), torch.atleast_2d(m2)
    p = torch.exp(-0.5 * logvar)
    nll = 0.5 * (torch.square(m1 * p - m2 * p) + logvar)
    if lv1 is not None and lv2 is not None:
        lv1, lv2 = torch.atleast_2d(lv1), torch.atleast_2d(lv2)
        if trace_quirk:
            nll = nll + 0.5 * torch.exp(lv1 + lv2 - logvar)
        else:
            nll = nll + 0.5 * (torch.exp(lv1 - logvar) + torch.exp(lv2 - logvar))
    elif lv1 is not None or lv2 is not None:
        lv = lv1 if lv1 is not None else lv2
        nll = nll + 0.5 * torch.exp(torch.atleast_2d(lv) - logvar)
    if channel_mask is not None:
        nll = torch.where(torch.atleast_2d(channel_mask) > 0, nll, torch.zeros_like(nll))
    return batch_weighted_mean(torch.sum(nll, dim=-1), weights, count)


def reparametrize(q: Gaussian, eps: torch.Tensor) -> torch.Tensor:
    """``mean + eps * exp(0.5 * logvar)`` with an injected standard normal."""
    return q.mean + eps * torch.exp(0.5 * q.logvar)


def running_var(acc_var: torch.Tensor, acc_size: torch.Tensor, new_var: torch.Tensor,
                new_size, *, size_cap: int = 1000):
    """Size-weighted streaming variance with the history's count capped at
    ``size_cap``. Returns ``(variance, total count)``; the count keeps
    ``acc_size``'s dtype and the weights are taken in ``acc_var``'s."""
    acc_size = torch.clamp(acc_size, max=size_cap)
    tot_size = acc_size + new_size
    tot = tot_size.to(acc_var.dtype)
    return (acc_size.to(acc_var.dtype) / tot) * acc_var + (new_size / tot) * new_var, tot_size


def nonecat(a: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
    """``a`` with the control ``u`` appended on the last axis, unless ``u`` is
    None or has no columns."""
    a = torch.atleast_2d(a)
    if u is None or u.shape[-1] == 0:
        return a
    return torch.cat([a, torch.atleast_2d(u)], dim=-1)


def finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    """A non-finite scalar loss term replaced by 0."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def tree_leaves(tree) -> list:
    """The tensors of a tree of (named) tuples, depth first."""
    if isinstance(tree, tuple):
        return [x for c in tree for x in tree_leaves(c)]
    return [tree]


def tree_where(ok: torch.Tensor, new, old):
    """``new`` where the scalar ``ok`` holds, else ``old``, leaf by leaf,
    selected on the device."""
    if isinstance(new, tuple):
        return type(new)(*(tree_where(ok, a, b) for a, b in zip(new, old)))
    return torch.where(ok, new, old)


def all_finite(tree) -> torch.Tensor:
    """True where every floating leaf of ``tree`` is finite (on the device)."""
    return torch.stack([torch.isfinite(t).all() for t in tree_leaves(tree)
                        if t.is_floating_point()]).all()
