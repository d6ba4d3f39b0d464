"""Held-out-channel predictive evaluation, co-smoothing (counterpart of
``vjf_tpu/models/evaluate.py``).

The evaluation protocol for latent population models on real data: infer
the latent trajectory from the observed channels only (the held-out
channels leave the smoother exactly, through its infinite-variance
missing-data path), then score the model's predictions of the held-out
channels it never saw. For Poisson observations the headline number is
bits per spike (the co-smoothing metric of the Neural Latents Benchmark):
the predictive log-likelihood gain over a constant mean-rate null, per
observed spike, in bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import VJFConfig
from . import smoothing
from .vjf import TrainState


class HeldoutEval(NamedTuple):
    """Result of :func:`heldout_eval`, all scores over held-out entries only.

    ``pred`` is the posterior-predictive mean observation: the Poisson rate
    ``E[exp(eta)] = exp(C m + d + diag(C P C^T)/2)`` or the Gaussian mean
    ``C m + d``; ``eta`` is ``C m + d``. Shapes: (T, k) for one sequence,
    (T, B, k) for a batch, k held-out channels, whose columns follow
    ``heldout``: the SORTED UNIQUE indices, not the order the caller passed.

    ``loglik`` / ``loglik_null`` are total predictive log-likelihoods (nats)
    of the held-out entries under the model and under the per-channel
    constant null (mean rate for Poisson, mean and variance for Gaussian,
    both on the evaluated segment). ``bits_per_spike`` is ``(loglik -
    loglik_null) / (n_spikes ln 2)`` for Poisson (NaN without spikes) and
    None for Gaussian; ``r2`` is the pooled prediction R² of ``pred``.
    """

    eta: torch.Tensor
    pred: torch.Tensor
    loglik: torch.Tensor
    loglik_null: torch.Tensor
    bits_per_spike: Optional[torch.Tensor]
    r2: torch.Tensor
    heldout: np.ndarray              # (k,) int channel indices used
    smoothed_means: torch.Tensor     # (T[, B], xdim) latents from observed channels
    n_spikes: Optional[torch.Tensor] = None   # Poisson: scored (observed) spikes


def _normalize_heldout(heldout, ydim: int) -> np.ndarray:
    """A boolean (ydim,) mask or int indices as sorted unique int indices,
    validated: nonempty, in range, and not every channel (with nothing
    observed the smoother would run on the prior alone)."""
    h = np.asarray(heldout)
    if h.dtype == bool:
        if h.shape != (ydim,):
            raise ValueError(
                f"boolean heldout must have shape ({ydim},); got {h.shape}"
            )
        idx = np.flatnonzero(h)
    else:
        idx = np.unique(h.astype(np.int64).ravel())
        if idx.size and (idx[0] < 0 or idx[-1] >= ydim):
            raise ValueError(
                f"heldout indices must lie in [0, {ydim}); got "
                f"[{idx[0]}, {idx[-1]}]"
            )
    if idx.size == 0:
        raise ValueError("heldout selects no channels")
    if idx.size >= ydim:
        raise ValueError(
            "heldout selects every channel — nothing would be observed; "
            "hold out a strict subset"
        )
    return idx


def _obs_weight(cfg, state, channel_mask, ys, idx, batched: bool) -> torch.Tensor:
    """The scoring weight of the held-out columns: observed entries of
    ``channel_mask`` (all ones without one), as ``ys[..., idx]``'s shape."""
    shape = ys.shape[:-1] + (idx.size,)
    if channel_mask is None:
        return torch.ones(shape, dtype=ys.dtype, device=ys.device)
    w = smoothing._as(cfg, state, channel_mask)[..., idx]
    if w.ndim == 2 and batched:
        w = w[:, None, :]
    return w.expand(shape)


def heldout_eval(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    heldout,
    x_ref=None,
    us=None,
    n_iter: Optional[int] = None,
    mesh=None,
    channel_mask=None,
) -> HeldoutEval:
    """Co-smoothing evaluation: smooth with the ``heldout`` channels masked
    out (they contribute exactly nothing to inference), then score their
    predictive log-likelihood.

    ``ys``: (T, ydim) one sequence or (T, B, ydim) a batch of trials (one
    batched smoother call; scores pool over trials). ``heldout``: int
    indices or a boolean (ydim,) mask, normalized to sorted unique indices.
    ``x_ref`` / ``us`` / ``n_iter`` pass through to the smoother;
    ``n_iter=None`` is 8 for Poisson and 1 for Gaussian for both shapes.
    ``mesh`` with a 2-d ``ys`` raises ``ValueError``, as in the JAX package;
    with a batch, :func:`smoothing.smooth_batch` spreads the trials over
    the ranks and the scoring runs on the gathered result.

    ``channel_mask``: optional (T, ydim) or (T, B, ydim) 0/1 observed-entry
    mask (electrode dropout). Inference sees entries observed AND not held
    out; scoring runs over the observed held-out entries only, whose stored
    values may be NaN. The held-out values in ``ys`` are used for scoring
    only, never for inference.
    """
    ys = smoothing._ingest(cfg, state, ys)
    if ys.ndim not in (2, 3):
        raise ValueError(f"ys must be (T, ydim) or (T, B, ydim); got {tuple(ys.shape)}")
    if ys.shape[-1] != cfg.ydim:
        raise ValueError(f"ys last dim must be ydim={cfg.ydim}; got {tuple(ys.shape)}")
    idx = _normalize_heldout(heldout, cfg.ydim)
    t_len = ys.shape[0]

    held = torch.ones(cfg.ydim, dtype=ys.dtype, device=ys.device)
    held[torch.as_tensor(idx, device=ys.device)] = 0.0
    infer_mask = held.expand(t_len, cfg.ydim)
    if channel_mask is not None:
        cm = smoothing._as(cfg, state, channel_mask)
        valid = ((t_len, cfg.ydim),) + (
            ((t_len, ys.shape[1], cfg.ydim),) if ys.ndim == 3 else ()
        )
        if tuple(cm.shape) not in valid:
            raise ValueError(
                f"channel_mask must have shape in {valid}; got {tuple(cm.shape)}"
            )
        infer_mask = cm * held
    obs_w = _obs_weight(cfg, state, channel_mask, ys, idx, ys.ndim == 3)

    # one default for both input shapes: (T, ydim) and (T, 1, ydim) score alike
    if n_iter is None:
        n_iter = 8 if cfg.likelihood == "poisson" else 1
    if ys.ndim == 3:
        _, smoothed = smoothing.smooth_batch(
            cfg, state, ys, x_ref=x_ref, channel_mask=infer_mask,
            mesh=mesh, us=us, n_iter=n_iter,
        )
    else:
        if mesh is not None:
            raise ValueError(
                "mesh= applies only to batched (T, B, ydim) input; a single "
                "(T, ydim) sequence smooths unsharded — drop mesh or add a "
                "trial axis"
            )
        _, smoothed = smoothing.smooth_iterated(
            cfg, state, ys, x_ref=x_ref, channel_mask=infer_mask,
            us=us, n_iter=n_iter,
        )
    return _score_heldout(cfg, state, ys, idx, obs_w, smoothed)


def _score_heldout(cfg: VJFConfig, state: TrainState, ys: torch.Tensor, idx: np.ndarray,
                   obs_w: torch.Tensor, smoothed) -> HeldoutEval:
    """Score the held-out channels against a smoother result (the scoring
    half of :func:`heldout_eval`, shared with the fold-batched k-fold)."""
    k = idx.size
    it = torch.as_tensor(idx, device=ys.device)
    c_h = state.params.decoder.weight[it]        # (k, xdim)
    d_h = state.params.decoder.bias[it]          # (k,)
    means, covs = smoothed.means, smoothed.covs
    # 0 at unobserved entries: a stored NaN must not reach the sums as 0 * NaN
    y_h = torch.where(obs_w > 0, ys[..., it], 0.0)
    eta = means @ c_h.T + d_h                    # (T[, B], k)
    # per-channel latent-uncertainty variance diag(C P C^T)
    s2 = torch.sum((c_h @ covs) * c_h, dim=-1)

    w_flat = obs_w.reshape(-1, k)
    cnt = torch.sum(w_flat, dim=0)

    def chan_mean(v):
        """Per-channel weighted mean over all observed (T[, B]) entries."""
        return torch.sum(w_flat * v.reshape(-1, k), dim=0) / torch.clamp(cnt, min=1e-12)

    bits = n_spk = None
    if cfg.likelihood == "poisson":
        # posterior-predictive mean rate (lognormal mean) under the runaway
        # clamp the training likelihood applies to eta
        log_rate = torch.clamp(eta + 0.5 * s2, max=cfg.poisson_clamp)
        pred = torch.exp(log_rate)
        lgam = torch.special.gammaln(y_h + 1.0)
        loglik = torch.sum(obs_w * (y_h * log_rate - pred - lgam))
        # null: per-channel constant mean rate on the evaluated segment
        rate0 = torch.clamp(chan_mean(y_h), min=1e-10)
        loglik_null = torch.sum(obs_w * (y_h * torch.log(rate0) - rate0 - lgam))
        n_spk = torch.sum(obs_w * y_h)
        bits = torch.where(n_spk > 0, (loglik - loglik_null) / (n_spk * math.log(2.0)),
                           torch.nan)
    elif cfg.likelihood == "gaussian":
        var = s2 + torch.exp(state.params.likelihood.logvar)
        pred = eta
        loglik = -0.5 * torch.sum(obs_w * (torch.log(2.0 * math.pi * var)
                                           + (y_h - pred) ** 2 / var))
        mu0 = chan_mean(y_h)
        var0_mle = chan_mean((y_h - mu0) ** 2)
        # a channel with fewer than 2 observed entries has an MLE variance
        # near 0, and its null would gain ~13 nats an entry: such channels
        # alone take the pooled held-out variance
        pooled = (torch.sum(w_flat * (y_h.reshape(-1, k) - mu0) ** 2)
                  / torch.clamp(torch.sum(w_flat), min=1.0))
        var0 = torch.where(cnt >= 2.0, torch.clamp(var0_mle, min=1e-12),
                           torch.clamp(pooled, min=1e-12))
        loglik_null = -0.5 * torch.sum(obs_w * (torch.log(2.0 * math.pi * var0)
                                                + (y_h - mu0) ** 2 / var0))
    else:
        raise NotImplementedError(f"unknown likelihood {cfg.likelihood}")

    resid = torch.sum(obs_w * (y_h - pred) ** 2)
    total = torch.sum(obs_w * (y_h - chan_mean(y_h)) ** 2)
    r2 = 1.0 - resid / torch.clamp(total, min=1e-12)
    return HeldoutEval(
        eta=eta, pred=pred, loglik=loglik, loglik_null=loglik_null,
        bits_per_spike=bits, r2=r2, heldout=idx, smoothed_means=means, n_spikes=n_spk,
    )


class KFoldEval(NamedTuple):
    """Result of :func:`kfold_channel_eval`. ``folds`` holds the per-fold
    :class:`HeldoutEval`s (fold f's channels are ``folds[f].heldout``); the
    scalars pool over folds, so every channel is scored exactly once while
    the inference of each fold sees the other folds."""

    folds: Tuple[HeldoutEval, ...]
    loglik: float
    loglik_null: float
    bits_per_spike: Optional[float]   # Poisson; pooled over all folds
    r2: np.ndarray                    # (k,) per-fold prediction R²


def _kfold_folds_vmapped(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    fold_idx,
    x_ref=None,
    us=None,
    n_iter: Optional[int] = None,
    mesh=None,
    channel_mask=None,
) -> Tuple[HeldoutEval, ...]:
    """All the folds of ``fold_idx`` in one batched smoother call: a fold is
    a channel mask, so the folds ride the trial axis. The data is tiled to
    (T, F*B, ydim), trial slot ``f*B + b`` carries fold f's inference mask,
    and each fold is scored on its slice. The covariances become (T, F*B,
    xdim, xdim); ``fold_chunk`` bounds F."""
    ys = smoothing._ingest(cfg, state, ys)
    squeeze = ys.ndim == 2
    ys3 = ys[:, None, :] if squeeze else ys
    t_len, n_b, _ = ys3.shape
    n_folds = len(fold_idx)
    if mesh is not None and squeeze:
        raise ValueError("mesh= applies only to batched (T, B, ydim) input")

    rows = torch.ones((n_folds, cfg.ydim), dtype=ys.dtype, device=ys.device)
    for f, idx in enumerate(fold_idx):
        rows[f, torch.as_tensor(idx, device=ys.device)] = 0.0
    # trial slot f*B + b carries fold f's mask
    infer = rows.repeat_interleave(n_b, dim=0).expand(t_len, n_folds * n_b, cfg.ydim)
    if channel_mask is not None:
        cm = smoothing._as(cfg, state, channel_mask)
        if cm.ndim == 2:
            # shared over trials, so shared over every F*B slot
            cm_rep = cm[:, None, :]
        elif tuple(cm.shape) == (t_len, n_b, cfg.ydim):
            cm_rep = cm.repeat(1, n_folds, 1)
        else:
            raise ValueError(
                f"channel_mask must be (T, ydim) or (T, B, ydim); got "
                f"{tuple(cm.shape)}"
            )
        infer = infer * cm_rep
    ys_rep = ys3.repeat(1, n_folds, 1)
    us_rep = None
    if us is not None:
        u = smoothing._as(cfg, state, us)
        # (T, udim) shared controls stay shared over the F*B slots
        us_rep = u if u.ndim == 2 else u.repeat(1, n_folds, 1)
    x_rep = None
    if x_ref is not None:
        xr = smoothing._as(cfg, state, x_ref)
        if xr.ndim == 2:
            xr = xr[:, None, :]
        x_rep = xr.repeat(1, n_folds, 1)
    if n_iter is None:
        n_iter = 8 if cfg.likelihood == "poisson" else 1
    _, smoothed = smoothing.smooth_batch(
        cfg, state, ys_rep, x_ref=x_rep, channel_mask=infer, mesh=mesh,
        us=us_rep, n_iter=n_iter,
    )

    folds = []
    for f, idx in enumerate(fold_idx):
        sl = slice(f * n_b, (f + 1) * n_b)
        view = smoothing.pkalman.SmoothResult(
            means=smoothed.means[:, sl].squeeze(1) if squeeze else smoothed.means[:, sl],
            covs=smoothed.covs[:, sl].squeeze(1) if squeeze else smoothed.covs[:, sl],
        )
        obs_w = _obs_weight(cfg, state, channel_mask, ys, idx, not squeeze)
        folds.append(_score_heldout(cfg, state, ys, idx, obs_w, view))
    return tuple(folds)


def kfold_channel_eval(
    cfg: VJFConfig,
    state: TrainState,
    ys,
    n_folds: int = 5,
    seed: int = 0,
    vmap_folds: bool = False,
    fold_chunk: Optional[int] = None,
    **kwargs,
) -> KFoldEval:
    """Rotate :func:`heldout_eval` over ``n_folds`` disjoint channel folds (a
    random balanced partition from ``np.random.default_rng(seed)``, the JAX
    package's folds) so every channel is scored by a smoother that never saw
    it. ``kwargs`` pass through to :func:`heldout_eval` (``x_ref``, ``us``,
    ``n_iter``, ``mesh``, ``channel_mask``).

    ``vmap_folds=True``: the folds ride the smoother's trial axis
    (:func:`_kfold_folds_vmapped`), ``fold_chunk`` folds a call (all of them
    by default). Pooled ``bits_per_spike`` is the total loglik gain over the
    total spikes.
    """
    if not 2 <= n_folds <= cfg.ydim:
        raise ValueError(
            f"n_folds must be in [2, ydim={cfg.ydim}]; got {n_folds}"
        )
    perm = np.random.default_rng(seed).permutation(cfg.ydim)
    fold_idx = [np.sort(perm[f::n_folds]) for f in range(n_folds)]
    if vmap_folds:
        c = n_folds if not fold_chunk else max(1, int(fold_chunk))
        folds = []
        for lo in range(0, n_folds, c):
            folds.extend(_kfold_folds_vmapped(cfg, state, ys, fold_idx[lo:lo + c], **kwargs))
        folds = tuple(folds)
    else:
        folds = tuple(heldout_eval(cfg, state, ys, fold_idx[f], **kwargs)
                      for f in range(n_folds))
    ll = float(sum(float(f.loglik) for f in folds))
    ll0 = float(sum(float(f.loglik_null) for f in folds))
    if cfg.likelihood == "poisson":
        n_spk = sum(float(f.n_spikes) for f in folds)
        bits = (ll - ll0) / (n_spk * np.log(2.0)) if n_spk > 0 else float("nan")
    else:
        bits = None
    return KFoldEval(
        folds=folds, loglik=ll, loglik_null=ll0, bits_per_spike=bits,
        r2=np.array([float(f.r2) for f in folds]),
    )
