"""Ragged-trial padding helpers (counterpart of ``vjf_tpu/utils/ragged.py``;
numpy only).

Real recordings come as trials of unequal length. The port trains them
through the ``mask=`` argument of :func:`vjf_tpu_torch.models.vjf.fit`
(masked entries leave every reduction and the posterior carry freezes over
padding); these helpers do the bookkeeping: pad a list of trials to a
common T, build the validity mask, and split stacked results back into
per-trial arrays.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np


class PaddedTrials(NamedTuple):
    """Result of :func:`pad_trials`.

    - ``y``: (T_max, B, ydim) observations, zero-padded past each trial's end
    - ``u``: (T_max, B, udim) controls or None
    - ``mask``: (T_max, B) 0/1 trial-validity mask (1 = real data)
    - ``channel_mask``: (T_max, B, ydim) 0/1 or None
    - ``lengths``: list of the original trial lengths
    """

    y: np.ndarray
    u: Optional[np.ndarray]
    mask: np.ndarray
    channel_mask: Optional[np.ndarray]
    lengths: List[int]


def _as_time_major(a) -> np.ndarray:
    """Promote one trial to (T, d): a 1-D (T,) vector becomes (T, 1) —
    NOT ``np.atleast_2d``'s (1, T)."""
    a = np.asarray(a)
    if a.ndim == 1:
        return a[:, None]
    return a


def _stack_padded(seqs: Sequence[np.ndarray], t_max: int) -> np.ndarray:
    """Stack (T_i, d) arrays into (t_max, B, d), zero-padding the tails."""
    first = np.asarray(seqs[0])
    out = np.zeros((t_max, len(seqs)) + first.shape[1:], dtype=first.dtype)
    for i, s in enumerate(seqs):
        s = np.asarray(s)
        out[: s.shape[0], i] = s
    return out


def pad_trials(
    ys: Sequence[np.ndarray],
    us: Optional[Sequence[np.ndarray]] = None,
    channel_masks: Optional[Sequence[np.ndarray]] = None,
) -> PaddedTrials:
    """Pad a list of unequal-length trials into one maskable batch.

    ``ys``: list of (T_i, ydim) observation arrays. ``us``: optional list of
    (T_i, udim) control arrays (must align with ``ys`` per trial).
    ``channel_masks``: optional list of (T_i, ydim) 0/1 missing-observation
    masks (padded region is 0 — it is already excluded by the trial mask).

    Padding is zeros, which the masked core ignores entirely (NaN padding
    would also be ignored, but zeros keep the arrays finite for user-side
    arithmetic). Returns a :class:`PaddedTrials`.
    """
    if len(ys) == 0:
        raise ValueError("pad_trials: empty trial list")
    # a 1-D (T,) trial means ydim=1 — np.atleast_2d would silently
    # transpose it to (1, T)
    ys = [_as_time_major(y) for y in ys]
    ydim = ys[0].shape[-1]
    for i, y in enumerate(ys):
        if y.ndim != 2 or y.shape[-1] != ydim:
            raise ValueError(
                f"pad_trials: trial {i} has shape {y.shape}; expected "
                f"(T_i, {ydim}) matching trial 0"
            )
    lengths = [int(y.shape[0]) for y in ys]
    t_max = max(lengths)

    y_pad = _stack_padded(ys, t_max)
    mask = np.zeros((t_max, len(ys)), dtype=np.float64)
    for i, n in enumerate(lengths):
        mask[:n, i] = 1.0

    u_pad = None
    if us is not None:
        if len(us) != len(ys):
            raise ValueError("pad_trials: len(us) != len(ys)")
        us = [_as_time_major(u) for u in us]
        for i, (u, n) in enumerate(zip(us, lengths)):
            if u.shape[0] != n:
                raise ValueError(
                    f"pad_trials: controls for trial {i} have {u.shape[0]} "
                    f"steps but the trial has {n}"
                )
        u_pad = _stack_padded(us, t_max)

    cm_pad = None
    if channel_masks is not None:
        if len(channel_masks) != len(ys):
            raise ValueError("pad_trials: len(channel_masks) != len(ys)")
        cms = [_as_time_major(cm) for cm in channel_masks]
        for i, (cm, n) in enumerate(zip(cms, lengths)):
            if cm.shape != (n, ydim):
                raise ValueError(
                    f"pad_trials: channel mask for trial {i} has shape "
                    f"{cm.shape}; expected ({n}, {ydim})"
                )
        cm_pad = _stack_padded(cms, t_max)

    return PaddedTrials(y_pad, u_pad, mask, cm_pad, lengths)


def split_trials(stacked, lengths: Sequence[int]) -> List[np.ndarray]:
    """Inverse of the stacking in :func:`pad_trials`: slice a
    (T_max, B, ...) result (e.g. ``fit``'s posterior means) back into a list
    of per-trial (T_i, ...) arrays (as numpy)."""
    stacked = np.asarray(stacked)
    if stacked.ndim < 2 or stacked.shape[1] != len(lengths):
        raise ValueError(
            f"split_trials: expected (T, {len(lengths)}, ...); got "
            f"{stacked.shape}"
        )
    return [stacked[: int(n), i] for i, n in enumerate(lengths)]
