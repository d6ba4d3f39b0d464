"""Exact-sync sharded training over a ``dp`` process group (counterpart of
``vjf_tpu/parallel/sharded.py``, its fused path).

Trials split over the ranks; the model and dynamics state are replicated. A
step couples trials only through its batch sums, so each step runs in three
parts:

1. phase 1 on this rank's trials, :func:`~..ops.fused_step.forward_sums_call`
   (the ``vjf_forward_sums`` kernel on the card), every batch mean scaled by
   the GLOBAL ``1/B``;
2. ONE ``dist.all_reduce`` of the flat ``FusedSums`` buffer, the JAX
   ``psum`` of the whole tuple;
3. phase 2 on every rank alike: ``step_apply`` from the summed statistics,
   then the stats-based exact-inverse fallback. Every rank applies the same
   update to the same state, so the state stays replicated.

Each rank holds its own slice of the trials: :func:`shard_data` gives rank
``r`` rows ``[r B_local, (r + 1) B_local)``, and the in-kernel noise draws
the same rows of the whole batch's Philox draw, so an epoch at any world
size uses the single-device epoch's noise for the same seed. The posteriors
returned are this rank's rows; the metrics and the state are the global,
replicated ones.

Not ported: the relaxed-sync path (``run_epoch_sync_every``,
``_merge_local_states``), the ``tp`` axis and the XLA-step route (ROADMAP
Queue 1 items 13 and 4). Masks raise.
"""
from __future__ import annotations

import copy
from typing import Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from ..config import StepFlags, VJFConfig
from ..models import vjf as core
from ..ops import fused_step as F


def _rank_and_size(group) -> tuple:
    """(rank in ``group``, world size); raises without a usable group, so
    the all-reduce is never skipped quietly."""
    if group is None:
        raise ValueError("the sharded path needs a dp process group (parallel.make_dp_group)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialised")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the dp group")
    return rank, dist.get_world_size(group)


def shard_data(ys: torch.Tensor, us: torch.Tensor, group):
    """This rank's trials of ``ys`` (T, B, ydim) and ``us`` (T, B, udim):
    rows ``[r B/n, (r + 1) B/n)`` for rank ``r`` of ``n``."""
    rank, world = _rank_and_size(group)
    b = ys.shape[1]
    if b % world:
        raise ValueError(f"batch {b} does not split over {world} ranks")
    rows = slice(rank * (b // world), (rank + 1) * (b // world))
    return ys[:, rows].contiguous(), us[:, rows].contiguous()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from (p.data for p in tree.parameters())
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)


def shard_state(cfg: VJFConfig, state: core.TrainState, group) -> core.TrainState:
    """A copy of ``state`` with every leaf broadcast from the group's rank 0,
    as JAX's replicated ``device_put`` does. ``cfg`` names no sharded leaf
    yet (the ``tp`` axis is not ported)."""
    _rank_and_size(group)
    src = dist.get_global_rank(group, 0)
    out = copy.deepcopy(state)
    for t in _tensors(out):
        dist.broadcast(t, src, group=group)
    return out


@F.full_f32_matmul()
@torch.no_grad()
def run_epoch_fused_sharded(
    cfg: VJFConfig,
    flags: StepFlags,
    state: core.TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seed: Union[int, torch.Generator],
    lr,
    group,
    noise=None,
    q0=None,
    mask=None,
    channel_mask=None,
) -> core.EpochResult:
    """One exact-sync epoch over ``group``: per step, phase 1 on this rank's
    trials, one all-reduce of the flat sums, then the replicated apply and
    the stats-based exact-inverse fallback (module docstring).

    ``ys``/``us`` are this rank's trials (:func:`shard_data`), the same
    number on every rank; ``state`` is the replicated state
    (:func:`shard_state`). Every rank passes the same ``seed`` (an int, or a
    generator in the same state), which keys the in-kernel Philox noise;
    ``noise=(eps_s, eps_t)``, each this rank's (T, B_local, xd), injects it
    instead. Returns this rank's posteriors and the global metrics."""
    rank, world = _rank_and_size(group)
    F._no_masks(mask, channel_mask)
    if ys.dtype != cfg.tdtype:
        ys = ys.to(cfg.tdtype)
    if us.dtype != cfg.tdtype:
        us = us.to(cfg.tdtype)
    t_len, b_local, _ = ys.shape
    n_batch = world * b_local
    inv_b = 1.0 / n_batch
    dtype, dev = ys.dtype, ys.device
    if q0 is None:
        q0 = core.prior(state.params, b_local)
    lr = F._lr_tensor(lr, dtype, dev)
    has_u = cfg.udim > 0

    do_fallback = flags.update and flags.update_transition and not flags.warm_up
    # gated on the GLOBAL batch, as on one device
    state = F.maybe_epoch_repair(cfg, flags, state, n_batch)
    carry = F.pad_carry(cfg, state)._replace(
        rng_seed=torch.full((1, 1), core.epoch_seed(seed), dtype=torch.int32, device=dev)
    )

    qm, qlv = q0.mean.contiguous(), q0.logvar.contiguous()
    q_seq, scal_seq = [], []
    for t in range(t_len):
        flat, q_pack = F.forward_sums_call(
            cfg, flags, carry, qm, qlv, ys[t], us[t] if has_u else None,
            None if noise is None else noise[0][t], None if noise is None else noise[1][t],
            inv_b, row0=rank * b_local,
        )
        dist.all_reduce(flat, group=group)
        sums = F.unpack_sums(flat, carry)
        new, scal, g_vec = F.step_apply(cfg, flags, carry, sums, lr, n_batch)
        if do_fallback:
            new = F.exact_v_fallback_sums(cfg, new, carry, sums, g_vec, scal.tau[0, 0], n_batch)
        carry = new._replace(rng_count=carry.rng_count + 1)
        qm, qlv = q_pack[0], q_pack[1]
        q_seq.append(q_pack)
        scal_seq.append(F._scal_row(scal))
    return F.epoch_result(cfg, carry, state, torch.stack(q_seq), torch.cat(scal_seq, dim=0))


def run_epochs_fused_sharded(
    cfg: VJFConfig,
    flags: StepFlags,
    state: core.TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seeds: Sequence[Union[int, torch.Generator]],
    lrs,
    group,
    mask=None,
    channel_mask=None,
) -> core.EpochsResult:
    """``len(seeds)`` consecutive sharded epochs over the same trials, the
    multi-rank counterpart of ``models.vjf.run_epochs``. Every epoch starts
    from the prior; the posteriors returned are the last epoch's, this
    rank's rows."""
    q0 = core.prior(state.params, ys.shape[1])

    def epoch(st, seed, lr):
        return run_epoch_fused_sharded(cfg, flags, st, ys, us, seed, lr, group, q0=q0,
                                       mask=mask, channel_mask=channel_mask)

    return core.chain_epochs(cfg, epoch, state, ys.shape[0], seeds, lrs)


_XLA_TODO = "the sharded autograd epoch: ROADMAP Queue 1 item 4 (its multi-rank route)"


def _fused_or_raise(cfg: VJFConfig, state, n_batch: int) -> None:
    if not F.fused_enabled(cfg, state, n_batch=n_batch):
        raise NotImplementedError(_XLA_TODO)


def make_sharded_epoch(cfg: VJFConfig, flags: StepFlags, group):
    """``fn(state, ys, us, seed, lr, mask=None, channel_mask=None) ->
    EpochResult`` over ``group``: the fused route,
    :func:`run_epoch_fused_sharded`. The XLA-step route (a configuration the
    fused step does not take) raises, and so do masks."""
    _rank_and_size(group)

    def call(state, ys, us, seed, lr, mask=None, channel_mask=None):
        F._no_masks(mask, channel_mask)
        _fused_or_raise(cfg, state, ys.shape[1])
        return run_epoch_fused_sharded(cfg, flags, state, ys, us, seed, lr, group)

    return call


def make_sharded_epochs(cfg: VJFConfig, flags: StepFlags, group):
    """``fn(state, ys, us, seeds, lrs, mask=None, channel_mask=None) ->
    EpochsResult``: the multi-epoch counterpart of :func:`make_sharded_epoch`
    (:func:`run_epochs_fused_sharded`)."""
    _rank_and_size(group)

    def call(state, ys, us, seeds, lrs, mask=None, channel_mask=None):
        F._no_masks(mask, channel_mask)
        _fused_or_raise(cfg, state, ys.shape[1])
        return run_epochs_fused_sharded(cfg, flags, state, ys, us, seeds, lrs, group)

    return call
