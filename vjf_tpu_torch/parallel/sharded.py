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

Ragged trials and missing channels: the trial mask is given whole (every
rank holds it); the per-step global valid counts are taken from it once an
epoch on the host, each rank's phase-1 kernel gets its rows of the mask and
the global ``1 / max(count, 1)``, ``step_apply`` the global count, and a
masked row's posterior is frozen at its last valid value. The channel mask
is given whole too and cut to the rank's rows; its observed-entry count
rides the all-reduce in the flat sums.

The relaxed-sync epoch (:func:`run_epoch_sync_every`, ``cfg.sync_every !=
1``) runs each rank's trials through the single-card epoch (the step and
mega kernels) for K steps and merges the ranks' states at each segment
boundary with one all-reduce (:func:`_merge_local_states`).

Only ``dist.all_reduce``, ``dist.broadcast`` and ``dist.barrier`` are used:
gloo takes CUDA tensors for those three, and NCCL refuses two ranks on one
device, so two ranks on one card run over gloo and the same code runs over
NCCL on several. A gather (:func:`gather_rows`) is an all-reduce of a
zero-filled buffer into which each rank wrote its rows; adding zeros is
exact. :class:`FitGroup` is what ``models.vjf.fit`` does over a group.

Not ported: the ``tp`` axis and the autograd route over ranks (ROADMAP
Queue 1 items 13 and 4).
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from ..config import StepFlags, VJFConfig
from ..models import regression as R
from ..models import vjf as core
from ..ops import fused_step as F
from ..types import Gaussian


def _rank_and_size(group) -> tuple:
    """(rank in ``group``, world size); raises without a usable group, so
    the all-reduce is never skipped quietly. ``mesh=`` of every entry point
    is such a group."""
    if group is None:
        raise ValueError("the sharded path needs a dp process group (parallel.make_dp_group)")
    if not isinstance(group, dist.ProcessGroup):
        raise ValueError("mesh must be a dp process group (parallel.make_dp_group), not a "
                         f"{type(group).__name__}")
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


def gather_rows(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` in one tensor, in rank order along ``axis``: rank
    ``r`` writes its ``n`` rows at ``[r n, (r + 1) n)`` of a zero-filled
    buffer and the ranks sum it (adding zeros is exact). Every rank holds
    the same number of rows and receives the whole."""
    rank, world = _rank_and_size(group)
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * world
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(axis, rank * n, n).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def broadcast_tree(tree, owner: int, group):
    """``tree`` (a state, a tensor) of rank ``owner`` on every rank: the
    owner sends its own, every other rank a copy of its ``tree`` (the same
    structure and shapes) overwritten with the owner's values."""
    rank, _ = _rank_and_size(group)
    out = tree if rank == owner else copy.deepcopy(tree)
    src = dist.get_global_rank(group, owner)
    for t in _tensors(out):
        dist.broadcast(t, src, group=group)
    return out


def shard_state(cfg: VJFConfig, state: core.TrainState, group) -> core.TrainState:
    """``state`` with every leaf broadcast from the group's rank 0
    (:func:`broadcast_tree`), as JAX's replicated ``device_put`` does.
    ``cfg`` names no sharded leaf yet (the ``tp`` axis is not ported)."""
    return broadcast_tree(state, 0, group)


# ---------------------------------------------------------------------------
# relaxed sync: local segments and the boundary merge
# ---------------------------------------------------------------------------


def _precision_form_or_raise(blr) -> None:
    if not isinstance(blr, (R.NSVBLR, R.PrecisionBLR)):
        raise NotImplementedError(
            "sync_every > 1 requires a precision-carrying RLS backend ('nsv' or 'precision'); "
            "the covariance backend cannot merge")


def merge_contribution(st0: core.TrainState, st_loc: core.TrainState) -> torch.Tensor:
    """This rank's part of a boundary merge's one all-reduce, flat in the
    state's dtype: ``P``, ``P w``, every parameter leaf, the state noise
    logvar, and the increments of the two running-variance counters since
    the segment's start state ``st0``."""
    blr, dyn0, dyn_l = st_loc.dynamics.blr, st0.dynamics, st_loc.dynamics
    _precision_form_or_raise(blr)
    dtype = blr.precision.dtype
    parts = [blr.precision, blr.precision @ blr.w_mean, *_tensors(st_loc.params),
             dyn_l.logvar, (dyn_l.n_sample - dyn0.n_sample).to(dtype),
             st_loc.lik_n_sample - st0.lik_n_sample]
    return torch.cat([p.reshape(-1).to(dtype) for p in parts])


def merge_from_sums(cfg: VJFConfig, st0: core.TrainState, st_loc: core.TrainState,
                    summed: torch.Tensor, n_dev: int, k_steps: int,
                    rls_active: bool = True) -> core.TrainState:
    """The merged state from the ranks' summed :func:`merge_contribution`:
    the math of the JAX package's ``_merge_local_states``.

    Over K local steps each rank's precision is ``lam^K P_0 + Jacc I + dF``
    (``Jacc`` the accumulated jitter, the same on every rank) and its
    ``P w`` is ``lam^K P_0 w_0 + dG``, so the sums less the ``n - 1`` bases
    counted too often are the pooled statistics. When the RLS did not run
    (``rls_active`` False: warm-up, update flags off) every rank still holds
    ``P_0``: the base is undecayed, with no jitter. P and ``V = P^-1`` are
    rebuilt by the relative-floored ``eigh`` in at least f32, ``w = V g``,
    and the step of ``w`` is damped to ``||dw|| <= cfg.sync_trust
    max(||w_0||, 1)``; the precision form refactors P. Parameters and the
    state noise logvar are averaged, the counters' increments added under
    their caps."""
    from ..ops.linalg import eigh_floor_inv_pair, inv_tril_transpose, safe_cholesky

    blr0, blr = st0.dynamics.blr, st_loc.dynamics.blr
    _precision_form_or_raise(blr)
    if rls_active:
        lam = cfg.rls_shrink ** k_steps
        if cfg.rls_shrink == 1.0:
            jacc = cfg.chol_jitter * k_steps
        else:
            jacc = cfg.chol_jitter * (1.0 - lam) / (1.0 - cfg.rls_shrink)
    else:
        lam, jacc = 1.0, 0.0
    n_f, n_o = blr.w_mean.shape
    p_sum, g_sum, rest = torch.split(summed, [n_f * n_f, n_f * n_o, summed.numel()
                                              - n_f * n_f - n_f * n_o])
    p_sum, g_sum = p_sum.reshape(n_f, n_f), g_sum.reshape(n_f, n_o)
    eye = torch.eye(n_f, dtype=p_sum.dtype, device=p_sum.device)
    p_m = p_sum - (n_dev - 1.0) * (lam * blr0.precision + jacc * eye)
    g_m = g_sum - (n_dev - 1.0) * (lam * (blr0.precision @ blr0.w_mean))
    p_m = 0.5 * (p_m + p_m.T)
    sol_dt = torch.promote_types(p_m.dtype, torch.float32)
    p_sol, v_sol = eigh_floor_inv_pair(p_m.to(sol_dt))
    w_m = (v_sol @ g_m.to(sol_dt)).to(blr.w_mean.dtype)
    p_m, v_m = p_sol.to(blr.precision.dtype), v_sol.to(blr.precision.dtype)
    if rls_active and cfg.sync_trust > 0 and n_dev > 1:
        d_w = w_m - blr0.w_mean
        ratio = torch.linalg.vector_norm(d_w) / torch.clamp(
            torch.linalg.vector_norm(blr0.w_mean), min=1.0)
        scale = torch.clamp(cfg.sync_trust / torch.clamp(ratio, min=1e-30), max=1.0)
        w_m = blr0.w_mean + scale.to(w_m.dtype) * d_w
    if isinstance(blr, R.NSVBLR):
        blr_m = R.NSVBLR(w_m, p_m, v_m)
    else:
        chol = safe_cholesky(p_sol).to(blr.precision.dtype)
        blr_m = R.PrecisionBLR(w_m, p_m, chol, inv_tril_transpose(chol))

    params_m = copy.deepcopy(st_loc.params)
    leaves = list(_tensors(params_m))
    vals = torch.split(rest, [t.numel() for t in leaves] + [1, 1, 1])
    for t, v in zip(leaves, vals):
        t.copy_((v / n_dev).reshape(t.shape))
    logvar_sum, dn_sum, dlik_sum = vals[len(leaves):]
    dyn0, dyn_l = st0.dynamics, st_loc.dynamics
    n_m = torch.clamp(dyn0.n_sample + torch.round(dn_sum[0]).to(dyn0.n_sample.dtype),
                      max=cfg.state_var_cap)
    lik_n_m = torch.clamp(st0.lik_n_sample + dlik_sum[0], max=cfg.obs_var_cap)
    return core.TrainState(
        params=params_m,
        dynamics=dyn_l._replace(blr=blr_m, logvar=(logvar_sum[0] / n_dev).reshape(
            dyn_l.logvar.shape).to(dyn_l.logvar.dtype), n_sample=n_m),
        lik_n_sample=lik_n_m.to(st_loc.lik_n_sample.dtype),
    )


@F.full_f32_matmul()
@torch.no_grad()
def _merge_local_states(cfg: VJFConfig, st0: core.TrainState, st_loc: core.TrainState,
                        group, k_steps: int, rls_active: bool = True,
                        extra: Optional[torch.Tensor] = None):
    """Merge the ranks' locally advanced states at a relaxed-sync segment
    boundary: one all-reduce of :func:`merge_contribution`, then
    :func:`merge_from_sums` (the counterpart of the JAX package's
    ``_merge_local_states``). ``extra``, a flat tensor of this rank's, rides
    the same all-reduce. Returns ``(merged state, the ranks' sum of extra or
    None)``. The covariance backend raises ``NotImplementedError``."""
    _, world = _rank_and_size(group)
    contrib = merge_contribution(st0, st_loc)
    n = contrib.numel()
    flat = contrib if extra is None else torch.cat([contrib, extra.to(contrib.dtype)])
    dist.all_reduce(flat, group=group)
    merged = merge_from_sums(cfg, st0, st_loc, flat[:n], world, k_steps, rls_active)
    return merged, None if extra is None else flat[n:]


def segment_seeds(seed: Union[int, torch.Generator], n_seg: int, rank: int) -> list:
    """The relaxed-sync epoch's noise keys for ``rank``: ``n_seg`` segment
    seeds drawn from ``seed`` (an int, or a generator every rank holds in
    the same state), the port's ``jax.random.split(key, n_seg)``, each
    combined with the rank as ``fold_in(seg_key, rank)`` combines it: one
    int drawn from a CPU generator seeded with ``seg * 1_000_003 + rank``.
    The streams differ from the TPU's, as every stream of the port."""
    gen = core._generator(seed)
    segs = [core.epoch_seed(gen) for _ in range(n_seg)]
    return [core.epoch_seed(torch.Generator().manual_seed(s * 1_000_003 + rank)) for s in segs]


@F.full_f32_matmul()
def run_epoch_sync_every(
    cfg: VJFConfig,
    flags: StepFlags,
    state: core.TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seed: Union[int, torch.Generator],
    lr,
    group,
    sync_every: int,
    noise=None,
) -> core.EpochResult:
    """One relaxed-sync epoch over ``group`` (a deliberate deviation, behind
    ``cfg.sync_every != 1``: the reference syncs every step, which
    :func:`run_epoch_fused_sharded` reproduces).

    ``sync_every = K``: each rank runs K steps of its own trials through
    ``models.vjf.run_epoch`` (the step and mega kernels where they apply,
    with no collective), then the ranks merge their states
    (:func:`_merge_local_states`) with ONE all-reduce per boundary, which
    also carries the segment's per-step metrics to average over the ranks. ``sync_every = 0`` merges once, at
    the epoch's end. The first segment runs with ``cfg`` (its
    ``ns_prefix`` exact-inverse steps), the later ones with ``ns_prefix=0``
    (they continue a contracted carry). The posterior carry stays local.

    ``ys``/``us``: this rank's trials (:func:`shard_data`); ``state`` the
    replicated state. Every rank passes the same ``seed``; each segment's
    noise is keyed by :func:`segment_seeds`. ``noise=(eps_s, eps_t)``, each
    this rank's (T, B_local, xd), injects it instead. Returns this rank's
    posteriors, the averaged metrics and the merged state. Masks are not
    supported (``fit`` refuses them); K must divide T."""
    rank, world = _rank_and_size(group)
    t_len = ys.shape[0]
    k = sync_every if sync_every > 0 else t_len
    if t_len % k:
        raise ValueError(f"sync_every={k} must divide the epoch length {t_len}")
    n_seg = t_len // k
    rls_active = flags.update and flags.update_transition and not flags.warm_up
    seeds = segment_seeds(seed, n_seg, rank)
    cfg_rest = cfg.replace(ns_prefix=0)
    st, q = state, None
    means, logvars, metrics = [], [], []
    for i in range(n_seg):
        rows = slice(i * k, (i + 1) * k)
        res = core.run_epoch(cfg if i == 0 else cfg_rest, flags, st, ys[rows], us[rows],
                             seeds[i], lr, q0=q,
                             noise=None if noise is None else (noise[0][rows], noise[1][rows]))
        fields = [m.detach() for m in res.metrics if m is not None]
        st, met = _merge_local_states(cfg, st, res.state, group, k, rls_active,
                                      extra=torch.cat(fields))
        q = Gaussian(res.q_means[-1], res.q_logvars[-1])
        means.append(res.q_means)
        logvars.append(res.q_logvars)
        metrics.append((met / world).reshape(len(fields), k).to(res.metrics.loss.dtype))
    met = torch.cat(metrics, dim=1)
    return core.EpochResult(state=st, q_means=torch.cat(means), q_logvars=torch.cat(logvars),
                            metrics=core.Metrics(*met.unbind(0)))


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
    instead. ``mask`` ((T,) or (T, B), every trial of the group) and
    ``channel_mask`` ((T, ydim) or (T, B, ydim), every trial) are the same
    on every rank; each rank cuts its rows (module docstring). Returns this
    rank's posteriors and the global metrics."""
    rank, world = _rank_and_size(group)
    if ys.dtype != cfg.tdtype:
        ys = ys.to(cfg.tdtype)
    if us.dtype != cfg.tdtype:
        us = us.to(cfg.tdtype)
    t_len, b_local, ydim = ys.shape
    n_batch = world * b_local
    inv_b = 1.0 / n_batch
    dtype, dev = ys.dtype, ys.device
    rows = slice(rank * b_local, (rank + 1) * b_local)
    m_local = counts = inv_bs = cm_local = None
    if mask is not None:
        full = core._promote_mask(mask, t_len, n_batch, dtype, "cpu") > 0
        # the global valid counts, once an epoch on the host: the phase-1
        # kernel takes 1 / max(count, 1) as a number, so no step waits
        n_valid = full.sum(dim=1).to(dtype)
        inv_bs = (1.0 / torch.clamp(n_valid, min=1.0)).tolist()
        counts = n_valid.to(dev)
        m_local = full[:, rows].to(device=dev, dtype=dtype)
    if channel_mask is not None:
        cm_full = core._promote_channel_mask(channel_mask, (t_len, n_batch, ydim), dtype, dev)
        cm_local = cm_full[:, rows]
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
        m_t = None if m_local is None else m_local[t]
        flat, q_pack = F.forward_sums_call(
            cfg, flags, carry, qm, qlv, ys[t], us[t] if has_u else None,
            None if noise is None else noise[0][t], None if noise is None else noise[1][t],
            inv_b if inv_bs is None else inv_bs[t], row0=rank * b_local, mask=m_t,
            cmask=None if cm_local is None else cm_local[t],
        )
        dist.all_reduce(flat, group=group)
        sums = F.unpack_sums(flat, carry, has_cm=cm_local is not None)
        count = None if counts is None else counts[t]
        new, scal, g_vec = F.step_apply(cfg, flags, carry, sums, lr, n_batch,
                                        valid_count=count)
        if do_fallback:
            new = F.exact_v_fallback_sums(cfg, new, carry, sums, g_vec, scal.tau[0, 0],
                                          n_batch if count is None else count)
        carry = new._replace(rng_count=carry.rng_count + 1)
        if m_t is not None:
            # the frozen carry of masked rows
            keep = m_t[:, None] > 0
            q_pack = torch.stack([torch.where(keep, q_pack[0], qm),
                                  torch.where(keep, q_pack[1], qlv)])
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
    multi-rank counterpart of ``models.vjf.run_epochs``, with the same masks
    (whole, as :func:`run_epoch_fused_sharded` takes them). Every epoch
    starts from the prior; the posteriors returned are the last epoch's,
    this rank's rows."""
    q0 = core.prior(state.params, ys.shape[1])

    def epoch(st, seed, lr):
        return run_epoch_fused_sharded(cfg, flags, st, ys, us, seed, lr, group, q0=q0,
                                       mask=mask, channel_mask=channel_mask)

    return core.chain_epochs(cfg, epoch, state, ys.shape[0], seeds, lrs)


_XLA_TODO = "the sharded autograd epoch: ROADMAP Queue 1 item 4 (its multi-rank route)"


def _fused_or_raise(cfg: VJFConfig, state, n_batch: int, mask=None,
                    channel_mask=None) -> None:
    if not F.fused_enabled(cfg, state, n_batch=n_batch, mask=mask is not None,
                           channel_mask=channel_mask is not None):
        raise NotImplementedError(_XLA_TODO)


def make_sharded_epoch(cfg: VJFConfig, flags: StepFlags, group):
    """``fn(state, ys, us, seed, lr, mask=None, channel_mask=None) ->
    EpochResult`` over ``group``: the fused route,
    :func:`run_epoch_fused_sharded`. The XLA-step route (a configuration the
    fused step does not take) raises."""
    _rank_and_size(group)

    def call(state, ys, us, seed, lr, mask=None, channel_mask=None):
        _fused_or_raise(cfg, state, ys.shape[1], mask, channel_mask)
        return run_epoch_fused_sharded(cfg, flags, state, ys, us, seed, lr, group, mask=mask,
                                       channel_mask=channel_mask)

    return call


def make_sharded_epochs(cfg: VJFConfig, flags: StepFlags, group):
    """``fn(state, ys, us, seeds, lrs, mask=None, channel_mask=None) ->
    EpochsResult``: the multi-epoch counterpart of :func:`make_sharded_epoch`
    (:func:`run_epochs_fused_sharded`)."""
    _rank_and_size(group)

    def call(state, ys, us, seeds, lrs, mask=None, channel_mask=None):
        _fused_or_raise(cfg, state, ys.shape[1], mask, channel_mask)
        return run_epochs_fused_sharded(cfg, flags, state, ys, us, seeds, lrs, group,
                                        mask=mask, channel_mask=channel_mask)

    return call


class FitGroup:
    """What ``models.vjf.fit`` and ``_fit_blocked`` do over a ``dp`` group
    (``mesh=``), beside their single-card ``models.vjf._Solo``: the
    replicated state broadcast from rank 0 after each host-side step, the
    whole batch's posteriors gathered where a consumer reads every trial,
    the host's control values taken from rank 0 so that every rank decides
    alike, and snapshots written by rank 0 alone (then every rank waits)."""

    def __init__(self, group, device):
        self.rank, self.world = _rank_and_size(group)
        self.group, self.device = group, device
        self._whole = (None, None)

    def state(self, cfg: VJFConfig, state: core.TrainState) -> core.TrainState:
        return shard_state(cfg, state, self.group)

    def whole(self, res):
        """``res`` (an ``EpochResult`` or ``EpochsResult`` of this rank's
        trials) with the whole batch's posteriors, gathered once a result."""
        if self._whole[0] is not res:
            self._whole = (res, res._replace(q_means=gather_rows(res.q_means, self.group, 1),
                                             q_logvars=gather_rows(res.q_logvars, self.group, 1)))
        return self._whole[1]

    def agree(self, vals) -> list:
        t = torch.tensor(list(vals), dtype=torch.float64, device=self.device)
        dist.broadcast(t, dist.get_global_rank(self.group, 0), group=self.group)
        return t.tolist()

    def save(self, save_fn, path: str, snapshot) -> None:
        save_on_rank0(save_fn, path, snapshot, self.group)


def save_on_rank0(save_fn, path: str, snapshot, group) -> None:
    """``save_fn(path, snapshot)`` on the group's rank 0 alone (one file,
    written atomically), then every rank waits for it: a rank that resumes
    reads what rank 0 wrote."""
    if _rank_and_size(group)[0] == 0:
        save_fn(path, snapshot)
    dist.barrier(group=group)
