"""Exact-sync sharded training over a ``dp`` x ``tp`` mesh (counterpart of
``vjf_tpu/parallel/sharded.py``).

Trials split over ``dp``; the model and dynamics state are replicated (the
autograd route cuts the decoder rows over ``tp`` inside an epoch). A step
couples trials only through its batch sums. The exact-sync epoch takes one
of two routes, decided as the JAX package decides it (:func:`fused_route`):

**The fused route** (:func:`run_epoch_fused_sharded`, where the kernels
take the configuration), over ``dp`` alone with whole channels on every
rank, each step in three parts:

1. phase 1 on this rank's trials, :func:`~..ops.fused_step.forward_sums_call`
   (the ``vjf_forward_sums`` kernel on the card), every batch mean scaled by
   the GLOBAL ``1/B``;
2. ONE ``dist.all_reduce`` of the flat ``FusedSums`` buffer, the JAX
   ``psum`` of the whole tuple;
3. phase 2 on every rank alike: ``step_apply`` from the summed statistics,
   then the stats-based exact-inverse fallback. Every rank applies the same
   update to the same state, so the state stays replicated.

**The autograd route** (:func:`run_epoch_autograd_sharded`, every other
configuration: ``fused_step='off'``, float64, the precision and covariance
forms, the Kalman learner, small-batch SGP, shapes past the kernels'
limits), the JAX package's ``core.run_epoch`` under GSPMD: the trials over
``dp`` and, where ``tp`` divides ``ydim``, the channels and decoder rows
over ``tp`` (:func:`channel_rows`); per step :func:`filter_step_sharded`,
two all-reduces over the mesh and, under a channel cut, two over ``tp``.

Each rank holds its own slice of the trials: :func:`shard_data` gives rank
``r`` rows ``[r B_local, (r + 1) B_local)``, and the noise is the same
rows of the whole batch's draw (the in-kernel Philox, or the autograd
epoch's CPU draw), so an epoch at any layout uses the single-device
epoch's noise for the same seed. The posteriors returned are this rank's
rows; the metrics and the state are the global, replicated ones.

Ragged trials and missing channels: the trial mask is given whole (every
rank holds it); the per-step global valid counts are taken from it, each
rank gets its rows of the mask, the batch means divide by the global
count, and a masked row's posterior is frozen at its last valid value. The
channel mask is given whole too and cut to the rank's part; its
observed-entry count rides an all-reduce.

The relaxed-sync epoch (:func:`run_epoch_sync_every`, ``cfg.sync_every !=
1``) runs each rank's trials through the single-card epoch (the step and
mega kernels) for K steps and merges the ranks' states at each segment
boundary with one all-reduce (:func:`_merge_local_states`), over ``dp``.

Only ``dist.all_reduce``, ``dist.broadcast`` and ``dist.barrier`` are used:
gloo takes CUDA tensors for those three, and NCCL refuses two ranks on one
device, so two ranks on one card run over gloo and the same code runs over
NCCL on several. A gather (:func:`gather_rows`) is an all-reduce of a
zero-filled buffer into which each rank wrote its rows; adding zeros is
exact. :class:`FitGroup` is what ``models.vjf.fit`` does over a mesh.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from ..config import StepFlags, VJFConfig
from ..models import dynamics as D
from ..models import regression as R
from ..models import vjf as core
from ..models.decoder import decode
from ..models.likelihoods import gaussian_lik_apply, gaussian_lik_from_sums, gaussian_lik_sums
from ..models.recognition import linear_from
from ..ops import fused_step as F
from ..ops.functional import all_finite, finite_or_zero, gaussian_entropy, reparametrize, tree_where
from ..ops.tp import TPSlice
from ..types import Gaussian
from .mesh import Mesh, as_mesh


def _rank_and_size(group) -> tuple:
    """(``dp`` index, ``dp`` size) of this rank in ``group``, a ``dp`` process
    group or a :class:`~.mesh.Mesh`; anything else raises ``ValueError``, so
    the all-reduce is never skipped quietly. ``mesh=`` of every entry point
    is such a group or mesh."""
    m = as_mesh(group)
    return m.coords[0], m.shape[0]


def _dp(group) -> dist.ProcessGroup:
    """The ``dp`` process group of ``group`` (a group or a mesh)."""
    return as_mesh(group).dp


def channel_rows(ydim: int, mesh) -> Optional[TPSlice]:
    """This rank's channels of the ``tp`` axis, or None where the channels
    stay whole: without a ``tp`` axis, or where ``tp`` does not divide
    ``ydim`` (the JAX package's ``data_sharding`` rule). The decoder rows
    split the same way."""
    m = as_mesh(mesh)
    n_tp = m.shape[1]
    if m.tp is None or ydim % n_tp:
        return None
    per = ydim // n_tp
    return TPSlice(m.tp, m.coords[1] * per, (m.coords[1] + 1) * per)


def _trial_rows(n_batch: int, mesh) -> slice:
    rank, world = _rank_and_size(mesh)
    if n_batch % world:
        raise ValueError(f"batch {n_batch} does not split over {world} ranks")
    per = n_batch // world
    return slice(rank * per, (rank + 1) * per)


def shard_data(ys: torch.Tensor, us: torch.Tensor, mesh):
    """This rank's part of ``ys`` (T, B, ydim) and ``us`` (T, B, udim): the
    trials ``[r B/n, (r + 1) B/n)`` of its ``dp`` index ``r`` of ``n``, and
    of ``ys`` its channels of :func:`channel_rows` (all of them where the
    channels stay whole). The controls are never cut by channel."""
    rows = _trial_rows(ys.shape[1], mesh)
    chans = channel_rows(ys.shape[-1], mesh)
    ys = ys[:, rows] if chans is None else ys[:, rows, chans.lo:chans.hi]
    return ys.contiguous(), us[:, rows].contiguous()


def shard_trials(ys: torch.Tensor, us: torch.Tensor, mesh):
    """This rank's trials of ``ys`` and ``us`` (T, B, ...) with every
    column: the fused and relaxed routes' part, and an injected noise's."""
    rows = _trial_rows(ys.shape[1], mesh)
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
    the same number of rows and receives the whole. Over a mesh the ranks
    are its ``dp`` axis."""
    group = _dp(group)
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
    structure and shapes) overwritten with the owner's values. Over a mesh
    ``owner`` is a ``dp`` index and the ranks are its ``dp`` axis. A leaf
    that is not contiguous (a transposed factor) travels through a
    contiguous copy: NCCL takes no other."""
    group = _dp(group)
    rank, _ = _rank_and_size(group)
    out = tree if rank == owner else copy.deepcopy(tree)
    src = dist.get_global_rank(group, owner)
    for t in _tensors(out):
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src, group=group)
        if buf is not t and rank != owner:
            t.copy_(buf)
    return out


def shard_state(cfg: VJFConfig, state: core.TrainState, mesh) -> core.TrainState:
    """``state`` with every leaf broadcast from the mesh's rank 0 to every
    rank (:func:`broadcast_tree`), as JAX's ``device_put`` of a replicated
    state. The state stays whole between epochs; the autograd epoch cuts
    the decoder rows over ``tp`` inside itself (:func:`channel_rows`) and
    gathers them at its end, as the JAX package's ``state_shardings`` shard
    them, so every caller sees the global state."""
    return broadcast_tree(state, 0, as_mesh(mesh).everyone)


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
    None)``. The covariance backend raises ``NotImplementedError``. Over a
    mesh the ranks are its ``dp`` axis (its ``tp`` peers merge the same)."""
    group = _dp(group)
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
    rank's posteriors and the global metrics. Over a mesh the all-reduce
    runs over its ``dp`` axis, with whole channels on every rank: the
    ``tp`` peers compute the same, as under the JAX package's ``shard_map``,
    which names ``dp`` alone."""
    group = _dp(group)
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


# ---------------------------------------------------------------------------
# exact sync, the autograd route: the step over a dp x tp mesh
# ---------------------------------------------------------------------------


class _Shard(NamedTuple):
    """What one rank of the autograd epoch over a mesh holds."""

    mesh: Mesh
    chans: Optional[TPSlice]   # its channels, None where they stay whole
    lead: bool                 # tp index 0: adds what the tp peers replicate


def _all_reduce(parts: list, group) -> list:
    """``parts`` summed over ``group`` in one all-reduce of their
    concatenation."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=group)
    return [v.reshape(p.shape) for v, p in zip(torch.split(flat, [p.numel() for p in parts]),
                                                parts)]


def _replicated(t: torch.Tensor, sh: _Shard) -> torch.Tensor:
    """A sum the ``tp`` peers compute alike enters the mesh's all-reduce
    once, from the lead rank (zeros elsewhere: never ``0 * x``, which keeps
    a NaN)."""
    return t if sh.lead else torch.zeros_like(t)


def _by_channel(t: torch.Tensor, sh: _Shard) -> torch.Tensor:
    """A sum over this rank's channels: partial over ``tp`` under a channel
    cut, else replicated (:func:`_replicated`)."""
    return t if sh.chans is not None else _replicated(t, sh)


def _input_linears(rec) -> list:
    """The recognition network's layers that read the channels."""
    return [rec.layers[0]] if len(rec.layers) else [rec.mean, rec.logvar]


def _grad_parts(cfg: VJFConfig, params, grads, sh: _Shard) -> list:
    """The step's gradients as they enter the mesh's all-reduce: a
    replicated leaf's from the lead rank; under a channel cut the input
    layer's weight with its channel columns (this rank's alone are non-zero)
    from every rank and the rest from the lead, the decoder's rows at their
    place in a zero-filled whole, and the Gaussian likelihood's log-variance
    (read by this rank's channels alone) from every rank."""
    inputs = {id(lin.weight) for lin in _input_linears(params.recognition)}
    dec = {id(t) for t in params.decoder.parameters()}
    lik = id(params.likelihood.logvar) if cfg.likelihood == "gaussian" else None
    parts = []
    for p, g in zip(core._trained_leaves(cfg, params), grads):
        if sh.chans is None:
            parts.append(_replicated(g, sh))
        elif id(p) == lik:
            parts.append(g)
        elif id(p) in dec:
            whole = torch.zeros((cfg.ydim,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
            whole[sh.chans.lo:sh.chans.hi] = g
            parts.append(whole)
        elif id(p) in inputs and not sh.lead:
            parts.append(torch.cat([g[:, :cfg.ydim], torch.zeros_like(g[:, cfg.ydim:])], dim=1))
        else:
            parts.append(_replicated(g, sh))
    return parts


def filter_step_sharded(cfg: VJFConfig, flags: StepFlags, state: core.TrainState, qs: Gaussian,
                        y: torch.Tensor, u: torch.Tensor, eps_s: torch.Tensor,
                        eps_t: torch.Tensor, lr, sh: _Shard, n_valid, mask=None,
                        channel_mask=None):
    """``models.vjf.filter_step`` on this rank's trials (and under a channel
    cut its channels; the decoder then holds its rows) over a mesh:
    ``(state, qt, Metrics)``, the state and the metrics the same on every
    rank. ``n_valid``: the whole batch's valid trial count at this step (an
    int B without a trial mask).

    Every batch mean is this rank's sum over the whole batch's count, which
    the ranks' sum completes. The mesh's collectives, in the step's order:

    1. over ``tp``, under a channel cut: the input layer's partial product
       in the forward pass (``ops.tp.reduce_from``) and the latent sample's
       gradient in the backward pass (``ops.tp.copy_to``);
    2. ONE all-reduce over the mesh of the three ELBO terms and every
       statistic taken before the update: the obs-noise mse, the RLS sums
       (``F^T F``, ``F^T dx``, nsv's trace sum) or for the covariance form
       and the Kalman learner the whole batch's ``F`` and ``dx`` rows (each
       rank factors the same B x B innovation), and the non-finite count of
       the samples;
    3. ONE all-reduce over the mesh of the gradients and the state noise's
       residual after the update.

    A non-finite term is dropped from the loss on every rank, as one device
    drops it (each term's gate reads its global value); the backward pass
    then runs on this rank's part of the gated loss. What the ``tp`` peers
    compute alike enters the all-reduces from the lead rank alone
    (:func:`_replicated`, :func:`_grad_parts`), so the sums count it once.
    The closed-form update runs before the SGD step here (it reads nothing
    the SGD step writes), so that its residual rides the gradients'
    all-reduce."""
    tr = core._transition(cfg)
    group = sh.mesh.everyone
    qs = Gaussian(qs.mean.detach(), qs.logvar.detach())
    dtype, dev = y.dtype, y.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    weights = mb = None
    if channel_mask is not None:
        cm = channel_mask > 0
        y = torch.where(cm, y, zero)
        channel_mask = cm.to(dtype)
    if mask is not None:
        mb = mask > 0
        weights = mb.to(dtype)
        y = torch.where(mb[:, None], y, zero)
        if u is not None and u.shape[-1] > 0:
            u = torch.where(mb[:, None], u, zero)
    count = n_valid if isinstance(n_valid, int) else torch.clamp(n_valid, min=1.0)
    params = core._trainable(cfg, state.params) if flags.sgd else state.params
    dyn_on = flags.update and flags.update_transition
    rls_on = dyn_on and not flags.warm_up
    lik_on = flags.update and cfg.likelihood == "gaussian" and flags.update_likelihood
    rule = "rls" if cfg.dynamics == "sgp" else cfg.dynamics_update
    blr = state.dynamics.blr
    rows_whole = rule == "kalman" or isinstance(blr, R.CovarianceBLR)

    with torch.set_grad_enabled(flags.sgd):
        xs = reparametrize(qs, eps_s)
        feat = tr.features(state.dynamics, xs, u)
        pt = tr.predict_from_features(state.dynamics, xs, feat, cfg.leak)
        y_rec = y if channel_mask is None else core._impute_y(cfg, params, qs, y, channel_mask)
        qt = params.recognition(y_rec, qs, u, activation=cfg.recognition_activation,
                                tp=sh.chans)
        qt = Gaussian(qt.mean, torch.clamp(qt.logvar, -cfg.logvar_clamp, cfg.logvar_clamp))
        xt = reparametrize(qt, eps_t)
        py = decode(params.decoder, xt, tp=sh.chans)
        l_recon = core._likelihood_loss(cfg, params.likelihood, py, y, weights=weights,
                                        channel_mask=channel_mask, count=count)
        l_dyn = tr.dynamics_loss(state.dynamics, pt, qt, trace_quirk=cfg.trace_quirk,
                                 weights=weights, count=count)
        h = gaussian_entropy(qt, weights=weights, count=count)

    # the first all-reduce: the terms and the statistics before the update
    xt, xs, py, feat = (a.detach() for a in (xt, xs, py, feat))
    parts = [torch.stack([_by_channel(l_recon.detach(), sh), _replicated(l_dyn.detach(), sh),
                          _replicated(h.detach(), sh)])]
    if lik_on:
        parts.append(_by_channel(gaussian_lik_sums(py, y, cfg.ydim, weights, channel_mask), sh))
    if dyn_on:
        feat_w = feat if weights is None else feat * weights[:, None]
        dx = xt - xs
        bad = torch.sum((~torch.isfinite(xt)).to(dtype)) + torch.sum((~torch.isfinite(xs))
                                                                     .to(dtype))
        parts.append(_replicated(bad.reshape(1), sh))
        v = torch.exp(state.dynamics.logvar)
        if rls_on and rows_whole:
            n_batch, rows = feat.shape[0] * sh.mesh.shape[0], feat.shape[0]
            lo = sh.mesh.coords[0] * rows
            for a in (feat_w, dx):
                whole = torch.zeros((n_batch, a.shape[1]), dtype=dtype, device=dev)
                whole[lo:lo + rows] = a
                parts.append(_replicated(whole, sh))
        elif rls_on:
            ff, fd = R.rls_products(feat_w, dx, v)
            parts += [_replicated(ff, sh), _replicated(fd, sh)]
            if isinstance(blr, R.NSVBLR):
                parts.append(_replicated(R.nsv_trace_sum(blr, feat_w, cfg.rls_shrink)
                                         .reshape(1), sh))
    sums = _all_reduce(parts, group)
    terms, rest = sums[0], sums[1:]
    lik_sums = rest.pop(0) if lik_on else None
    t_recon, t_dyn, t_h = (finite_or_zero(t) for t in terms.unbind(0))
    loss = t_recon - t_h
    if not flags.warm_up:
        loss = loss + t_dyn
    metrics = core.Metrics(loss, -t_recon, -t_dyn, t_h)

    # the closed-form update from the summed statistics, the same on every
    # rank, and this rank's residual after it
    res_parts = []
    if dyn_on:
        bad = rest.pop(0)[0]
        blr_new = blr
        if rls_on and rows_whole:
            blr_new = D.closed_form_update(cfg, blr, rest[0], rest[1], v, rule)
        elif rls_on:
            tau_sum = rest[2][0] if isinstance(blr, R.NSVBLR) else None
            blr_new = R.rls_from_sums(blr, rest[0], rest[1], tau_sum, v, cfg.rls_shrink,
                                      cfg.chol_jitter)
        resid = dx - feat_w @ blr_new.w_mean
        rows = torch.sum(torch.square(resid), dim=-1) / cfg.xdim
        if weights is not None:
            rows = torch.where(weights > 0, rows, torch.zeros_like(rows)) * weights
        res_parts.append(_replicated(torch.sum(rows).reshape(1), sh))

    # the backward pass on this rank's part of the gated loss
    grads = []
    if flags.sgd:
        gated = (torch.where(torch.isfinite(terms[0]), l_recon, torch.zeros_like(l_recon))
                 - torch.where(torch.isfinite(terms[2]), h, torch.zeros_like(h)))
        if not flags.warm_up:
            gated = gated + torch.where(torch.isfinite(terms[1]), l_dyn, torch.zeros_like(l_dyn))
        grads = list(torch.autograd.grad(gated, core._trained_leaves(cfg, params)))
        res_parts = _grad_parts(cfg, params, grads, sh) + res_parts

    # the second all-reduce: the gradients and the residual
    if res_parts:
        res_parts = _all_reduce(res_parts, group)
    with torch.no_grad():
        new_params = state.params
        if flags.sgd:
            new_params = core.sgd_params(
                cfg, flags, state, params, res_parts[:len(grads)], lr,
                decoder_rows=None if sh.chans is None else slice(sh.chans.lo, sh.chans.hi))
        lik_n = state.lik_n_sample
        if lik_on:
            mse, n_rows = gaussian_lik_from_sums(lik_sums, cfg.ydim, n_valid,
                                                 channel_mask is not None)
            lik, lik_n = gaussian_lik_apply(new_params.likelihood, lik_n, mse, n_rows,
                                            size_cap=cfg.obs_var_cap,
                                            logvar_clamp=cfg.logvar_clamp)
            new_params = new_params._replace(likelihood=lik)
        dynamics = state.dynamics
        if dyn_on:
            mse = res_parts[-1][0] / count
            logvar, n_sample = D.state_noise_update(cfg, dynamics.logvar, dynamics.n_sample,
                                                    mse, n_valid)
            upd = dynamics._replace(blr=blr_new, logvar=logvar, n_sample=n_sample)
            upd_ok = (bad == 0) & all_finite(upd)
            if weights is not None:
                upd_ok = upd_ok & (n_valid > 0)
            dynamics = tree_where(upd_ok, upd, dynamics)
        qt = Gaussian(qt.mean.detach(), qt.logvar.detach())
        if mb is not None:
            qt = Gaussian(torch.where(mb[:, None], qt.mean, qs.mean),
                          torch.where(mb[:, None], qt.logvar, qs.logvar))
    return core.TrainState(new_params, dynamics, lik_n), qt, metrics


def _decoder_rows(state: core.TrainState, chans: Optional[TPSlice]) -> core.TrainState:
    """``state`` with this rank's decoder rows (views, never written)."""
    if chans is None:
        return state
    dec = state.params.decoder
    cut = linear_from(dec.weight[chans.lo:chans.hi],
                      None if dec.bias is None else dec.bias[chans.lo:chans.hi])
    return state._replace(params=state.params._replace(decoder=cut))


def _whole_decoder(state: core.TrainState, chans: Optional[TPSlice]) -> core.TrainState:
    """The decoder rows of every ``tp`` rank gathered, in order."""
    if chans is None:
        return state
    dec = state.params.decoder
    whole = linear_from(gather_rows(dec.weight, chans.group, 0),
                        None if dec.bias is None else gather_rows(dec.bias, chans.group, 0))
    return state._replace(params=state.params._replace(decoder=whole))


@F.full_f32_matmul()
def run_epoch_autograd_sharded(
    cfg: VJFConfig,
    flags: StepFlags,
    state: core.TrainState,
    ys: torch.Tensor,
    us: torch.Tensor,
    seed: Union[int, torch.Generator],
    lr,
    mesh,
    noise=None,
    q0=None,
    mask=None,
    channel_mask=None,
) -> core.EpochResult:
    """One exact-sync epoch over ``mesh`` on the autograd route: the
    counterpart of the JAX package's ``core.run_epoch`` under GSPMD, for
    every configuration the fused route does not take. Per step
    :func:`filter_step_sharded`.

    ``ys``/``us`` are this rank's part (:func:`shard_data`: its trials, and
    its channels where ``tp`` cuts them); ``state`` the whole, replicated
    state (:func:`shard_state`), whose decoder rows the epoch cuts over
    ``tp`` and gathers again at its end, so the state returned is whole and
    the same on every rank. Every rank passes the same ``seed``: each takes
    its trials' rows of the whole batch's (T, 2, B, xdim) draw, so an epoch
    at any layout uses the one-card autograd epoch's noise.
    ``noise=(eps_s, eps_t)``, each this rank's (T, B_local, xdim), injects
    it instead. ``mask`` ((T,) or (T, B)) and ``channel_mask`` ((T, ydim)
    or (T, B, ydim)) are whole on every rank; each rank cuts its part, and
    the per-step valid counts come from the whole mask. Returns this rank's
    posteriors and the global metrics."""
    m = as_mesh(mesh)
    if ys.dtype != cfg.tdtype:
        ys = ys.to(cfg.tdtype)
    if us.dtype != cfg.tdtype:
        us = us.to(cfg.tdtype)
    t_len, b_local, _ = ys.shape
    n_batch = b_local * m.shape[0]
    rows = _trial_rows(n_batch, m)
    sh = _Shard(m, channel_rows(cfg.ydim, m), m.coords[1] == 0)
    dtype, dev = ys.dtype, ys.device
    n_valid, m_local, cm_local = [n_batch] * t_len, None, None
    if mask is not None:
        full = core._promote_mask(mask, t_len, n_batch, dtype, dev) > 0
        n_valid = full.sum(dim=1).to(dtype)
        m_local = full[:, rows].to(dtype)
    if channel_mask is not None:
        cm = core._promote_channel_mask(channel_mask, (t_len, n_batch, cfg.ydim), dtype, dev)
        cm_local = cm[:, rows] if sh.chans is None else cm[:, rows, sh.chans.lo:sh.chans.hi]
    if noise is None:
        gen = torch.Generator().manual_seed(core.epoch_seed(seed))
        eps = torch.randn((t_len, 2, n_batch, cfg.xdim), generator=gen, dtype=dtype)
        eps = eps[:, :, rows].to(dev)
        noise = (eps[:, 0], eps[:, 1])
    lr = F._lr_tensor(lr, dtype, dev)
    q = core.prior(state.params, b_local) if q0 is None else q0
    st = _decoder_rows(state, sh.chans)
    qs, steps = [], []
    for t in range(t_len):
        st, q, met = filter_step_sharded(
            cfg, flags, st, q, ys[t], us[t], noise[0][t], noise[1][t], lr, sh, n_valid[t],
            mask=None if m_local is None else m_local[t],
            channel_mask=None if cm_local is None else cm_local[t])
        qs.append(q)
        steps.append(met[:4])
    return core.EpochResult(_whole_decoder(st, sh.chans), torch.stack([q.mean for q in qs]),
                            torch.stack([q.logvar for q in qs]),
                            core.Metrics(*(torch.stack(f) for f in zip(*steps))))


def run_epochs_autograd_sharded(cfg: VJFConfig, flags: StepFlags, state: core.TrainState,
                                ys: torch.Tensor, us: torch.Tensor,
                                seeds: Sequence[Union[int, torch.Generator]], lrs, mesh,
                                mask=None, channel_mask=None) -> core.EpochsResult:
    """``len(seeds)`` consecutive :func:`run_epoch_autograd_sharded` epochs
    over the same part of the data (``models.vjf.chain_epochs``), each from
    the prior."""
    q0 = core.prior(state.params, ys.shape[1])

    def epoch(st, seed, lr):
        return run_epoch_autograd_sharded(cfg, flags, st, ys, us, seed, lr, mesh, q0=q0,
                                          mask=mask, channel_mask=channel_mask)

    return core.chain_epochs(cfg, epoch, state, ys.shape[0], seeds, lrs)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def fused_route(cfg: VJFConfig, state, n_batch: int, mesh, mask: bool = False,
                channel_mask: bool = False) -> bool:
    """Whether the exact-sync epoch over ``mesh`` takes the fused route, as
    the JAX package decides it: SGP's small-batch gate and ``fused_step``
    on the whole batch ``n_batch``, the card's shared memory on the trials
    one launch carries (the rank's)."""
    _, world = _rank_and_size(mesh)
    return F.fused_enabled(cfg, state, n_batch=n_batch, launch_batch=n_batch // world,
                           mask=mask, channel_mask=channel_mask)


def make_sharded_epoch(cfg: VJFConfig, flags: StepFlags, mesh):
    """``fn(state, ys, us, seed, lr, mask=None, channel_mask=None) ->
    EpochResult`` over ``mesh`` (a ``dp`` process group or a ``Mesh``), on
    the whole batch ``ys`` (T, B, ydim), as the JAX package's: the fused
    route (:func:`run_epoch_fused_sharded`, whole channels over ``dp``)
    where :func:`fused_route` says so, else the autograd route
    (:func:`run_epoch_autograd_sharded` on :func:`shard_data`'s part). The
    masks are whole; the posteriors returned are this rank's trials."""
    as_mesh(mesh)

    def call(state, ys, us, seed, lr, mask=None, channel_mask=None):
        if fused_route(cfg, state, ys.shape[1], mesh, mask is not None,
                       channel_mask is not None):
            y_l, u_l = shard_trials(ys, us, mesh)
            return run_epoch_fused_sharded(cfg, flags, state, y_l, u_l, seed, lr, mesh,
                                           mask=mask, channel_mask=channel_mask)
        y_l, u_l = shard_data(ys, us, mesh)
        return run_epoch_autograd_sharded(cfg, flags, state, y_l, u_l, seed, lr, mesh,
                                          mask=mask, channel_mask=channel_mask)

    return call


def make_sharded_epochs(cfg: VJFConfig, flags: StepFlags, mesh):
    """``fn(state, ys, us, seeds, lrs, mask=None, channel_mask=None) ->
    EpochsResult``: the multi-epoch counterpart of :func:`make_sharded_epoch`
    (:func:`run_epochs_fused_sharded` or :func:`run_epochs_autograd_sharded`)."""
    as_mesh(mesh)

    def call(state, ys, us, seeds, lrs, mask=None, channel_mask=None):
        if fused_route(cfg, state, ys.shape[1], mesh, mask is not None,
                       channel_mask is not None):
            y_l, u_l = shard_trials(ys, us, mesh)
            return run_epochs_fused_sharded(cfg, flags, state, y_l, u_l, seeds, lrs, mesh,
                                            mask=mask, channel_mask=channel_mask)
        y_l, u_l = shard_data(ys, us, mesh)
        return run_epochs_autograd_sharded(cfg, flags, state, y_l, u_l, seeds, lrs, mesh,
                                           mask=mask, channel_mask=channel_mask)

    return call


class FitGroup:
    """What ``models.vjf.fit`` and ``_fit_blocked`` do over a mesh
    (``mesh=``), beside their single-card ``models.vjf._Solo``: the
    replicated state broadcast from rank 0 to every rank after each
    host-side step, the whole batch's posteriors gathered over ``dp`` where
    a consumer reads every trial (the ``tp`` peers hold the same rows), the
    host's control values taken from rank 0 so that every rank decides
    alike, and snapshots written by rank 0 alone (then every rank waits)."""

    def __init__(self, mesh, device):
        self.mesh = as_mesh(mesh)
        self.rank, self.world = self.mesh.coords[0], self.mesh.shape[0]
        self.device = device
        self._whole = (None, None)

    def state(self, cfg: VJFConfig, state: core.TrainState) -> core.TrainState:
        return shard_state(cfg, state, self.mesh)

    def whole(self, res):
        """``res`` (an ``EpochResult`` or ``EpochsResult`` of this rank's
        trials) with the whole batch's posteriors, gathered once a result."""
        if self._whole[0] is not res:
            self._whole = (res, res._replace(q_means=gather_rows(res.q_means, self.mesh, 1),
                                             q_logvars=gather_rows(res.q_logvars, self.mesh, 1)))
        return self._whole[1]

    def agree(self, vals) -> list:
        t = torch.tensor(list(vals), dtype=torch.float64, device=self.device)
        everyone = self.mesh.everyone
        dist.broadcast(t, dist.get_global_rank(everyone, 0), group=everyone)
        return t.tolist()

    def save(self, save_fn, path: str, snapshot) -> None:
        save_on_rank0(save_fn, path, snapshot, self.mesh)


def save_on_rank0(save_fn, path: str, snapshot, mesh) -> None:
    """``save_fn(path, snapshot)`` on the mesh's rank 0 alone (one file,
    written atomically), then every rank waits for it: a rank that resumes
    reads what rank 0 wrote."""
    everyone = as_mesh(mesh).everyone
    if dist.get_rank(everyone) == 0:
        save_fn(path, snapshot)
    dist.barrier(group=everyone)
