"""Ensemble ``fit``: N independent models trained in one launch stream
(counterpart of ``vjf_tpu/parallel/ensemble.py``).

Each member runs the whole ``fit`` state machine of ``models.vjf.fit``:
its own warm-up plateau, decoder freeze, dynamics bootstrap, convergence
patience and learning-rate schedule, so member k of an ensemble equals a
solo ``fit`` of member k from the same seed chain, phase transitions
included (``tests/test_torch_ensemble.py``).

- **Phase-uniform epochs** (all members warm, or none) run every member
  together: on the card through the member-axis kernels, one N-member
  launch per prefix step and one N-member mega launch
  (``ops.fused_step.run_epoch_fused`` on the list of states), where the JAX package
  ``vmap``s its Pallas kernels.
- **Phase-mixed epochs** run each member's autograd epoch with its
  ``warm_gate`` (``models.vjf.filter_step``), as the JAX package runs its
  gated XLA epoch.
- **Hot-tau safety per member**: on the mega layout a member whose epoch
  skipped more than ``cfg.demote_hot_frac`` of its updates re-runs that
  epoch (or block) on the autograd route from its repaired pre-epoch
  state, and the healthy members keep their kernel results bit for bit.
  The next epoch's kernel launch computes every member again, so it is the
  re-probe. Only when every member is hot does the whole ensemble demote,
  with the solo fit's re-probe machinery.
- **Prefix-free continuation**: once every member's watched epoch has
  contracted, the exact-inverse prefix is dropped.

The members are a list of ``TrainState``s; ``y`` may be (T, B, ydim), one
data set for every member (a seed ensemble), or (N, T, B, ydim), one per
member. Where the JAX package splits PRNG keys, each member here has a CPU
``torch.Generator``: one int seed is drawn from it per epoch, one more at
its bootstrap, as the solo ``fit`` draws from its own.

Over several cards (``mesh``, a ``dp`` process group or a mesh, whose
``tp`` peers run the same members, as the JAX package replicates the
member axis over ``tp``), ``dp`` rank r of n runs
members ``[r N/n, (r + 1) N/n)`` (``replicated.shard_ensemble``) in one
member-axis launch, each from its own seed chain, and every rank replays
the host state machine for all N members: the per-member scalars an epoch
(block) reads (losses, tau statistics, selection metrics) are gathered with
one small all-reduce (:class:`_Members`), so that the decisions that read
every member (all done, the uniform phase, prefix-free, the all-hot
demotion) come out alike on every rank and member k's bits do not depend on
the ranks. The result and the snapshots hold all N members, each broadcast
from the rank that ran it.
"""
from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..config import StepFlags, VJFConfig
from ..models import vjf as core
from ..ops import fused_step as _fused
from .replicated import member_data, member_range, member_seeds, run_epoch_ensemble

logger = logging.getLogger(__name__)

# a module attribute, so that tests can force the decision
_prefix_free_next = _fused.prefix_free_next


class EnsembleFitResult(NamedTuple):
    """Per-member ``FitResult`` fields, each member frozen at its own
    stopping epoch (a member that converges early stops while the rest
    train on)."""

    mu: torch.Tensor         # (N, T, B, xdim) posterior means, each member's final epoch
    logvar: torch.Tensor     # (N, T, B, xdim)
    loss: np.ndarray         # (N,) final epoch mean loss per member
    states: list             # N TrainStates
    warm_up: np.ndarray      # (N,) bool: the member never left warm-up
    lr: np.ndarray           # (N,) schedule position after the run
    epochs_run: np.ndarray   # (N,) epochs each member ran
    # select='forecast' only: the epoch whose snapshot each member returned
    # (-1: none) and its rollout RMSE (nan likewise)
    selected_epoch: Optional[np.ndarray] = None
    selected_metric: Optional[np.ndarray] = None


class _Members:
    """The members this process runs, a slice ``sl`` of the N, and the
    collectives that make the host's per-member values whole: on one card
    (``group`` None) every member and no collective; over a ``dp`` group
    :func:`replicated.member_range`'s slice, per-member vectors gathered
    with one all-reduce (``parallel.sharded.gather_rows``), states and
    posteriors assembled from their owners, snapshots written by rank 0."""

    def __init__(self, n_models: int, group=None, device=None):
        r = member_range(n_models, group)
        self.n, self.group, self.device = n_models, group, device
        self.sl = slice(r.start, r.stop)
        self.lo, self.per = r.start, len(r)

    def gather(self, local) -> np.ndarray:
        """(n_local, ...) host values of this rank's members -> (N, ...)."""
        local = np.asarray(local, dtype=float)
        if self.group is None:
            return local
        from .sharded import gather_rows

        t = torch.as_tensor(local, dtype=torch.float64, device=self.device)
        return gather_rows(t, self.group, 0).cpu().numpy()

    def rows(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A tensor led by this rank's members -> led by all N."""
        if self.group is None or t is None:
            return t
        from .sharded import gather_rows

        return gather_rows(t, self.group, 0)

    def states(self, local: list) -> list:
        """This rank's member states -> all N, each from its owner."""
        if self.group is None:
            return list(local)
        from .sharded import _rank_and_size, broadcast_tree

        rank, _ = _rank_and_size(self.group)
        out = []
        for m in range(self.n):
            owner = m // self.per
            out.append(broadcast_tree(local[m - self.lo] if owner == rank else local[0],
                                      owner, self.group))
        return out

    def save(self, save_fn, path: str, snapshot) -> None:
        if self.group is None:
            save_fn(path, snapshot)
            return
        from .sharded import save_on_rank0

        save_on_rank0(save_fn, path, snapshot, self.group)


def _member_select(take, new, old):
    """Per member: ``new[i]`` where ``take[i]``, else ``old[i]``; for a list
    of states or a tensor with a leading member axis."""
    if isinstance(new, list):
        return [n if t else o for t, n, o in zip(take, new, old)]
    t = torch.as_tensor(np.asarray(take), device=new.device)
    return torch.where(t.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _ensemble_epoch(cfg, flags, states, y, us, seeds, lr, warms=None, mask=None,
                    channel_mask=None) -> core.EpochResult:
    """One epoch of every member (``replicated.run_epoch_ensemble``)."""
    return run_epoch_ensemble(cfg, flags, states, y, us, seeds, lr, warm_gate=warms,
                              mask=mask, channel_mask=channel_mask)


def _row_means(x: torch.Tensor) -> torch.Tensor:
    """Each member's mean of ``x`` (N, T), each row reduced alone as the
    solo fit reduces its epoch's (T,), so that the plateau decisions see
    the solo fit's bits."""
    return torch.stack([torch.mean(r) for r in x])


def _member_tau_stats(cfg, tau: Optional[torch.Tensor], t_len: int, n: int, dtype, device):
    """(max finite tau, hot fraction) of each member over the post-prefix
    segment of ``tau`` (N, T): ``models.vjf.epoch_tau_stats`` per member,
    zeros without a tau stream or evidence."""
    if tau is None or t_len <= cfg.ns_prefix:
        z = torch.zeros(n, dtype=dtype, device=device)
        return z, z
    seg = tau[:, cfg.ns_prefix:]
    finite = torch.isfinite(seg)
    max_tau = torch.max(torch.where(finite, seg, torch.zeros_like(seg)), dim=1).values
    hot = torch.mean(((seg >= _fused.NS_TAU_MAX) | ~finite).to(dtype), dim=1)
    return max_tau.to(dtype), hot


def _ensemble_epochs(cfg, flags, states, y, us, seeds, lrs, warms=None, mask=None,
                     channel_mask=None) -> core.EpochsResult:
    """K epochs of every member (the blocked mode), ``seeds[m][j]`` member
    m's key of epoch j, ``lrs`` (K,) one rate per epoch for all, ``warms``
    held across the block. ``state`` is the list of states; ``q_means`` the
    last epoch's (N, T, B, xd); the per-epoch statistics are (N, K)."""
    t_len, n = y.shape[-3], len(states)
    dev = y.device
    means, max_taus, hots = [], [], []
    res = None
    for j in range(len(lrs)):
        res = _ensemble_epoch(cfg, flags, states, y, us, [s[j] for s in seeds], lrs[j],
                              warms, mask, channel_mask)
        states = res.state
        means.append(core.Metrics(*(None if m is None else _row_means(m)
                                    for m in res.metrics)))
        mt, hot = _member_tau_stats(cfg, res.metrics.tau, t_len, n, cfg.tdtype, dev)
        max_taus.append(mt)
        hots.append(hot)
    mean_metrics = core.Metrics(*(None if f[0] is None else torch.stack(f, dim=1)
                                  for f in zip(*means)))
    return core.EpochsResult(state=states, q_means=res.q_means, q_logvars=res.q_logvars,
                             epoch_loss=mean_metrics.loss, epoch_metrics=mean_metrics,
                             max_tau=torch.stack(max_taus, dim=1),
                             hot_frac=torch.stack(hots, dim=1))


def _ensemble_boot(cfg, states, q_means, us, gens, trans, pair_w, lo: int = 0):
    """The end of warm-up for the members in ``trans`` (all N): each draws
    its bootstrap generator from its own chain (the solo fit's draw), on
    every rank, so that every chain stays alike; the members run here are
    ``states``, from member ``lo`` on."""
    draws = {i: core._draw_generator(gens[i]) for i in np.flatnonzero(trans)}
    return [core._bootstrap_dynamics(cfg, st, q_means[j], member_data(us, j), draws[lo + j],
                                     pair_w) if lo + j in draws else st
            for j, st in enumerate(states)]


def _ensemble_adapt(cfg, states, q_means, us, take, pair_w):
    """The SGP hyperparameter step of the members in ``take``."""
    return [core._sgp_adapt_step(cfg, st, q_means[i], member_data(us, i), pair_w)
            if take[i] else st for i, st in enumerate(states)]


def _ensemble_msrefine(cfg, states, q_means, take):
    """``models.vjf.multistep_refine`` of the members in ``take``."""
    return [core.multistep_refine(cfg, st, q_means[i]) if take[i] else st
            for i, st in enumerate(states)]


def _ensemble_repair(cfg, flags, n_batch: int, states):
    return [_fused.maybe_epoch_repair(cfg, flags, st, n_batch) for st in states]


def _hot_indices(hot: np.ndarray) -> np.ndarray:
    """The hot members to re-run. The JAX package pads this index vector to
    a power of two (repeating the first) to bound its recompiles; nothing
    here compiles per shape, so the port gathers exactly the hot members
    (the duplicates wrote the same values: no result changes)."""
    return np.flatnonzero(hot)


def _set_rows(t: Optional[torch.Tensor], idx: torch.Tensor, rows) -> Optional[torch.Tensor]:
    if t is None:
        return None
    out = t.clone()
    out[idx] = rows.to(out.dtype) if isinstance(rows, torch.Tensor) else rows
    return out


def _rerun_hot_members(cfg, flags, n_batch, backup, y, us, seeds, lr, mask, channel_mask,
                       hot, result, losses, epochs_mode=False, lrs=None):
    """Per-member hot-tau demotion: re-run only the hot members' epoch (or
    block, ``epochs_mode``) on the autograd route from their repaired
    pre-epoch states, and put their results in place; the healthy members'
    results stay those of the kernel launch, bit for bit. The autograd route
    reports no tau, so the kernel's tau stream (already read) is kept, and
    the hot members' block statistics read 0."""
    idx = _hot_indices(hot)
    if not len(idx):
        return result, losses
    it = torch.as_tensor(idx, device=result.q_means.device)
    sub_states = _ensemble_repair(cfg, flags, n_batch, [backup[i] for i in idx])
    sub_y = y[it] if y.dim() == 4 else y
    sub_us = us[it] if us.dim() == 4 else us
    sub_seeds = [seeds[i] for i in idx]
    cfg_off = cfg.replace(fused_step="off")
    state = list(result.state)
    if epochs_mode:
        sub = _ensemble_epochs(cfg_off, flags, sub_states, sub_y, sub_us, sub_seeds, lrs,
                               None, mask, channel_mask)
        sub_losses = sub.epoch_loss.tolist()
        for j, i in enumerate(idx):
            state[i] = sub.state[j]
        m = result.epoch_metrics
        merged = result._replace(
            state=state,
            q_means=_set_rows(result.q_means, it, sub.q_means),
            q_logvars=_set_rows(result.q_logvars, it, sub.q_logvars),
            epoch_loss=_set_rows(result.epoch_loss, it, sub.epoch_loss),
            epoch_metrics=m._replace(**{f: _set_rows(getattr(m, f), it, getattr(
                sub.epoch_metrics, f)) for f in m._fields[:4]}),
            max_tau=_set_rows(result.max_tau, it, 0.0),
            hot_frac=_set_rows(result.hot_frac, it, 0.0))
    else:
        sub = _ensemble_epoch(cfg_off, flags, sub_states, sub_y, sub_us, sub_seeds, lr, None,
                              mask, channel_mask)
        sub_losses = _row_means(sub.metrics.loss).tolist()
        for j, i in enumerate(idx):
            state[i] = sub.state[j]
        m = result.metrics
        merged = result._replace(
            state=state,
            q_means=_set_rows(result.q_means, it, sub.q_means),
            q_logvars=_set_rows(result.q_logvars, it, sub.q_logvars),
            metrics=m._replace(**{f: _set_rows(getattr(m, f), it, getattr(sub.metrics, f))
                                  for f in m._fields[:4]}))
    losses = np.array(losses, dtype=float)
    losses[idx] = sub_losses
    return merged, losses


def _ensemble_select_metric(cfg, states, q_means, y, us, bases, epoch, eligible) -> np.ndarray:
    """Each eligible member's forecast-selection metric
    (``models.vjf.rollout_rmse``) from its own selection stream; inf for
    the others."""
    return np.array([
        float(core.rollout_rmse(cfg, st, q_means[i], member_data(y, i), member_data(us, i),
                                core._select_generator(bases[i], epoch)))
        if eligible[i] else np.inf for i, st in enumerate(states)])


class _SelectTracker:
    """Each member's best-forecast snapshot (``select='forecast'`` of the
    solo fit, per member), shared by both ensemble fit loops."""

    def __init__(self, n_models: int, sel_base: Sequence[int], members: _Members):
        # the N-member arrays are whole on every rank; the states and
        # posteriors kept are this rank's members' (``members.sl``)
        self.members = members
        self.sel_base = [int(b) for b in sel_base]
        self.best_sel = np.full(n_models, np.inf)
        self.best_loss = np.full(n_models, np.nan)
        self.sel_epoch = np.full(n_models, -1, dtype=np.int64)
        self.have = np.zeros(n_models, dtype=bool)
        self.states = None
        self.mu = None
        self.lv = None

    def observe(self, cfg, states, result_mu, result_lv, y, us, epoch: int,
                eligible: np.ndarray, losses: np.ndarray) -> None:
        if not eligible.any():
            return
        sl = self.members.sl
        sel = self.members.gather(_ensemble_select_metric(
            cfg, states, result_mu, y, us, self.sel_base[sl], epoch, eligible[sl]))
        sel = np.where(np.isfinite(sel), sel, np.inf)   # a NaN never selects
        take = eligible & (sel < self.best_sel)
        if not take.any():
            return
        if self.states is None:
            self.states, self.mu, self.lv = list(states), result_mu, result_lv
        self.states = _member_select(take[sl], states, self.states)
        self.mu = _member_select(take[sl], result_mu, self.mu)
        self.lv = _member_select(take[sl], result_lv, self.lv)
        self.best_sel = np.where(take, sel, self.best_sel)
        self.best_loss = np.where(take, losses, self.best_loss)
        self.sel_epoch = np.where(take, epoch, self.sel_epoch)
        self.have |= take

    def snapshot(self) -> tuple:
        """The tracker in plain containers with all N members' states and
        posteriors, for :class:`EnsembleSnapshot`."""
        m = self.members
        states = None if self.states is None else m.states(self.states)
        return (list(self.sel_base), self.best_sel.tolist(), self.best_loss.tolist(),
                self.sel_epoch.tolist(), self.have.tolist(), states, m.rows(self.mu),
                m.rows(self.lv))

    @classmethod
    def restore(cls, n_models: int, snap, members: _Members) -> "_SelectTracker":
        t = cls(n_models, snap[0], members)
        sl = t.members.sl
        t.best_sel = np.asarray(snap[1], dtype=float)
        t.best_loss = np.asarray(snap[2], dtype=float)
        t.sel_epoch = np.asarray(snap[3], dtype=np.int64)
        t.have = np.asarray(snap[4], dtype=bool)
        if snap[5] is not None:
            t.states, t.mu, t.lv = list(snap[5][sl]), snap[6][sl], snap[7][sl]
        return t

    def finalize(self, states, mu_store, lv_store, losses_final):
        """``(states, mu, logvar, loss, selected_epoch, selected_metric)``
        with each selected member's best snapshot in place."""
        metric = np.where(self.have, self.best_sel, np.nan)
        if not self.have.any():
            return states, mu_store, lv_store, losses_final, self.sel_epoch, metric
        have = self.have[self.members.sl]
        return (_member_select(have, self.states, states),
                _member_select(have, self.mu, mu_store),
                _member_select(have, self.lv, lv_store),
                np.where(self.have, self.best_loss, losses_final), self.sel_epoch, metric)


@_fused.full_f32_matmul()
def forecast_ensemble(cfg: VJFConfig, states, x0: torch.Tensor,
                      seed: Union[int, torch.Generator, None], n_step: int, u=None,
                      noise: bool = False, draws=None):
    """``models.vjf.forecast`` of every member: ``x0`` (N, B, xdim) or (N,
    xdim) per-member starts, ``u`` optional (n_step, ...) controls shared by
    every member. Returns ``(xs, ys)`` with a leading member axis. Each
    member samples its weights from its own seed, drawn from ``seed``
    (:func:`replicated.member_seeds`), unless ``draws`` (N per-member
    ``(eps_w, eps_n)``) injects them."""
    n = len(states)
    seeds = member_seeds(seed, n) if draws is None else [None] * n
    outs = [core.forecast(cfg, st, x0[i], seeds[i], n_step, u=u, noise=noise,
                          draws=None if draws is None else draws[i])
            for i, st in enumerate(states)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _draw_members(gens) -> List[int]:
    """One int seed from each member's chain (the JAX package's split of
    every member key)."""
    return [core.epoch_seed(g) for g in gens]


class EnsembleSnapshot(NamedTuple):
    """The whole per-member fit state machine at an epoch (or block)
    boundary, so that an interrupted ensemble fit resumes bit-identically
    (saved with ``utils.checkpoint.save_ensemble_checkpoint``). Host state
    is kept as lists (Python floats are float64, as the loop's numpy
    arrays)."""

    epoch: int               # completed epochs
    warm: list               # (N,) bool
    done: list
    running: list            # running EMA loss
    losses_final: list
    plateau_hits: list
    lr: list                 # schedule positions
    epochs_run: list
    generators: list         # the member chains (the JAX package's keys)
    states: list
    mu_store: Optional[torch.Tensor]   # (N, T, B, xdim); None before an epoch ran
    lv_store: Optional[torch.Tensor]
    demoted: bool            # whole-ensemble hot-tau demotion active
    demote_epoch: int        # -1 encodes None
    repromotes_left: int
    tracker: Optional[tuple]
    # what a resume is checked against: another member count, blocking or
    # config would not resume bit for bit
    n_models: Optional[int] = None
    k_block: Optional[int] = None
    cfg_digest: Optional[str] = None
    prefix_free: Optional[bool] = None


def _cfg_digest(cfg: VJFConfig) -> str:
    from ..utils.checkpoint import config_digest

    return config_digest(cfg)


def _restore_host_state(snap: EnsembleSnapshot):
    """An :class:`EnsembleSnapshot`'s loop variables, for both fit loops."""
    de = int(snap.demote_epoch)
    return (
        int(snap.epoch),
        np.asarray(snap.warm, dtype=bool),
        np.asarray(snap.done, dtype=bool),
        np.asarray(snap.running, dtype=float),
        np.asarray(snap.losses_final, dtype=float),
        np.asarray(snap.plateau_hits, dtype=np.int64),
        np.asarray(snap.lr, dtype=float),
        np.asarray(snap.epochs_run, dtype=np.int64),
        snap.mu_store,
        snap.lv_store,
        bool(snap.demoted),
        None if de < 0 else de,
        int(snap.repromotes_left),
        bool(snap.prefix_free),
    )


def _copy_generators(gens) -> list:
    out = []
    for g in gens:
        c = torch.Generator()
        c.set_state(g.get_state())
        out.append(c)
    return out


def _make_snapshot(epoch, warm, done, running, losses_final, plateau_hits, lr, epochs_run,
                   gens, states, mu_store, lv_store, demoted, demote_epoch, repromotes_left,
                   tracker, n_models, k_block, cfg, members: _Members,
                   prefix_free=False) -> EnsembleSnapshot:
    """The snapshot of all N members; ``states`` and the posteriors are
    this rank's members', assembled through ``members``."""
    return EnsembleSnapshot(
        epoch=int(epoch), warm=warm.tolist(), done=done.tolist(), running=running.tolist(),
        losses_final=losses_final.tolist(), plateau_hits=plateau_hits.tolist(),
        lr=lr.tolist(), epochs_run=epochs_run.tolist(), generators=_copy_generators(gens),
        states=members.states(states), mu_store=members.rows(mu_store),
        lv_store=members.rows(lv_store), demoted=bool(demoted),
        demote_epoch=-1 if demote_epoch is None else int(demote_epoch),
        repromotes_left=int(repromotes_left),
        tracker=None if tracker is None else tracker.snapshot(), n_models=int(n_models),
        k_block=int(k_block), cfg_digest=_cfg_digest(cfg), prefix_free=bool(prefix_free))


def _load_snapshot(cfg, resume_from: str, n_models: int, k_block: int, device):
    from ..utils.checkpoint import load_ensemble_checkpoint

    snap = load_ensemble_checkpoint(resume_from, device)
    if not isinstance(snap, EnsembleSnapshot):
        raise ValueError(f"resume_from {resume_from!r} is not a fit_ensemble snapshot (got "
                         f"{type(snap).__name__}); solo-fit snapshots resume through fit()")
    # a snapshot missing its fields is refused, never trusted
    if snap.n_models is None or snap.k_block is None or snap.cfg_digest is None:
        raise ValueError("resume_from snapshot is missing validation fields "
                         "(n_models/k_block/cfg_digest); refusing to resume an "
                         "unvalidatable snapshot")
    if snap.n_models != n_models:
        raise ValueError(f"resume_from snapshot has {snap.n_models} members; this call "
                         f"passes states for {n_models}")
    if snap.k_block != k_block:
        raise ValueError(f"resume_from snapshot was saved with epochs_per_dispatch="
                         f"{snap.k_block}; resuming with {k_block} would change the member "
                         "seed draws and the plateau cadence (not bit-exact)")
    if snap.cfg_digest != _cfg_digest(cfg):
        raise ValueError("resume_from snapshot was saved under a different config; resume "
                         "with the same cfg")
    return snap


def _reprobe(epoch: int, left: int) -> None:
    logger.info("ensemble: re-probing the mega layout at epoch %d (%d probes left).",
                epoch, left)


@_fused.full_f32_matmul()
def fit_ensemble(
    cfg: VJFConfig,
    states,
    y,
    u=None,
    *,
    seed: Union[int, torch.Generator, None] = None,
    seeds: Optional[Sequence[Union[int, torch.Generator]]] = None,
    max_iter: int = 200,
    beta: Optional[float] = None,
    rtol: Optional[float] = None,
    callback=None,
    mask=None,
    channel_mask=None,
    lr0: Optional[float] = None,
    mesh=None,
    epochs_per_dispatch: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
) -> EnsembleFitResult:
    """Train every member of an ensemble with the whole per-member ``fit``
    state machine in one launch stream (module docstring).

    :param states: N ``TrainState``s (:func:`replicated.init_ensemble`), on
        the device the fit runs on
    :param y: (T, B, ydim) shared data or (N, T, B, ydim) per member;
        (T, ydim) becomes (T, 1, ydim)
    :param u: controls, the same conventions (None: autonomous)
    :param seed: one int or CPU generator, from which N member seeds are
        drawn; or ``seeds``: N ints or generators, to match N solo fits seed
        for seed (member k's chain is then that of ``fit(seed=seeds[k])``)
    :param mask: (T,)/(T, B) trial mask and ``channel_mask`` (T[, B],
        ydim), shared by every member
    :param mesh: a ``dp`` process group (``parallel.make_dp_group``) or a
        mesh (``parallel.make_mesh``, its ``dp`` axis): every
        rank calls with all N ``states`` and the same seeds and data, runs
        its slice of the members (N must divide over the ranks) and returns
        all N (module docstring); ``callback`` gets this rank's members'
        results beside all N losses
    :param epochs_per_dispatch: K > 1 runs K epochs a dispatch per member
        with the plateau machine replayed on the host at block boundaries
        (member k equals ``fit(epochs_per_dispatch=K)`` of member k)
    :param checkpoint_path: with ``checkpoint_every`` K > 0, save the whole
        state machine every K epochs (at block boundaries in blocked mode),
        atomically, to that one file; ``resume_from`` resumes such a
        snapshot bit-identically (same cfg, data and ``epochs_per_dispatch``;
        the snapshot supersedes ``states`` and the seeds)
    """
    beta = cfg.beta if beta is None else beta
    rtol = cfg.rtol if rtol is None else rtol
    states = list(states)
    n_models = len(states)
    if seeds is None:
        if seed is None:
            raise ValueError("pass seed= (drawn per member) or seeds= (N,)")
        seeds = member_seeds(seed, n_models)
    elif len(seeds) != n_models:
        raise ValueError(f"seeds has {len(seeds)} entries, n_models is {n_models}")
    gens = [s if isinstance(s, torch.Generator) else core._generator(s) for s in seeds]
    dev = states[0].dynamics.blr.w_mean.device
    members = _Members(n_models, mesh, dev)

    y = core.wire_ingest(y, cfg.tdtype, dev)
    if y.dim() == 2:
        y = y[:, None, :]
    per_member = y.dim() == 4
    if per_member and y.shape[0] != n_models:
        raise ValueError(f"per-member y leading axis {y.shape[0]} != n_models {n_models}")
    t_len, n_batch = y.shape[-3], y.shape[-2]
    if u is None:
        us = torch.zeros(((n_models,) if per_member else ()) + (t_len, n_batch, 0),
                         dtype=cfg.tdtype, device=dev)
    else:
        us = torch.as_tensor(u).to(device=dev, dtype=cfg.tdtype)
        if us.dim() != 4:
            us = core._promote_u(us, t_len, n_batch, cfg.tdtype, dev)
    mask = core._promote_mask(mask, t_len, n_batch, cfg.tdtype, dev)
    channel_mask = core._promote_channel_mask(channel_mask, (t_len, n_batch, cfg.ydim),
                                              cfg.tdtype, dev)
    pair_w = core._pair_weights(mask)
    cfg = core._demote_masked_small_sgp(cfg, mask)
    select_on = core._validate_select(cfg, mask, channel_mask, t_len=t_len)
    core._validate_multistep(cfg, mask)

    k_block = int(epochs_per_dispatch)
    snap = None
    if resume_from is not None:
        snap = _load_snapshot(cfg, resume_from, n_models, k_block, dev)
        states, gens = list(snap.states), list(snap.generators)

    tracker = None
    if select_on:
        if snap is not None and snap.tracker is not None:
            tracker = _SelectTracker.restore(n_models, snap.tracker, members)
        else:
            # each member's selection stream from its chain at the start,
            # without drawing from it (the solo fit's)
            tracker = _SelectTracker(n_models, [core._select_base(g) for g in gens], members)

    # this rank's members and their data
    states = states[members.sl]
    if per_member:
        y = y[members.sl]
    if us.dim() == 4:
        us = us[members.sl]
    run = _fit_ensemble_blocked if k_block > 1 else _fit_ensemble_epochs
    return run(cfg, states, y, us, gens, mask, channel_mask, pair_w, n_batch,
               k_block=k_block, max_iter=max_iter, beta=beta, rtol=rtol, callback=callback,
               lr0=lr0, tracker=tracker, checkpoint_path=checkpoint_path,
               checkpoint_every=checkpoint_every, snap=snap, members=members)


def _start(cfg, states, n_batch, mask, channel_mask, lr0, snap, members):
    """The loop variables both fit loops start from, fresh or from ``snap``:
    host arrays over all N members, the posteriors of this rank's."""
    n = members.n
    mega_possible = (cfg.fused_epoch == "mega"
                     and _fused.fused_enabled(cfg, states[0], n_batch=n_batch,
                                              mask=mask is not None,
                                              channel_mask=channel_mask is not None))
    v = dict(
        epoch=0, warm=np.ones(n, dtype=bool), done=np.zeros(n, dtype=bool),
        running=np.full(n, np.nan), losses_final=np.full(n, np.nan),
        plateau_hits=np.zeros(n, dtype=np.int64),
        lr=np.full(n, cfg.lr if lr0 is None else float(lr0)),
        epochs_run=np.zeros(n, dtype=np.int64), mu_store=None, lv_store=None,
        cfg_run=cfg, mega_guard=mega_possible, demote_epoch=None,
        repromotes_left=cfg.repromote_max if cfg.repromote_after > 0 else 0,
        prefix_free=False)
    if snap is not None:
        (v["epoch"], v["warm"], v["done"], v["running"], v["losses_final"],
         v["plateau_hits"], v["lr"], v["epochs_run"], v["mu_store"], v["lv_store"], demoted,
         v["demote_epoch"], v["repromotes_left"], v["prefix_free"]) = _restore_host_state(snap)
        if v["mu_store"] is not None:
            v["mu_store"], v["lv_store"] = (v["mu_store"][members.sl],
                                            v["lv_store"][members.sl])
        if demoted:
            v["cfg_run"] = cfg.replace(fused_step="off")
            v["mega_guard"] = False
    return v


def _store(mu_store, lv_store, active, res):
    """The posteriors kept per member: the newest of each active member."""
    if mu_store is None:
        return res.q_means, res.q_logvars
    return (_member_select(active, res.q_means, mu_store),
            _member_select(active, res.q_logvars, lv_store))


def _fit_ensemble_epochs(cfg, states, y, us, gens, mask, channel_mask, pair_w, n_batch, *,
                         k_block, max_iter, beta, rtol, callback, lr0, tracker,
                         checkpoint_path, checkpoint_every, snap, members) -> EnsembleFitResult:
    """The per-epoch fit loop: one dispatch of this rank's members per epoch,
    the plateau machine per member on the host (solo ``fit`` semantics) over
    all N, from the gathered losses. ``states``, ``y`` and ``us`` are this
    rank's members' (``members.sl``); ``gens`` every member's chain."""
    n_models, sl = members.n, members.sl
    use_adapt = cfg.dynamics == "sgp" and cfg.sgp_adapt_lr > 0
    masks = dict(mask=mask, channel_mask=channel_mask)
    v = _start(cfg, states, n_batch, mask, channel_mask, lr0, snap, members)
    warm, done, running = v["warm"], v["done"], v["running"]
    losses_final, plateau_hits, lr = v["losses_final"], v["plateau_hits"], v["lr"]
    epochs_run, mu_store, lv_store = v["epochs_run"], v["mu_store"], v["lv_store"]
    cfg_run, mega_guard, demote_epoch = v["cfg_run"], v["mega_guard"], v["demote_epoch"]
    repromotes_left, prefix_free = v["repromotes_left"], v["prefix_free"]
    member_demoted = np.zeros(n_models, dtype=bool)   # transitions, for the log
    pf_logged = False

    for epoch in range(v["epoch"], max_iter):
        if done.all():
            break
        if (demote_epoch is not None and repromotes_left > 0 and not warm.any()
                and epoch - demote_epoch >= cfg.repromote_after):
            repromotes_left -= 1
            demote_epoch = None
            cfg_run = cfg
            mega_guard = True
            _reprobe(epoch, repromotes_left)
        seeds_e = _draw_members(gens)[sl]
        uniform = warm.all() or not warm.any()
        all_warm = bool(warm.all())
        backup = states if (mega_guard and not all_warm) else None
        # one schedule position for every active member
        lr_shared = float(lr[~done][0])
        engage_pf = (prefix_free and mega_guard and uniform and not all_warm
                     and cfg.ns_prefix_free != "off" and cfg_run.ns_prefix > 0)
        cfg_disp = cfg_run.replace(ns_prefix=0) if engage_pf else cfg_run
        if engage_pf and not pf_logged:
            pf_logged = True
            logger.info("ensemble: every member contracted (max tau < %.2f); continuing "
                        "prefix-free from epoch %d.", _fused.NS_TAU_ESCALATE, epoch)
        if uniform:
            flags = StepFlags(sgd=True, update=True, warm_up=all_warm, train_decoder=all_warm)
            result = _ensemble_epoch(cfg_disp, flags, states, y, us, seeds_e, lr_shared,
                                     **masks)
        else:
            flags = StepFlags(sgd=True, update=True, warm_up=False, train_decoder=False)
            result = _ensemble_epoch(cfg_run, flags, states, y, us, seeds_e, lr_shared,
                                     warms=warm[sl].astype(float).tolist(), **masks)
        tau = result.metrics.tau
        watch_hot = (mega_guard and uniform and not all_warm and tau is not None
                     and tau.shape[1] > cfg_disp.ns_prefix)
        if watch_hot:
            max_t, hot_d = _member_tau_stats(cfg_disp, tau, tau.shape[1], len(states),
                                             cfg.tdtype, tau.device)
            # one host read (and one gather) for the losses and the tau statistics
            stats = members.gather(np.asarray(torch.stack([
                _row_means(result.metrics.loss), hot_d, max_t]).tolist()).T).T
            losses, hot_frac, max_taus = stats[0], stats[1], stats[2]
            prefix_free = _prefix_free_next(prefix_free, float(hot_frac.max()),
                                            float(max_taus.max()))
        else:
            losses = members.gather(_row_means(result.metrics.loss).tolist())
            if (mega_guard and uniform and not all_warm and tau is not None
                    and tau.shape[1] <= cfg_disp.ns_prefix):
                # the whole epoch ran inside the protected prefix: engage
                # structurally; the engaged epoch's own statistics then govern
                prefix_free = True
        hot = np.zeros(n_models, dtype=bool)
        if watch_hot and hot_frac.max() > cfg.demote_hot_frac:
            hot = hot_frac > cfg.demote_hot_frac
            if hot.all():
                logger.warning(
                    "ensemble: all %d members skipped >%.1f%% of RLS updates on the mega "
                    "layout (epoch %d); demoting the ensemble to the autograd epoch and "
                    "re-running from backup.", n_models, 100 * cfg.demote_hot_frac, epoch)
                cfg_run = cfg.replace(fused_step="off")
                mega_guard = False
                demote_epoch = epoch
                backup = _ensemble_repair(cfg, flags, n_batch, backup)
                result = _ensemble_epoch(cfg_run, flags, backup, y, us, seeds_e, lr_shared,
                                         **masks)
                losses = members.gather(_row_means(result.metrics.loss).tolist())
            else:
                newly = hot & ~member_demoted
                if newly.any():
                    logger.warning(
                        "ensemble: members %s skipped up to %.1f%% of RLS updates on the "
                        "mega layout (epoch %d); re-running only those members on the "
                        "autograd route from their repaired pre-epoch states (per epoch, "
                        "until their kernel epoch runs clean).",
                        np.flatnonzero(newly).tolist(), 100 * hot_frac.max(), epoch)
                result, local = _rerun_hot_members(
                    cfg, flags, n_batch, backup, y, us, seeds_e, lr_shared, mask,
                    channel_mask, hot[sl], result, losses[sl])
                losses = members.gather(local)
        if watch_hot:
            recovered = member_demoted & ~hot
            if recovered.any():
                logger.info("ensemble: members %s ran clean on the mega layout at epoch %d; "
                            "keeping their kernel results.", np.flatnonzero(recovered).tolist(),
                            epoch)
            member_demoted = hot.copy()

        active = ~done
        states = _member_select(active[sl], result.state, states)
        mu_store, lv_store = _store(mu_store, lv_store, active[sl], result)
        losses_final = np.where(active, losses, losses_final)
        epochs_run = np.where(active, epoch + 1, epochs_run)
        if callback is not None:
            callback(epoch, losses, result)

        # the phase transitions, per member (solo fit semantics)
        trans = np.zeros(n_models, dtype=bool)
        newly_done = np.zeros(n_models, dtype=bool)
        for i in np.flatnonzero(active):
            if warm[i]:
                forced = cfg.warmup_max > 0 and epoch + 1 >= cfg.warmup_max
                if core._isclose(losses[i], running[i], rtol) or forced:
                    trans[i] = True
            elif core._isclose(losses[i], running[i], rtol):
                plateau_hits[i] += 1
                newly_done[i] = plateau_hits[i] >= cfg.stop_patience
            else:
                plateau_hits[i] = 0
        post = active & ~warm & ~newly_done
        if trans.any():
            states = _ensemble_boot(cfg, states, result.q_means, us, gens, trans, pair_w,
                                    members.lo)
            warm[trans] = False
            running[trans] = losses[trans]
            for i in np.flatnonzero(trans):
                logger.info("ensemble: member %d left warm-up at epoch %d.", i, epoch)
        if newly_done.any():
            done |= newly_done
            for i in np.flatnonzero(newly_done):
                logger.info("ensemble: member %d converged at epoch %d.", i, epoch)
        if use_adapt and post.any():
            states = _ensemble_adapt(cfg, states, result.q_means, us, post[sl], pair_w)
        if cfg.multistep_refine > 0 and post.any():
            states = _ensemble_msrefine(cfg, states, result.q_means, post[sl])
        if tracker is not None:
            tracker.observe(cfg, states, result.q_means, result.q_logvars, y, us, epoch,
                            active & ~warm, losses)

        still = active & ~newly_done
        if epoch > 0:
            running = np.where(still, beta * running + (1 - beta) * losses, running)
        else:
            running = np.where(still, losses, running)
        lr = np.where(still, lr * cfg.lr_decay, lr)

        if (checkpoint_path is not None and checkpoint_every > 0
                and (epoch + 1) % checkpoint_every == 0):
            from ..utils.checkpoint import save_ensemble_checkpoint

            members.save(save_ensemble_checkpoint, checkpoint_path, _make_snapshot(
                epoch + 1, warm, done, running, losses_final, plateau_hits, lr, epochs_run,
                gens, states, mu_store, lv_store, cfg_run != cfg, demote_epoch,
                repromotes_left, tracker, n_models, 1, cfg, members, prefix_free=prefix_free))

    return _result(tracker, states, mu_store, lv_store, losses_final, warm, lr, epochs_run,
                   members)


def _result(tracker, states, mu_store, lv_store, losses_final, warm, lr,
            epochs_run, members: _Members) -> EnsembleFitResult:
    """All N members' result, each from the rank that ran it."""
    sel_ep = sel_m = None
    if tracker is not None:
        states, mu_store, lv_store, losses_final, sel_ep, sel_m = tracker.finalize(
            states, mu_store, lv_store, losses_final)
    return EnsembleFitResult(mu=members.rows(mu_store), logvar=members.rows(lv_store),
                             loss=losses_final, states=members.states(states), warm_up=warm,
                             lr=lr, epochs_run=epochs_run, selected_epoch=sel_ep,
                             selected_metric=sel_m)


def _fit_ensemble_blocked(cfg, states, y, us, gens, mask, channel_mask, pair_w, n_batch, *,
                          k_block, max_iter, beta, rtol, callback, lr0, tracker,
                          checkpoint_path, checkpoint_every, snap, members) -> EnsembleFitResult:
    """The blocked fit loop: K epochs of this rank's members a dispatch, the
    plateau machine replayed per member on the host over the block's
    gathered (N, K) losses, transitions at block boundaries
    (``models.vjf._fit_blocked`` per member)."""
    n_models, sl = members.n, members.sl
    use_adapt = cfg.dynamics == "sgp" and cfg.sgp_adapt_lr > 0
    masks = dict(mask=mask, channel_mask=channel_mask)
    t_len = y.shape[-3]
    v = _start(cfg, states, n_batch, mask, channel_mask, lr0, snap, members)
    epoch, warm, done, running = v["epoch"], v["warm"], v["done"], v["running"]
    losses_final, plateau_hits, lr = v["losses_final"], v["plateau_hits"], v["lr"]
    epochs_run, mu_store, lv_store = v["epochs_run"], v["mu_store"], v["lv_store"]
    cfg_run, mega_guard, demote_epoch = v["cfg_run"], v["mega_guard"], v["demote_epoch"]
    repromotes_left, prefix_free = v["repromotes_left"], v["prefix_free"]
    member_demoted = np.zeros(n_models, dtype=bool)
    pf_logged = False

    while epoch < max_iter and not done.all():
        if (demote_epoch is not None and repromotes_left > 0 and not warm.any()
                and epoch - demote_epoch >= cfg.repromote_after):
            repromotes_left -= 1
            demote_epoch = None
            cfg_run = cfg
            mega_guard = True
            _reprobe(epoch, repromotes_left)
        k = min(k_block, max_iter - epoch)
        seeds_b = [[core.epoch_seed(g) for _ in range(k)] for g in gens][sl]
        lr_shared = float(lr[~done][0])
        lrs = [lr_shared * cfg.lr_decay ** j for j in range(k)]
        uniform = warm.all() or not warm.any()
        all_warm = bool(warm.all())
        backup = states if (mega_guard and not all_warm) else None
        engage_pf = (prefix_free and mega_guard and uniform and not all_warm
                     and cfg.ns_prefix_free != "off" and cfg_run.ns_prefix > 0)
        cfg_disp = cfg_run.replace(ns_prefix=0) if engage_pf else cfg_run
        if engage_pf and not pf_logged:
            pf_logged = True
            logger.info("ensemble: every member contracted (max tau < %.2f); continuing "
                        "prefix-free from the epoch-%d block.", _fused.NS_TAU_ESCALATE, epoch)
        if uniform:
            flags = StepFlags(sgd=True, update=True, warm_up=all_warm, train_decoder=all_warm)
            res = _ensemble_epochs(cfg_disp, flags, states, y, us, seeds_b, lrs, **masks)
        else:
            flags = StepFlags(sgd=True, update=True, warm_up=False, train_decoder=False)
            res = _ensemble_epochs(cfg_run, flags, states, y, us, seeds_b, lrs,
                                   warms=warm[sl].astype(float).tolist(), **masks)
        # one host read (and one gather) per block for the control signals
        vals = members.gather(np.asarray(torch.stack(
            [res.epoch_loss, res.max_tau, res.hot_frac], dim=1).tolist()))
        losses_blk, tau_blk, hot_blk = vals[:, 0], vals[:, 1], vals[:, 2]
        watched = mega_guard and uniform and not all_warm
        if watched:
            if t_len > cfg_disp.ns_prefix:
                prefix_free = _prefix_free_next(prefix_free, float(hot_blk.max()),
                                                float(tau_blk.max()))
            else:
                # the whole block ran inside the protected prefix: engage
                # structurally; the engaged block's own statistics then govern
                prefix_free = True
        hot = np.zeros(n_models, dtype=bool)
        if watched and float(hot_blk.max()) > cfg.demote_hot_frac:
            hot = hot_blk.max(axis=1) > cfg.demote_hot_frac
            _, j = np.unravel_index(int(hot_blk.argmax()), hot_blk.shape)
            if hot.all():
                logger.warning(
                    "ensemble: all %d members skipped >%.1f%% of RLS updates on the mega "
                    "layout (epoch %d); demoting the ensemble to the autograd epoch and "
                    "re-running the block from backup.", n_models,
                    100 * cfg.demote_hot_frac, epoch + int(j))
                cfg_run = cfg.replace(fused_step="off")
                mega_guard = False
                demote_epoch = epoch + int(j)
                backup = _ensemble_repair(cfg, flags, n_batch, backup)
                res = _ensemble_epochs(cfg_run, flags, backup, y, us, seeds_b, lrs, **masks)
                losses_blk = members.gather(res.epoch_loss.tolist())
            else:
                newly = hot & ~member_demoted
                if newly.any():
                    logger.warning(
                        "ensemble: members %s skipped up to %.1f%% of RLS updates on the "
                        "mega layout (epoch %d); re-running only those members' block on "
                        "the autograd route from their repaired pre-block states (per "
                        "block, until their kernel block runs clean).",
                        np.flatnonzero(newly).tolist(), 100 * float(hot_blk.max()),
                        epoch + int(j))
                res, local = _rerun_hot_members(
                    cfg, flags, n_batch, backup, y, us, seeds_b, None, mask, channel_mask,
                    hot[sl], res, losses_blk[sl], epochs_mode=True, lrs=lrs)
                losses_blk = members.gather(local)
        if watched:
            recovered = member_demoted & ~hot
            if recovered.any():
                logger.info("ensemble: members %s ran clean on the mega layout at the "
                            "epoch-%d block; keeping their kernel results.",
                            np.flatnonzero(recovered).tolist(), epoch)
            member_demoted = hot.copy()

        active = ~done
        states = _member_select(active[sl], res.state, states)
        mu_store, lv_store = _store(mu_store, lv_store, active[sl], res)
        losses_final = np.where(active, losses_blk[:, -1], losses_final)
        epochs_run = np.where(active, epoch + k, epochs_run)
        if callback is not None:
            callback(epoch, losses_blk, res)

        # each member replays the block's K epochs (solo _fit_blocked:
        # transitions latch in the block and apply at its boundary)
        warmup_plateau = np.zeros(n_models, dtype=bool)
        converged = np.zeros(n_models, dtype=bool)
        for j in range(k):
            for i in np.flatnonzero(active):
                el = float(losses_blk[i, j])
                if core._isclose(el, running[i], rtol):
                    if warm[i]:
                        warmup_plateau[i] = True
                    else:
                        plateau_hits[i] += 1
                        converged[i] |= plateau_hits[i] >= cfg.stop_patience
                elif not warm[i]:
                    plateau_hits[i] = 0
                running[i] = beta * running[i] + (1 - beta) * el if epoch + j > 0 else el
        epoch += k
        lr = np.where(active, lr * cfg.lr_decay ** k, lr)
        if cfg.warmup_max > 0 and epoch >= cfg.warmup_max:
            forced = active & warm & ~warmup_plateau
            if forced.any():
                logger.warning("ensemble: warm-up plateau never fired within warmup_max=%d "
                               "for members %s; forcing the phase transition at the block "
                               "boundary.", cfg.warmup_max, np.flatnonzero(forced).tolist())
                warmup_plateau |= forced

        trans = active & warm & warmup_plateau
        if trans.any():
            states = _ensemble_boot(cfg, states, res.q_means, us, gens, trans, pair_w,
                                    members.lo)
            warm[trans] = False
            running[trans] = losses_blk[trans, -1]
            for i in np.flatnonzero(trans):
                logger.info("ensemble: member %d left warm-up at the epoch-%d block boundary.",
                            i, epoch)
        newly_done = active & ~warm & converged & ~trans
        if newly_done.any():
            done |= newly_done
            for i in np.flatnonzero(newly_done):
                logger.info("ensemble: member %d converged by epoch %d.", i, epoch)
        post = active & ~warm & ~newly_done & ~trans
        if use_adapt and post.any():
            states = _ensemble_adapt(cfg, states, res.q_means, us, post[sl], pair_w)
        if cfg.multistep_refine > 0 and post.any():
            states = _ensemble_msrefine(cfg, states, res.q_means, post[sl])
        if tracker is not None:
            # block-granular: each block's final state and posteriors
            tracker.observe(cfg, states, res.q_means, res.q_logvars, y, us, epoch - 1,
                            active & ~warm, losses_blk[:, -1])

        if (checkpoint_path is not None and checkpoint_every > 0
                and epoch // checkpoint_every > (epoch - k) // checkpoint_every):
            from ..utils.checkpoint import save_ensemble_checkpoint

            members.save(save_ensemble_checkpoint, checkpoint_path, _make_snapshot(
                epoch, warm, done, running, losses_final, plateau_hits, lr, epochs_run, gens,
                states, mu_store, lv_store, cfg_run != cfg, demote_epoch, repromotes_left,
                tracker, n_models, k_block, cfg, members, prefix_free=prefix_free))

    return _result(tracker, states, mu_store, lv_store, losses_final, warm, lr, epochs_run,
                   members)
