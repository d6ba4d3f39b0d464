"""Ensembles: many independent models trained side by side (counterpart of
``vjf_tpu/parallel/replicated.py``).

The JAX package stacks N ``TrainState``s on a leading axis and ``vmap``s
the epoch over it. The port keeps the members as a list of ``TrainState``s
(they hold ``nn.Linear`` modules) and stacks only the padded kernel carry
for a launch: on the fused route one N-member launch per step of the
prefix and one N-member mega launch run every member
(``ops.fused_step.run_epoch_fused`` on a list of states); elsewhere each member runs
the autograd epoch in turn. Typical uses: seed ensembles, per-subject
models, hyperparameter sweeps. Over several cards (:func:`shard_ensemble`)
each rank runs a contiguous slice of the members: whole filters, no
collective inside an epoch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..config import StepFlags, VJFConfig
from ..models import vjf as core
from ..ops import fused_step as _fused


def member_seeds(seed: Union[int, torch.Generator], n_models: int) -> List[int]:
    """N int seeds drawn from one seed or CPU generator: the port's
    counterpart of ``jax.random.split(key, n_models)``."""
    gen = core._generator(seed)
    return [core.epoch_seed(gen) for _ in range(n_models)]


def init_ensemble(seed: Union[int, torch.Generator], cfg: VJFConfig, n_models: int,
                  device=torch.device("cuda"), backend: Optional[str] = None) -> list:
    """N independently initialised ``TrainState``s on ``device`` (the card
    unless the caller asks for ``device="cpu"``), member m from the m-th
    seed of :func:`member_seeds`."""
    return [core.init_state(s, cfg, device=device, backend=backend)
            for s in member_seeds(seed, n_models)]


def member_range(n_models: int, group) -> range:
    """The members rank ``r`` of ``n`` runs: ``[r N/n, (r + 1) N/n)``; all
    of them without a group. N must divide over the ranks."""
    if group is None:
        return range(n_models)
    from .sharded import _rank_and_size

    rank, world = _rank_and_size(group)
    if n_models % world:
        raise ValueError(f"{n_models} members do not divide over {world} ranks")
    per = n_models // world
    return range(rank * per, (rank + 1) * per)


def shard_ensemble(states: Sequence, group) -> list:
    """This rank's members of ``states`` (all N, the same on every rank), as
    :func:`member_range` assigns them: the counterpart of the JAX package's
    placement of the member axis over devices. Each rank then runs its
    members as an ensemble of its own."""
    r = member_range(len(states), group)
    return list(states[r.start:r.stop])


def member_data(x: Optional[torch.Tensor], m: int, ndim: int = 3):
    """Member ``m``'s copy of ensemble data whose per-member form has
    ``ndim`` dims: ``x[m]`` when it is stacked (N, ...), else ``x`` itself,
    one copy that every member reads."""
    if x is None or x.dim() == ndim:
        return x
    return x[m]


def stack_epochs(results: Sequence[core.EpochResult]) -> core.EpochResult:
    """Members' ``EpochResult``s as one: the list of states, every tensor
    with a leading member axis."""
    return core.EpochResult(
        state=[r.state for r in results],
        q_means=torch.stack([r.q_means for r in results]),
        q_logvars=torch.stack([r.q_logvars for r in results]),
        metrics=core.Metrics(*(None if f[0] is None else torch.stack(f)
                               for f in zip(*(r.metrics for r in results)))),
    )


def run_epoch_ensemble(
    cfg: VJFConfig,
    flags: StepFlags,
    states: Sequence[core.TrainState],
    ys: torch.Tensor,
    us: torch.Tensor,
    seeds: Sequence[int],
    lr,
    warm_gate: Optional[Sequence] = None,
    mask=None,
    channel_mask=None,
) -> core.EpochResult:
    """One epoch of every member.

    ``ys`` (N, T, B, ydim) per member or (T, B, ydim) shared, ``us``
    likewise; ``seeds`` N int Philox keys (distinct noise streams); ``lr`` one
    rate for all. ``mask`` (T,)/(T, B) and ``channel_mask`` are shared by
    every member. Where ``fused_enabled`` says so, the members run together
    through the member-axis kernels; otherwise, and always with
    ``warm_gate`` (N phases, 1 = warm-up, see ``models.vjf.filter_step``),
    each member runs ``models.vjf.run_epoch`` in turn. Returns an
    ``EpochResult`` whose ``state`` is the list of the N new states and whose
    tensors have a leading member axis."""
    t_len, n_batch = ys.shape[-3], ys.shape[-2]
    dev = ys.device
    mask = core._promote_mask(mask, t_len, n_batch, cfg.tdtype, dev)
    channel_mask = core._promote_channel_mask(channel_mask, (t_len, n_batch, cfg.ydim),
                                              cfg.tdtype, dev)
    if warm_gate is None and _fused.fused_enabled(cfg, states[0], n_batch=n_batch,
                                                  mask=mask is not None,
                                                  channel_mask=channel_mask is not None):
        if ys.dtype != cfg.tdtype:
            ys = ys.to(cfg.tdtype)
        with torch.no_grad():
            return _fused.run_epoch_fused(
                cfg, flags, list(states), ys, us.to(cfg.tdtype), seeds, lr, mask=mask,
                channel_mask=channel_mask)
    return stack_epochs([
        core.run_epoch(cfg, flags, st, member_data(ys, m), member_data(us, m), seeds[m], lr,
                       mask=mask, channel_mask=channel_mask,
                       warm_gate=None if warm_gate is None else warm_gate[m])
        for m, st in enumerate(states)])
