"""The comparison that decides ``correct``: what the program produced in
the run against the plain reference (``reference/plain.py``).

Three stages of a run are checked, each from a state the reference has or
is given, and each to its end:

* ``warm``: the set-up's warm-up epoch, from the reference's own model
  initialised from the run's seed (the start of the chain).
* ``rls``: the set-up's RLS epoch with the exact-inverse prefix, from the
  program's state after the warm-up (held by ``warm``).
* ``call``: one timed call, drawn from the seed, from the warmed state
  every call starts from (held by ``rls``).

Four numbers, each the worst over the stages:

* ``q_gap``: the posteriors followed freely, step by step, over a stage's
  first ``follow`` steps (the prefix and the segment's first steps).
* ``step_gap``: every step of a stage, teacher forced: the reference fed
  the posterior the program reported for the step before, its own weights
  carried through the stage (``plain.teacher_forced``); the widest gap of
  a reported posterior from the reference's.
* ``rls_gap``: the weight posterior and state noise at the stage's end
  against the teacher-forced reference's, by the worst leaf, over how far
  the reference moved that leaf.
* ``sgd_gap``: the weights SGD trains (the recognition MLP, the decoder,
  the observation noise) at the stage's end the same way, over how far the
  reference moved that leaf or the median leaf, whichever is larger;
  leaves the reference moves by under a thousandth of the median leaf's
  move (a Poisson model's observation noise) are left out.

The reference never reads the program's weights, tables or padded carry: it
takes the stage's starting state as a plain dict and works the rest out
itself, reading the program's posteriors only as inputs and to judge them.
"""
from __future__ import annotations

import contextlib
import statistics

import torch

from reference import plain

RLS_LEAVES = ("w_dyn", "precision", "cov", "state_logvar")
SGD_LEFT_OUT = 1e-3


@contextlib.contextmanager
def no_tf32():
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def q_gap(q_means, q_logvars, q_ref) -> float:
    """The widest gap of a step's posteriors: over the steps and the two
    leaves (mean, log-variance), |program - reference| / |reference|, each
    the Frobenius norm of the step's (B, xd) block."""
    k = q_ref.shape[0]
    worst = 0.0
    for i, got in enumerate((q_means[:k], q_logvars[:k])):
        ref = q_ref[:, i]
        gap = (got.float() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
        worst = max(worst, float(gap.max()))
    return worst


def rls_gaps(got: dict, ref: dict, start: dict) -> dict:
    """Each leaf of the weight posterior and state noise at the end:
    |program - reference| over how far the reference moved it,
    |reference - start| (a leaf left where it started reads 1)."""
    out = {}
    for k in RLS_LEAVES:
        moved = float((ref[k] - start[k]).norm())
        diff = float((got[k].float() - ref[k]).norm())
        out[k] = diff / moved if moved > 0 else (0.0 if diff == 0 else float("inf"))
    return out


def sgd_gaps(got: dict, ref: dict, start: dict) -> dict:
    """Each trained weight at the end: |program - reference| over how far
    the reference moved it or the median leaf, whichever is larger; leaves
    the reference moved by under ``SGD_LEFT_OUT`` of the median leaf's move
    are left out."""
    moved = {k: float((ref[k] - start[k]).norm()) for k in ref}
    med = statistics.median(moved.values())
    return {k: float((got[k] - ref[k]).norm()) / max(moved[k], med)
            for k in ref if moved[k] >= SGD_LEFT_OUT * med and med > 0}


def stage_gaps(model: dict, stage: dict, ys, mm: str = "bfloat16") -> dict:
    """The numbers of one stage: a dict of ``start`` (the plain state, or
    None for the reference's own initial model from ``init_seed``),
    ``flags``, ``seed``, ``lr``, ``prefix``, ``follow`` (steps followed
    freely), ``q_means``, ``q_logvars`` (every step's) and ``end`` (the
    program's end state as a plain dict)."""
    start = stage["start"]
    if start is None:
        start = plain.init_state(model, stage["init_seed"], ys.device)
    q_ref, _, _ = plain.follow(model, stage["flags"], start, ys, stage["seed"], stage["lr"],
                               stage["prefix"], stage["follow"], mm)
    out = {"q_gap": q_gap(stage["q_means"], stage["q_logvars"], q_ref)}
    del q_ref
    step_gap, carry = plain.teacher_forced(
        model, stage["flags"], start, ys, stage["q_means"].float(), stage["q_logvars"].float(),
        stage["seed"], stage["lr"], stage["prefix"], mm, graph=ys.is_cuda)
    out["step_gap"] = step_gap
    c0 = plain.pad(model, start)
    by_rls = rls_gaps(stage["end"], plain.rls_leaves(carry), plain.rls_leaves(c0))
    by_sgd = sgd_gaps(plain.sgd_leaves(plain.pad(model, stage["end"])),
                      plain.sgd_leaves(carry), plain.sgd_leaves(c0))
    out["rls_gap"] = max(by_rls.values())
    out["sgd_gap"] = max(by_sgd.values())
    out.update({f"rls_gap.{k}": v for k, v in by_rls.items()})
    out.update({f"sgd_gap.{k}": v for k, v in by_sgd.items()})
    return out


def gaps(model: dict, stages: list, ys) -> dict:
    """Each compared number: its worst reading over the stages."""
    out = {}
    with no_tf32(), torch.no_grad():
        for stage in stages:
            for k, v in stage_gaps(model, stage, ys[:stage["steps"]]).items():
                out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Correct where every compared number is finite and within its limit."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())
