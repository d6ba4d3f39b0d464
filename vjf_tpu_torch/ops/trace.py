"""The port's instrumentation: the kernel launch counters, and the spans and
tau-band counters it records while a ``torch.profiler`` session is active.

A leaf module (it imports only torch), so any module of the port can use it.

Spans are on exactly while someone profiles (``torch.autograd
._profiler_enabled()``): the benchmark's traced run, or a caller under
``utils.metrics.profiler_trace`` or any other ``torch.profiler`` session.
Off, :func:`span` returns a shared null context and does nothing else. On,
it enters ``torch.profiler.record_function(name)`` (so the span lands in
the trace, and the launches inside it carry its correlation) and keeps a
:class:`Span` record in memory, stamped with ``time.time_ns()``: the clock
of the chrome trace, whose ``ts`` is ``(time_ns - baseTimeNanoseconds) /
1000`` microseconds.

A session is what :func:`read` returns: the first span or count seen on
after one seen off (or after :func:`reset_launches`) starts a new one and
clears the records and the tau-band counts, so a reader sees exactly one
profiled window. Two profiler sessions with no call of the port between
them read as one. Spans are recorded from one thread at a time.

The spans the port records: ``vjf.epoch`` (``models/vjf.py:run_epoch``),
``vjf.prefix`` (the prefix loop of ``ops/fused_step.py:run_epoch_fused``),
``vjf.fallback`` (``exact_v_fallback``) and ``vjf.launch.<kernel>``
(``_launch`` of ``fused_step``, ``mega_epoch`` or ``forward_sums``).
"""
from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

# kernel launches, one count per launcher and form (``.ensemble``: N members
# in one launch); only the CUDA branch of a wrapper adds to its count
launches = {"fused_step": 0, "mega_epoch": 0, "forward_sums": 0,
            "fused_step.ensemble": 0, "mega_epoch.ensemble": 0}
# timesteps those launches ran (a mega launch runs a whole segment; an
# ensemble launch counts member-steps)
steps = dict.fromkeys(launches, 0)

EPOCH = "vjf.epoch"
CAPACITY = 1 << 20          # span records a session keeps; past it they are counted as dropped
# rows of the tau-band counts: the prefix's steps that ran the exact
# fallback, and the steps of mega launches
TAU_ROWS = ("fallback", "mega")
NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int           # time.time_ns(), before the record_function is entered
    end_ns: int             # after it is left; 0 while the span is open
    parent: int             # index of the enclosing record, -1 at the top
    epoch: int              # index of the enclosing vjf.epoch record (its own for one), -1 outside


class _Session:
    """The records, the open spans and the tau-band counts of one profiled
    window."""

    def __init__(self):
        self.reset()

    def reset(self, stale: bool = True):
        self.records = []                   # [name, start_ns, end_ns, parent, epoch]
        self.open = []                      # indices of the open records, innermost last
        self.dropped = 0
        self.tau_bands = {}                 # device -> (2, 4) int64 on it
        self.stale = stale                  # the next span or count seen on starts anew


_session = _Session()


def reset_launches() -> None:
    """Zero the launch counters and clear the session's spans and counts."""
    for k in launches:
        launches[k] = steps[k] = 0
    _session.reset()


def _on() -> bool:
    """Whether a profiler is active; the first time after it was not, clear
    the session."""
    if not _profiling():
        _session.stale = True
        return False
    if _session.stale:
        _session.reset(stale=False)
    return True


class _Recorded:
    __slots__ = ("name", "rf", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = _session
        start = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.i = len(s.records)
        if self.i >= CAPACITY:
            s.dropped += 1
            return self
        parent = s.open[-1] if s.open else -1
        epoch = self.i if self.name == EPOCH else (s.records[parent][4] if parent >= 0 else -1)
        s.records.append([self.name, start, 0, parent, epoch])
        s.open.append(self.i)
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        s = _session
        if self.i < CAPACITY and s.open and s.open[-1] == self.i:
            s.open.pop()
            s.records[self.i][2] = time.time_ns()
        return False


def span(name: str):
    """A context manager that records the span ``name`` while a profiler is
    active, and does nothing otherwise."""
    if not _on():
        return NULL
    return _Recorded(name)


def tau_bands(device) -> Optional[torch.Tensor]:
    """The session's (2, 4) int64 tau-band counts on ``device`` (rows
    :data:`TAU_ROWS`), to add an epoch's steps to; None while no profiler is
    active."""
    if not _on():
        return None
    key = str(device)
    counts = _session.tau_bands.get(key)
    if counts is None:
        counts = _session.tau_bands[key] = torch.zeros((2, 4), dtype=torch.int64,
                                                        device=device)
    return counts


def read() -> SimpleNamespace:
    """The session: ``spans`` (the :class:`Span` records in the order they
    were entered), ``dropped`` (records past :data:`CAPACITY`) and
    ``tau_bands`` (rows :data:`TAU_ROWS` of four ints, summed over devices
    and members: the steps with tau below ``NS_TAU_ESCALATE``, from it to
    ``NS_TAU_THRESHOLD``, from there to ``NS_TAU_MAX``, and the rest with
    every tau that is not finite). Reads the counts back from the device."""
    bands = [[0] * 4 for _ in TAU_ROWS]
    for counts in _session.tau_bands.values():
        for row, got in zip(bands, counts.tolist()):
            row[:] = [a + b for a, b in zip(row, got)]
    return SimpleNamespace(spans=[Span(*r) for r in _session.records],
                           dropped=_session.dropped, tau_bands=bands)
