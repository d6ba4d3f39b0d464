"""What the per-layer metrics read from the port's own spans and counters
(``vjf_tpu_torch.ops.trace``), which the port records while the traced
window's profiler runs: one session, the traced window's calls. Each
reader takes the reading context, which it does not need, and returns a
number, or None where the session holds nothing to read, as on a program
that records no spans (where the module is missing).

Span times are host times on ``time.time_ns()``; a span's self time is its
duration less its direct children's."""
from __future__ import annotations

LAUNCH = "vjf.launch.fused_step"
LAUNCHES = "vjf.launch."
FALLBACK = "vjf.fallback"
PREFIX = "vjf.prefix"
FALLBACK_ROW, MEGA_ROW = 0, 1           # rows of the session's tau-band counts


def _session():
    """The port's session, or None where the port records none or the
    session dropped records past its capacity (its sums would be short)."""
    try:
        from vjf_tpu_torch.ops import trace
    except ImportError:
        return None
    s = trace.read()
    return None if s.dropped else s


def _dur(s):
    return s.end_ns - s.start_ns


def _named(session, name):
    return [s for s in session.spans if s.name == name and s.end_ns]


def launch_host_us(ctx):
    """Mean host µs of a prefix step's launch (``_launch``: the operands'
    checks, the limits, the workspace, the library's call)."""
    s = _session()
    spans = [] if s is None else _named(s, LAUNCH)
    if not spans:
        return None
    return sum(map(_dur, spans)) / len(spans) / 1e3


def fallback_host_ms(ctx):
    """Host ms an epoch in the exact fallback, over the epochs that ran it."""
    s = _session()
    spans = [] if s is None else _named(s, FALLBACK)
    if not spans:
        return None
    epochs = {f.epoch for f in spans}
    return sum(map(_dur, spans)) / len(epochs) / 1e6


def prefix_glue_ms(ctx):
    """Host ms an epoch in the prefix outside its launches and fallbacks:
    the carry snapshot, the step slicing, the posterior split, the output
    buffers."""
    s = _session()
    prefixes = [] if s is None else [(i, p) for i, p in enumerate(s.spans)
                                     if p.name == PREFIX and p.end_ns]
    if not prefixes:
        return None
    inside = {i: 0 for i, _ in prefixes}
    for c in s.spans:
        if c.parent in inside and c.end_ns and (c.name == FALLBACK
                                                or c.name.startswith(LAUNCHES)):
            inside[c.parent] += _dur(c)
    return sum(_dur(p) - inside[i] for i, p in prefixes) / len(prefixes) / 1e6


def fallback_useful_pct(ctx):
    """The prefix's steps whose tau selected the exact fallback's result
    (tau >= ``NS_TAU_THRESHOLD`` or not finite) over the fallback's calls, %."""
    s = _session()
    calls = 0 if s is None else len(_named(s, FALLBACK))
    if not calls:
        return None
    return 100.0 * sum(s.tau_bands[FALLBACK_ROW][2:]) / calls


def mega_escalated_pct(ctx):
    """The mega launches' steps that ran more than the base Newton-Schulz
    iterations or skipped the update (tau >= ``NS_TAU_ESCALATE`` or not
    finite) over their steps, %."""
    s = _session()
    row = None if s is None else s.tau_bands[MEGA_ROW]
    if not row or not sum(row):
        return None
    return 100.0 * sum(row[1:]) / sum(row)
