"""What the per-layer metrics' readers compute from a traced window
(``tracing.read``): each takes the reading context and returns a number, or
None where the trace holds nothing to read. ``metrics/<name>.py`` picks
one; the name's suffix (``.train``, ``.prefix_free``) only says which cells
report it."""
from __future__ import annotations

import counts
import tracing

KERNEL = "vjf_kernel"


def _inside(s, outer):
    return outer[1] <= s[1] and s[1] + s[2] <= outer[1] + outer[2]


def _epochs(ctx):
    return [s for s in ctx.trace.spans if s[0] == "run_epoch"]


def _launches(ctx, name):
    return [s for s in ctx.trace.spans if s[0] == name]


def driver_ms(ctx):
    """Host ms an epoch inside ``run_epoch`` outside the port's launch calls
    (padding, unpadding, slicing, the epoch's statistics)."""
    epochs = _epochs(ctx)
    if not epochs:
        return None
    calls = [s for s in ctx.trace.spans if s[0] in tracing.CALLS]
    own = [e[2] - sum(c[2] for c in calls if _inside(c, e)) for e in epochs]
    return sum(own) / len(own) / 1e3


def prefix_ms(ctx):
    """Host ms an epoch from the first prefix launch's start to the mega
    launch's start."""
    out = []
    for e in _epochs(ctx):
        first = [s for s in _launches(ctx, "prefix.fused_step_call") if _inside(s, e)]
        mega = [s for s in _launches(ctx, "mega_epoch_call") if _inside(s, e)]
        if first and mega:
            out.append(mega[0][1] - first[0][1])
    return sum(out) / len(out) / 1e3 if out else None


def _roofline(ctx, span, segment, steps_a_launch):
    dev = sum(k["dur"] for k in ctx.trace.kernels if k["span"] == span and KERNEL in k["name"])
    n = len(_launches(ctx, span)) * steps_a_launch
    if dev <= 0 or n == 0:
        return None
    least, _ = counts.least_seconds(ctx.model, ctx.trials, segment, steps_a_launch)
    return 100.0 * least / (dev * 1e-6 / n)


def mega_roofline(ctx):
    """The least time a segment step needs on the card over the mega
    kernel's device time a step, %."""
    return _roofline(ctx, "mega_epoch_call", True, ctx.steps - ctx.prefix)


def step_roofline(ctx):
    """The same for the per-step kernel of the prefix (the kernel alone,
    not the exact fallback), %."""
    return _roofline(ctx, "prefix.fused_step_call", False, 1)


def mfu_pct(ctx):
    """Every step of the traced window at the published peaks, over the
    window, %."""
    if not ctx.trace.kernels:
        return None
    n_prefix = len(_launches(ctx, "prefix.fused_step_call"))
    n_mega = len(_launches(ctx, "mega_epoch_call")) * (ctx.steps - ctx.prefix)
    if n_prefix + n_mega == 0:
        return None
    need = (n_prefix * counts.step_peak_seconds(ctx.model, ctx.trials, False)
            + n_mega * counts.step_peak_seconds(ctx.model, ctx.trials, True))
    return 100.0 * need / ((ctx.trace.window[1] - ctx.trace.window[0]) * 1e-6)


def device_idle_pct(ctx):
    """The share of the traced window in which no operation ran on the
    device, %."""
    if not ctx.trace.kernels:
        return None
    lo, hi = ctx.trace.window
    busy = sum(e - s for s, e in tracing.busy_intervals(ctx.trace.kernels, ctx.trace.window))
    return 100.0 * (1.0 - busy / (hi - lo))
