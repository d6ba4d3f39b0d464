"""The traced run: spans that the benchmark puts around the port's calls, and
the reading of a ``torch.profiler`` trace into what the per-layer metrics'
readers take.

In the traced run only, :func:`spans` wraps four functions of the port, as
module attributes, in ``record_function``: ``run_epoch`` (the epochs
driver), the prefix's ``fused_step_call`` and ``exact_v_fallback``, and
``mega_epoch_call``. No file of the port changes. :func:`read` turns the
profiler's chrome trace into device operations (each with the span whose
host code launched it, matched by the CUDA correlation id), host spans and
the traced window, all in microseconds on the trace's clock."""
from __future__ import annotations

import bisect
import contextlib
import json
from types import SimpleNamespace

WINDOW = "bench.window"
WRAPPED = (("vjf_tpu_torch.models.vjf", "run_epoch", "run_epoch"),
           ("vjf_tpu_torch.ops.fused_step", "fused_step_call", "prefix.fused_step_call"),
           ("vjf_tpu_torch.ops.fused_step", "exact_v_fallback", "prefix.exact_v_fallback"),
           ("vjf_tpu_torch.ops.fused_step", "mega_epoch_call", "mega_epoch_call"))
CALLS = tuple(label for _, _, label in WRAPPED[1:])     # the spans of the port's launches
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def spans():
    """Wrap the port's functions of :data:`WRAPPED` in ``record_function``
    for the duration; restore them after."""
    import importlib

    import torch

    saved = []
    for mod_name, attr, label in WRAPPED:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrapped(*args, _orig=orig, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _orig(*args, **kw)

        saved.append((mod, attr, orig))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def _innermost(starts, items, t):
    """The item of ``items`` (sorted by start, non-overlapping) that holds
    time ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and items[i][1] <= t <= items[i][1] + items[i][2]:
        return items[i]
    return None


def read(path: str) -> SimpleNamespace:
    """``kernels``: dicts of ``name``, ``ts``, ``dur`` and ``span`` (the
    launching call's span name, or None); ``spans``: (name, ts, dur) of the
    wrapped functions; ``window``: (start, end) of the traced window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window, host, launches, device = None, [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation":
            if name == WINDOW:
                window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            elif name in CALLS or name == "run_epoch":
                host.append((name, float(e["ts"]), float(e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    if window is None:
        raise ValueError(f"no {WINDOW} span in the trace")
    calls = sorted((s for s in host if s[0] in CALLS), key=lambda s: s[1])
    starts = [s[1] for s in calls]
    kernels = []
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        span = None if t is None else _innermost(starts, calls, t)
        kernels.append({"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"]),
                        "span": None if span is None else span[0]})
    return SimpleNamespace(kernels=kernels, spans=sorted(host, key=lambda s: s[1]),
                           window=window)


def busy_intervals(kernels, window):
    """The union of the device operations' intervals inside ``window``, as
    sorted disjoint (start, end) pairs."""
    lo, hi = window
    iv = sorted((max(k["ts"], lo), min(k["ts"] + k["dur"], hi)) for k in kernels
                if k["ts"] < hi and k["ts"] + k["dur"] > lo)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def breakdown(tr, top: int = 10) -> dict:
    """The device operations that took most time (seconds, by name), and the
    longest idle gaps of the device inside the window, each named by the
    innermost span the host was in when it began."""
    by_name = {}
    for k in tr.kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(tr.kernels, tr.window)
    edges = [tr.window[0]] + [x for iv in busy for x in iv] + [tr.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    calls = [s for s in tr.spans if s[0] in CALLS]
    epochs = [s for s in tr.spans if s[0] == "run_epoch"]

    def label(t):
        s = _innermost([c[1] for c in calls], calls, t) or _innermost(
            [c[1] for c in epochs], epochs, t)
        return s[0] if s else "harness"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(a), (b - a) * 1e-6] for a, b in longest]}
