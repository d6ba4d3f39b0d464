"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s workload) names a configuration and a
traffic file; everything else is found by those names (``cells.py``). The
program under test is the PyTorch/CUDA port, ``vjf_tpu_torch``:

* set-up (``setup_s``, from the process's start): the kernels' library
  (built into ``build/`` of this checkout at the first run), the model from
  the seed, the cell's data on the card from the seed, one warm-up epoch
  and one RLS epoch with the exact-inverse prefix over the first
  ``warmup_steps`` steps. Their result is the warmed state.
* the window: ``run_epochs`` over one epoch of the whole data from the
  warmed state, with the traffic's ``prefix``, one call after another and
  each with its own epoch seed, at most two in flight and nothing read from
  the device, until ``--seconds`` have passed; it ends at the synchronised
  end of the call that crossed them. The rate is every step of every call
  over that time. A call counts as failed where its loss is not finite or
  is 0, its Newton-Schulz bound reached 0.7, or 1% of its steps skipped
  their update (``bench.py``'s gates).
* after the window: the peak memory, the gates, the warmed state's digest
  (a call must leave it as it was), then the comparison with the plain
  reference (``check.py``) over every step of both set-up epochs and of
  one timed call, each number printed beside its limit.

With ``--trace 1`` a window of the traffic's ``trace_calls`` calls runs
under ``torch.profiler`` with spans around the port's calls
(``tracing.py``), and the result carries the cell's per-layer metrics, the
device's busy and window seconds and the breakdown. The last line of
standard output is the result's JSON object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

import numpy as np  # noqa: E402

import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vjf_tpu")
IN_FLIGHT = 2
CACHE = ROOT / "build" / "benchmark_cache"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def seeds(seed: int) -> dict:
    """Every draw of a run from ``--seed``: the model, the data, the epochs'
    Philox keys (31 bits, as the kernels take them) and the checked call."""
    ss = np.random.SeedSequence(int(seed))
    init, data, rest = ss.spawn(3)
    rng = np.random.default_rng(rest)
    return {"init": int(init.generate_state(1, np.uint64)[0] >> 1),
            "data": int(data.generate_state(1, np.uint64)[0] >> 1),
            "warm": int(rng.integers(0, 2**31 - 1)), "rls": int(rng.integers(0, 2**31 - 1)),
            "checked_call": int(rng.integers(0, 3)), "calls": rng}


class Pacer:
    """At most ``IN_FLIGHT`` calls queued on the card: before a call is
    enqueued, wait for the end of the one ``IN_FLIGHT`` back (no data is
    read). The calls' end events give their times once the window has
    closed."""

    def __init__(self, torch, device):
        self.torch, self.cuda, self.events = torch, device.type == "cuda", []

    def mark(self):
        if not self.cuda:
            return
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        if len(self.events) >= IN_FLIGHT:
            self.events[-IN_FLIGHT].synchronize()

    def drain(self) -> list:
        """Wait for the last call; the ms between consecutive calls' ends."""
        if not self.cuda:
            return []
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def set_up(cell, s: dict, device):
    """The program, the data and the warmed state; the two set-up epochs'
    outputs for the check."""
    import torch

    from vjf_tpu_torch.config import StepFlags, VJFConfig
    from vjf_tpu_torch.models import vjf as core

    import gen
    import state

    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        from vjf_tpu_torch.ops._build import load_library

        load_library()
    marks.append(("library", time.perf_counter()))
    model, tr = cell.model, cell.traffic
    cfg = VJFConfig(**{**model, "hidden_sizes": tuple(model["hidden_sizes"])})
    ys = gen.make(tr, cfg.ydim, s["data"], device)
    us = torch.zeros(ys.shape[:2] + (0,), dtype=ys.dtype, device=device)
    n = tr["warmup_steps"]
    st0 = core.init_state(s["init"], cfg, device=device)
    marks.append(("data and model", time.perf_counter()))
    warm = core.run_epochs(cfg, StepFlags(warm_up=True), st0, ys[:n], us[:n], [s["warm"]],
                           [cfg.lr])
    marks.append(("warm-up epoch", time.perf_counter()))
    rls = core.run_epochs(cfg, StepFlags(), warm.state, ys[:n], us[:n], [s["rls"]], [cfg.lr])
    marks.append(("RLS epoch", time.perf_counter()))
    k_warm = tr["check_warmup_steps"]
    stages = [
        {"name": "warm", "start": None, "init_seed": s["init"], "seed": s["warm"],
         "flags": {"sgd": True, "update": True, "warm_up": True}, "lr": cfg.lr, "prefix": 0,
         "steps": n, "follow": k_warm, "q_means": warm.q_means, "q_logvars": warm.q_logvars,
         "end": state.as_dict(warm.state)},
        {"name": "rls", "start": state.as_dict(warm.state), "seed": s["rls"],
         "flags": {"sgd": True, "update": True, "warm_up": False}, "lr": cfg.lr,
         "prefix": min(cfg.ns_prefix, n), "steps": n,
         "follow": min(cfg.ns_prefix + tr["check_steps"], n), "q_means": rls.q_means,
         "q_logvars": rls.q_logvars, "end": state.as_dict(rls.state)},
    ]
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("synchronised", time.perf_counter()))
    print("run.py: set-up s " + " ".join(f"{name} {t - T_START:.2f}" for name, t in marks),
          file=sys.stderr)
    return cfg, ys, us, rls.state, stages


def window(cfg, tr, warmed, ys, us, s: dict, device, seconds=None, calls=None):
    """Timed calls from the warmed state until ``seconds`` have passed (or
    ``calls`` calls): ``(steps, elapsed, gate readings, checked call,
    its seed)``."""
    import torch

    from vjf_tpu_torch.config import StepFlags
    from vjf_tpu_torch.models import vjf as core

    cfg_call = cfg.replace(ns_prefix=tr["prefix"])
    pacer = Pacer(torch, device)
    gates, chosen, last, i = [], None, None, 0
    t0 = time.perf_counter()
    while True:
        seed = int(s["calls"].integers(0, 2**31 - 1))
        res = core.run_epochs(cfg_call, StepFlags(), warmed, ys, us, [seed], [cfg.lr])
        gates.append((res.epoch_loss[-1], res.max_tau[-1], res.hot_frac[-1]))
        if i == s["checked_call"]:
            chosen = (res, seed)
        last = (res, seed) if chosen is None else None
        del res
        pacer.mark()
        i += 1
        if (i >= calls) if calls is not None else (time.perf_counter() - t0 >= seconds):
            break
    call_ms = pacer.drain()
    elapsed = time.perf_counter() - t0
    if call_ms:
        print("run.py: ms between calls' ends " + " ".join(f"{x:.1f}" for x in call_ms),
              file=sys.stderr)
    return i * ys.shape[0], elapsed, gates, chosen or last


def call_stage(cfg, tr, warmed, res, seed) -> dict:
    """A timed call as ``check.py`` takes a stage: from the warmed state,
    the first ``prefix + check_steps`` steps followed freely, every step
    teacher forced, its end state compared."""
    import state

    prefix = min(tr["prefix"], tr["steps"])
    return {"name": "call", "start": state.as_dict(warmed), "seed": seed,
            "flags": {"sgd": True, "update": True, "warm_up": False}, "lr": cfg.lr,
            "prefix": prefix, "steps": tr["steps"],
            "follow": min(prefix + tr["check_steps"], tr["steps"]),
            "q_means": res.q_means, "q_logvars": res.q_logvars, "end": state.as_dict(res.state)}


def gate_failures(gates) -> int:
    """Calls that break ``bench.py``'s gates: a loss that is not finite or
    is 0, a Newton-Schulz bound of 0.7 or more, 1% or more skipped steps."""
    bad = 0
    for loss, tau, hot in gates:
        loss, tau, hot = float(loss), float(tau), float(hot)
        if not (math.isfinite(loss) and loss != 0.0 and tau < 0.7 and hot < 0.01):
            bad += 1
    return bad


def traced_window(cfg, tr, warmed, ys, us, s, device):
    """The traced window under ``torch.profiler``, read into the per-layer
    metrics' context."""
    import torch

    import tracing

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tracing.spans(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            out = window(cfg, tr, warmed, ys, us, s, device, calls=tr["trace_calls"])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        read = tracing.read(path)
    finally:
        os.unlink(path)
    return out, read


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of ``cell`` on ``device``: the result's object, its ``check``
    (each compared number with its limit) last."""
    import torch

    import check
    import state
    from types import SimpleNamespace

    s = seeds(seed)
    tr = cell.traffic
    cfg, ys, us, warmed, stages = set_up(cell, s, device)
    before = state.digest(warmed)
    setup_s = time.perf_counter() - T_START
    if traced:
        (steps, elapsed, gates, (res, call_seed)), read = traced_window(
            cfg, tr, warmed, ys, us, s, device)
    else:
        steps, elapsed, gates, (res, call_seed) = window(cfg, tr, warmed, ys, us, s, device,
                                                        seconds=seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = gate_failures(gates)
    changed = state.digest(warmed) != before
    stages.append(call_stage(cfg, tr, warmed, res, call_seed))
    del res, warmed
    t_check = time.perf_counter()
    numbers = check.gaps(cell.model, stages, ys)
    print(f"run.py: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    numbers["warmed_state_changed"] = float(changed)
    limits = dict(tr["limits"], warmed_state_changed=0.0)
    metrics = {}
    if traced:
        ctx = SimpleNamespace(trace=read, model=cell.model, traffic=tr, trials=tr["trials"],
                              steps=tr["steps"], prefix=min(tr["prefix"], tr["steps"]))
        for m in cell.per_layer:
            v = cells.reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else steps / elapsed
            if m["name"] != "setup_s" and m["unit"] != "steps/s":
                raise ValueError(f"no measurement for end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": check.judge(numbers, limits), "attempted": len(gates), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced:
        import tracing

        busy = sum(e - s_ for s_, e in tracing.busy_intervals(read.kernels, read.window))
        dev.update(busy_s=busy * 1e-6, window_s=(read.window[1] - read.window[0]) * 1e-6)
        out["breakdown"] = tracing.breakdown(read)
    out["check"] = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches live in this checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"run.py: {args.workload} seed {args.seed} on {power_line()}", file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']:.6e} limit {v['limit']:.6e}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
