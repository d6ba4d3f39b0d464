"""Shared helpers of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds, with the port's plain versions in place of the
kernels (``fused_step='on'`` on CPU tensors)."""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import cells  # noqa: E402

SIZES = dict(trials=64, steps=160, warmup_steps=96, check_warmup_steps=8, check_steps=16,
             trace_calls=2)


def tiny(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """The cell ``workload`` cut to a CPU size."""
    cell = cells.load(workload, bench_path)
    prefix = 24 if cell.traffic["prefix"] else 0
    return cell._replace(traffic=dict(cell.traffic, prefix=prefix, **SIZES),
                         model=dict(cell.model, fused_step="on", ns_prefix=24))
