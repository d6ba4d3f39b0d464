"""A cell's files, found by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``, through the entry's ``file``), its
traffic (``traffic/<traffic>.json``) and its per-layer metrics'
readers (``metrics/<metric>.py``). Nothing here names a cell."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    root: Path            # the directory that holds BENCHMARK.json
    model: dict           # the configuration as it is run (the port's VJFConfig fields)
    traffic: dict
    chips: int
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    model = json.loads((bench_path.parent / conf["file"]).read_text())["model"]
    root = bench_path.parent
    traffic = json.loads((root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(workload, root, model, traffic, w["chips"],
                [m for m in bench["end_to_end"] if reports(m, workload)],
                [m for m in bench["per_layer"] if reports(m, workload)])


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
