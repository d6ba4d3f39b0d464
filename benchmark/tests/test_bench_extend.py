"""A later change adds a cell, a configuration and a per-layer metric by new
files and new entries of BENCHMARK.json alone: here in a copy of the tree,
with no file of the benchmark edited, and a traced run reports them."""
import json
import shutil

import torch

from bench_tiny import BENCH, ROOT, SIZES

import cells
import run


def test_add_cell_config_metric_by_files(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark").mkdir()
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, tmp_path / "benchmark" / sub)
    conf = json.loads((BENCH / "configs" / "flagship.json").read_text())
    conf = dict(conf, name="dummy", model=dict(conf["model"], ydim=50, fused_step="on",
                                              ns_prefix=24))
    (tmp_path / "benchmark" / "configs" / "dummy.json").write_text(json.dumps(conf))
    traffic = dict(json.loads((BENCH / "traffic" / "train_b1024.json").read_text()),
                   prefix=24, **SIZES)
    (tmp_path / "benchmark" / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "dummy_span_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.trace.spans))\n")
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_steps_per_s", "unit": "steps/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["dummy.cell"]})
    spec["per_layer"].append({"name": "dummy_span_count", "unit": "spans", "better": "lower",
                              "source": "program_span", "layer": "epochs driver",
                              "moves": "dummy_steps_per_s", "workloads": ["dummy.cell"]})
    bench_path = tmp_path / "BENCHMARK.json"
    bench_path.write_text(json.dumps(spec))

    cell = cells.load("dummy.cell", bench_path)
    assert {m["name"] for m in cell.end_to_end} == {"dummy_steps_per_s", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["dummy_span_count"]
    out = run.run_cell(cell, 77, 0.05, False, torch.device("cpu"))
    assert out["correct"] and set(out["metrics"]) == {"dummy_steps_per_s", "setup_s"}
    out = run.run_cell(cell, 78, 0.05, True, torch.device("cpu"))
    assert out["correct"] and out["metrics"]["dummy_span_count"]["value"] > 0
    # the copied tree's files are the benchmark's, unchanged
    for sub in ("configs", "traffic", "metrics"):
        for p in (BENCH / sub).iterdir():
            if p.is_file():
                assert (tmp_path / "benchmark" / sub / p.name).read_bytes() == p.read_bytes()
