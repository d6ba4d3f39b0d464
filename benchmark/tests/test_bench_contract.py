"""BENCHMARK.json against the rules a benchmark file keeps: names, units and
keys, the cells' files, and each per-layer metric's reader and cells."""
import json
import re

import pytest

from bench_tiny import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    w = {x["name"]: x for x in SPEC["workloads"]}[cell]
    conf = {c["name"]: c for c in SPEC["configs"]}[w["config"]]
    assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and w["chips"] in (1, 4)
    path = ROOT / conf["file"]
    assert path.is_file() and path.is_relative_to(BENCH)
    assert json.loads(path.read_text())["reduced"] == conf["reduced"]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert set(traffic["limits"]) >= {"q_gap", "step_gap", "rls_gap", "sgd_gap"}
    reported = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]
                if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in reported and len(reported) >= 4


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_moves(metric):
    """Each per-layer metric has a reader, and every cell it lists reports
    the end-to-end metric it moves."""
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    assert (BENCH / "metrics" / f"{metric}.py").is_file()
    moved = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
    cells = {w["name"] for w in SPEC["workloads"]}
    assert m["workloads"] and set(m["workloads"]) <= cells
    for cell in m["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_layers_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"epochs driver", "prefix", "kernels", "whole step", "device"}
