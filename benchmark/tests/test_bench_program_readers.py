"""The readers of the port's own spans and counters
(``program_readers.py``): each on a synthetic session, on an empty one and
on a program without the module; then a traced run of a cell cut to the
CPU's size, where every span and count is recorded but no kernel launches."""
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_tiny import tiny

import cells
import program_readers
import run
import vjf_tpu_torch.ops
from vjf_tpu_torch.ops import trace

NEW = {"launch_host_us.train": "flagship.train_b1024",
       "fallback_host_ms.train": "flagship.train_b1024",
       "prefix_glue_ms.train": "flagship.train_b1024",
       "fallback_useful_pct.train": "flagship.train_b1024",
       "mega_escalated_pct.train": "flagship.train_b1024",
       "mega_escalated_pct.prefix_free": "flagship.prefix_free"}
US = 1000                                     # ns


def session():
    """Two epochs, each a prefix of two steps (a 40 µs launch and a 30 µs
    fallback each, 300 µs in all) and one mega launch."""
    spans = []

    def add(name, start, dur, parent, epoch):
        spans.append(trace.Span(name, start * US, (start + dur) * US, parent, epoch))
        return len(spans) - 1

    for t0 in (0, 2000):
        e = len(spans)
        add("vjf.epoch", t0, 900, -1, e)
        p = add("vjf.prefix", t0 + 50, 300, e, e)
        for i in range(2):
            add("vjf.launch.fused_step", t0 + 60 + 100 * i, 40, p, e)
            add("vjf.fallback", t0 + 110 + 100 * i, 30, p, e)
        add("vjf.launch.mega_epoch", t0 + 360, 20, e, e)
    return SimpleNamespace(spans=spans, dropped=0, tau_bands=[[1, 1, 1, 1], [6, 1, 0, 1]])


def read(metric):
    return cells.reader(metric)(SimpleNamespace())


def test_readers_on_a_session(monkeypatch):
    monkeypatch.setattr(trace, "read", session)
    assert read("launch_host_us.train") == pytest.approx(40.0)
    assert read("fallback_host_ms.train") == pytest.approx(2 * 30 / 1e3)
    assert read("prefix_glue_ms.train") == pytest.approx((300 - 2 * 40 - 2 * 30) / 1e3)
    assert read("fallback_useful_pct.train") == pytest.approx(100 * 2 / 4)
    assert read("mega_escalated_pct.train") == pytest.approx(100 * 2 / 8)
    assert read("mega_escalated_pct.prefix_free") == pytest.approx(100 * 2 / 8)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_readers_find_nothing(monkeypatch, metric):
    """None on an empty session, on a session whose spans are still open,
    on one that dropped records, and where the program has no such module."""
    empty = SimpleNamespace(spans=[], dropped=0, tau_bands=[[0] * 4, [0] * 4])
    monkeypatch.setattr(trace, "read", lambda: empty)
    assert read(metric) is None
    open_ = session()
    open_.spans = [s._replace(end_ns=0) for s in open_.spans]
    open_.tau_bands = empty.tau_bands
    monkeypatch.setattr(trace, "read", lambda: open_)
    assert read(metric) is None
    full = session()
    full.dropped = 1
    monkeypatch.setattr(trace, "read", lambda: full)
    assert read(metric) is None
    monkeypatch.setitem(sys.modules, "vjf_tpu_torch.ops.trace", None)
    monkeypatch.delattr(vjf_tpu_torch.ops, "trace")
    assert program_readers._session() is None
    assert read(metric) is None


def test_traced_run_on_the_cpu():
    """The cell's new metrics come out of a traced run, all but the launch's
    (the CPU runs the plain versions, which launch nothing); every reader
    finds the session the run's window recorded."""
    cell = tiny("flagship.train_b1024")
    out = run.run_cell(cell, 2**31 + 12345, 0.05, True, torch.device("cpu"))
    assert out["correct"]
    ours = {m["name"] for m in cell.per_layer} & set(NEW)
    assert ours == {k for k, v in NEW.items() if v == cell.name}
    assert set(out["metrics"]) >= ours - {"launch_host_us.train"}
    assert "launch_host_us.train" not in out["metrics"]
    got = {m: read(m) for m in NEW}
    assert got.pop("launch_host_us.train") is None
    assert all(v is not None for v in got.values()), got
    s = trace.read()
    n_epochs = sum(1 for x in s.spans if x.name == "vjf.epoch")
    assert n_epochs == cell.traffic["trace_calls"]
    assert sum(s.tau_bands[0]) == n_epochs * cell.traffic["prefix"]
    assert sum(s.tau_bands[1]) == n_epochs * (cell.traffic["steps"] - cell.traffic["prefix"])
    assert 0.0 <= got["fallback_useful_pct.train"] <= 100.0
