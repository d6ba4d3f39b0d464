"""The port's own instrumentation (``vjf_tpu_torch/ops/trace.py``): spans
and tau-band counts recorded while a ``torch.profiler`` session runs, and
nothing otherwise; the launch counters beside them. The fused epoch runs
through the kernels' plain versions (``fused_step='on'`` on the CPU)."""
import json
import math

import numpy as np
import pytest
import torch

from vjf_tpu_torch import convert
from vjf_tpu_torch.config import StepFlags, VJFConfig
from vjf_tpu_torch.models import vjf as core
from vjf_tpu_torch.ops import fused_step as F
from vjf_tpu_torch.ops import trace

torch.set_num_threads(1)

T, B, PREFIX = 32, 8, 8
CFG = VJFConfig(ydim=20, xdim=3, udim=2, n_rbf=30, hidden_sizes=(16, 8), likelihood="poisson",
                dtype="float32", rls_backend="nsv", fused_step="on", matmul_dtype="float32",
                ns_prefix=PREFIX)


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with no session (and zero launch counts)."""
    trace.reset_launches()
    yield
    trace.reset_launches()


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(0)
    ys = torch.poisson(torch.ones(T, B, CFG.ydim, dtype=torch.float32), generator=g)
    us = torch.randn(T, B, CFG.udim, generator=g, dtype=torch.float32)
    return core.init_state(0, CFG, device="cpu"), ys, us


def epoch(inputs, seed=3):
    st, ys, us = inputs
    return core.run_epoch(CFG, StepFlags(), st, ys, us, seed, 1e-3)


def profiled(fn, path=None):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def outputs(res):
    leaves = convert.flatten(convert.state_to_numpy(res.state))
    leaves.update(q_means=res.q_means.numpy(), q_logvars=res.q_logvars.numpy(),
                  **{f"metrics.{k}": v.numpy() for k, v in res.metrics._asdict().items()
                     if v is not None})
    return leaves


def test_off_records_nothing(inputs, monkeypatch):
    """With no profiler active a span enters no ``record_function`` and
    the epoch records nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("vjf.epoch") is trace.NULL
    assert trace.tau_bands("cpu") is None
    epoch(inputs)
    s = trace.read()
    assert s.spans == [] and s.dropped == 0 and s.tau_bands == [[0] * 4, [0] * 4]


def test_on_records_the_epoch_on_the_trace_clock(inputs, tmp_path):
    """One ``vjf.epoch`` holds one ``vjf.prefix``, which holds the eight
    ``vjf.fallback`` calls; each record is a ``user_annotation`` event of the
    chrome trace, its start within 1 ms of the event's ``ts``."""
    path = tmp_path / "trace.json"
    res = profiled(lambda: epoch(inputs), path)
    s = trace.read()
    names = [x.name for x in s.spans]
    assert names == ["vjf.epoch", "vjf.prefix"] + ["vjf.fallback"] * PREFIX
    assert [x.parent for x in s.spans] == [-1, 0] + [1] * PREFIX
    assert all(x.epoch == 0 for x in s.spans)
    for x in s.spans:
        assert 0 < x.start_ns <= x.end_ns
        if x.parent >= 0:
            p = s.spans[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns

    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    events = sorted((e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("vjf.")), key=lambda e: e["ts"])
    assert [e["name"] for e in events] == names
    for x, e in zip(s.spans, events):
        assert abs((x.start_ns - base) / 1e3 - e["ts"]) < 1e3, (x, e)

    bands = s.tau_bands
    assert sum(bands[0]) == PREFIX and sum(bands[1]) == T - PREFIX
    tau = res.metrics.tau
    assert bands[0][2] + bands[0][3] == int(((tau[:PREFIX] >= F.NS_TAU_THRESHOLD)
                                            | ~torch.isfinite(tau[:PREFIX])).sum())
    assert bands[1] == F.tau_band_counts(tau[PREFIX:]).tolist()


def test_ensemble_counts_every_member(inputs):
    """An ensemble epoch (a list of states, one launch for all members)
    adds each member's steps to its row."""
    st, ys, us = inputs
    res = profiled(lambda: F.run_epoch_fused(CFG, StepFlags(), [st, st], ys, us, [3, 4], 1e-3))
    bands = trace.read().tau_bands
    assert sum(bands[0]) == 2 * PREFIX and sum(bands[1]) == 2 * (T - PREFIX)
    assert bands[1] == F.tau_band_counts(res.metrics.tau[:, PREFIX:]).tolist()


def test_second_session_starts_empty(inputs):
    """A profiler session after calls with none active reads only its own
    epoch; so does one after ``reset_launches``. Two sessions with no call
    between them read as one window."""
    profiled(lambda: epoch(inputs))
    profiled(lambda: epoch(inputs))
    assert [x.name for x in trace.read().spans].count("vjf.epoch") == 2
    epoch(inputs)
    profiled(lambda: epoch(inputs))
    s = trace.read()
    assert [x.name for x in s.spans].count("vjf.epoch") == 1
    assert sum(map(sum, s.tau_bands)) == T
    trace.reset_launches()
    profiled(lambda: epoch(inputs))
    assert [x.name for x in trace.read().spans].count("vjf.epoch") == 1


def test_outputs_equal_on_and_off(inputs):
    off = outputs(epoch(inputs))
    on = outputs(profiled(lambda: epoch(inputs)))
    assert off.keys() == on.keys()
    for k in off:
        assert np.array_equal(off[k], on[k], equal_nan=True), k


def test_tau_bands_edges():
    """A tau at a threshold falls in the band above it; NaN and inf in the
    last; the counts sum over every axis (steps and members)."""
    inf, nan = math.inf, math.nan
    tau = torch.tensor([[0.0, 0.049, F.NS_TAU_ESCALATE, 0.2, F.NS_TAU_THRESHOLD],
                        [0.69, F.NS_TAU_MAX, 3.0, inf, nan]])
    assert F.tau_band_counts(tau).tolist() == [2, 2, 2, 4]
    assert F.tau_band_counts(tau[:, :0]).tolist() == [0, 0, 0, 0]


def test_reset_clears_and_counters_count(inputs):
    """``reset_launches`` zeros the launch counters and clears the session;
    the counters are the port's, shared with ``ops.fused_step``, and a
    launch still counts by form."""
    assert F.launches is trace.launches and F.steps is trace.steps
    assert F.reset_launches is trace.reset_launches
    profiled(lambda: epoch(inputs))
    assert trace.read().spans
    carry = F.pad_carry(CFG, inputs[0])
    F._count("fused_step", carry, 1)
    F._count("mega_epoch", carry, T - PREFIX)
    F._count("fused_step", F.stack_carries([carry, carry]), 1)
    assert F.launches == {**dict.fromkeys(F.launches, 0), "fused_step": 1, "mega_epoch": 1,
                          "fused_step.ensemble": 1}
    assert F.steps == {**dict.fromkeys(F.steps, 0), "fused_step": 1,
                       "mega_epoch": T - PREFIX, "fused_step.ensemble": 2}
    trace.reset_launches()
    assert set(F.launches.values()) == {0} and set(F.steps.values()) == {0}
    s = trace.read()
    assert s.spans == [] and s.tau_bands == [[0] * 4, [0] * 4]
    # the CPU epoch launches no kernel, so it adds to no counter
    epoch(inputs)
    assert set(F.launches.values()) == {0}


def test_capacity_drops_and_counts(monkeypatch):
    """Past ``CAPACITY`` records a span is counted as dropped, its
    ``record_function`` still entered."""
    monkeypatch.setattr(trace, "CAPACITY", 2)

    def spans():
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
        with trace.span("d"):
            pass

    profiled(spans)
    s = trace.read()
    assert [(x.name, x.parent) for x in s.spans] == [("a", -1), ("b", 0)]
    assert s.dropped == 2 and all(x.end_ns for x in s.spans)


@pytest.mark.parametrize("prefix", [1, PREFIX])
def test_prefix_calls_the_fallback_by_attribute(inputs, monkeypatch, prefix):
    """A prefix of n steps calls ``exact_v_fallback`` through the module
    attribute (what the benchmark's wrapper replaces) n times, each call
    one ``vjf.fallback`` span inside ``vjf.prefix``."""
    calls = []
    own = F.exact_v_fallback

    def counted(*a, **k):
        calls.append(1)
        return own(*a, **k)

    monkeypatch.setattr(F, "exact_v_fallback", counted)
    st, ys, us = inputs
    profiled(lambda: core.run_epoch(CFG.replace(ns_prefix=prefix), StepFlags(), st, ys, us, 3,
                                    1e-3))
    spans = trace.read().spans
    fallbacks = [x for x in spans if x.name == "vjf.fallback"]
    assert len(calls) == prefix and len(fallbacks) == prefix
    assert all(spans[x.parent].name == "vjf.prefix" for x in fallbacks)
