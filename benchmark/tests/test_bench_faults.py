"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, ``correct`` comes out true; with the timed path broken
underneath (``faults.py``), false, once for each fault a one-chip cell can
have."""
import contextlib

import pytest
import torch

from bench_tiny import tiny

import faults
import run

CELLS = ["flagship.prefix_free", "flagship.train_b1024"]


def _run(workload, fault=None, monkeypatch=None):
    if fault is not None:
        window = run.window

        def broken(*args, **kw):
            with faults.planted(fault):
                return window(*args, **kw)

        monkeypatch.setattr(run, "window", broken)
    return run.run_cell(tiny(workload), 2**34 + 1, 0.05, False, torch.device("cpu"))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"] and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in out["check"].values())


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_caught(workload, fault, monkeypatch):
    out = _run(workload, fault, monkeypatch)
    assert not out["correct"], out["check"]


def test_changed_warmed_state_is_caught(monkeypatch):
    """A call that writes into the state it was given fails the digest."""
    import vjf_tpu_torch.models.vjf as mv

    orig = mv.run_epochs

    def writes(cfg, flags, state, *args, **kw):
        with contextlib.suppress(AttributeError):
            state.dynamics.blr.w_mean.add_(1e-3)
        return orig(cfg, flags, state, *args, **kw)

    window = run.window

    def broken(*args, **kw):
        monkeypatch.setattr(mv, "run_epochs", writes)
        try:
            return window(*args, **kw)
        finally:
            monkeypatch.setattr(mv, "run_epochs", orig)

    monkeypatch.setattr(run, "window", broken)
    out = run.run_cell(tiny("flagship.prefix_free"), 9, 0.05, False, torch.device("cpu"))
    assert out["check"]["warmed_state_changed"]["value"] == 1.0 and not out["correct"]
