"""The plain reference against the port's plain epoch (the specification
its kernels are held to, on CPU tensors) at a tiny size: the same bits.
Both follow one step at a time, so they must agree exactly; the teacher
forced reference, fed the port's reported posteriors, must give every one
of them again and the port's whole end state."""

import pytest
import torch

from bench_tiny import tiny

from reference import plain
import check
import state

from vjf_tpu_torch.config import StepFlags, VJFConfig
from vjf_tpu_torch.models import vjf as core

import gen

# the sparse-GP ring model of bench_all.py:115-155 (no cell yet, PERF.md §7):
# the whitening, the DTC term, a Gaussian likelihood, forgetting and jitter
SGP = dict(ydim=20, xdim=2, hidden_sizes=[20], likelihood="gaussian", dynamics="sgp",
           n_inducing=50, lr=1e-3, rls_shrink=0.999, chol_jitter=1e-3)
CASES = [("flagship.train_b1024", "bfloat16", {}), ("flagship.train_b1024", "float32", {}),
         ("flagship.train_b1024", "bfloat16", SGP)]
IDS = ["flagship-bf16", "flagship-f32", "sgp-bf16"]


def _setup(workload, mm, over):
    cell = tiny(workload)
    model = dict(cell.model, matmul_dtype=mm, **over)
    cfg = VJFConfig(**{**model, "hidden_sizes": tuple(model["hidden_sizes"])})
    tr = dict(cell.traffic, steps=48)
    ys = gen.make(tr, cfg.ydim, 5, "cpu")
    return model, cfg, ys, torch.zeros(ys.shape[:2] + (0,))


@pytest.mark.parametrize("workload,mm,over", CASES, ids=IDS)
def test_init_and_warm_up(workload, mm, over):
    model, cfg, ys, us = _setup(workload, mm, over)
    st0 = core.init_state(2**40 + 3, cfg, device="cpu")
    ref0 = plain.init_state(model, 2**40 + 3, "cpu")
    got0 = state.as_dict(st0)
    for k, v in ref0.items():
        for a, b in zip(*((x if isinstance(x, list) else [x]) for x in (got0[k], v))):
            assert torch.equal(a, b.reshape(a.shape)), k
    wu = core.run_epochs(cfg, StepFlags(warm_up=True), st0, ys, us, [7], [cfg.lr])
    flags = {"sgd": True, "update": True, "warm_up": True}
    q, loss, _ = plain.follow(model, flags, ref0, ys, 7, cfg.lr, 0, ys.shape[0], mm)
    assert torch.equal(q[:, 0], wu.q_means) and torch.equal(q[:, 1], wu.q_logvars)
    assert torch.allclose(loss.mean(), wu.epoch_loss[0], rtol=1e-6)
    gap, carry = plain.teacher_forced(model, flags, ref0, ys, wu.q_means, wu.q_logvars, 7,
                                      cfg.lr, 0, mm, chunk=20)
    assert gap == 0.0
    end = plain.pad(model, state.as_dict(wu.state))
    for k, v in plain.sgd_leaves(carry).items():
        assert torch.equal(v, plain.sgd_leaves(end)[k]), k


@pytest.mark.parametrize("workload,mm,over", CASES, ids=IDS)
def test_rls_epoch_follow_and_replay(workload, mm, over):
    model, cfg, ys, us = _setup(workload, mm, over)
    st0 = core.init_state(11, cfg, device="cpu")
    warm = core.run_epochs(cfg, StepFlags(warm_up=True), st0, ys, us, [3], [cfg.lr]).state
    res = core.run_epochs(cfg, StepFlags(), warm, ys, us, [4], [cfg.lr])
    start = state.as_dict(warm)
    flags = {"sgd": True, "update": True, "warm_up": False}
    q, _, carry = plain.follow(model, flags, start, ys, 4, cfg.lr, cfg.ns_prefix, ys.shape[0],
                               mm)
    assert torch.equal(q[:, 0], res.q_means) and torch.equal(q[:, 1], res.q_logvars)
    end = state.as_dict(res.state)
    gap, forced = plain.teacher_forced(model, flags, start, ys, res.q_means, res.q_logvars, 4,
                                       cfg.lr, cfg.ns_prefix, mm, chunk=20)
    assert gap == 0.0
    for k, v in plain.rls_leaves(carry).items():
        assert torch.equal(v, end[k].reshape(v.shape)), k
        assert torch.equal(plain.rls_leaves(forced)[k], end[k].reshape(v.shape)), k
    padded = plain.sgd_leaves(plain.pad(model, end))
    for k, v in plain.sgd_leaves(forced).items():
        assert torch.equal(v, padded[k]), k
    by_sgd = check.sgd_gaps(padded, plain.sgd_leaves(forced),
                            plain.sgd_leaves(plain.pad(model, start)))
    assert by_sgd and max(by_sgd.values()) == 0.0


def test_noise_is_the_kernels_philox():
    """Random123's Philox4x32-10 known-answer vector, and the step noise's
    layout: step t's draw is keyed by (seed, 0) at counter (t, i // 2)."""
    ctr = [torch.tensor(0xFFFFFFFF, dtype=torch.int64)] * 4
    key = [torch.tensor(0xFFFFFFFF, dtype=torch.int64)] * 2
    out = [int(w) for w in plain.philox(ctr, key)]
    assert out == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    e_s, e_t = plain.step_noise(9, [0, 5], 3, 2, "cpu")
    e_s5, _ = plain.step_noise(9, [5], 3, 2, "cpu")
    assert e_s.shape == (2, 3, 2) and torch.equal(e_s[1], e_s5[0])
    assert not torch.equal(e_s[0], e_t[0])


def test_fp8_products_are_coarser():
    a = torch.randn(16, 16, generator=torch.Generator().manual_seed(1))
    exact = a @ a
    err = {mm: float((plain.matmul_fn(mm)(a, a) - exact).abs().max())
           for mm in ("bfloat16", "fp8")}
    assert 0 < err["bfloat16"] < err["fp8"] / 4
