"""The port's plain fused step (``step_math`` + ``exact_v_fallback``) against
the JAX package's on the same numpy inputs, and the state carried across."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.config import StepFlags, VJFConfig
from vjf_tpu.models import vjf as jcore
from vjf_tpu.ops.pallas import fused_step as JF
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.ops import fused_step as TF

torch.set_num_threads(1)

FLAG_CASES = [
    StepFlags(),
    StepFlags(warm_up=True),
    StepFlags(sgd=False),
    StepFlags(update=False),
    StepFlags(train_decoder=False),
]
B = 8
# float64: the same algorithm in the same order, so rounding alone differs;
# float32: the tolerance of tests/test_fused_step.py (the fused step vs the
# XLA step) -- summation orders differ and the exact fallback's Cholesky
# amplifies them by cond(P); bf16 products: one rounded input can land on
# the other side of a bf16 tie when its f32 value differs in the last bit
TOL = {"float64": 1e-9, "float32": 2e-4, "bf16": 2e-3}


def _port(flags):
    return tcfg.StepFlags(**dataclasses.asdict(flags))


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _inputs(likelihood, dtype, seed=0):
    rng = np.random.default_rng(seed)
    npdt = np.dtype(dtype)
    y = (rng.poisson(1.0, (B, 20)) if likelihood == "poisson"
         else rng.normal(size=(B, 20))).astype(npdt)
    eps = rng.normal(size=(2, B, 3)).astype(npdt)
    q = (0.3 * rng.normal(size=(2, B, 3))).astype(npdt)
    return y, eps, q


def _case(likelihood, dtype, flags, matmul="float32"):
    """(JAX StepOut after the fallback, port StepOut after the fallback)."""
    cfg = VJFConfig(ydim=20, xdim=3, n_rbf=30, hidden_sizes=(16,), likelihood=likelihood,
                    dtype=dtype, rls_backend="nsv", fused_step="off", matmul_dtype=matmul)
    state = jcore.init_state(jax.random.PRNGKey(0), cfg)
    y, eps, q = _inputs(likelihood, dtype)
    lr = 1e-3
    carry = JF.pad_carry(cfg, state)
    ref = JF.step_math(cfg, flags, carry, jnp.asarray(q[0]), jnp.asarray(q[1]),
                       jnp.asarray(y), None, jnp.asarray(eps[0]), jnp.asarray(eps[1]),
                       jnp.asarray(lr, dtype))
    tc = _port_cfg(cfg)
    tstate = convert.state_from_numpy(tc, jax.tree.map(np.asarray, state), device="cpu")
    tcarry = TF.pad_carry(tc, tstate)
    t = torch.tensor
    got = TF.step_math(tc, _port(flags), tcarry, t(q[0]), t(q[1]), t(y), None, t(eps[0]),
                       t(eps[1]), t(lr, dtype=tc.tdtype))
    if flags.update and not flags.warm_up:
        ref = JF.exact_v_fallback(cfg, ref, carry, None)
        got = TF.exact_v_fallback(tc, got, tcarry, None)
    return ref, got


def _compare(ref, got, tol):
    """Every carry leaf, the posterior, g_vec, xt, xs and the scalar pack."""
    a = convert.flatten(jax.tree.map(np.asarray, ref))
    b = convert.flatten({k: v for k, v in got._asdict().items()})
    b = {k: v.numpy() for k, v in b.items()}
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k].astype(np.float64), a[k].astype(np.float64),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def cases():
    """Every JAX reference of this module, computed once."""
    out = {}
    for dtype in ("float64", "float32"):
        for lik in ("poisson", "gaussian"):
            for i, flags in enumerate(FLAG_CASES):
                out[dtype, lik, i] = _case(lik, dtype, flags)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("likelihood", ["poisson", "gaussian"])
@pytest.mark.parametrize("flag_idx", range(len(FLAG_CASES)),
                         ids=[str(f) for f in FLAG_CASES])
def test_step_math_matches_jax(cases, dtype, likelihood, flag_idx):
    ref, got = cases[dtype, likelihood, flag_idx]
    _compare(ref, got, TOL[dtype])


def test_step_math_bf16_products_match_jax():
    ref, got = _case("poisson", "float32", StepFlags(), matmul="bfloat16")
    _compare(ref, got, TOL["bf16"])
    # and the bf16 mode really differs from the f32 one
    _, f32 = _case("poisson", "float32", StepFlags())
    assert not torch.equal(f32.qt_mean, got.qt_mean)


def test_state_and_carry_round_trip_exactly():
    cfg = VJFConfig(ydim=20, xdim=3, udim=2, n_rbf=30, hidden_sizes=(16, 8),
                    likelihood="gaussian", dtype="float32", rls_backend="nsv")
    state = jcore.init_state(jax.random.PRNGKey(1), cfg)
    tree = jax.tree.map(np.asarray, state)
    tc = _port_cfg(cfg)
    tstate = convert.state_from_numpy(tc, tree, device="cpu")
    a = convert.flatten(tree)
    b = convert.flatten(convert.state_to_numpy(tstate))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # pad -> unpad is the identity, and the pad matches the JAX pad exactly
    carry = TF.pad_carry(tc, tstate)
    jcarry = convert.flatten(jax.tree.map(np.asarray, JF.pad_carry(cfg, state)))
    tcarry = convert.flatten(carry._asdict())
    assert jcarry.keys() == tcarry.keys()
    for k in jcarry:
        if k == "c2":   # a 5-term sum of squares, reduced in another order: 1 ulp
            np.testing.assert_allclose(tcarry[k].numpy(), jcarry[k], rtol=3e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(tcarry[k].numpy(), jcarry[k], err_msg=k)
    back = convert.flatten(convert.state_to_numpy(TF.unpad_carry(tc, carry, tstate)))
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)


# The rule the fallback kernel (csrc/exact_fallback.cu) is held to: which tau
# takes the exact branch, and that each gate keeps the step's leaves.
FALLBACK_CASES = {
    "below": (0.2499, None), "at": (0.25, None), "above": (0.4, None),
    "inf": (float("inf"), None), "nan": (float("nan"), None),
    "gate_info": (0.4, "not_pd"), "gate_finite_w": (0.4, "w_inf"),
    "gate_finite_var": (0.4, "var_inf"),
}


def _fallback_inputs(tau, gate):
    """``chip_smoke.fallback_case``'s operands at 30 features and B trials in
    float64 (a step's output and the pre-step snapshot: P symmetric positive
    definite, one eigenvalue -1 under ``not_pd``; g = P w; the pre-step
    log-variance at 1e30 under ``var_inf``), and the exact w they imply."""
    import chip_smoke

    cfg, out, prev, _, _ = chip_smoke.fallback_case((30, B, False, 0, False), (tau,), "cpu",
                                                    5, gate=gate)
    out, prev = chip_smoke.as_f64(out), chip_smoke.as_f64(prev)
    w = torch.linalg.solve(out.carry.p_mat, out.g_vec)
    return cfg.replace(dtype="float64"), out, prev, w


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_exact_fallback_branch_and_gates(case):
    """The exact branch is taken where tau >= NS_TAU_THRESHOLD, inf or NaN
    (exactly the steps ``tau_band_counts`` puts in its two upper bands), and
    there it replaces V, w, the state log-variance and its count with the
    exact values; below the threshold, or where the factorisation fails, w
    or the variance is not finite, the four leaves keep their bits."""
    tau, gate = FALLBACK_CASES[case]
    tc, out, prev, w = _fallback_inputs(tau, gate)
    got = TF.exact_v_fallback(tc, out, prev, None).carry
    assert convert.flatten(got._asdict()).keys() == convert.flatten(out.carry._asdict()).keys()
    taken = not tau < TF.NS_TAU_THRESHOLD
    bands = TF.tau_band_counts(out.scal[..., 4]).tolist()
    assert sum(bands[2:]) == int(taken) and sum(bands) == 1
    leaves = ("v_mat", "w_dyn", "state_logvar", "dyn_n")
    if not taken or gate is not None:
        for k in leaves:
            assert torch.equal(getattr(got, k), getattr(out.carry, k)), k
        return
    np.testing.assert_allclose(got.v_mat.numpy(), torch.linalg.inv(out.carry.p_mat).numpy(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.w_dyn.numpy(), w.numpy(), rtol=1e-9, atol=1e-9)
    n = min(float(prev.dyn_n), tc.state_var_cap)
    assert float(got.dyn_n) == n + B
    resid = float(torch.mean(((out.xt - out.xs) - _features(got, out.xs) @ got.w_dyn) ** 2))
    var = n / (n + B) * math.exp(float(prev.state_logvar)) + B / (n + B) * resid
    assert float(got.state_logvar) == pytest.approx(math.log(var), rel=1e-12)


def _features(carry, xs):
    d2 = torch.clamp(torch.sum(xs * xs, -1, keepdim=True) + carry.c2 - 2.0 * xs @ carry.cent_x.T,
                     min=0.0)
    return torch.exp(-0.5 * d2 * carry.inv_w2)
