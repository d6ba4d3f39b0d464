"""The port's sparse-GP dynamics (``vjf_tpu_torch/gp``) against the JAX
package's ``vjf_tpu/gp`` on the same numpy inputs: the covariance functions,
the whitener, the transition interface, hyperparameter adaptation, the SGP
``filter_step``, the plain fused SGP step and epoch, per-epoch ``fit`` with
adaptation, the sharded SGP epoch at world size 1, and the routing of shapes
the kernels refuse. Random draws the JAX side takes from a key are injected
on both sides."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from vjf_tpu.config import StepFlags, VJFConfig
from vjf_tpu.gp import covfun as jcov
from vjf_tpu.gp import sgp as jsgp
from vjf_tpu.models import regression as jreg
from vjf_tpu.models import vjf as jcore
from vjf_tpu.ops.pallas import fused_step as JF
from vjf_tpu.types import Gaussian as JG
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.gp import covfun as tcov
from vjf_tpu_torch.gp import sgp as tsgp
from vjf_tpu_torch.models import dynamics as tdyn
from vjf_tpu_torch.models import regression as treg
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF

import torch_tile_plan as TP
from vjf_tpu_torch.ops.functional import all_finite
from vjf_tpu_torch.parallel import make_dp_group, run_epoch_fused_sharded
from vjf_tpu_torch.types import Gaussian as TG

torch.set_num_threads(1)

# float64, the same formula: rounding alone differs, grown through the
# kernel matrices' conditioning
TOL = dict(rtol=1e-9, atol=1e-9)
# through one eigh (the whitener): relative to the norm of the result
EIGH_TOL = 1e-8
# the JAX running variance of the state noise divides its int32 counter in
# float32 even under x64; the port weighs in the value's dtype (ROADMAP
# Queue 3, as in tests/test_torch_functional.py)
LOGVAR_TOL = dict(rtol=1e-6, atol=1e-7)
B, XD, UD, M = 6, 2, 1, 12


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=name, **tol)


def close_norm(got, want, rel=EIGH_TOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want), 1e-300), name


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _cfg(**kw):
    base = dict(ydim=6, xdim=XD, udim=UD, dynamics="sgp", n_inducing=M, sgp_scale=1.3,
                sgp_lengthscale=0.9, dtype="float64", rls_backend="nsv",
                rls_shrink=0.995, chol_jitter=1e-3, leak=0.1)
    base.update(kw)
    return VJFConfig(**base)


# the JAX references, each compiled once (eager JAX compiles every primitive)
_j_init_state = jax.jit(jcore.init_state, static_argnames=("cfg", "backend", "batch_hint"))
_j_adapt = jax.jit(jsgp.adapt_hyperparams, static_argnames=("cfg", "lr", "n_steps"))


def _to_port(js):
    """The port's SGPDynamicsState from a JAX one (float64, CPU)."""
    a = jax.tree.map(np.asarray, js)
    return tsgp.SGPDynamicsState(
        inducing=_t(a.inducing), whiten=_t(a.whiten), whiten_inv=_t(a.whiten_inv),
        log_scale=_t(a.log_scale), log_lengthscale=_t(a.log_lengthscale),
        blr=treg.NSVBLR(_t(a.blr.w_mean), _t(a.blr.precision), _t(a.blr.cov)),
        logvar=_t(a.logvar), n_sample=torch.tensor(int(a.n_sample), dtype=torch.int32))


def _sgp_pair(seed=0, trained=True):
    """(JAX state, port state, cfg): a fresh SGP state, with ``trained`` one
    RLS update on a short pooled trajectory so that the posterior is not the
    prior."""
    cfg = _cfg()
    js = jsgp.init_sgp_dynamics(jax.random.PRNGKey(seed), cfg)
    if trained:
        r = np.random.default_rng(seed + 100)
        xs, u = r.normal(size=(40, XD)), r.normal(size=(40, UD))
        xt = xs + 0.2 * np.sin(2 * xs[:, ::-1]) + 0.05 * r.normal(size=(40, XD))
        js = jsgp.dynamics_update(cfg, js, xt, xs, u)
    return js, _to_port(js), cfg


def _sgp_close(got, want, tol=TOL):
    for name in ("inducing", "whiten", "whiten_inv", "log_scale", "log_lengthscale"):
        close(getattr(got, name), getattr(want, name), tol, name)
    for name, a, b in zip(want.blr._fields, got.blr, want.blr):
        close(a, b, tol, name)
    close(got.logvar, want.logvar, LOGVAR_TOL, "logvar")
    assert int(got.n_sample) == int(want.n_sample)


# ---------------------------------------------------------------------------
# covfun and the whitener
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["SquaredExponential", "Matern52"])
def test_covariance_functions(name):
    r = np.random.default_rng(1)
    x1, x2 = r.normal(size=(7, 3)), r.normal(size=(5, 3))
    jk, tk = getattr(jcov, name)(1.4, 0.7), getattr(tcov, name)(1.4, 0.7)
    close(tk(_t(x1), _t(x2)), jk(x1, x2))
    close(tk(_t(x1[0]), _t(x2)), jk(x1[0], x2))
    close(tk.diag(_t(x1)), jk.diag(x1))
    close(tcov._sqdist(_t(x1), _t(x2)), jcov._sqdist(x1, x2))


@pytest.mark.parametrize("lengthscale", [0.5, 3.0])
def test_whiten_matrices(lengthscale):
    """One eigh with the relative floor; a long lengthscale makes K_zz
    numerically low-rank, so the floor binds."""
    r = np.random.default_rng(2)
    z = r.uniform(-2, 2, size=(M, XD))
    kzz = np.asarray(jcov.SquaredExponential(1.0, lengthscale)(z, z)) + 1e-6 * np.eye(M)
    jw, jwi = jsgp.whiten_matrices(jnp.asarray(kzz))
    tw, twi = tsgp.whiten_matrices(_t(kzz))
    close_norm(tw, jw, name="whiten")
    close_norm(twi, jwi, name="whiten_inv")
    np.testing.assert_allclose((tw @ twi).numpy(), np.eye(M), atol=1e-8)
    assert tsgp._jitter(torch.float64) == jsgp._jitter(jnp.float64)
    assert tsgp._jitter(torch.float32) == jsgp._jitter(jnp.float32)


def test_init_sgp_dynamics():
    """Inducing points U[-2, 2) from a seed or the same CPU generator, the
    whitener of K_zz + jitter, the nsv prior; the precision and covariance
    backends build their own prior."""
    tc = _port_cfg(_cfg())
    st = tsgp.init_sgp_dynamics(4, tc, device="cpu")
    assert st.inducing.shape == (M, XD + UD) and st.inducing.abs().max() <= 2.0
    same = tsgp.init_sgp_dynamics(torch.Generator().manual_seed(4), tc, device="cpu")
    assert torch.equal(st.inducing, same.inducing)
    kzz = tcov.SquaredExponential(1.3, 0.9)(st.inducing, st.inducing)
    kzz = kzz + 1e-6 * torch.eye(M, dtype=torch.float64)
    w, w_inv = tsgp.whiten_matrices(kzz)
    assert torch.equal(st.whiten, w) and torch.equal(st.whiten_inv, w_inv)
    close(st.log_scale, np.log(1.3))
    close(st.log_lengthscale, np.log(0.9))
    assert torch.equal(st.blr.precision, torch.eye(M, dtype=torch.float64))
    assert st.n_sample.dtype == torch.int32 and int(st.n_sample) == 0
    for backend, kind in (("precision", treg.PrecisionBLR), ("covariance", treg.CovarianceBLR)):
        other = tsgp.init_sgp_dynamics(4, tc.replace(rls_backend=backend, chol_jitter=0.0),
                                       device="cpu")
        assert type(other.blr) is kind and torch.equal(other.inducing, st.inducing)


# ---------------------------------------------------------------------------
# the transition interface
# ---------------------------------------------------------------------------


def test_features_predict_and_transition():
    js, ts, _ = _sgp_pair(5)
    r = np.random.default_rng(6)
    x, u = r.normal(size=(B, XD)), r.normal(size=(B, UD))
    close(tsgp._se_kernel(_t(x), ts.inducing[:, :XD], ts.log_scale, ts.log_lengthscale),
          jsgp._se_kernel(x, js.inducing[:, :XD], js.log_scale, js.log_lengthscale))
    feat_t, feat_j = tsgp.features(ts, _t(x), _t(u)), jsgp.features(js, x, u)
    close(feat_t, feat_j)
    g_t = tsgp.predict_from_features(ts, _t(x), feat_t, 0.1)
    g_j = jsgp.predict_from_features(js, x, feat_j, 0.1)
    close(g_t.mean, g_j.mean)
    close(g_t.logvar, g_j.logvar)
    g_t, g_j = tsgp.transition_gaussian(ts, _t(x), _t(u), 0.1), jsgp.transition_gaussian(
        js, x, u, 0.1)
    close(g_t.mean, g_j.mean)
    close(g_t.logvar, g_j.logvar)
    # the DTC term is what keeps the variance away from phi V phi^T
    fvf = torch.sum((feat_t @ ts.blr.cov) * feat_t, dim=-1)
    assert bool((torch.exp(g_t.logvar[:, 0]) > fvf).all())
    qm, ql = r.normal(size=(2, B, XD))
    for quirk in (True, False):
        close(tsgp.dynamics_loss(ts, TG(g_t.mean, g_t.logvar), TG(_t(qm), _t(ql)), quirk),
              jsgp.dynamics_loss(js, g_j, JG(qm, ql), quirk))


@pytest.mark.parametrize("warm_up", [False, True])
def test_update_from_features_and_dynamics_update(warm_up):
    js, ts, cfg = _sgp_pair(7)
    tc = _port_cfg(cfg)
    r = np.random.default_rng(8)
    xs, xt, u = r.normal(size=(B, XD)), r.normal(size=(B, XD)), r.normal(size=(B, UD))
    feat = np.asarray(jsgp.features(js, xs, u))
    _sgp_close(tsgp.update_from_features(tc, ts, _t(xt), _t(xs), _t(feat), warm_up=warm_up),
               jsgp.update_from_features(cfg, js, xt, xs, feat, warm_up=warm_up))
    _sgp_close(tsgp.dynamics_update(tc, ts, _t(xt), _t(xs), _t(u), warm_up=warm_up),
               jsgp.dynamics_update(cfg, js, xt, xs, u, warm_up=warm_up))


def _patched_uniform(unit):
    """A stand-in for ``jax.random.uniform`` that returns the injected unit
    draw, scaled to [minval, maxval)."""
    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return minval + (maxval - minval) * jnp.asarray(unit, dtype)
    return uniform


def test_dynamics_initialize_with_injected_draw(monkeypatch):
    js, ts, cfg = _sgp_pair(9, trained=False)
    r = np.random.default_rng(10)
    xs, u = r.normal(size=(50, XD)), r.normal(size=(50, UD))
    xt = xs + 0.1 * np.tanh(xs[:, ::-1]) + 0.02 * r.normal(size=(50, XD))
    unit = r.uniform(size=(M, XD + UD))
    monkeypatch.setattr(jax.random, "uniform", _patched_uniform(unit))
    want = jsgp.dynamics_initialize(cfg, jax.random.PRNGKey(0), js, xt, xs, u)
    monkeypatch.undo()
    got = tsgp.dynamics_initialize(_port_cfg(cfg), None, ts, _t(xt), _t(xs), _t(u),
                                   unit=_t(unit))
    close(got.inducing, want.inducing)
    for name in ("whiten", "whiten_inv"):
        close_norm(getattr(got, name), getattr(want, name), name=name)
    for name, a, b in zip(want.blr._fields, got.blr, want.blr):
        close_norm(a, b, name=name)
    close(got.logvar, want.logvar, dict(rtol=1e-8, atol=0.0))
    drawn = tsgp.dynamics_initialize(_port_cfg(cfg), torch.Generator().manual_seed(1), ts,
                                     _t(xt), _t(xs), _t(u))
    assert torch.isfinite(drawn.blr.w_mean).all() and not torch.equal(drawn.inducing,
                                                                       got.inducing)


@pytest.mark.parametrize("noise", [False, True])
def test_forecast_with_injected_draws(noise):
    """The rollout against the JAX package's features and weight square
    root stepped with the same draws (the JAX rollout draws from its key)."""
    js, ts, _ = _sgp_pair(11)
    r = np.random.default_rng(12)
    n_step = 6
    x0, us = r.normal(size=(B, XD)), r.normal(size=(n_step, B, UD))
    eps_w, eps_n = r.normal(size=(n_step, M, XD)), r.normal(size=(n_step, B, XD))
    got = tsgp.forecast(ts, _t(x0), None, n_step, u=_t(us), noise=noise, leak=0.1,
                        draws=(_t(eps_w), _t(eps_n)))
    s = np.asarray(jreg.weight_sqrt(js.blr))
    x, want = x0, [x0]
    for t in range(n_step):
        w = np.asarray(js.blr.w_mean) + s @ eps_w[t]
        x = 0.9 * x + np.asarray(jsgp.features(js, x, us[t])) @ w
        if noise:
            x = x + eps_n[t] * np.exp(0.5 * float(js.logvar))
        want.append(x)
    close(got, np.stack(want))
    drawn = tsgp.forecast(ts, _t(x0), torch.Generator().manual_seed(1), n_step, u=_t(us))
    assert drawn.shape == (n_step + 1, B, XD) and torch.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# hyperparameter adaptation
# ---------------------------------------------------------------------------


def _adapt_data(seed=13, n=120):
    r = np.random.default_rng(seed)
    xs, u = r.uniform(-2, 2, size=(n, XD)), r.normal(size=(n, UD))
    xt = xs + 0.3 * np.sin(3.0 * xs) + 0.02 * r.normal(size=(n, XD))
    return xs, xt, u


def test_hyperparam_nll_and_its_gradient():
    js, ts, _ = _sgp_pair(14)
    xs, xt, u = _adapt_data()
    xu, dx = np.concatenate([xs, u], axis=1), xt - xs
    theta = (0.2, -0.3)
    want, g_want = jax.jit(jax.value_and_grad(lambda th: jsgp.hyperparam_nll(js, th, xu, dx)))(
        tuple(jnp.asarray(v) for v in theta))
    th = tuple(torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in theta)
    got = tsgp.hyperparam_nll(ts, th, _t(xu), _t(dx))
    g_got = torch.autograd.grad(got, th)
    close(got.detach(), want)
    close(torch.stack(g_got), np.stack([np.asarray(g) for g in g_want]))


def test_adapt_hyperparams_matches_jax():
    js, ts, cfg = _sgp_pair(15)
    cfg = cfg.replace(sgp_adapt_lr=0.05, sgp_adapt_steps=3)
    xs, xt, u = _adapt_data(16)
    want = _j_adapt(cfg, js, xt, xs, u)
    got = tsgp.adapt_hyperparams(_port_cfg(cfg), ts, _t(xt), _t(xs), _t(u))
    assert float(got.log_lengthscale) != float(ts.log_lengthscale), "nothing adapted"
    close(got.log_scale, want.log_scale)
    close(got.log_lengthscale, want.log_lengthscale)
    close(got.inducing, want.inducing)
    for name in ("whiten", "whiten_inv"):
        close_norm(getattr(got, name), getattr(want, name), name=name)
    for name, a, b in zip(want.blr._fields, got.blr, want.blr):
        close_norm(a, b, name=name)


def test_adapt_reprojection_preserves_the_posterior_at_z():
    """Port of tests/test_gp.py's reprojection property: with zero steps the
    reprojection is the identity; with a hyperparameter change the posterior
    mean at the inducing points, f(Z) = W^-1 v, is kept."""
    cfg = _port_cfg(VJFConfig(ydim=8, xdim=2, udim=0, dynamics="sgp", n_inducing=12,
                              sgp_lengthscale=0.8, dtype="float64", rls_backend="nsv",
                              sgp_adapt_lr=0.05, sgp_adapt_steps=3))
    state = tsgp.init_sgp_dynamics(0, cfg, device="cpu")
    r = np.random.default_rng(5)
    xs = _t(r.normal(size=(100, 2)))
    xt = xs + 0.1 * (-xs)
    state = tsgp.dynamics_update(cfg, state, xt, xs)
    same = tsgp.adapt_hyperparams(cfg, state, xt, xs, n_steps=0)
    np.testing.assert_allclose(same.blr.w_mean.numpy(), state.blr.w_mean.numpy(), rtol=1e-9)
    new = tsgp.adapt_hyperparams(cfg, state, xt, xs)
    assert float(new.log_lengthscale) != float(state.log_lengthscale)
    np.testing.assert_allclose((new.whiten_inv @ new.blr.w_mean).numpy(),
                               (state.whiten_inv @ state.blr.w_mean).numpy(),
                               rtol=1e-8, atol=1e-10)
    # P' V' stays the identity: P' = A^-T P A^-1 and V' = A V A^T
    np.testing.assert_allclose((new.blr.precision @ new.blr.cov).numpy(),
                               (state.blr.precision @ state.blr.cov).numpy(), atol=1e-6)


def test_adapt_skips_steps_whose_gradient_is_not_finite():
    """A non-finite target makes every gradient non-finite: each step is
    skipped, the hyperparameters stay where they were, and the reprojection
    through A = W W^-1 (the identity up to rounding) keeps a finite state,
    as in the JAX package."""
    js, ts, cfg = _sgp_pair(17)
    cfg = cfg.replace(sgp_adapt_lr=0.05)
    xs, xt, u = _adapt_data(18)
    xt = xt.copy()
    xt[3, 0] = np.inf
    want = _j_adapt(cfg, js, xt, xs, u)
    got = tsgp.adapt_hyperparams(_port_cfg(cfg), ts, _t(xt), _t(xs), _t(u))
    assert torch.equal(got.log_scale, ts.log_scale)
    assert torch.equal(got.log_lengthscale, ts.log_lengthscale)
    assert float(want.log_lengthscale) == float(js.log_lengthscale)
    for name, a, b in zip(want.blr._fields, got.blr, want.blr):
        close_norm(a, b, name=name)
    assert bool(all_finite(got))


# ---------------------------------------------------------------------------
# the SGP step, the plain fused step and the fused epoch
# ---------------------------------------------------------------------------


def _state_pair(cfg, seed=0):
    state = _j_init_state(jax.random.PRNGKey(seed), cfg)
    tc = _port_cfg(cfg)
    return state, tc, convert.state_from_numpy(tc, jax.tree.map(np.asarray, state),
                                               device="cpu")


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
def test_filter_step_matches_jax(likelihood):
    cfg = VJFConfig(ydim=10, xdim=2, udim=1, dynamics="sgp", n_inducing=14, sgp_scale=1.2,
                    sgp_lengthscale=0.8, hidden_sizes=(8,), likelihood=likelihood,
                    dtype="float64", rls_backend="nsv", fused_step="off")
    state, tc, tstate = _state_pair(cfg, 1)
    r = np.random.default_rng(19)
    y = (r.poisson(1.0, (B, 10)) if likelihood == "poisson" else r.normal(size=(B, 10)))
    y = y.astype(np.float64)
    u, eps = r.normal(size=(B, 1)), r.normal(size=(2, B, 2))
    qm, ql = 0.5 * r.normal(size=(2, B, 2))
    flags = StepFlags()
    step = jax.jit(jcore.filter_step, static_argnames=("cfg", "flags"))
    want_s, want_q, want_m = step(cfg, flags, state, JG(qm, ql), y, u, eps[0], eps[1],
                                  jnp.asarray(1e-2))
    got_s, got_q, got_m = tcore.filter_step(tc, tcfg.StepFlags(), tstate, TG(_t(qm), _t(ql)),
                                            _t(y), _t(u), _t(eps[0]), _t(eps[1]),
                                            torch.tensor(1e-2, dtype=torch.float64))
    close(got_q.mean, want_q.mean)
    close(got_q.logvar, want_q.logvar)
    for f in ("loss", "recon", "dynamics", "entropy"):
        close(getattr(got_m, f), getattr(want_m, f), name=f)
    a = convert.flatten(jax.tree.map(np.asarray, want_s))
    b = convert.flatten(convert.state_to_numpy(got_s))
    assert a.keys() == b.keys()
    for k in a:
        close(b[k], a[k], LOGVAR_TOL if k == "dynamics.logvar" else TOL, k)


# tests/test_torch_fused_step.py's step limits: f32 against f32, summation
# orders differ and the exact fallback's Cholesky amplifies them; bf16
# products: an input whose f32 value differs in its last bit can round to
# the neighbouring bf16 value
STEP_TOL = {"float32": 2e-4, "bfloat16": 2e-3}


@pytest.mark.parametrize("matmul", ["float32", "bfloat16"])
def test_plain_fused_step_matches_jax(matmul):
    """Port of tests/test_fused_step.py's SGP step: whitened features and the
    DTC correction through ``step_math`` + ``exact_v_fallback``, against
    JAX's ``step_math`` + fallback, every carry leaf and output."""
    cfg = VJFConfig(ydim=20, xdim=3, udim=0, dynamics="sgp", n_inducing=30, sgp_scale=1.2,
                    sgp_lengthscale=0.8, hidden_sizes=(16,), likelihood="gaussian",
                    dtype="float32", rls_backend="nsv", fused_step="off",
                    matmul_dtype=matmul)
    state, tc, tstate = _state_pair(cfg, 2)
    r = np.random.default_rng(20)
    y = r.normal(size=(8, 20)).astype(np.float32)
    eps = r.normal(size=(2, 8, 3)).astype(np.float32)
    q = (0.3 * r.normal(size=(2, 8, 3))).astype(np.float32)
    carry = JF.pad_carry(cfg, state)

    @jax.jit
    def jax_step(carry, q, y, eps):   # one compile, not one a primitive
        out = JF.step_math(cfg, StepFlags(), carry, q[0], q[1], y, None, eps[0], eps[1],
                           jnp.asarray(1e-3, jnp.float32))
        return JF.exact_v_fallback(cfg, out, carry, None)

    ref = jax_step(carry, jnp.asarray(q), jnp.asarray(y), jnp.asarray(eps))
    tcarry = TF.pad_carry(tc, tstate)
    assert tcarry.w_white is not None and tcarry.scale2.shape == (1, 1)
    t = torch.tensor
    got = TF.step_math(tc, tcfg.StepFlags(), tcarry, t(q[0]), t(q[1]), t(y), None, t(eps[0]),
                       t(eps[1]), t(1e-3))
    got = TF.exact_v_fallback(tc, got, tcarry, None)
    a = convert.flatten(jax.tree.map(np.asarray, ref))
    b = {k: v.numpy() for k, v in convert.flatten(got._asdict()).items()}
    assert a.keys() == b.keys()
    for k in a:
        close(b[k], a[k], dict(rtol=STEP_TOL[matmul], atol=STEP_TOL[matmul]), k)
    back = TF.unpad_carry(tc, got.carry, tstate)
    for name in ("inducing", "whiten", "whiten_inv", "log_scale", "log_lengthscale"):
        assert torch.equal(getattr(back.dynamics, name), getattr(tstate.dynamics, name))


def test_pad_carry_matches_jax_and_round_trips():
    cfg = VJFConfig(ydim=12, xdim=2, udim=2, dynamics="sgp", n_inducing=20,
                    sgp_scale=1.1, sgp_lengthscale=0.7, hidden_sizes=(10, 6),
                    likelihood="gaussian", dtype="float32", rls_backend="nsv")
    state, tc, tstate = _state_pair(cfg, 3)
    a = convert.flatten(jax.tree.map(np.asarray, state))
    b = convert.flatten(convert.state_to_numpy(tstate))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    jcarry = convert.flatten(jax.tree.map(
        np.asarray, jax.jit(JF.pad_carry, static_argnums=0)(cfg, state)))
    carry = TF.pad_carry(tc, tstate)
    tcarry = convert.flatten(carry._asdict())
    assert jcarry.keys() == tcarry.keys()
    for k in jcarry:
        # a sum of squares, exp of the hyperparameters and a product, each in
        # another order or another exp: 1 ulp
        if k in ("c2", "inv_w2", "scale2", "w_white"):
            np.testing.assert_allclose(tcarry[k].numpy(), jcarry[k], rtol=3e-7, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tcarry[k].numpy(), jcarry[k], err_msg=k)
    back = convert.flatten(convert.state_to_numpy(TF.unpad_carry(tc, carry, tstate)))
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)


def test_plain_fused_epoch_matches_jax_autograd_epoch():
    """Port of tests/test_fused_step.py's SGP epoch: the prefix and the mega
    segment (plain versions) against JAX's ``fused_step='off'`` epoch with
    the same noise, at its limits."""
    cfg = VJFConfig(ydim=16, xdim=2, udim=0, dynamics="sgp", n_inducing=20, sgp_scale=1.0,
                    sgp_lengthscale=1.0, hidden_sizes=(12,), likelihood="gaussian",
                    dtype="float32", rls_backend="nsv", fused_step="off",
                    matmul_dtype="float32", ns_prefix=40)
    state, tc, tstate = _state_pair(cfg, 4)
    r = np.random.default_rng(21)
    ys = r.normal(size=(90, 8, 16)).astype(np.float32)
    eps = r.normal(size=(2, 90, 8, 2)).astype(np.float32)
    ref = jcore.run_epoch(cfg, StepFlags(), state, jnp.asarray(ys), jnp.zeros((90, 8, 0)),
                          jax.random.PRNGKey(0), jnp.asarray(1e-3, jnp.float32),
                          noise=(jnp.asarray(eps[0]), jnp.asarray(eps[1])))
    t = torch.tensor
    got = tcore.run_epoch(tc.replace(fused_step="on"), tcfg.StepFlags(), tstate, t(ys),
                          torch.zeros(90, 8, 0), 0, 1e-3, noise=(t(eps[0]), t(eps[1])))
    assert got.metrics.tau is not None and bool((got.metrics.tau[:40] >= 0.25).any())
    np.testing.assert_allclose(got.metrics.loss.numpy(), np.asarray(ref.metrics.loss),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.q_means.numpy(), np.asarray(ref.q_means),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got.state.dynamics.blr.w_mean.numpy(),
                               np.asarray(ref.state.dynamics.blr.w_mean), rtol=2e-3,
                               atol=2e-4)
    assert int(got.state.dynamics.n_sample) == int(ref.state.dynamics.n_sample)


# ---------------------------------------------------------------------------
# fit with adaptation
# ---------------------------------------------------------------------------

FIT_T, FIT_B, FIT_MAX = 40, 2, 7
# tests/test_torch_fit.py's limits. The JAX epoch weighs the state-noise
# running variance in float32 (its int32 counter divided, even under x64;
# the port weighs in float64, a deliberate deviation). The SGP's eigh-based
# steps (the bootstrap's floored solve, condition number 1e5, and each
# epoch's re-whitening) amplify that difference: with the port's own
# weighing the last epoch's loss read 6.9e-5 apart (relative) and a few
# posterior log-variances 1.5e-3. The fixture therefore gives the port
# JAX's float32 weights (``_jax_running_var``), so that what is compared is
# the SGP path and not the known deviation.
FIT_TOL = dict(rtol=2e-3, atol=1e-5)


def _jax_running_var(acc_var, acc_size, new_var, new_size, *, size_cap=1000):
    """``ops.functional.running_var`` with JAX's float32 weights."""
    acc = torch.clamp(acc_size, max=size_cap)
    tot = acc + new_size
    f1 = (acc.to(torch.float32) / tot.to(torch.float32)).to(acc_var.dtype)
    f2 = (torch.tensor(float(new_size), dtype=torch.float32) / tot.to(torch.float32))
    return f1 * acc_var + f2.to(acc_var.dtype) * new_var, tot


@pytest.fixture(scope="module")
def fit_pair():
    """(JAX FitResult, port FitResult, cfg, adapt steps) of one per-epoch
    SGP fit at float64 with ``sgp_adapt_lr > 0``: warm-up forced to end after
    2 epochs, the bootstrap with the same unit draw, then RLS epochs each
    followed by a hyperparameter step."""
    cfg = VJFConfig(ydim=10, xdim=XD, dynamics="sgp", n_inducing=15, sgp_lengthscale=1.0,
                    hidden_sizes=(8,), likelihood="gaussian", dtype="float64",
                    rls_backend="nsv", lr=0.05, rtol=1e-6, warmup_max=2,
                    sgp_adapt_lr=0.05, sgp_adapt_steps=3)
    rng = np.random.default_rng(22)
    phase = np.linspace(0, 6 * np.pi, FIT_T)
    x = np.stack([np.sin(phase), np.cos(phase)], axis=-1)
    y = x @ rng.normal(size=(XD, 10)) + 0.1 * rng.normal(size=(FIT_B, FIT_T, 10))
    y = np.ascontiguousarray(y.transpose(1, 0, 2))
    eps = rng.normal(size=(FIT_MAX, 2, FIT_T, FIT_B, XD))
    unit = rng.uniform(size=(15, XD))
    mp = pytest.MonkeyPatch()
    real_j, real_t = jsgp.dynamics_initialize, tsgp.dynamics_initialize
    real_adapt = tcore._sgp_adapt_step
    adapts = []

    def j_init(cfg, key, state, xt, xs, u=None, weights=None):   # jitted: static cfg
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "uniform", _patched_uniform(unit))
            return real_j(cfg, key, state, xt, xs, u, weights=weights)

    def t_adapt(*a, **kw):
        adapts.append(1)
        return real_adapt(*a, **kw)

    mp.setattr(jsgp, "dynamics_initialize", j_init)
    mp.setattr(tsgp, "dynamics_initialize",
               lambda c, gen, st, xt, xs, u=None, weights=None: real_t(
                   c, gen, st, xt, xs, u, unit=torch.tensor(unit), weights=weights))
    mp.setattr(tcore, "_sgp_adapt_step", t_adapt)
    mp.setattr(tdyn, "running_var", _jax_running_var)
    try:
        state, tc, tstate = _state_pair(cfg, 5)
        ref = jcore.fit(cfg, state, y, key=jax.random.PRNGKey(1), max_iter=FIT_MAX,
                        noise_hook=lambda e: (jnp.asarray(eps[e, 0]), jnp.asarray(eps[e, 1])),
                        donate=False)
        got = tcore.fit(tc, tstate, y, seed=1, max_iter=FIT_MAX,
                        noise_hook=lambda e: (torch.tensor(eps[e, 0]),
                                              torch.tensor(eps[e, 1])))
    finally:
        mp.undo()
    return ref, got, tstate, len(adapts)


def test_fit_with_adaptation_matches_jax(fit_pair):
    ref, got, start, adapts = fit_pair
    assert not ref.warm_up and (got.warm_up, got.epochs_run) == (ref.warm_up, ref.epochs_run)
    assert adapts == FIT_MAX - 2, "one adaptation step after each RLS epoch"
    assert float(got.state.dynamics.log_lengthscale) != float(start.dynamics.log_lengthscale)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=1e-5)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(ref.mu), **FIT_TOL)
    np.testing.assert_allclose(got.logvar.numpy(), np.asarray(ref.logvar), **FIT_TOL)
    a = convert.flatten(jax.tree.map(np.asarray, ref.state))
    b = convert.flatten(convert.state_to_numpy(got.state))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k], np.float64), np.asarray(a[k], np.float64),
                                   err_msg=k, **FIT_TOL)


def test_blocked_fit_adapts_and_forecasts():
    """The blocked fit runs the adaptation step at block boundaries, and the
    SGP forecast and rollout metric run on its result."""
    tc = _port_cfg(VJFConfig(ydim=8, xdim=XD, dynamics="sgp", n_inducing=10,
                             hidden_sizes=(6,), likelihood="gaussian", dtype="float32",
                             rls_backend="nsv", warmup_max=2, rtol=1e-9, sgp_adapt_lr=0.05,
                             select="forecast", select_horizon=4, select_starts=3))
    r = np.random.default_rng(23)
    y = r.normal(size=(30, 3, 8)).astype(np.float32)
    state = tcore.init_state(0, tc, device="cpu")
    res = tcore.fit(tc, state, y, seed=2, max_iter=6, epochs_per_dispatch=2)
    assert not res.warm_up and res.epochs_run == 6 and np.isfinite(res.loss)
    assert float(res.state.dynamics.log_lengthscale) != float(state.dynamics.log_lengthscale)
    assert res.selected_epoch is not None and np.isfinite(res.selected_metric)
    x, yf = tcore.forecast(tc, res.state, res.mu[-1], 3, n_step=4)
    assert x.shape == (5, 3, XD) and yf.shape == (5, 3, 8) and torch.isfinite(yf).all()


# ---------------------------------------------------------------------------
# routing: SGP below sgp_fused_min_batch, and the kernels' limits
# ---------------------------------------------------------------------------


class _FakeLib:
    """The two size queries of the kernels' library, without a build:
    ``need`` bytes, or with ``need=None`` the mirror of the kernels' tile
    plan (``tests/torch_tile_plan.py:plan_of``)."""

    def __init__(self, need):
        self.need = need

    def vjf_smem_bytes(self, args):
        return TP.plan_of(args._obj).smem_bytes if self.need is None else self.need

    def vjf_smem_limit(self):
        return 232448


@pytest.fixture
def on_card(monkeypatch):
    """The port's gate sees a state on the card; the library answers the
    shared-memory query with ``on_card(need)``'s bytes (``None``: the
    mirror's)."""
    monkeypatch.setattr(TF, "_on_cuda", lambda t: True)
    monkeypatch.setattr(TF, "_routed_away", set())

    def set_need(need):
        monkeypatch.setattr(TF, "_library", lambda: _FakeLib(need))
    set_need(1000)
    return set_need


def _small(**kw):
    base = dict(ydim=6, xdim=2, n_rbf=10, hidden_sizes=(5,), dtype="float32",
                rls_backend="nsv", fused_step="auto")
    base.update(kw)
    return tcfg.VJFConfig(**base)


def test_sgp_routes_small_batches_as_the_reference_does(on_card):
    cfg = _small(dynamics="sgp", n_inducing=10)
    state = tcore.init_state(0, cfg, device="cpu")
    jcfg = VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jstate = _j_init_state(jax.random.PRNGKey(0), jcfg)
    for b in (1, 7, 8, 64):
        got = TF.fused_enabled(cfg, state, n_batch=b)
        with pytest.MonkeyPatch.context() as m:   # JAX's gate on a TPU backend
            m.setattr(JF.jax, "default_backend", lambda: "tpu")
            assert got is JF.fused_enabled(jcfg, jstate, n_batch=b) is (b >= 8)
    assert TF.fused_enabled(cfg.replace(fused_step="on"), state, n_batch=1)
    assert not TF.fused_enabled(cfg.replace(fused_step="off"), state, n_batch=64)


# Shapes the TPU kernels take that the CUDA kernels refused until phase 1
# ran in trial tiles and the Newton-Schulz operand was staged in chunks,
# until the panels and the trials' state could live in L2 (n_rbf=400 to
# B=65536), and until the layer table replaced the arrays of eight layers
LIMIT_CASES = {
    "n_rbf=200": (dict(n_rbf=200), 8),
    "n_inducing=200": (dict(dynamics="sgp", n_inducing=200), 8),
    "hidden=(96,)": (dict(hidden_sizes=(96,)), 8),
    "four_layers": (dict(hidden_sizes=(8, 8, 8, 8)), 8),
    "n_rbf=400": (dict(n_rbf=400), 8),
    "n_inducing=400": (dict(dynamics="sgp", n_inducing=400), 8),
    "B=65536": (dict(), 65536),
    "nine_layers": (dict(hidden_sizes=(5,) * 9), 8),
    "sixteen_layers": (dict(hidden_sizes=(3,) * 16), 8),
}


@pytest.mark.parametrize("case", list(LIMIT_CASES))
def test_kernel_limits_gate_agrees_with_launch(case, on_card, caplog):
    """These configurations take the kernel route: within every limit off
    the card and within the card's shared memory (the query answered by
    the mirror of the kernels' tile plan), and under 'auto' the fused epoch
    with no warning."""
    kw, b = LIMIT_CASES[case]
    cfg = _small(**kw)
    assert TF.kernel_limits(cfg, b, on_card=False) is None
    on_card(None)
    assert TF.kernel_limits(cfg, b) is None
    state = tcore.init_state(0, cfg, device="cpu")
    with caplog.at_level(logging.WARNING, logger=TF.__name__):
        assert TF.fused_enabled(cfg, state, n_batch=b)
        assert TF.fused_enabled(cfg.replace(fused_step="on"), state, n_batch=b)
    assert not caplog.records


# Configurations still past the kernels' limits: a block past the card's
# shared memory at the smallest plan of the L2 route (one trial a tile,
# chunks and sub-panels of 4 rows), which only an input or a layer far wider
# than any configuration reaches, at any depth (nine layers, the last one
# that wide: any number of layers is taken, their activations counted)
REFUSED_CASES = {
    "nine_layers": (dict(hidden_sizes=(5,) * 8 + (16000,)), 8),
    "ydim=20000": (dict(ydim=20000), 8),
    "hidden=(16000,)": (dict(hidden_sizes=(16000,)), 8),
}


@pytest.mark.parametrize("case", list(REFUSED_CASES))
def test_kernel_limits_refuse_past_the_smallest_tile(case, on_card, caplog, monkeypatch):
    """Under 'auto' a configuration past a kernel limit takes the autograd
    epoch with one warning naming the limit; the launch raises ValueError
    with the same limit, which is what 'on' reaches on the card. The shared
    memory is the mirror's, at the smallest trial tile."""
    kw, b = REFUSED_CASES[case]
    cfg = _small(**kw)
    on_card(None)
    reason = TF.kernel_limits(cfg, b)
    assert reason is not None
    assert TF.kernel_limits(cfg, b, on_card=False) is None
    assert "shared memory" in reason and "smallest trial tile" in reason
    assert str(TP.tile_plan(cfg, b).smem_bytes) in reason
    state = tcore.init_state(0, cfg, device="cpu")
    with caplog.at_level(logging.WARNING, logger=TF.__name__):
        assert not TF.fused_enabled(cfg, state, n_batch=b)
        assert not TF.fused_enabled(cfg, state, n_batch=b)
    warned = [r for r in caplog.records if reason in r.getMessage()]
    assert len(warned) == 1
    assert TF.fused_enabled(cfg.replace(fused_step="on"), state, n_batch=b)
    # host tensors stand in for the card's: the launch checks the shapes
    monkeypatch.setattr(TF, "_ptr", lambda t, *a, **k: None if t is None else t.data_ptr())
    carry = TF.pad_carry(cfg, state)
    q = torch.zeros(b, 2)
    with pytest.raises(ValueError, match="do not take") as err:
        TF._launch("fused_step", cfg, tcfg.StepFlags(), carry, q, q, torch.zeros(1, b, cfg.ydim),
                   None, None, None, torch.tensor(1e-3), torch.empty(2, b, 2),
                   torch.empty(1, 8))
    assert reason in str(err.value)
    # the epoch takes the autograd route (no tau stream) and runs
    ys = torch.randn(3, b, cfg.ydim, generator=torch.Generator().manual_seed(0))
    res = tcore.run_epoch(cfg, tcfg.StepFlags(), state, ys, torch.zeros(3, b, 0), 0, 1e-3)
    assert res.metrics.tau is None and torch.isfinite(res.metrics.loss).all()


def test_shared_memory_limit_routes_away(on_card, caplog):
    cfg = _small()
    state = tcore.init_state(0, cfg, device="cpu")
    assert TF.kernel_limits(cfg, 8) is None and TF.fused_enabled(cfg, state, n_batch=8)
    on_card(300000)
    reason = TF.kernel_limits(cfg, 8)
    assert reason is not None and "shared memory" in reason
    with caplog.at_level(logging.WARNING, logger=TF.__name__):
        assert not TF.fused_enabled(cfg, state, n_batch=8)
    assert any("shared memory" in r.getMessage() for r in caplog.records)
    assert TF.kernel_limits(cfg, 8, on_card=False) is None


# ---------------------------------------------------------------------------
# the sharded SGP epoch at world size 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group1():
    """A real world-size-1 gloo group, in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_dp_group()
    finally:
        dist.destroy_process_group()


def test_sharded_sgp_epoch_world1_matches_single_device(group1):
    """Port of tests/test_sharding.py's SGP epoch: the whitened features stay
    on the rank, only the flat sums cross; against the single-device
    stepwise epoch at its limits. The SGP-static leaves pass through."""
    cfg = VJFConfig(ydim=12, xdim=2, udim=0, dynamics="sgp", n_inducing=16, sgp_scale=1.0,
                    sgp_lengthscale=1.0, hidden_sizes=(10,), likelihood="gaussian",
                    dtype="float32", rls_backend="nsv", fused_step="on",
                    matmul_dtype="float32")
    _, tc, tstate = _state_pair(cfg, 6)
    r = np.random.default_rng(24)
    t = torch.tensor
    ys = t(r.normal(size=(24, 16, 12)).astype(np.float32))
    eps = t(r.normal(size=(2, 24, 16, 2)).astype(np.float32))
    us = torch.zeros(24, 16, 0)
    got = run_epoch_fused_sharded(tc, tcfg.StepFlags(), tstate, ys, us, 0, 1e-3, group1,
                                  noise=(eps[0], eps[1]))
    ref = tcore.run_epoch(tc.replace(fused_epoch="stepwise"), tcfg.StepFlags(), tstate, ys,
                          us, 0, 1e-3, noise=(eps[0], eps[1]))
    assert bool((ref.metrics.tau >= TF.NS_TAU_THRESHOLD).any())
    np.testing.assert_allclose(got.metrics.loss.numpy(), ref.metrics.loss.numpy(),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.state.dynamics.blr.w_mean.numpy(),
                               ref.state.dynamics.blr.w_mean.numpy(), rtol=1e-3, atol=1e-4)
    assert torch.equal(got.state.dynamics.inducing, tstate.dynamics.inducing)
    assert torch.equal(got.state.dynamics.whiten, tstate.dynamics.whiten)
