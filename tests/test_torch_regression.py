"""The port's regression backends (``vjf_tpu_torch/models/regression.py``:
precision, covariance and nsv forms, ``rls``, ``one_shot_rls``, ``kalman``),
the Kalman toolkit (``ops/kalman.py``), the new linear-algebra helpers, the
weight-diffusion learner in the dynamics, the other backends of the SGP
dynamics and the standalone ``SGP`` class, the RBF network, ``convert``,
and ``filter_step``, the autograd epoch and per-epoch ``fit`` with
precision, covariance and Kalman states, against the JAX package
(``vjf_tpu``) on the same numpy inputs. Draws the JAX side takes from a key
are injected on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.config import StepFlags, VJFConfig
from vjf_tpu.gp import covfun as jcov
from vjf_tpu.gp import sgp as jsgp
from vjf_tpu.models import dynamics as jdyn
from vjf_tpu.models import rbf as jrbf
from vjf_tpu.models import rbfn as jrbfn
from vjf_tpu.models import regression as jreg
from vjf_tpu.models import vjf as jcore
from vjf_tpu.ops import kalman as jkal
from vjf_tpu.ops import linalg as jlin
from vjf_tpu.types import Gaussian as JG
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.gp import SGP
from vjf_tpu_torch.gp import covfun as tcov
from vjf_tpu_torch.gp import sgp as tsgp
from vjf_tpu_torch.models import dynamics as tdyn
from vjf_tpu_torch.models import rbf as trbf
from vjf_tpu_torch.models import rbfn as trbfn
from vjf_tpu_torch.models import regression as treg
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF
from vjf_tpu_torch.ops import kalman as tkal
from vjf_tpu_torch.ops import linalg as tlin
from vjf_tpu_torch.types import Gaussian as TG

torch.set_num_threads(1)

# float64 on both sides, the same formulas: rounding alone differs, grown by
# the conditioning of the factored matrices (a few hundred at most here)
TOL = dict(rtol=1e-9, atol=1e-10)
# the step and the 20-step autograd epoch at float64, as
# tests/test_torch_filter.py states them: the same algorithm, the sums in
# another order (autograd against jax.grad), grown through each step's
# factorisation
STEP_TOL = dict(rtol=1e-9, atol=1e-11)
EPOCH_TOL = dict(rtol=1e-6, atol=1e-7)
# float32 floored rebuild of the precision form (one eigh of a Gram of
# condition number up to 1e5 after the floor, LAPACK builds that differ):
# relative to the norm of each result. w itself is compared through the
# predictions F w on the pooled rows: in the directions near the floor it
# is not determined to f32 (measured: w 2.3e-3 apart, F w 4e-7)
F32_REL = 2e-3
NF, NOUT, B = 7, 2, 3
BACKENDS = ("precision", "covariance", "nsv")


def _t(a, dtype=torch.float64):
    return torch.tensor(np.array(a, copy=True), dtype=dtype)


def close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=name, **tol)


def close_rel(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= rel * max(np.linalg.norm(want), 1e-300), (name, err)


def close_tree(got, want, tol=TOL):
    """A port NamedTuple against its JAX counterpart, field by field."""
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, got, want):
        close(a, b, tol, name)


def to_port(jtree, dtype=torch.float64):
    """A JAX regression state as the port's type of the same name."""
    kind = getattr(treg, type(jtree).__name__)
    return kind(*(_t(x, dtype) for x in jtree))


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _spd(rng, n, scale=1.0):
    a = rng.normal(size=(n, n))
    return scale * (a @ a.T / n + 0.5 * np.eye(n))


def _data(seed, b=B, nf=NF, nout=NOUT):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, nf)) * 0.7, rng.normal(size=(b, nout)), 0.3


def _init(backend, dtype=jnp.float64):
    return getattr(jreg, f"init_{backend}")(NF, NOUT, dtype=dtype)


def _trained(backend, seed=0, steps=3):
    """A JAX state after ``steps`` RLS updates from the prior (the
    covariance form without jitter, the others with a little)."""
    st = _init(backend)
    for i in range(steps):
        f, y, v = _data(seed + i)
        st = jreg.rls(st, jnp.asarray(f), jnp.asarray(y), jnp.asarray(v), shrink=0.98,
                      jitter=0.0 if backend == "covariance" else 1e-3)
    return st


# ---------------------------------------------------------------------------
# ops/linalg.py and ops/kalman.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tril_solve", "cho_solve", "inv_tril_transpose",
                                  "symmetric"])
def test_linalg_helpers_match_jax(name):
    rng = np.random.default_rng(1)
    a = _spd(rng, 6)
    chol = np.linalg.cholesky(a)
    rhs = rng.normal(size=(6, 3))
    args = {"tril_solve": (chol, rhs), "cho_solve": (chol, rhs),
            "inv_tril_transpose": (chol,)}.get(name)
    if name == "symmetric":
        for m in (a, a + 1e-3 * np.triu(np.ones((6, 6)), 1)):
            assert bool(tlin.symmetric(_t(m))) == bool(jlin.symmetric(jnp.asarray(m)))
        return
    close(getattr(tlin, name)(*map(_t, args)), getattr(jlin, name)(*map(jnp.asarray, args)))


def test_cholesky_failure_reads_nan_as_in_jax():
    """``cholesky_ex`` gives a finite partial factor where JAX's Cholesky
    gives NaN in the lower triangle (the part a solve reads);
    ``nan_where_failed`` makes the whole factor NaN."""
    a = np.diag([1.0, -2.0, 3.0])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    chol, info = tlin.cholesky_f32(_t(a))
    lower = np.tril(np.ones((3, 3), bool))
    assert int(info) != 0 and torch.isfinite(chol).all() and np.isnan(want[lower]).all()
    assert torch.isnan(tlin.nan_where_failed(chol, info)).all()
    good = tlin.nan_where_failed(*tlin.cholesky_f32(_t(np.eye(3) * 2)))
    close(good, np.sqrt(2) * np.eye(3))


def _kalman_inputs(seed=2, xdim=5, ydim=3, batch=2):
    rng = np.random.default_rng(seed)
    v = _spd(rng, xdim)
    return dict(x=rng.normal(size=(xdim, batch)), v=v, chol_v=np.linalg.cholesky(v),
                a=np.eye(xdim) + 0.1 * rng.normal(size=(xdim, xdim)), q=0.05 * _spd(rng, xdim),
                h=rng.normal(size=(ydim, xdim)), y=rng.normal(size=(ydim, batch)),
                r=np.diag(rng.uniform(0.2, 0.5, size=ydim)))


@pytest.mark.parametrize("cholesky", [True, False])
@pytest.mark.parametrize("fn", ["predict", "update", "joseph", "joseph_quirk"])
def test_kalman_toolkit_matches_jax(fn, cholesky):
    d = _kalman_inputs()
    j, t = {k: jnp.asarray(v) for k, v in d.items()}, {k: _t(v) for k, v in d.items()}
    v_in = "chol_v" if cholesky else "v"
    want = jkal.predict(j["x"], j[v_in], j["a"], j["q"], j["h"], cholesky=cholesky)
    got = tkal.predict(t["x"], t[v_in], t["a"], t["q"], t["h"], cholesky=cholesky)
    if fn != "predict":
        kw = dict(cholesky=cholesky)
        if fn.startswith("joseph"):
            kw["quirk"] = fn == "joseph_quirk"
        jf = jkal.update if fn == "update" else jkal.joseph_update
        tf = tkal.update if fn == "update" else tkal.joseph_update
        want = jf(j["y"], *want, j["h"], j["r"], **kw)
        got = tf(t["y"], *got, t["h"], t["r"], **kw)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, name=f"{fn}[{i}]")


# ---------------------------------------------------------------------------
# models/regression.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS + ("nonbayes",))
def test_init_matches_jax(backend):
    want = _init(backend)
    got = getattr(treg, f"init_{backend}")(NF, NOUT, dtype=torch.float64, device="cpu")
    close_tree(got, want)
    assert all(x.dtype == torch.float64 for x in got)
    distinct = {x.data_ptr() for x in got}
    assert len(distinct) == len(got), "init leaves alias one buffer"


@pytest.mark.parametrize("backend", BACKENDS)
def test_predictions_match_jax(backend):
    """``weight_sqrt``, ``predict_gaussian`` and ``predict_sample`` dispatch on
    the state's type."""
    js = _trained(backend)
    ts = to_port(js)
    f, _, _ = _data(9, b=4)
    eps = np.random.default_rng(10).normal(size=(NF, NOUT))
    close(treg.weight_sqrt(ts), jreg.weight_sqrt(js), name="weight_sqrt")
    g, jg = treg.predict_gaussian(ts, _t(f)), jreg.predict_gaussian(js, jnp.asarray(f))
    close(g.mean, jg.mean, name="mean")
    close(g.logvar, jg.logvar, name="logvar")
    close(treg.predict_sample(ts, _t(f), _t(eps)),
          jreg.predict_sample(js, jnp.asarray(f), jnp.asarray(eps)), name="sample")


@pytest.mark.parametrize("shrink,jitter", [(1.0, 0.0), (0.97, 0.0), (0.97, 1e-2)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_rls_matches_jax(backend, shrink, jitter):
    """Four RLS steps from the prior."""
    if backend == "covariance" and jitter:
        with pytest.raises(ValueError, match="chol_jitter"):
            f, y, v = _data(0)
            treg.rls(treg.init_covariance(NF, NOUT, dtype=torch.float64), _t(f), _t(y),
                     _t(v), jitter=jitter)
        return
    js, ts = _init(backend), to_port(_init(backend))
    for i in range(4):
        f, y, v = _data(20 + i)
        js = jreg.rls(js, jnp.asarray(f), jnp.asarray(y), jnp.asarray(v), shrink=shrink,
                      jitter=jitter)
        ts = treg.rls(ts, _t(f), _t(y), _t(v), shrink=shrink, jitter=jitter)
    close_tree(ts, js)


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_shot_rls_f64_matches_jax(backend):
    """Pooled rows from a trained state: the precision and covariance forms
    take the incremental ``rls`` at float64, nsv the floored eigh."""
    js = _trained(backend, seed=30)
    f, y, v = _data(31, b=40)
    want = jreg.one_shot_rls(js, jnp.asarray(f), jnp.asarray(y), jnp.asarray(v), shrink=0.99,
                             jitter=0.0 if backend == "covariance" else 1e-3)
    got = treg.one_shot_rls(to_port(js), _t(f), _t(y), _t(v), shrink=0.99,
                            jitter=0.0 if backend == "covariance" else 1e-3)
    close_tree(got, want, dict(rtol=1e-8, atol=1e-10))


def test_one_shot_rls_f32_precision_rebuilds_from_the_floor():
    """At float32 the precision form solves the pooled statistics by the
    floored eigh and rebuilds its factor pair from the floored P: bounded
    at a Gram of condition number about 1e8, and ``U U^T P = I``."""
    rng = np.random.default_rng(40)
    base = rng.normal(size=(600, 3))
    f = np.concatenate([base, base @ rng.normal(size=(3, NF - 3)) * 1e-4
                        + 1e-6 * rng.normal(size=(600, NF - 3))], axis=1).astype(np.float32)
    y = rng.normal(size=(600, NOUT)).astype(np.float32)
    v = np.float32(0.05)
    js = jreg.init_precision(NF, NOUT, dtype=jnp.float32)
    want = jreg.one_shot_rls(js, jnp.asarray(f), jnp.asarray(y), jnp.asarray(v), jitter=1e-3)
    got = treg.one_shot_rls(to_port(js, torch.float32), _t(f, torch.float32),
                            _t(y, torch.float32), torch.tensor(v), jitter=1e-3)
    assert type(got) is treg.PrecisionBLR and all(x.dtype == torch.float32 for x in got)
    for name in ("precision", "prec_chol", "prec_chol_inv_t"):
        close_rel(getattr(got, name), getattr(want, name), F32_REL, name)
    f64 = f.astype(np.float64)
    close_rel(f64 @ got.w_mean.double().numpy(), f64 @ np.asarray(want.w_mean, np.float64),
              F32_REL, "F w")
    p, u = got.precision.double(), got.prec_chol_inv_t.double()
    assert float(torch.linalg.matrix_norm(u @ u.T @ p - torch.eye(NF, dtype=p.dtype))) < 1e-2


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_kalman_matches_jax(backend, quirk):
    """Three weight-diffusion Kalman steps from a trained state."""
    js = _trained(backend, seed=50)
    ts = to_port(js)
    for i in range(3):
        f, y, v = _data(51 + i)
        js = jreg.kalman(js, jnp.asarray(f), jnp.asarray(y), jnp.asarray(v), diffusion=0.01,
                         quirk=quirk)
        ts = treg.kalman(ts, _t(f), _t(y), _t(v), diffusion=0.01, quirk=quirk)
    close_tree(ts, js, dict(rtol=1e-8, atol=1e-10))


def test_kalman_without_diffusion_is_rls():
    """``kalman(diffusion=0, quirk=False)`` is the exact Bayesian update: on a
    covariance state it equals the covariance ``rls`` (and JAX's)."""
    ts = to_port(_trained("covariance", seed=60))
    a = b = ts
    for i in range(3):
        f, y, v = _data(61 + i)
        a = treg.kalman(a, _t(f), _t(y), _t(v), diffusion=0.0)
        b = treg.rls(b, _t(f), _t(y), _t(v))
    close_tree(a, b, dict(rtol=1e-9, atol=1e-12))


def test_kalman_innovation_failure_is_nan_as_in_jax():
    """A negative noise variance makes the innovation indefinite: JAX's
    Cholesky returns NaN and so must the port's hot path (not a finite
    partial factor), so the step's finite gate drops the update."""
    js = _trained("covariance", seed=70)
    f, y, _ = _data(71, b=1)
    want = jreg.kalman(js, jnp.asarray(f), jnp.asarray(y), jnp.asarray(-1e3), diffusion=0.0)
    got = treg.kalman(to_port(js), _t(f), _t(y), _t(-1e3), diffusion=0.0)
    assert np.isnan(np.asarray(want.w_mean)).all()
    assert torch.isnan(got.w_mean).all() and torch.isnan(got.cov).all()


def test_nonbayes_and_batch_posterior_match_jax():
    """``predict_point`` and ``batch_lstsq_posterior``; one RLS pass from the
    prior reproduces the batch posterior."""
    f, y, v = _data(80, b=12)
    w = np.random.default_rng(81).normal(size=(NF, NOUT))
    close(treg.predict_point(treg.NonBayesLR(_t(w)), _t(f)),
          jreg.predict_point(jreg.NonBayesLR(jnp.asarray(w)), jnp.asarray(f)))
    got = treg.batch_lstsq_posterior(_t(f), _t(y), _t(v))
    want = jreg.batch_lstsq_posterior(jnp.asarray(f), jnp.asarray(y), jnp.asarray(v))
    for a, b in zip(got, want):
        close(a, b)
    one = treg.rls(treg.init_precision(NF, NOUT, dtype=torch.float64), _t(f), _t(y), _t(v))
    close(one.w_mean, got[0], dict(rtol=1e-9, atol=1e-12))
    close(one.precision, got[1])


# ---------------------------------------------------------------------------
# the dynamics: backends, the weight-diffusion learner, the type built
# ---------------------------------------------------------------------------


def _dyn_cfg(**kw):
    base = dict(ydim=6, xdim=2, udim=1, n_rbf=NF, dtype="float64", leak=0.1,
                kalman_diffusion=0.02)
    base.update(kw)
    return VJFConfig(**base)


_CASES = {   # cfg fields, batch_hint, the type 'auto' builds
    "f32_b1": (dict(dtype="float32"), 1, "CovarianceBLR"),
    "f32_b1_jitter": (dict(dtype="float32", chol_jitter=1e-3), 1, "NSVBLR"),
    "f32_b256": (dict(dtype="float32", n_rbf=100), 256, "NSVBLR"),
    "f32_no_hint": (dict(dtype="float32"), None, "NSVBLR"),
    "f64": (dict(), 1, "PrecisionBLR"),
    "kalman": (dict(dtype="float32", dynamics_update="kalman"), 256, "CovarianceBLR"),
    "explicit": (dict(dtype="float32", rls_backend="precision"), 1, "PrecisionBLR"),
    "sgp_f64": (dict(dynamics="sgp", n_inducing=NF), None, "PrecisionBLR"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_resolve_backend_builds_that_state(case):
    """``init_state`` (``'auto'`` unless stated) builds the type that
    ``resolve_backend`` names, as the JAX package does."""
    kw, hint, want = _CASES[case]
    cfg = _dyn_cfg(**kw)
    tstate = tcore.init_state(0, _port_cfg(cfg), device="cpu", batch_hint=hint)
    jstate = jax.eval_shape(lambda k: jcore.init_state(k, cfg, batch_hint=hint),
                            jax.random.PRNGKey(0))
    assert type(tstate.dynamics.blr).__name__ == type(jstate.dynamics.blr).__name__ == want
    assert tstate.dynamics.blr.w_mean.dtype == _port_cfg(cfg).tdtype
    assert tuple(tstate.dynamics.blr.w_mean.shape) == jstate.dynamics.blr.w_mean.shape


@pytest.mark.parametrize("quirk", [False, True])
def test_blr_residual_update_kalman_matches_jax(quirk):
    cfg = _dyn_cfg(dynamics_update="kalman", joseph_quirk=quirk)
    js = _trained("covariance", seed=90)
    rng = np.random.default_rng(91)
    xs, xt = rng.normal(size=(B, 2)), rng.normal(size=(B, 2))
    f = rng.normal(size=(B, NF)) * 0.5
    logvar, n = np.log(0.4), 3
    want = jdyn.blr_residual_update(cfg, js, jnp.asarray(logvar), jnp.asarray(n, jnp.int32),
                                    jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(f),
                                    update_rule="kalman")
    got = tdyn.blr_residual_update(_port_cfg(cfg), to_port(js), _t(logvar),
                                   torch.tensor(n, dtype=torch.int32), _t(xt), _t(xs), _t(f),
                                   update_rule="kalman")
    close_tree(got[0], want[0], dict(rtol=1e-9, atol=1e-11))
    # the state-noise weights differ in dtype by design (ROADMAP Queue 3)
    close(got[1], want[1], dict(rtol=1e-6, atol=1e-7))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_init_sgp_dynamics_takes_each_backend(backend):
    cfg = _port_cfg(_dyn_cfg(dynamics="sgp", n_inducing=9))
    st = tsgp.init_sgp_dynamics(0, cfg, backend=backend, device="cpu")
    want = _init(backend)
    assert type(st.blr).__name__ == type(want).__name__
    assert st.blr.w_mean.shape == (9, 2) and st.whiten.shape == (9, 9)


@pytest.mark.parametrize("backend", ["precision", "covariance"])
def test_adapt_hyperparams_reprojects_each_backend(backend):
    """``adapt_hyperparams`` on a precision and on a covariance SGP state
    against JAX: the hyperparameters, the whitener and the reprojected
    posterior (the precision form refactored)."""
    cfg = _dyn_cfg(dynamics="sgp", n_inducing=10, sgp_scale=1.3, sgp_lengthscale=0.9,
                   rls_backend=backend, sgp_adapt_lr=0.05, sgp_adapt_steps=3)
    js = jsgp.init_sgp_dynamics(jax.random.PRNGKey(3), cfg)
    r = np.random.default_rng(100)
    xs, u = r.uniform(-2, 2, size=(60, 2)), r.normal(size=(60, 1))
    xt = xs + 0.3 * np.sin(3.0 * xs) + 0.02 * r.normal(size=(60, 2))
    js = jsgp.dynamics_update(cfg, js, xt, xs, u)
    a = jax.tree.map(np.asarray, js)
    ts = tsgp.SGPDynamicsState(
        *(_t(getattr(a, k)) for k in ("inducing", "whiten", "whiten_inv", "log_scale",
                                      "log_lengthscale")),
        blr=to_port(js.blr), logvar=_t(a.logvar),
        n_sample=torch.tensor(int(a.n_sample), dtype=torch.int32))
    want = jax.jit(jsgp.adapt_hyperparams, static_argnames=("cfg",))(cfg, js, xt, xs, u)
    got = tsgp.adapt_hyperparams(_port_cfg(cfg), ts, _t(xt), _t(xs), _t(u))
    assert float(got.log_lengthscale) != float(ts.log_lengthscale), "nothing adapted"
    close(got.log_lengthscale, want.log_lengthscale)
    assert type(got.blr) is type(ts.blr)
    # through one eigh (the whitener): relative to the norm of the result
    for name, x, y in zip(want.blr._fields, got.blr, want.blr):
        close_rel(x, y, 1e-8, name)


def test_sgp_class_matches_jax():
    """The standalone ``SGP``: float64 by default, predictions before and
    after two batch updates, against JAX's class."""
    rng = np.random.default_rng(110)
    z = rng.uniform(-2, 2, size=(8, 1))
    x = rng.uniform(-2, 2, size=(30, 1))
    y = np.sin(2 * x) + 0.05 * rng.normal(size=x.shape)
    want = jsgp.SGP(1, 1, 0, jcov.SquaredExponential(1.0, 0.7), noise_var=0.01, inducing=z)
    got = SGP(1, 1, 0, tcov.SquaredExponential(1.0, 0.7), noise_var=0.01, inducing=z,
              device="cpu")
    assert got.dtype == torch.float64 and got.inducing.dtype == torch.float64
    xq = np.linspace(-2, 2, 11)[:, None]
    for step in range(3):
        p, q = got.predict(xq), want.predict(xq)
        close(p.mean, q.mean, dict(rtol=1e-8, atol=1e-10), f"mean {step}")
        close(p.logvar, q.logvar, dict(rtol=1e-8, atol=1e-10), f"logvar {step}")
        if step < 2:
            sl = slice(15 * step, 15 * step + 15)
            want.fit(x[sl], y[sl])
            got.fit(x[sl], y[sl])
    assert float(torch.max(torch.abs(got.predict(x).mean - _t(np.sin(2 * x))))) < 0.2


def test_sgp_class_jitter_follows_the_dtype():
    """The jitter of ``K_zz`` is keyed on the inducing points' actual dtype
    (1e-5 at float32, 1e-6 at float64)."""
    z = np.linspace(-1, 1, 5)[:, None]
    for dtype, jit in ((torch.float32, 1e-5), (torch.float64, 1e-6)):
        s = SGP(1, 1, covfun=tcov.SquaredExponential(), noise_var=0.1, inducing=z,
                dtype=dtype, device="cpu")
        kzz = s.covfun(s.inducing, s.inducing) + jit * torch.eye(5, dtype=dtype)
        assert s.kzz_chol.dtype == dtype
        torch.testing.assert_close(s.kzz_chol @ s.kzz_chol.T, kzz)


def test_rbfn_matches_jax():
    """``apply_rbfn`` on the JAX network's parameters, and the shapes the
    port's ``init_rbfn`` draws."""
    jp = jrbfn.init_rbfn(jax.random.PRNGKey(4), 3, 2, 10, dtype=jnp.float64)
    a = jax.tree.map(np.asarray, jp)
    tp = trbfn.init_rbfn(torch.Generator(), 3, 2, 10, dtype=torch.float64)
    tp = tp._replace(centroid=_t(a.centroid), logscale=_t(a.logscale) + 0.1)
    tp.out.weight.data.copy_(_t(a.out.w))
    tp.out.bias.data.copy_(_t(a.out.b))
    jp = jp._replace(logscale=jp.logscale + 0.1)
    x = np.random.default_rng(120).normal(size=(20, 3))
    close(trbfn.apply_rbfn(tp, _t(x)), jrbfn.apply_rbfn(jp, jnp.asarray(x)))
    fresh = trbfn.init_rbfn(torch.Generator().manual_seed(0), 3, 2, 10, bias=False)
    assert fresh.centroid.shape == (10, 3) and fresh.logscale.shape == (1, 10)
    assert fresh.out.bias is None and torch.equal(fresh.logscale, torch.zeros(1, 10))


@pytest.mark.parametrize("dynamics", ["rbf", "sgp"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_convert_round_trip(backend, dynamics):
    """JAX state -> port -> numpy reads every leaf of the JAX state back,
    with the posterior type kept."""
    cfg = _dyn_cfg(dynamics=dynamics, n_inducing=NF, likelihood="gaussian")
    js = jcore.init_state(jax.random.PRNGKey(5), cfg, backend=backend)
    js = js._replace(dynamics=js.dynamics._replace(blr=_trained(backend, seed=130)))
    ts = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(np.asarray, js), device="cpu")
    assert type(ts.dynamics.blr).__name__ == type(js.dynamics.blr).__name__
    a = convert.flatten(jax.tree.map(np.asarray, js))
    b = convert.flatten(convert.state_to_numpy(ts))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# ---------------------------------------------------------------------------
# filter_step, the autograd epoch and fit with the new states
# ---------------------------------------------------------------------------

_STATES = {   # backend, cfg fields
    "precision": ("precision", dict()),
    "covariance": ("covariance", dict()),
    "kalman": ("covariance", dict(dynamics_update="kalman")),
    "kalman_quirk": ("covariance", dict(dynamics_update="kalman", joseph_quirk=True)),
}
SB, YD, XD, UD = 3, 6, 2, 1


def _pair(which, likelihood="gaussian", **kw):
    backend, extra = _STATES[which]
    cfg = VJFConfig(ydim=YD, xdim=XD, udim=UD, n_rbf=8, hidden_sizes=(5,),
                    likelihood=likelihood, dtype="float64", rls_backend=backend,
                    fused_step="off", rls_shrink=0.99, kalman_diffusion=0.01, **extra, **kw)
    state = jcore.init_state(jax.random.PRNGKey(1), cfg)
    tstate = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(np.asarray, state),
                                      device="cpu")
    assert type(tstate.dynamics.blr).__name__ == type(state.dynamics.blr).__name__
    return cfg, state, tstate


def _inputs(likelihood, seed=0, t=None):
    rng = np.random.default_rng(seed)
    lead = () if t is None else (t,)
    y = (rng.poisson(2.0, lead + (SB, YD)) if likelihood == "poisson"
         else rng.normal(size=lead + (SB, YD))).astype(np.float64)
    return y, rng.normal(size=lead + (SB, UD)), rng.normal(size=(2,) + lead + (SB, XD)), \
        0.5 * rng.normal(size=(2, SB, XD))


def _state_close(tstate, jstate, tol):
    a = convert.flatten(jax.tree.map(np.asarray, jstate))
    b = convert.flatten(convert.state_to_numpy(tstate))
    assert a.keys() == b.keys()
    for k in a:
        close(b[k], a[k], tol, k)


# one compile per configuration (eager JAX compiles every primitive)
_j_filter_step = jax.jit(jcore.filter_step, static_argnums=(0, 1))


@pytest.mark.parametrize("which,likelihood", [(w, "gaussian") for w in _STATES]
                         + [("precision", "poisson"), ("kalman", "poisson")])
def test_filter_step_matches_jax(which, likelihood):
    cfg, state, tstate = _pair(which, likelihood)
    y, u, eps, q = _inputs(likelihood, seed=3)
    jst, jq, jm = _j_filter_step(cfg, StepFlags(), state, JG(q[0], q[1]), y, u,
                                 eps[0], eps[1], jnp.asarray(0.05))
    tst, tq, tm = tcore.filter_step(_port_cfg(cfg), tcfg.StepFlags(), tstate,
                                    TG(_t(q[0]), _t(q[1])), _t(y), _t(u), _t(eps[0]),
                                    _t(eps[1]), 0.05)
    _state_close(tst, jst, STEP_TOL)
    close(tq.mean, jq.mean, STEP_TOL, "qt.mean")
    for name in ("loss", "recon", "dynamics", "entropy"):
        close(getattr(tm, name), getattr(jm, name), STEP_TOL, name)


@pytest.mark.parametrize("which", list(_STATES))
def test_autograd_epoch_matches_jax(which):
    """20 RLS-active steps of ``run_epoch`` (the autograd route: these states
    never reach the kernels) against JAX's XLA epoch with the same noise."""
    T = 20
    cfg, state, tstate = _pair(which)
    y, u, eps, _ = _inputs("gaussian", seed=5, t=T)
    ref = jcore.run_epoch(cfg, StepFlags(), state, jnp.asarray(y), jnp.asarray(u),
                          jax.random.PRNGKey(0), jnp.asarray(0.02),
                          noise=(jnp.asarray(eps[0]), jnp.asarray(eps[1])))
    pcfg = _port_cfg(cfg)
    assert not TF.fused_enabled(pcfg.replace(fused_step="auto"), tstate, n_batch=SB)
    got = tcore.run_epoch(pcfg, tcfg.StepFlags(), tstate, _t(y), _t(u), 0, 0.02,
                          noise=(_t(eps[0]), _t(eps[1])))
    assert got.metrics.tau is None
    for name in ("loss", "recon", "dynamics", "entropy"):
        close(getattr(got.metrics, name), getattr(ref.metrics, name), EPOCH_TOL, name)
    close(got.q_means, ref.q_means, EPOCH_TOL, "q_means")
    _state_close(got.state, ref.state, EPOCH_TOL)


def test_epoch_repair_leaves_other_backends_alone():
    """The epoch-boundary repair is an nsv operation; with a precision state
    it returns the state it was given, as JAX's."""
    _, _, tstate = _pair("precision")
    cfg = tcfg.VJFConfig(ydim=YD, xdim=XD, rls_epoch_repair="on")
    assert TF.maybe_epoch_repair(cfg, tcfg.StepFlags(), tstate, 1) is tstate


FT, FYD, FXD, FNF = 40, 8, 2, 12


def _fit_data(seed=3):
    rng = np.random.default_rng(seed)
    phase = np.linspace(0, 6 * np.pi, FT)
    x = np.stack([np.sin(phase), np.cos(phase)], axis=-1)
    return (x @ rng.normal(size=(FXD, FYD)) + 0.1 * rng.normal(size=(FT, FYD)))


def _patch_reinit(monkeypatch, unit):
    """The bootstrap's centroid draw, the same unit draw on both sides."""
    def jax_reinit(key, params, x):
        r = jnp.max(jnp.linalg.norm(x, axis=-1))
        return jrbf.RBFParams((-1.0 + 2.0 * jnp.asarray(unit, x.dtype)) * r,
                              jnp.full_like(params.logwidth, jnp.log(r)))

    real = trbf.reinit_rbf
    monkeypatch.setattr(jdyn, "reinit_rbf", jax_reinit)
    monkeypatch.setattr(tdyn, "reinit_rbf",
                        lambda gen, params, x: real(gen, params, x, unit=torch.tensor(unit)))


@pytest.fixture(scope="module")
def fit_b1_auto():
    """(JAX FitResult, port FitResult, cfg) of one per-epoch fit at B 1,
    float32 and ``rls_backend='auto'`` with ``chol_jitter`` 0, which both
    packages resolve to the covariance form: warm-up forced to end after 2
    epochs, the bootstrap (the covariance ``rls`` over the 39 pooled rows)
    with the same unit draw, then RLS epochs."""
    max_iter = 6
    cfg = VJFConfig(ydim=FYD, xdim=FXD, n_rbf=FNF, hidden_sizes=(8,), likelihood="gaussian",
                    dtype="float32", lr=0.05, rtol=1e-6, warmup_max=2)
    y = _fit_data().astype(np.float32)
    rng = np.random.default_rng(4)
    eps = rng.normal(size=(max_iter, 2, FT, 1, FXD)).astype(np.float32)
    unit = rng.uniform(size=(FNF, FXD)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    _patch_reinit(mp, unit)
    try:
        state = jcore.init_state(jax.random.PRNGKey(0), cfg, batch_hint=1)
        tstate = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(np.asarray, state),
                                          device="cpu")
        ref = jcore.fit(cfg, state, y, key=jax.random.PRNGKey(1), max_iter=max_iter,
                        noise_hook=lambda e: (jnp.asarray(eps[e, 0]), jnp.asarray(eps[e, 1])),
                        donate=False)
        got = tcore.fit(_port_cfg(cfg), tstate, y, seed=1, max_iter=max_iter,
                        noise_hook=lambda e: (torch.tensor(eps[e, 0]),
                                              torch.tensor(eps[e, 1])))
    finally:
        mp.undo()
    return ref, got, cfg


# float32 on both sides (JAX's XLA:CPU and torch's CPU kernels round their
# sums differently): after 4 RLS epochs of 40 steps and the pooled
# bootstrap the two fits stay within this, relative to each leaf's size
FIT32_REL = 1e-3


def test_fit_b1_auto_covariance_matches_jax(fit_b1_auto):
    ref, got, _ = fit_b1_auto
    assert type(ref.state.dynamics.blr).__name__ == "CovarianceBLR"
    assert type(got.state.dynamics.blr) is treg.CovarianceBLR
    assert not ref.warm_up, "the warm-up never ended: nothing was compared"
    assert (got.warm_up, got.epochs_run) == (ref.warm_up, ref.epochs_run)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=FIT32_REL)
    close_rel(got.mu.numpy(), np.asarray(ref.mu), FIT32_REL, "mu")
    a = convert.flatten(jax.tree.map(np.asarray, ref.state))
    b = convert.flatten(convert.state_to_numpy(got.state))
    assert a.keys() == b.keys()
    for k in a:
        close_rel(b[k], a[k], FIT32_REL, k)


@pytest.mark.parametrize("case", ["f32_b1", "f64", "kalman", "kalman_quirk"])
def test_fit_runs_with_each_state(case):
    """Per-epoch and blocked ``fit``, ``select='forecast'``, ``forecast`` and
    ``rollout_rmse`` with a covariance state at B 1, a precision state at
    float64 and the Kalman learner: finite, the posterior type kept."""
    kw = {"f32_b1": dict(), "f64": dict(dtype="float64"),
          "kalman": dict(dynamics_update="kalman"),
          "kalman_quirk": dict(dynamics_update="kalman", joseph_quirk=True)}[case]
    cfg = tcfg.VJFConfig(ydim=FYD, xdim=FXD, n_rbf=FNF, hidden_sizes=(8,),
                         likelihood="gaussian", lr=0.05, warmup_max=2, select="forecast",
                         select_horizon=5, select_starts=3, **kw)
    y = torch.tensor(_fit_data(7), dtype=cfg.tdtype)
    state = tcore.init_state(0, cfg, device="cpu", batch_hint=1)
    kind = type(state.dynamics.blr)
    for k in (1, 2):
        res = tcore.fit(cfg, state, y, seed=2, max_iter=3, epochs_per_dispatch=k)
        assert not res.warm_up and np.isfinite(res.loss)
        assert type(res.state.dynamics.blr) is kind and res.selected_epoch is not None
        assert all(torch.isfinite(x).all() for x in res.state.dynamics.blr)
    x, yf = tcore.forecast(cfg, res.state, res.mu[-1], 3, n_step=5)
    assert x.shape == (6, 1, FXD) and torch.isfinite(yf).all()
