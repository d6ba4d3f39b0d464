"""The port's math outside the kernels (``ops/functional.py``,
``ops/linalg.py``, ``models/{rbf,likelihoods,decoder,regression,dynamics}``,
``datasets.py``) against the JAX package's functions at float64 on the same
numpy inputs. Random draws the JAX side takes from a key are recovered
from its result or injected on both sides."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu import datasets as jdata
from vjf_tpu.config import VJFConfig as JConfig
from vjf_tpu.models import decoder as jdec
from vjf_tpu.models import dynamics as jdyn
from vjf_tpu.models import likelihoods as jlik
from vjf_tpu.models import rbf as jrbf
from vjf_tpu.models import regression as jreg
from vjf_tpu.models.recognition import LinearParams
from vjf_tpu.ops import functional as jf
from vjf_tpu.ops import linalg as jla
from vjf_tpu.types import Gaussian as JG
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import datasets as tdata
from vjf_tpu_torch.models import dynamics as tdyn
from vjf_tpu_torch.models import likelihoods as tlik
from vjf_tpu_torch.models import rbf as trbf
from vjf_tpu_torch.models import regression as treg
from vjf_tpu_torch.models.decoder import decode
from vjf_tpu_torch.models.recognition import linear_from
from vjf_tpu_torch.ops import functional as tf
from vjf_tpu_torch.ops import linalg as tla
from vjf_tpu_torch.types import Gaussian as TG

torch.set_num_threads(1)

# float64 on both sides, the same formula: the last few bits only
TOL = dict(rtol=1e-12, atol=1e-12)
# through a factorisation or an inverse (Cholesky, eigh, Newton-Schulz) the
# rounding grows with the condition number of the matrix
LA_TOL = dict(rtol=1e-9, atol=1e-10)
B, XD, UD, NF = 5, 2, 1, 7


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=name, **tol)


# ---------------------------------------------------------------------------
# ops/functional.py and ops/linalg.py
# ---------------------------------------------------------------------------


def test_rbf_features():
    r = _rng(1)
    x, c, w = r.normal(size=(4, B, 3)), r.normal(size=(NF, 3)), r.uniform(0.5, 2, NF)
    close(tf.rbf(_t(x), _t(c), _t(w)), jf.rbf(x, c, w))


@pytest.mark.parametrize("weighted", [False, True])
def test_batch_means(weighted):
    r = _rng(2)
    per = r.normal(size=B)
    lv = r.normal(size=(B, XD))
    w = (r.uniform(size=B) > 0.4).astype(np.float64) if weighted else None
    tw = None if w is None else _t(w)
    close(tf.batch_weighted_mean(_t(per), tw), jf.batch_weighted_mean(per, w))
    close(tf.gaussian_entropy(TG(_t(lv), _t(lv)), tw),
          jf.gaussian_entropy(JG(lv, lv), w))


@pytest.mark.parametrize("case", ["arrays", "gauss_array", "array_gauss", "quirk",
                                  "corrected"])
def test_gaussian_loss(case):
    r = _rng(3)
    m1, m2, l1, l2 = (r.normal(size=(B, XD)) for _ in range(4))
    lv = r.normal()
    ja, jb = m1, m2
    ta, tb = _t(m1), _t(m2)
    if case in ("gauss_array", "quirk", "corrected"):
        ja, ta = JG(m1, l1), TG(_t(m1), _t(l1))
    if case in ("array_gauss", "quirk", "corrected"):
        jb, tb = JG(m2, l2), TG(_t(m2), _t(l2))
    quirk = case != "corrected"
    close(tf.gaussian_loss(ta, tb, _t(lv), trace_quirk=quirk),
          jf.gaussian_loss(ja, jb, lv, trace_quirk=quirk))


def test_pointwise_helpers():
    r = _rng(4)
    m, lv, eps, u = (r.normal(size=(B, XD)) for _ in range(4))
    close(tf.reparametrize(TG(_t(m), _t(lv)), _t(eps)), jf.reparametrize(JG(m, lv), eps))
    close(tf.nonecat(_t(m), _t(u)), jf.nonecat(m, u))
    close(tf.nonecat(_t(m), torch.zeros(B, 0, dtype=torch.float64)), m)
    close(tf.nonecat(_t(m), None), m)
    for x in (np.inf, np.nan, -2.5):
        close(tf.finite_or_zero(_t(x)), jf.finite_or_zero(jnp.asarray(x)))


@pytest.mark.parametrize("acc_size", [3, 700, 2000])
def test_running_var(acc_size):
    for new_size in (5, 0.5):
        want = jf.running_var(jnp.asarray(1.7), jnp.asarray(float(acc_size)),
                              jnp.asarray(0.3), new_size, size_cap=1000)
        got = tf.running_var(_t(1.7), _t(float(acc_size)), _t(0.3), new_size, size_cap=1000)
        close(got[0], want[0])
        close(got[1], want[1])
    # the state noise's integer counter: the count stays an integer
    v, n = tf.running_var(_t(1.7), torch.tensor(acc_size, dtype=torch.int32), _t(0.3), B,
                          size_cap=500)
    assert n.dtype == torch.int32 and int(n) == min(acc_size, 500) + B
    close(v, jf.running_var(jnp.asarray(1.7), jnp.asarray(float(acc_size)), 0.3, B,
                            size_cap=500)[0])


def _spd(seed, n=NF, cond=1e3):
    r = _rng(seed)
    q, _ = np.linalg.qr(r.normal(size=(n, n)))
    return (q * np.logspace(0, np.log10(cond), n)) @ q.T


@pytest.mark.parametrize("shift", [0.0, -5.0], ids=["pd", "indefinite"])
def test_positivize_and_safe_cholesky(shift):
    a = _spd(5) + shift * np.eye(NF)
    close(tla.positivize(_t(a)), jla.positivize(a), LA_TOL)
    close(tla.safe_cholesky(_t(a)), jla.safe_cholesky(a), LA_TOL)
    assert not torch.isfinite(tla.safe_cholesky(_t(np.full((3, 3), np.nan)))).any()


# ---------------------------------------------------------------------------
# models/rbf.py, likelihoods.py, decoder.py
# ---------------------------------------------------------------------------


def _rbf_pair(seed=6, dim=XD + UD):
    r = _rng(seed)
    c, lw = r.normal(size=(NF, dim)), 0.3 * r.normal(size=NF)
    return jrbf.RBFParams(c, lw), trbf.RBFParams(_t(c), _t(lw))


def test_apply_rbf_and_reinit():
    jp, tp = _rbf_pair()
    x = _rng(7).normal(size=(B, XD + UD))
    close(trbf.apply_rbf(tp, _t(x)), jrbf.apply_rbf(jp, x))
    # the JAX re-init's own uniform draw, recovered from its centroids and
    # injected into the port's
    want = jrbf.reinit_rbf(jax.random.PRNGKey(3), jp, x)
    r = np.max(np.linalg.norm(x, axis=-1))
    unit = (np.asarray(want.centroid) / r + 1.0) / 2.0
    got = trbf.reinit_rbf(None, tp, _t(x), unit=_t(unit))
    close(got.centroid, want.centroid)
    close(got.logwidth, want.logwidth)
    drawn = trbf.reinit_rbf(torch.Generator().manual_seed(0), tp, _t(x))
    assert drawn.centroid.abs().max() <= r and drawn.centroid.shape == tp.centroid.shape


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
def test_likelihoods_and_decode(likelihood):
    r = _rng(8)
    eta = 4.0 * r.normal(size=(B, 6))
    eta[0, 0] = 30.0                        # past the Poisson rate clamp
    y = r.poisson(2.0, (B, 6)).astype(np.float64)
    if likelihood == "gaussian":
        jp, tp = jlik.GaussianLikParams(jnp.asarray(-0.4)), tlik.GaussianLikParams(_t(-0.4))
        close(tlik.gaussian_nll(tp, _t(eta), _t(y)), jlik.gaussian_nll(jp, eta, y))
        for n in (3.0, 999.0):
            jl, jn = jlik.gaussian_lik_update(jp, jnp.asarray(n), eta, y, size_cap=1000,
                                              logvar_clamp=30.0)
            tl, tn = tlik.gaussian_lik_update(tp, _t(n), _t(eta), _t(y), size_cap=1000,
                                              logvar_clamp=30.0)
            close(tl.logvar, jl.logvar)
            close(tn, jn)
        # an overflowing mse is skipped
        tl, tn = tlik.gaussian_lik_update(tp, _t(3.0), _t(eta), _t(np.full_like(y, np.inf)))
        assert float(tl.logvar) == -0.4 and float(tn) == 3.0
    else:
        close(tlik.poisson_nll(_t(eta), _t(y), clamp=10.0), jlik.poisson_nll(eta, y, clamp=10.0))
    w, b = r.normal(size=(6, XD)), r.normal(size=6)
    x = r.normal(size=(B, XD))
    close(decode(linear_from(_t(w), _t(b)), _t(x)), jdec.decode(LinearParams(w, b), x))


# ---------------------------------------------------------------------------
# models/regression.py
# ---------------------------------------------------------------------------


def _blr(seed=9, cond=1e2, scale=1.0):
    r = _rng(seed)
    p = scale * _spd(seed, cond=cond)
    w = r.normal(size=(NF, XD))
    v = np.linalg.inv(p)
    return jreg.NSVBLR(w, p, v), treg.NSVBLR(_t(w), _t(p), _t(v))


def _leaves_close(got, want, tol=LA_TOL):
    for name, a, b in zip(want._fields, got, want):
        close(a, b, tol, name)


def test_predictive_distribution_and_sample():
    jb, tb = _blr()
    r = _rng(10)
    feat, eps = r.uniform(size=(B, NF)), r.normal(size=(NF, XD))
    g_t, g_j = treg.predict_gaussian(tb, _t(feat)), jreg.predict_gaussian(jb, feat)
    close(g_t.mean, g_j.mean, LA_TOL)
    close(g_t.logvar, g_j.logvar, LA_TOL)
    close(treg.weight_sqrt(tb), jreg.weight_sqrt(jb), LA_TOL)
    close(treg.predict_sample(tb, _t(feat), _t(eps)), jreg.predict_sample(jb, feat, eps),
          LA_TOL)


@pytest.mark.parametrize("scale,branch", [(1e3, "newton_schulz"), (1.0, "exact")])
@pytest.mark.parametrize("shrink,jitter", [(1.0, 0.0), (0.99, 1e-3)])
def test_rls_both_branches(scale, branch, shrink, jitter):
    """A precise prior (P large) keeps tau below NS_TAU_THRESHOLD: the
    Newton-Schulz branch; a vague one puts it above: the exact inverse."""
    jb, tb = _blr(11, scale=scale)
    r = _rng(12)
    feat, target = r.uniform(size=(B, NF)), r.normal(size=(B, XD))
    v = 0.7
    tau = np.sum((feat @ (np.asarray(jb.cov) / shrink)) * feat) / v
    assert (tau < treg.NS_TAU_THRESHOLD) == (branch == "newton_schulz"), tau
    want = jreg.rls(jb, feat, target, jnp.asarray(v), shrink=shrink, jitter=jitter)
    got = treg.rls(tb, _t(feat), _t(target), _t(v), shrink=shrink, jitter=jitter)
    _leaves_close(got, want)


def test_rls_exact_branch_is_nan_where_cholesky_fails():
    """An indefinite update: JAX's Cholesky gives NaN, the port's ``info``
    gate gives NaN too (the step's finite gate then drops the update)."""
    jb, tb = _blr(13)
    feat = np.ones((B, NF))
    p_bad = -np.eye(NF)
    got = treg.rls(tb._replace(precision=_t(p_bad)), _t(feat), _t(np.ones((B, XD))), _t(1.0))
    want = jreg.rls(jb._replace(precision=p_bad), feat, np.ones((B, XD)), jnp.asarray(1.0))
    assert not np.isfinite(np.asarray(want.cov)).all()
    assert not torch.isfinite(got.cov).all()


def test_one_shot_rls():
    jb, tb = _blr(14, cond=1.0)
    r = _rng(15)
    feat, target = r.uniform(size=(300, NF)), r.normal(size=(300, XD))
    want = jreg.one_shot_rls(jb, feat, target, jnp.asarray(0.3), shrink=0.999, jitter=1e-3)
    got = treg.one_shot_rls(tb, _t(feat), _t(target), _t(0.3), shrink=0.999, jitter=1e-3)
    _leaves_close(got, want)


def test_unported_backend_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        treg.predict_gaussian(object(), torch.zeros(1, NF))


# ---------------------------------------------------------------------------
# models/dynamics.py
# ---------------------------------------------------------------------------


def _cfg(**kw):
    base = dict(ydim=6, xdim=XD, udim=UD, n_rbf=NF, dtype="float64", rls_backend="nsv",
                rls_shrink=0.995, chol_jitter=1e-3, leak=0.1)
    base.update(kw)
    return JConfig(**base), tcfg.VJFConfig(**base)


def _dyn_pair(seed=16, scale=1.0):
    jr, tr = _rbf_pair(seed)
    jb, tb = _blr(seed, scale=scale)
    lv = -1.3
    return (jdyn.DynamicsState(jr, jb, jnp.asarray(lv), jnp.asarray(37, jnp.int32)),
            tdyn.DynamicsState(tr, tb, _t(lv), torch.tensor(37, dtype=torch.int32)))


# the JAX running variance of the state noise divides its int32 counter,
# which JAX does in float32 even under x64; the port weighs in the value's
# dtype (a deliberate deviation, ROADMAP Queue 3)
LOGVAR_TOL = dict(rtol=1e-6, atol=1e-7)


def _dyn_close(got, want, tol=LA_TOL):
    _leaves_close(got.rbf, want.rbf, tol)
    _leaves_close(got.blr, want.blr, tol)
    close(got.logvar, want.logvar, LOGVAR_TOL, "logvar")
    assert int(got.n_sample) == int(want.n_sample)


def test_features_and_transitions():
    js, ts = _dyn_pair()
    r = _rng(17)
    x, u, eps_w = r.normal(size=(B, XD)), r.normal(size=(B, UD)), r.normal(size=(NF, XD))
    close(tdyn.features(ts, _t(x), _t(u)), jdyn.features(js, x, u))
    g_t, g_j = tdyn.transition_gaussian(ts, _t(x), _t(u), 0.1), jdyn.transition_gaussian(
        js, x, u, 0.1)
    close(g_t.mean, g_j.mean, LA_TOL)
    close(g_t.logvar, g_j.logvar, LA_TOL)
    close(tdyn.transition_sample(ts, _t(x), _t(eps_w), _t(u), 0.1),
          jdyn.transition_sample(js, x, eps_w, u, 0.1), LA_TOL)
    qm, ql = r.normal(size=(2, B, XD))
    for quirk in (True, False):
        close(tdyn.dynamics_loss(ts, TG(g_t.mean, g_t.logvar), TG(_t(qm), _t(ql)), quirk),
              jdyn.dynamics_loss(js, g_j, JG(qm, ql), quirk), LA_TOL)


@pytest.mark.parametrize("noise", [False, True])
def test_forecast_rollout_with_injected_draws(noise):
    """The rollout against the JAX package's own sampled transition stepped
    with the same draws (the JAX rollout draws them from its key)."""
    js, ts = _dyn_pair(18)
    r = _rng(19)
    n_step = 6
    x0, us = r.normal(size=(B, XD)), r.normal(size=(n_step, B, UD))
    eps_w, eps_n = r.normal(size=(n_step, NF, XD)), r.normal(size=(n_step, B, XD))
    got = tdyn.forecast(ts, _t(x0), None, n_step, u=_t(us), noise=noise, leak=0.1,
                        draws=(_t(eps_w), _t(eps_n)))
    x = x0
    want = [x0]
    for t in range(n_step):
        x = jdyn.transition_sample(js, x, eps_w[t], us[t], 0.1)
        if noise:
            x = x + eps_n[t] * np.exp(0.5 * -1.3)
        want.append(x)
    close(got, np.stack(want), LA_TOL)
    drawn = tdyn.forecast(ts, _t(x0), torch.Generator().manual_seed(1), n_step, u=_t(us),
                          noise=noise)
    assert drawn.shape == (n_step + 1, B, XD) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("warm_up", [False, True])
def test_dynamics_update(warm_up):
    jc, tc = _cfg()
    js, ts = _dyn_pair(20, scale=30.0)
    r = _rng(21)
    xs, xt, u = r.normal(size=(B, XD)), r.normal(size=(B, XD)), r.normal(size=(B, UD))
    want = jdyn.dynamics_update(jc, js, xt, xs, u, warm_up=warm_up)
    got = tdyn.dynamics_update(tc, ts, _t(xt), _t(xs), _t(u), warm_up=warm_up)
    _dyn_close(got, want)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tdyn.dynamics_update(tc.replace(dynamics_update="kalman"), ts, _t(xt), _t(xs), _t(u))


def test_dynamics_initialize():
    """The bootstrap with the JAX re-init's own centroid draw injected."""
    jc, tc = _cfg()
    js, ts = _dyn_pair(22)
    r = _rng(23)
    n = 400
    xs, xt, u = r.normal(size=(n, XD)), r.normal(size=(n, XD)), r.normal(size=(n, UD))
    key = jax.random.PRNGKey(5)
    want = jdyn.dynamics_initialize(jc, key, js, xt, xs, u)
    xu = np.concatenate([xs, u], axis=1)
    rad = np.max(np.linalg.norm(xu, axis=-1))
    unit = (np.asarray(jrbf.reinit_rbf(key, js.rbf, xu).centroid) / rad + 1.0) / 2.0
    real = trbf.reinit_rbf

    def injected(gen, params, x):
        return real(gen, params, x, unit=_t(unit))

    mp = pytest.MonkeyPatch()
    mp.setattr(tdyn, "reinit_rbf", injected)
    try:
        got = tdyn.dynamics_initialize(tc, None, ts, _t(xt), _t(xs), _t(u))
    finally:
        mp.undo()
    _dyn_close(got, want)


def test_datasets_are_the_jax_packages():
    for name, fn in inspect.getmembers(jdata, inspect.isfunction):
        assert inspect.getsource(getattr(tdata, name)) == inspect.getsource(fn), name
    x = tdata.van_der_pol(T=50)
    np.testing.assert_array_equal(x, jdata.van_der_pol(T=50))
    np.testing.assert_array_equal(tdata.lorenz(T=40), jdata.lorenz(T=40))
