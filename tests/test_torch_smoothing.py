"""Post-hoc smoothing and co-smoothing evaluation in the port
(``vjf_tpu_torch/models/smoothing.py``, ``models/evaluate.py`` and
``VJF.smooth``/``evaluate``/``evaluate_kfold``) against the JAX package's on
the same numpy inputs and the same trained state (carried by ``convert``), at
float64: the linearization, the Gaussian smoother on both R forms, the
iterated Laplace smoother, the batched smoother with its masks, x_ref and
controls, the held-out scoring and the k-fold rotation; then the port's own
semantics.

Each JAX result is computed once, in a module-scoped fixture; the JAX
smoother compiles once per configuration, so the cases share its calls. The
JAX package's ``smooth_batch`` is a ``vmap`` of its single-sequence smoother,
so trial b of a batched JAX result is the reference of the port's
single-sequence call on trial b; a (T, 1, ydim) batch scores as one (T,
ydim) sequence does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu import api as japi
from vjf_tpu.config import VJFConfig as JConfig
from vjf_tpu.models import evaluate as jev
from vjf_tpu.models import smoothing as jsm
from vjf_tpu.models import vjf as jcore
from vjf_tpu_torch import VJF, convert
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch.models import evaluate as tev
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.models import smoothing as tsm

torch.set_num_threads(1)

YD, XD, NF, T, B = 8, 2, 6, 13, 3
# float64, the same operations: the summation order of the products differs
TOL = dict(rtol=1e-8, atol=1e-10)
# the Poisson fixture's batch is one trial: it is the single-sequence case
KW = dict(n_rbf=NF, hidden_sizes=(4,), dtype="float64", rls_backend="nsv")


def _close(got, want, tol=TOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **tol)


def _cfg_kw(likelihood, udim=0, dynamics="rbf"):
    kw = dict(ydim=YD, xdim=XD, udim=udim, likelihood=likelihood, dynamics=dynamics, **KW)
    if dynamics == "sgp":
        kw.update(n_inducing=NF)
    return kw


def _path(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path)


def _pair(likelihood, udim=0, dynamics="rbf", seed=0):
    """(JAX cfg, JAX state, port cfg, port state on the CPU), one state: the
    port's fresh state with random dynamics weights and a small state noise
    (a fresh state's weights are 0, its linearization the identity), put
    into the structure of JAX's ``init_state`` (``eval_shape``: no compile)."""
    kw = _cfg_kw(likelihood, udim, dynamics)
    jc, tc = JConfig(**kw), tcfg.VJFConfig(**kw)
    leaves = convert.flatten(convert.state_to_numpy(tcore.init_state(seed, tc, device="cpu")))
    rng = np.random.default_rng(seed)
    leaves["dynamics.blr.w_mean"] = 0.4 * rng.normal(size=leaves["dynamics.blr.w_mean"].shape)
    leaves["dynamics.logvar"] = np.asarray(np.log(0.05))
    shapes = jax.eval_shape(lambda: jcore.init_state(jax.random.PRNGKey(seed), jc))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    assert sorted(_path(p) for p, _ in paths) == sorted(leaves)
    js = jax.tree.unflatten(treedef, [jnp.asarray(leaves[_path(p)], leaf.dtype)
                                      for p, leaf in paths])
    return jc, js, tc, convert.state_from_numpy(tc, jax.tree.map(np.asarray, js), device="cpu")


def _counts(rng, shape):
    return rng.poisson(1.5, size=shape).astype(np.float64)


def _holes(rng, shape, p=0.2):
    """A 0/1 channel mask with about ``p`` of the entries missing."""
    return (rng.random(shape) > p).astype(np.float64)


def _nan_at(y, cm):
    y = y.copy()
    y[np.broadcast_to(cm, y.shape) == 0] = np.nan
    return y


@pytest.fixture(scope="module")
def gauss():
    """Gaussian likelihood, SGP dynamics with a control: the dense-R smoother
    of a batch with shared controls (one pass), and the held-out evaluation
    of that batch with per-trial x_ref, controls and channel mask (three
    passes of the diagonal-R smoother), held-out channels given unsorted."""
    jc, js, tc, ts = _pair("gaussian", udim=1, dynamics="sgp", seed=1)
    rng = np.random.default_rng(11)
    d = dict(y=rng.normal(size=(T, B, YD)), us_shared=rng.normal(size=(T, 1)),
             us=rng.normal(size=(T, B, 1)), x_ref=0.5 * rng.normal(size=(T, B, XD)),
             cm=_holes(rng, (T, B, YD)), heldout=[6, 1, 6])
    d["y_nan"] = _nan_at(d["y"], d["cm"])
    dense = jsm.smooth_batch(jc, js, d["y"], us=d["us_shared"], n_iter=1)
    ev = jev.heldout_eval(jc, js, d["y_nan"], d["heldout"], x_ref=d["x_ref"], us=d["us"],
                          n_iter=3, channel_mask=d["cm"])
    held = np.ones(YD)
    held[[1, 6]] = 0.0
    d["infer"] = d["cm"] * held
    return jc, js, tc, ts, d, dense, ev


@pytest.fixture(scope="module")
def pois():
    """Poisson RBF, one trial: the held-out evaluation at the default eight
    Laplace passes with a shared channel mask and a boolean heldout, and the
    3-fold rotation with the fold loop (the same smoother call each fold)."""
    jc, js, tc, ts = _pair("poisson", seed=2)
    rng = np.random.default_rng(12)
    y = _counts(rng, (T, 1, YD))
    cm = _holes(rng, (T, YD))
    heldout = np.zeros(YD, bool)
    heldout[[0, 3, 7]] = True
    d = dict(y=y, cm=cm, y_nan=_nan_at(y, cm[:, None]), heldout=heldout,
             infer=cm * ~heldout)
    ev = jev.heldout_eval(jc, js, d["y_nan"], heldout, channel_mask=cm)
    kf = jev.kfold_channel_eval(jc, js, d["y_nan"], n_folds=3, seed=4, channel_mask=cm)
    return jc, js, tc, ts, d, ev, kf


@pytest.fixture(scope="module")
def rbf_controls():
    """RBF dynamics with a control, for the linearization alone."""
    return _pair("gaussian", udim=1, seed=4)


@pytest.fixture(scope="module")
def sgp_plain():
    """SGP dynamics without controls, for the linearization alone."""
    return _pair("poisson", dynamics="sgp", seed=5)


# ---------------------------------------------------------------- linearization


_j_linearize = jax.jit(jsm.linearize_dynamics, static_argnums=0)


@pytest.mark.parametrize("case", ["rbf_point", "rbf_steps", "rbf_controls_point",
                                  "rbf_controls_steps", "sgp_point", "sgp_steps",
                                  "sgp_controls_point", "sgp_controls_steps"])
def test_linearize_dynamics_matches_jax_jacfwd(case, gauss, pois, rbf_controls, sgp_plain):
    (jc, js, tc, ts) = {"rbf": pois, "rbf_controls": rbf_controls, "sgp": sgp_plain,
                        "sgp_controls": gauss}[case.rsplit("_", 1)[0]][:4]
    rng = np.random.default_rng(len(case))
    steps = case.endswith("steps")
    x = rng.normal(size=(T, XD) if steps else (XD,))
    u = rng.normal(size=(T, 1) if steps else (1,)) if jc.udim else None
    want = _j_linearize(jc, js, jnp.asarray(x), None if u is None else jnp.asarray(u))
    got = tsm.linearize_dynamics(tc, ts, x, u)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_linearize_broadcasts_a_point_against_steps(gauss):
    """One point against per-step controls, and per-step points against one
    control, as JAX broadcasts them."""
    jc, js, tc, ts = gauss[:4]
    rng = np.random.default_rng(3)
    x, u = rng.normal(size=(T, XD)), rng.normal(size=(T, 1))
    got = tsm.linearize_dynamics(tc, ts, x[0], u)
    for g, w in zip(got, _j_linearize(jc, js, jnp.asarray(x[0]), jnp.asarray(u))):
        _close(g, w)
    a, c = tsm.linearize_dynamics(tc, ts, x, u[0])
    a1, c1 = tsm.linearize_dynamics(tc, ts, x[4], u[0])
    _close(a[4], a1, dict(rtol=1e-14, atol=1e-15))
    _close(c[4], c1, dict(rtol=1e-14, atol=1e-15))


# ---------------------------------------------------------------- smoothers


def test_smooth_batch_dense_r_matches_jax(gauss):
    jc, js, tc, ts, d, (jf, jsmth), _ = gauss
    filt, sm = tsm.smooth_batch(tc, ts, d["y"], us=d["us_shared"], n_iter=1)
    for got, want, name in ((filt.means, jf.means, "filtered means"),
                            (filt.covs, jf.covs, "filtered covs"),
                            (sm.means, jsmth.means, "smoothed means"),
                            (sm.covs, jsmth.covs, "smoothed covs")):
        assert got.shape == want.shape
        _close(got, want, name=name)


@pytest.mark.parametrize("trial", range(B))
def test_smooth_one_sequence_matches_jax(gauss, trial):
    """``smooth`` (dense R, one pass) and ``smooth_iterated`` (three passes
    with x_ref and a channel mask: the diagonal form) on one trial."""
    jc, js, tc, ts, d, (_, jsmth), ev = gauss
    _, sm = tsm.smooth(tc, ts, d["y"][:, trial], us=d["us_shared"])
    _close(sm.means, jsmth.means[:, trial])
    _close(sm.covs, jsmth.covs[:, trial])
    _, it = tsm.smooth_iterated(tc, ts, d["y_nan"][:, trial], n_iter=3,
                                x_ref=d["x_ref"][:, trial],
                                channel_mask=d["infer"][:, trial], us=d["us"][:, trial])
    _close(it.means, ev.smoothed_means[:, trial])


def test_smooth_batch_masked_x_ref_controls_matches_jax(gauss):
    """Per-trial channel mask, x_ref and controls, three passes."""
    jc, js, tc, ts, d, _, ev = gauss
    _, sm = tsm.smooth_batch(tc, ts, d["y_nan"], x_ref=d["x_ref"], channel_mask=d["infer"],
                             n_iter=3, us=d["us"])
    _close(sm.means, ev.smoothed_means)


def test_smooth_poisson_matches_jax_at_eight_passes(pois):
    """The default eight Laplace passes on one sequence, through
    ``smooth``, ``smooth_poisson``, ``smooth_iterated`` and
    ``smooth_batch``, with a shared channel mask."""
    jc, js, tc, ts, d, ev, _ = pois
    want = ev.smoothed_means[:, 0]
    y = d["y_nan"][:, 0]
    for fn, kw in ((tsm.smooth, {}), (tsm.smooth_poisson, {}),
                   (tsm.smooth_iterated, dict(n_iter=8))):
        _, sm = fn(tc, ts, y, channel_mask=d["infer"], **kw)
        _close(sm.means, want, name=fn.__name__)
    _, sm = tsm.smooth_batch(tc, ts, d["y_nan"], channel_mask=d["infer"])
    _close(sm.means, ev.smoothed_means)


# ---------------------------------------------------------------- evaluation


def _same_eval(got, want, poisson):
    assert np.array_equal(got.heldout, want.heldout)
    keys = ["eta", "pred", "loglik", "loglik_null", "r2", "smoothed_means"]
    keys += ["bits_per_spike", "n_spikes"] if poisson else []
    for k in keys:
        _close(getattr(got, k), getattr(want, k), name=k)
    if not poisson:
        assert got.bits_per_spike is None and got.n_spikes is None


def test_heldout_eval_batch_gaussian_matches_jax(gauss):
    """Unsorted, repeated held-out indices, a per-trial channel mask with NaN
    at its missing entries, x_ref and controls."""
    jc, js, tc, ts, d, _, ev = gauss
    got = tev.heldout_eval(tc, ts, d["y_nan"], d["heldout"], x_ref=d["x_ref"], us=d["us"],
                           n_iter=3, channel_mask=d["cm"])
    _same_eval(got, ev, poisson=False)
    assert np.array_equal(got.heldout, [1, 6])


def test_heldout_eval_one_sequence_poisson_matches_jax(pois):
    """A boolean heldout and a shared channel mask: the (T, ydim) sequence
    and the (T, 1, ydim) batch against JAX's (T, 1, ydim) batch."""
    jc, js, tc, ts, d, ev, _ = pois
    got = tev.heldout_eval(tc, ts, d["y_nan"], d["heldout"], channel_mask=d["cm"])
    _same_eval(got, ev, poisson=True)
    one = tev.heldout_eval(tc, ts, d["y_nan"][:, 0], d["heldout"], channel_mask=d["cm"])
    for k in ("loglik", "loglik_null", "bits_per_spike", "r2"):
        _close(getattr(one, k), getattr(ev, k), name=k)
    _close(one.pred, ev.pred[:, 0])
    _close(one.smoothed_means, ev.smoothed_means[:, 0])


@pytest.mark.parametrize("mode", ["loop", "vmap_chunk2"])
def test_kfold_matches_jax(pois, mode):
    jc, js, tc, ts, d, _, kf = pois
    kw = dict(vmap_folds=True, fold_chunk=2) if mode != "loop" else {}
    got = tev.kfold_channel_eval(tc, ts, d["y_nan"], n_folds=3, seed=4, channel_mask=d["cm"],
                                 **kw)
    assert len(got.folds) == 3
    for f, (g, w) in enumerate(zip(got.folds, kf.folds)):
        _same_eval(g, w, poisson=True)
    _close(got.loglik, kf.loglik)
    _close(got.loglik_null, kf.loglik_null)
    _close(got.bits_per_spike, kf.bits_per_spike)
    _close(got.r2, kf.r2)


def test_facade_matches_jax_facade(pois, monkeypatch):
    """``VJF.smooth``/``evaluate``/``evaluate_kfold`` on a state carried from
    the JAX facade (``VJF.make_model`` there, built on the trained state)."""
    jc, js, tc, ts, d, _, _ = pois
    monkeypatch.setattr(japi.core, "init_state", lambda *a, **k: js)
    jm = japi.VJF.make_model(YD, XD, likelihood="poisson", **KW)
    assert jm.cfg == jc
    tm = VJF.make_model(YD, XD, likelihood="poisson", device="cpu", **KW)
    tm.state = convert.state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jm.state),
                                        device="cpu")
    jf, jsmth = jm.smooth(d["y_nan"], channel_mask=d["infer"])
    tf, tsmth = tm.smooth(d["y_nan"], channel_mask=d["infer"])
    _close(tf.means, jf.means)
    _close(tsmth.covs, jsmth.covs)
    _, one = tm.smooth(d["y_nan"][:, 0], channel_mask=d["infer"])
    _close(one.means, jsmth.means[:, 0])
    _same_eval(tm.evaluate(d["y_nan"], d["heldout"], channel_mask=d["cm"]),
               jm.evaluate(d["y_nan"], d["heldout"], channel_mask=d["cm"]), poisson=True)
    got = tm.evaluate_kfold(d["y_nan"], n_folds=3, seed=4, channel_mask=d["cm"])
    want = jm.evaluate_kfold(d["y_nan"], n_folds=3, seed=4, channel_mask=d["cm"])
    _close(got.bits_per_spike, want.bits_per_spike)
    _close(got.r2, want.r2)


# ---------------------------------------------------------------- port semantics


@pytest.mark.parametrize("which", ["gauss", "pois"])
def test_smooth_batch_equals_a_loop_of_smooth(which, gauss, pois):
    """Per-trial x_ref, channel mask and controls (Gaussian, SGP); three
    Poisson trials with a shared channel mask."""
    if which == "gauss":
        _, _, tc, ts, d, _, _ = gauss
        y = d["y_nan"]
        kw = dict(x_ref=d["x_ref"], channel_mask=d["infer"], us=d["us"])
    else:
        _, _, tc, ts, d, _, _ = pois
        y = _counts(np.random.default_rng(5), (T, B, YD))
        kw = dict(x_ref=np.random.default_rng(6).normal(size=(T, B, XD)),
                  channel_mask=d["infer"])
    _, sm = tsm.smooth_batch(tc, ts, y, n_iter=2, **kw)
    for i in range(B):
        one_kw = {k: (v if v.ndim == 2 and k == "channel_mask" else v[:, i])
                  for k, v in kw.items()}
        _, one = tsm.smooth_iterated(tc, ts, y[:, i], n_iter=2, **one_kw)
        _close(sm.means[:, i], one.means, dict(rtol=1e-12, atol=1e-13))
        _close(sm.covs[:, i], one.covs, dict(rtol=1e-12, atol=1e-13))


def test_heldout_values_never_reach_the_predictions(gauss, pois):
    for fix, kw in ((gauss, dict(x_ref="x_ref", us="us", channel_mask="cm")),
                    (pois, dict(channel_mask="cm"))):
        tc, ts, d = fix[2], fix[3], fix[4]
        kw = {k: d[v] for k, v in kw.items()}
        idx = tev._normalize_heldout(d["heldout"], YD)
        base = tev.heldout_eval(tc, ts, d["y_nan"], d["heldout"], **kw)
        bad = d["y_nan"].copy()
        bad[..., idx] = 1e6 * np.random.default_rng(0).normal(size=bad[..., idx].shape)
        hit = tev.heldout_eval(tc, ts, bad, d["heldout"], **kw)
        for k in ("eta", "pred", "smoothed_means"):
            assert torch.equal(getattr(base, k), getattr(hit, k)), k
        assert not torch.equal(base.loglik, hit.loglik)


@pytest.mark.parametrize("fill", [0.0, 1e6])
def test_masked_entries_give_the_same_bits_whatever_they_hold(pois, fill):
    _, _, tc, ts, d, _, _ = pois
    base = tev.heldout_eval(tc, ts, d["y_nan"], d["heldout"], channel_mask=d["cm"])
    y = np.where(np.isnan(d["y_nan"]), fill, d["y_nan"])
    got = tev.heldout_eval(tc, ts, y, d["heldout"], channel_mask=d["cm"])
    for k in ("bits_per_spike", "loglik", "loglik_null", "r2", "pred"):
        assert torch.equal(getattr(got, k), getattr(base, k)), k
    assert torch.isfinite(base.bits_per_spike)


def test_bits_per_spike_is_nan_without_spikes(pois):
    """No spike in the scored entries: bits/spike is NaN, the log-likelihoods
    stay finite."""
    _, _, tc, ts, d, _, _ = pois
    y = d["y"].copy()
    y[..., d["heldout"]] = 0.0
    ev = tev.heldout_eval(tc, ts, y, d["heldout"], n_iter=2)
    assert float(ev.n_spikes) == 0.0 and torch.isnan(ev.bits_per_spike)
    assert torch.isfinite(ev.loglik) and torch.isfinite(ev.loglik_null)


def test_one_step_sequences(gauss, pois):
    for fix in (gauss, pois):
        tc, ts, d = fix[2], fix[3], fix[4]
        y = d["y"][:1, 0]
        us = d["us"][:1, 0] if tc.udim else None
        filt, sm = tsm.smooth(tc, ts, y, us=us)
        assert sm.means.shape == (1, XD) and sm.covs.shape == (1, XD, XD)
        _close(sm.means, filt.means, dict(rtol=0, atol=0))
        ev = tev.heldout_eval(tc, ts, y, [2, 5], us=us)
        assert torch.isfinite(ev.loglik) and ev.pred.shape == (1, 2)


def test_wire_format_counts_smooth_as_floats(pois):
    _, _, tc, ts, d, _, _ = pois
    y8 = d["y"].astype(np.uint8)
    _, a = tsm.smooth_batch(tc, ts, torch.from_numpy(y8), n_iter=2)
    _, b = tsm.smooth_batch(tc, ts, d["y"], n_iter=2)
    assert torch.equal(a.means, b.means)


def _raises(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


def test_validation_errors_are_those_of_jax(gauss, pois):
    jg, jgs, tg, tgs, dg = gauss[:5]
    jp, jps, tp, tps, dp = pois[:5]
    y3, y2 = dg["y"], dg["y"][:, 0]
    us = dg["us"]
    cases = [
        ("smooth_batch 2-d", lambda m, c, s: m.smooth_batch(c, s, y2, us=us[:, 0])),
        ("smooth_batch x_ref", lambda m, c, s: m.smooth_batch(c, s, y3, x_ref=y3, us=us)),
        ("smooth_batch cm 3-d", lambda m, c, s: m.smooth_batch(
            c, s, y3, channel_mask=np.ones((T, 2, YD)), us=us)),
        ("smooth_batch cm 2-d", lambda m, c, s: m.smooth_batch(
            c, s, y3, channel_mask=np.ones((T, 3)), us=us)),
        ("smooth_batch no us", lambda m, c, s: m.smooth_batch(c, s, y3)),
        ("smooth_batch us 3-d", lambda m, c, s: m.smooth_batch(c, s, y3, us=us[:, :2])),
        ("smooth_batch us 2-d", lambda m, c, s: m.smooth_batch(c, s, y3, us=us[:4, 0])),
        ("smooth 3-d", lambda m, c, s: m.smooth(c, s, y3, us=us)),
        ("smooth no us", lambda m, c, s: m.smooth(c, s, y2)),
        ("smooth us shape", lambda m, c, s: m.smooth(c, s, y2, us=us[:4, 0])),
        ("smooth x_ref shape", lambda m, c, s: m.smooth(c, s, y2, x_ref=y2, us=us[:, 0])),
        ("iterated n_iter", lambda m, c, s: m.smooth_iterated(c, s, y2, n_iter=0,
                                                              us=us[:, 0])),
        ("linearize no u", lambda m, c, s: m.linearize_dynamics(c, s, np.zeros(XD))),
    ]
    for name, fn in cases:
        want = _raises(lambda: fn(jsm, jg, jgs))
        assert _raises(lambda: fn(tsm, tg, tgs)) == want, name
    yp = dp["y"]
    cases = [
        ("poisson n_iter", lambda m, c, s: m.smooth_poisson(c, s, yp[:, 0], n_iter=0)),
        ("poisson 3-d", lambda m, c, s: m.smooth_poisson(c, s, yp)),
        ("heldout bool shape", lambda m, c, s: m.heldout_eval(c, s, yp, np.ones(3, bool))),
        ("heldout range", lambda m, c, s: m.heldout_eval(c, s, yp, [1, YD])),
        ("heldout empty", lambda m, c, s: m.heldout_eval(c, s, yp, [])),
        ("heldout all", lambda m, c, s: m.heldout_eval(c, s, yp, np.arange(YD))),
        ("heldout ys ndim", lambda m, c, s: m.heldout_eval(c, s, yp[0, 0], [1])),
        ("heldout ys width", lambda m, c, s: m.heldout_eval(c, s, yp[..., :4], [1])),
        ("heldout cm shape", lambda m, c, s: m.heldout_eval(
            c, s, yp, [1], channel_mask=np.ones((T, 2, YD)))),
        ("heldout mesh 2-d", lambda m, c, s: m.heldout_eval(c, s, yp[:, 0], [1],
                                                            mesh=object())),
        ("kfold n_folds", lambda m, c, s: m.kfold_channel_eval(c, s, yp, n_folds=1)),
        ("kfold vmapped mesh 2-d", lambda m, c, s: m._kfold_folds_vmapped(
            c, s, yp[:, 0], [np.array([1])], mesh=object())),
    ]
    for name, fn in cases:
        mod = (jsm, tsm) if name.startswith("poisson") else (jev, tev)
        want = _raises(lambda: fn(mod[0], jp, jps))
        assert _raises(lambda: fn(mod[1], tp, tps)) == want, name


def test_mesh_names_roadmap_item_13(pois):
    """Trials over several cards are ported (item 13): ``mesh=`` on a batch
    that is not a dp process group raises ``ValueError`` naming it; on one
    sequence ``heldout_eval`` raises JAX's ``ValueError``."""
    _, _, tc, ts, d, _, _ = pois
    with pytest.raises(ValueError, match="dp process group"):
        tsm.smooth_batch(tc, ts, d["y"], mesh=object())
    with pytest.raises(ValueError, match="dp process group"):
        tev.kfold_channel_eval(tc, ts, d["y"], n_folds=2, mesh=object())
    with pytest.raises(ValueError, match="mesh= applies only to batched"):
        tev.heldout_eval(tc, ts, d["y"][:, 0], [1], mesh=object())
