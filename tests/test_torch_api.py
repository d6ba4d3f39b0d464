"""The port's facade (``vjf_tpu_torch.api.VJF``) against the JAX package's
(``vjf_tpu.api.VJF``): the same numpy inputs, the state carried across by
``convert``, the sampling noise injected on both sides (JAX's
``jax.random.normal`` and the port's ``VJF._normals``), at float64. Also
the port's own contracts: ``make_model``'s precedence, the fit's
bookkeeping, ``save``/``load`` and the card as the default device."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu import api as japi
from vjf_tpu.models import dynamics as jdyn
from vjf_tpu.models import rbf as jrbf
from vjf_tpu.models import vjf as jcore
from vjf_tpu_torch import VJF, VJFConfig, convert
from vjf_tpu_torch.models import dynamics as tdyn
from vjf_tpu_torch.models import rbf as trbf
from vjf_tpu_torch.models import vjf as tcore

torch.set_num_threads(1)

YD, XD, NF, B = 5, 2, 6, 2
# float64 on both sides and the same algorithm: only the order of sums
# differs (tests/test_torch_filter.py's limit for one step)
TOL = dict(rtol=1e-9, atol=1e-10)
# where the state-noise running variance updates: the JAX package weighs it
# in float32 (its int32 counter, even under x64; the port weighs in
# float64, a deliberate deviation), 2.4e-8 relative in dynamics.logvar after
# one step here, and it feeds the next steps' dynamics term (the limit of
# tests/test_torch_filter.py's epochs)
STEP_TOL = dict(rtol=1e-6, atol=1e-7)
# whole fits: that drift over the RLS epochs (tests/test_torch_fit.py's limit)
FIT_TOL = dict(rtol=2e-3, atol=1e-5)
KW = dict(n_rbf=NF, hidden_sizes=[3], likelihood="gaussian", dtype="float64",
          rls_backend="nsv", lr=1e-2)


def _pair(**kw):
    """(JAX facade, port facade on the CPU) with the same state."""
    kw = {**KW, **kw}
    jm = japi.VJF.make_model(YD, XD, **kw)
    tm = VJF.make_model(YD, XD, device="cpu", **kw)
    tm.state = convert.state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jm.state),
                                        device="cpu")
    return jm, tm


def _inject(monkeypatch, jm, tm, eps):
    """Every sampling draw of a step, on both sides, from ``eps`` (one
    (2, B, xdim) array per draw, in order)."""
    it_j, it_t = iter(eps), iter(eps)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(next(it_j), dtype))
    monkeypatch.setattr(tm, "_normals", lambda n: torch.tensor(next(it_t)))


def _close(got, want, name="", tol=TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got), np.float64),
                               np.asarray(want, np.float64), err_msg=name, **tol)


def _same_state(tm, jm, tol=STEP_TOL):
    a = convert.flatten(jax.tree.map(np.asarray, jm.state))
    b = convert.flatten(convert.state_to_numpy(tm.state))
    assert a.keys() == b.keys()
    for k in a:
        _close(b[k], a[k], k, tol)


def test_forward_and_loss_match_jax(monkeypatch):
    jm, tm = _pair()
    rng = np.random.default_rng(0)
    y = rng.normal(size=(B, YD))
    _inject(monkeypatch, jm, tm, [rng.normal(size=(2, B, XD))])
    want, got = jm.forward(y), tm.forward(y)
    for name, w, g in zip(("xs", "pt", "qt", "xt", "py"), want, got):
        if isinstance(w, tuple):
            _close(g.mean, w.mean, name + ".mean")
            _close(g.logvar, w.logvar, name + ".logvar")
        else:
            _close(g, w, name)
    for warm_up in (False, True):
        _close(tm.loss(y, *got, warm_up=warm_up), jm.loss(y, *want, warm_up=warm_up),
               f"loss warm_up={warm_up}")


@pytest.mark.parametrize("masks", ["none", "mask", "channel_mask", "both"])
def test_filter_steps_match_jax(monkeypatch, masks):
    """Three online steps with the posterior carried, with and without the
    trial and channel masks (a masked entry of y is NaN)."""
    jm, tm = _pair()
    rng = np.random.default_rng(1)
    _inject(monkeypatch, jm, tm, [rng.normal(size=(2, B, XD)) for _ in range(3)])
    qj = qt = None
    for t in range(3):
        y = rng.normal(size=(B, YD))
        kw = {}
        if masks in ("mask", "both"):
            kw["mask"] = np.array([1.0, float(t != 1)])
        if masks in ("channel_mask", "both"):
            cm = (rng.uniform(size=(B, YD)) > 0.3).astype(np.float64)
            y = np.where(cm > 0, y, np.nan)
            kw["channel_mask"] = cm
        qj, lj = jm.filter(y, qs=qj, **kw)
        qt, lt = tm.filter(y, qs=qt, **kw)
        _close(lt, lj, f"loss {t}", STEP_TOL)
        _close(qt.mean, qj.mean, f"q.mean {t}", STEP_TOL)
        _close(qt.logvar, qj.logvar, f"q.logvar {t}", STEP_TOL)
    _same_state(tm, jm)


@pytest.mark.parametrize("lik_kw", [dict(), dict(likelhood=False), dict(likelihood=False),
                                    dict(likelhood=False, likelihood=True),
                                    dict(transition=False)])
def test_update_matches_jax(lik_kw):
    """The gradient-free update, with the reference's misspelt kwarg and its
    corrected alias (which wins)."""
    jm, tm = _pair()
    rng = np.random.default_rng(2)
    y, xs, xt = rng.normal(size=(B, YD)), rng.normal(size=(B, XD)), rng.normal(size=(B, XD))
    jm.update(y, xs, xt=xt, **lik_kw)
    tm.update(y, xs, xt=xt, **lik_kw)
    _same_state(tm, jm)


def test_velocity_and_forecast_match_jax(monkeypatch):
    jm, tm = _pair()
    # a trained posterior, so the velocity field is not zero
    rng = np.random.default_rng(3)
    jm.update(rng.normal(size=(8, YD)), rng.normal(size=(8, XD)), xt=rng.normal(size=(8, XD)))
    tm.state = convert.state_from_numpy(tm.cfg, jax.tree.map(np.asarray, jm.state),
                                        device="cpu")
    grid = rng.normal(size=(7, XD))
    _close(tm.velocity(grid), jm.velocity(grid), "velocity")
    # the rollout's weight draw, the same at every step on both sides
    eps_w = rng.normal(size=(NF, XD))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(eps_w, dtype))
    monkeypatch.setattr(tdyn, "rollout_draws",
                        lambda gen, n, nf, nout, x_shape, dtype, device, noise=False:
                        (torch.tensor(eps_w).expand(n, nf, nout), None))
    x0 = rng.normal(size=(B, XD))
    (jx, jy), (tx, ty) = jm.forecast(x0, n_step=5), tm.forecast(x0, n_step=5)
    _close(tx, jx, "forecast x")
    _close(ty, jy, "forecast y")
    assert tx.shape == (6, B, XD) and ty.shape == (6, B, YD)


@pytest.mark.parametrize("args,kw", [
    ((6, 2), {}),
    ((6, 2, 1, 12, [4, 3], "Gaussian"), {}),
    ((6, 2), dict(likelihood="POISSON", lr=3e-3, rtol=0.0, warmup_max=5)),
    ((6, 2), dict(hidden_sizes=(7,), n_rbf=9, dtype="float64", rls_backend="precision")),
])
def test_make_model_precedence_matches_jax(args, kw):
    """make_model's own defaults (the reference's: poisson, 100 RBFs, one
    hidden layer of 20) win over the config's; its arguments over both; the
    likelihood is case-free and ``hidden_sizes`` a tuple; every other
    keyword is a config field."""
    jm = japi.VJF.make_model(*args, **kw)
    tm = VJF.make_model(*args, device="cpu", **kw)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    if "likelihood" not in kw and len(args) < 6:
        assert tm.cfg.likelihood == "poisson" != VJFConfig(ydim=6, xdim=2).likelihood
    assert type(tm.state.dynamics.blr).__name__ == type(jm.state.dynamics.blr).__name__
    with pytest.raises(TypeError):
        VJF.make_model(6, 2, device="cpu", no_such_field=1)


def _patch_fit(monkeypatch, max_iter, t_len, n_batch, seed=4):
    """The same per-epoch noise and bootstrap draw in both facades' fits:
    each facade's ``fit`` gets a ``noise_hook`` (JAX's also ``donate=False``),
    the RBF re-init one unit draw."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(2 * max_iter, 2, t_len, n_batch, XD))
    unit = rng.uniform(size=(NF, XD))
    offset = {"j": 0, "t": 0}

    def hook(side, wrap):
        def noise(e):
            k = offset[side] + e
            return wrap(eps[k, 0]), wrap(eps[k, 1])
        return noise

    real_j, real_t = jcore.fit, tcore.fit

    def jfit(*a, **kw):
        out = real_j(*a, donate=False, noise_hook=hook("j", jnp.asarray), **kw)
        offset["j"] += out.epochs_run
        return out

    def tfit(*a, **kw):
        out = real_t(*a, noise_hook=hook("t", torch.tensor), **kw)
        offset["t"] += out.epochs_run
        return out

    def jax_reinit(key, params, x):
        r = jnp.max(jnp.linalg.norm(x, axis=-1))
        return jrbf.RBFParams((-1.0 + 2.0 * jnp.asarray(unit)) * r,
                              jnp.full_like(params.logwidth, jnp.log(r)))

    real_reinit = trbf.reinit_rbf
    monkeypatch.setattr(jcore, "fit", jfit)
    monkeypatch.setattr(tcore, "fit", tfit)
    monkeypatch.setattr(jdyn, "reinit_rbf", jax_reinit)
    monkeypatch.setattr(tdyn, "reinit_rbf", lambda gen, params, x:
                        real_reinit(gen, params, x, unit=torch.tensor(unit)))


def test_fit_bookkeeping_matches_jax(monkeypatch):
    """Two facade fits: the warm-up forced to end, the decoder frozen for
    good, the learning rate carried into the second fit, ``epochs_run``,
    and the posteriors and states against JAX's facade."""
    t_len, max_iter = 24, 4
    jm, tm = _pair(rtol=0.0, warmup_max=2, rls_shrink=0.999, chol_jitter=1e-3)
    _patch_fit(monkeypatch, 2 * max_iter, t_len, B)
    rng = np.random.default_rng(5)
    y = rng.normal(size=(t_len, B, YD))
    for round_ in range(2):
        mj, lj, loss_j = jm.fit(y, max_iter=max_iter)
        mt, lt, loss_t = tm.fit(y, max_iter=max_iter)
        assert (tm.epochs_run, tm._decoder_frozen) == (jm.epochs_run, jm._decoder_frozen)
        assert tm._decoder_frozen and tm.epochs_run == max_iter
        assert tm._lr == pytest.approx(jm._lr, rel=1e-15)
        assert tm._lr == pytest.approx(KW["lr"] * 0.9 ** (max_iter * (round_ + 1)), rel=1e-12)
        _close(loss_t, loss_j, f"loss {round_}", FIT_TOL)
        _close(mt, mj, f"mu {round_}", FIT_TOL)
        _close(lt, lj, f"logvar {round_}", FIT_TOL)
        _same_state(tm, jm, FIT_TOL)
    assert tm.selected_epoch is None and jm.selected_epoch is None


def test_fit_list_of_trials_in_and_out(monkeypatch):
    """A list of unequal trials in, per-trial posteriors out, as JAX's."""
    jm, tm = _pair(rtol=0.0, warmup_max=1)
    _patch_fit(monkeypatch, 3, 20, 3)
    rng = np.random.default_rng(6)
    trials = [rng.normal(size=(n, YD)) for n in (20, 13, 17)]
    mj, lj, _ = jm.fit(trials, max_iter=3)
    mt, lt, _ = tm.fit(trials, max_iter=3)
    assert [m.shape for m in mt] == [(20, XD), (13, XD), (17, XD)]
    for a, b in zip(mt, mj):
        _close(a, b, tol=FIT_TOL)
    for a, b in zip(lt, lj):
        _close(a, b, tol=FIT_TOL)
    with pytest.raises(ValueError, match="EITHER a list"):
        tm.fit(trials, mask=np.ones((20, 3)), max_iter=1)
    with pytest.raises(ValueError, match="per-trial list"):
        tm.fit(trials, u=np.zeros((20, 0)), max_iter=1)


def _leaves(model):
    return convert.flatten(convert.state_to_numpy(model.state))


@pytest.mark.parametrize("backend", ["nsv", "auto"])
def test_save_load_roundtrip_is_bit_exact(tmp_path, backend):
    """The whole model round-trips (the state, the learning rate, the
    decoder freeze, the generator; an 'auto' backend pinned to the form it
    resolved to), and one filter step and one fit epoch then give the bits
    of the model that was never saved."""
    cfg_kw = dict(KW, dtype="float32", rls_backend=backend, fused_step="on", ns_prefix=4)
    model = VJF.make_model(YD, XD, device="cpu", **cfg_kw)
    rng = np.random.default_rng(7)
    y = rng.normal(size=(16, B, YD)).astype(np.float32)
    model.fit(y, max_iter=3, rtol=1e9)        # the plateau fires: decoder frozen
    assert model._decoder_frozen
    model._lr = 5e-4
    path = str(tmp_path / "model.pt")
    model.save(path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model.pt"]
    loaded = VJF.load(path, device="cpu")
    assert loaded._decoder_frozen and loaded._lr == 5e-4
    assert loaded.cfg.rls_backend == type(model.state.dynamics.blr).__name__[:-3].lower()
    a, b = _leaves(model), _leaves(loaded)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert torch.equal(model.generator.get_state(), loaded.generator.get_state())
    q1, l1 = model.filter(y[0])
    q2, l2 = loaded.filter(y[0])
    assert torch.equal(q1.mean, q2.mean) and torch.equal(l1, l2)
    f1, f2 = model.fit(y, max_iter=1), loaded.fit(y, max_iter=1)
    assert torch.equal(f1[0], f2[0]) and f1[2] == f2[2]
    a, b = _leaves(model), _leaves(loaded)
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("method,item", [
    ("fit_ensemble", "13"),
    # the ids keep the items that ported each method (12, then 13 for mesh=)
    pytest.param("smooth", "13", id="smooth-12"),
    pytest.param("evaluate", "13", id="evaluate-12"),
    pytest.param("evaluate_kfold", "13", id="evaluate_kfold-12")])
def test_deferred_methods_name_their_roadmap_item(method, item):
    """``mesh=`` of the facade is ported (members or trials over several
    cards, item 13): what is not a dp process group raises ``ValueError``
    naming it, here on a (T, B, ydim) batch."""
    model = VJF.make_model(YD, XD, device="cpu", **KW)
    args = {"fit_ensemble": (np.zeros((4, YD)),), "smooth": (np.zeros((4, 2, YD)),),
            "evaluate": (np.zeros((4, 2, YD)), [1]), "evaluate_kfold": (np.zeros((4, 2, YD)),)}
    kw = dict(n_models=2) if method == "fit_ensemble" else {}
    with pytest.raises(ValueError, match="dp process group"):
        getattr(model, method)(*args[method], mesh=object(), **kw)


def test_fit_mesh_names_item_13():
    """``VJF.fit(mesh=...)`` is ported (item 13): a mesh that is not a dp
    process group raises ``ValueError`` naming it, as does one sequence's
    ``smooth`` with such a mesh."""
    model = VJF.make_model(YD, XD, device="cpu", **KW)
    with pytest.raises(ValueError, match="dp process group"):
        model.fit(np.zeros((4, YD)), mesh=object(), max_iter=1)
    with pytest.raises(ValueError, match="dp process group"):
        model.smooth(np.zeros((4, YD)), mesh=object())


def test_vjf_defaults_to_the_card():
    """The facade builds on the card unless asked for the CPU; without a
    card it raises and never carries on on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VJF.make_model(YD, XD, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VJF(VJFConfig(ydim=YD, xdim=XD))
    assert VJF.make_model(YD, XD, device="cpu", **KW).state.dynamics.blr.w_mean.device.type \
        == "cpu"
    for fn in (VJF.__init__, VJF.make_model, VJF.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
