"""The port's fit loop (``models.vjf.fit`` and ``_fit_blocked``), forecast
selection and evaluation against the JAX package: per-epoch ``fit`` at
float64 with injected noise and the same bootstrap draw on both sides, and
the blocked fit's decisions on scripted epoch sequences given to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.config import VJFConfig
from vjf_tpu.models import dynamics as jdyn
from vjf_tpu.models import rbf as jrbf
from vjf_tpu.models import vjf as jcore
from vjf_tpu.ops.pallas import fused_step as JF
from vjf_tpu.utils import evaluation as jeval
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.models import dynamics as tdyn
from vjf_tpu_torch.models import rbf as trbf
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF
from vjf_tpu_torch.utils import evaluation as teval

torch.set_num_threads(1)

T, B, YD, XD, NF = 40, 2, 10, 2, 15


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _cfg(**kw):
    base = dict(ydim=YD, xdim=XD, n_rbf=NF, hidden_sizes=(8,), likelihood="gaussian",
                dtype="float64", rls_backend="nsv", lr=3e-3, rtol=0.05)
    base.update(kw)
    return VJFConfig(**base)


def _data(seed=3):
    rng = np.random.default_rng(seed)
    phase = np.linspace(0, 6 * np.pi, T)
    x = np.stack([np.sin(phase), np.cos(phase)], axis=-1)
    y = x @ rng.normal(size=(XD, YD)) + 0.1 * rng.normal(size=(B, T, YD))
    return np.ascontiguousarray(y.transpose(1, 0, 2)), x


def _patch_reinit(monkeypatch, unit):
    """The bootstrap's centroid draw, the same unit draw on both sides."""
    def jax_reinit(key, params, x):
        r = jnp.max(jnp.linalg.norm(x, axis=-1))
        return jrbf.RBFParams((-1.0 + 2.0 * jnp.asarray(unit)) * r,
                              jnp.full_like(params.logwidth, jnp.log(r)))

    real = trbf.reinit_rbf
    monkeypatch.setattr(jdyn, "reinit_rbf", jax_reinit)
    monkeypatch.setattr(tdyn, "reinit_rbf",
                        lambda gen, params, x: real(gen, params, x, unit=torch.tensor(unit)))


@pytest.fixture(scope="module")
def fit_pair():
    """(JAX FitResult, port FitResult, cfg) of one per-epoch fit at float64:
    warm-up, the plateau and bootstrap, then RLS epochs."""
    max_iter = 8
    cfg = _cfg(lr=0.05, rtol=0.1)   # the plateau fires at epoch 4 (6.4% against 10%)
    y, _ = _data()
    rng = np.random.default_rng(4)
    eps = rng.normal(size=(max_iter, 2, T, B, XD))
    unit = rng.uniform(size=(NF, XD))
    mp = pytest.MonkeyPatch()
    _patch_reinit(mp, unit)
    try:
        state = jcore.init_state(jax.random.PRNGKey(0), cfg)
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


def test_fit_matches_jax_control_flow(fit_pair):
    ref, got, _ = fit_pair
    assert not ref.warm_up, "the warm-up plateau never fired: nothing was compared"
    assert (got.warm_up, got.epochs_run) == (ref.warm_up, ref.epochs_run)
    assert got.lr == pytest.approx(ref.lr, rel=1e-15)
    assert got.selected_epoch is None and ref.selected_epoch is None


# The JAX epoch weighs the state-noise running variance in float32 (its
# int32 counter, even under x64; the port weighs in float64, a deliberate
# deviation), so the RLS epochs drift apart from about 1e-7 a step; after
# the 3 RLS epochs here the loss read 2.0e-7 apart (relative), the
# posterior means 1.6e-6 (absolute; 2.0e-4 relative to |mu| + 1e-5), the
# RLS precision 3.1e-5 (absolute, on entries of order 1e2).
FIT_TOL = dict(rtol=2e-3, atol=1e-5)


def test_fit_matches_jax_values(fit_pair):
    ref, got, _ = fit_pair
    np.testing.assert_allclose(got.loss, ref.loss, rtol=1e-5)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(ref.mu), **FIT_TOL)
    np.testing.assert_allclose(got.logvar.numpy(), np.asarray(ref.logvar), **FIT_TOL)
    a = convert.flatten(jax.tree.map(np.asarray, ref.state))
    b = convert.flatten(convert.state_to_numpy(got.state))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k], np.float64), np.asarray(a[k], np.float64),
                                   err_msg=k, **FIT_TOL)


# ---------------------------------------------------------------------------
# the blocked fit on scripted epochs
# ---------------------------------------------------------------------------

# per dispatched block: (losses, max_taus, hot_fracs), one entry per epoch.
# The fit loops see nothing else of an epoch; the state passes through.
SCRIPTS = {
    # warm-up plateau in block 0; a clean first RLS block engages
    # prefix-free; a hot block revokes it and demotes; the re-probe after
    # repromote_after epochs; convergence on a repeated loss
    "plateau_prefix_free_demote_probe_converge": [
        ([50.0, 40.0], [0.0, 0.0], [0.0, 0.0]),
        ([40.01, 40.0], [0.0, 0.0], [0.0, 0.0]),
        ([30.0, 25.0], [0.01, 0.02], [0.0, 0.0]),
        ([21.0, 18.0], [0.3, 0.6], [0.0, 0.5]),
        ([20.0, 17.0], [0.0, 0.0], [0.0, 0.0]),
        ([14.0, 11.0], [0.0, 0.0], [0.0, 0.0]),
        ([9.0, 7.5], [0.01, 0.01], [0.0, 0.0]),
        ([6.2, 6.2], [0.01, 0.01], [0.0, 0.0]),
    ],
    # no plateau: warmup_max forces the transition; the hysteresis band
    # holds prefix-free; a tau in the fallback band revokes it
    "forced_warmup_hysteresis_revoke": [
        ([50.0, 40.0], [0.0, 0.0], [0.0, 0.0]),
        ([35.0, 30.0], [0.0, 0.0], [0.0, 0.0]),
        ([25.0, 20.0], [0.01, 0.04], [0.0, 0.0]),
        ([15.0, 10.0], [0.1, 0.2], [0.0, 0.0]),
        ([5.0, 2.0], [0.1, 0.3], [0.0, 0.0]),
        ([1.0, -1.0], [0.01, 0.01], [0.0, 0.0]),
    ],
    # a partial final block and a hot block that demotes for good
    "partial_block_permanent_demotion": [
        ([50.0, 40.0, 30.0], [0.0] * 3, [0.0] * 3),
        ([29.0, 28.99, 20.0], [0.0] * 3, [0.0] * 3),
        ([10.0, 9.0, 8.0], [0.01, 0.9, 0.01], [0.0, 0.2, 0.0]),
        ([7.0, 6.0, 5.0], [0.0] * 3, [0.0] * 3),
        ([4.0, 3.0, 2.0], [0.0] * 3, [0.0] * 3),
        ([1.0, 0.5], [0.0] * 2, [0.0] * 2),
    ],
}
SCRIPT_CFG = {
    "plateau_prefix_free_demote_probe_converge": dict(k=2, max_iter=16, warmup_max=0,
                                                      repromote_after=2),
    "forced_warmup_hysteresis_revoke": dict(k=2, max_iter=12, warmup_max=4,
                                            repromote_after=3),
    "partial_block_permanent_demotion": dict(k=3, max_iter=14, warmup_max=0,
                                             repromote_after=0),
}


def _scripted(script, log, framework):
    """A run_epochs stand-in that logs each dispatch's (ns_prefix,
    fused_step, warm_up, lrs) and returns the script's next block."""
    calls = iter(script)

    def run_epochs(cfg, flags, state, ys, us, seeds, lrs, *a, **kw):
        losses, taus, hots = next(calls)
        k = len(losses)
        log.append((cfg.ns_prefix, cfg.fused_step, flags.warm_up,
                    [float(np.float32(v)) for v in lrs]))
        rng = np.random.default_rng(len(log))
        q = rng.normal(size=(ys.shape[0], ys.shape[1], XD)).astype(np.float32)
        if framework == "jax":
            arr = jnp.asarray
            metrics = jcore.Metrics(*(arr(losses) for _ in range(4)), tau=arr(taus))
            return jcore.EpochsResult(state, arr(q), arr(q), arr(losses), metrics,
                                      arr(taus), arr(hots))
        arr = torch.tensor
        metrics = tcore.Metrics(*(arr(losses) for _ in range(4)), tau=arr(taus))
        assert len(seeds) == k
        return tcore.EpochsResult(state, arr(q), arr(q), arr(losses), metrics, arr(taus),
                                  arr(hots))

    return run_epochs


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_blocked_fit_makes_the_jax_decisions(name, monkeypatch):
    """Warm-up end, prefix-free engage and revoke (``ns_prefix`` 0 on the
    blocks where JAX dispatches it), demotion and re-probe, convergence and
    the learning-rate schedule, dispatch by dispatch."""
    sc = SCRIPT_CFG[name]
    cfg = _cfg(dtype="float32", fused_step="on", ns_prefix=8, warmup_max=sc["warmup_max"],
               repromote_after=sc["repromote_after"], rtol=0.05, lr=1e-2, lr_decay=0.9)
    y = _data(5)[0].astype(np.float32)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)     # run the JAX loop eagerly
    logs = {}
    results = {}
    for fw in ("jax", "torch"):
        logs[fw] = []
        if fw == "jax":
            monkeypatch.setattr(jcore, "run_epochs", _scripted(SCRIPTS[name], logs[fw], fw))
            st = jcore.init_state(jax.random.PRNGKey(0), cfg)
            results[fw] = jcore.fit(cfg, st, y, key=jax.random.PRNGKey(2),
                                    max_iter=sc["max_iter"], epochs_per_dispatch=sc["k"])
        else:
            monkeypatch.setattr(tcore, "run_epochs", _scripted(SCRIPTS[name], logs[fw], fw))
            st = tcore.init_state(0, _port_cfg(cfg), device="cpu")
            results[fw] = tcore.fit(_port_cfg(cfg), st, y, seed=2, max_iter=sc["max_iter"],
                                    epochs_per_dispatch=sc["k"])
    assert logs["torch"] == logs["jax"]
    assert len(logs["jax"]) == len(SCRIPTS[name]), "the script and the fit loop disagree"
    assert any(p == 0 for p, *_ in logs["jax"]) == (name != "partial_block_permanent_demotion")
    j, t = results["jax"], results["torch"]
    assert (t.warm_up, t.epochs_run) == (j.warm_up, j.epochs_run)
    assert t.lr == pytest.approx(j.lr, rel=1e-12)
    assert t.loss == pytest.approx(j.loss, rel=1e-6)


@pytest.mark.parametrize("hot", [0.0, 0.01])
@pytest.mark.parametrize("tau", [0.0, 0.01, 0.049, 0.05, 0.1, 0.2499, 0.25, 0.7])
@pytest.mark.parametrize("current", [False, True])
def test_prefix_free_next_truth_table(current, tau, hot):
    assert TF.prefix_free_next(current, hot, tau) is JF.prefix_free_next(current, hot, tau)


# ---------------------------------------------------------------------------
# selection and evaluation
# ---------------------------------------------------------------------------


def test_select_forecast_trains_like_select_loss():
    """The selection stream is derived from the fit's generator without
    drawing from it: training is bit-identical, only the returned snapshot
    differs."""
    cfg = _port_cfg(_cfg(warmup_max=2, rtol=1e-9, select_horizon=5, select_starts=4))
    y, _ = _data(6)
    seen = {}
    for sel in ("loss", "forecast"):
        c = cfg.replace(select=sel)
        losses = []
        res = tcore.fit(c, tcore.init_state(0, c, device="cpu"), y, seed=9, max_iter=4,
                        callback=lambda e, loss, r: losses.append(loss))
        seen[sel] = (losses, res)
    assert seen["loss"][0] == seen["forecast"][0]
    res = seen["forecast"][1]
    assert res.selected_epoch in (1, 2, 3) and np.isfinite(res.selected_metric)
    assert seen["loss"][1].selected_epoch is None


def test_evaluation_matches_jax():
    r = np.random.default_rng(7)
    mu, x = r.normal(size=(50, XD)), r.normal(size=(50, 3))
    assert teval.latent_r2(torch.tensor(mu), x) == pytest.approx(jeval.latent_r2(mu, x),
                                                                 rel=1e-12)
    cfg = _cfg(likelihood="poisson")
    state = jcore.init_state(jax.random.PRNGKey(3), cfg)
    tstate = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(np.asarray, state),
                                      device="cpu")
    y = r.poisson(1.0, size=(50, YD)).astype(np.float64)
    j_model, j_pers = jeval.forecast_rmse(cfg, state, mu, y, jax.random.PRNGKey(0),
                                          horizon=5, n_starts=6)
    t_model, t_pers = teval.forecast_rmse(_port_cfg(cfg), tstate, mu, y, 0, horizon=5,
                                          n_starts=6)
    assert t_pers == pytest.approx(j_pers, rel=1e-12)
    # the model's rollout draws differ (key against generator); its value
    # is the port's own rollout from the same starts, decoded on the count
    # scale
    starts = np.linspace(0, 50 - 5 - 2, 6).astype(int)
    _, yf = tcore.forecast(_port_cfg(cfg), tstate, torch.tensor(mu[starts]), 0, n_step=5)
    yf = np.exp(np.minimum(yf[1:].numpy(), cfg.poisson_clamp))
    err = np.mean([np.mean((yf[:, j] - y[s + 1:s + 6]) ** 2) for j, s in enumerate(starts)])
    assert t_model == pytest.approx(np.sqrt(err), rel=1e-12)
    assert np.isfinite(j_model)
