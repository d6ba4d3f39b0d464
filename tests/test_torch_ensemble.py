"""The port's ensembles (``vjf_tpu_torch.parallel``: ``fit_ensemble``,
``init_ensemble``, ``run_epoch_ensemble``, ``forecast_ensemble``, the
ensemble snapshots), the ``warm_gate`` of the autograd step and
``multistep_refine``, against the JAX package on the same numpy inputs at
float64, and the member-axis launchers' plain versions against the solo
ones. Inside the port, member k of an ensemble fit must equal a solo fit
of member k from the same seed chain (the contract of
``tests/test_ensemble.py``). The member-axis CUDA kernels are held against
their plain versions on the card (``tests/test_torch_cluster.py``'s
``card`` test and ``chip_smoke.py``).

Tolerances, float64 on both sides:
- ``warm_gate`` and ``multistep_refine``: the same formula, 1e-10;
- an epoch against JAX: ``EPOCH_TOL`` (the JAX epoch weighs its running
  variances in float32, a drift of about 1e-7 a step; see
  ``tests/test_torch_filter.py``);
- inside the port (gate against static flags, member against solo, plain
  member launches against solo launches): bit for bit where the same code
  runs, else 1e-12.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.config import StepFlags as JFlags
from vjf_tpu.config import VJFConfig
from vjf_tpu.models import vjf as jcore
from vjf_tpu.parallel import ensemble as JE
from vjf_tpu.parallel import fit_ensemble as jfit_ensemble
from vjf_tpu.parallel import forecast_ensemble as jforecast_ensemble
from vjf_tpu.parallel import init_ensemble as jinit_ensemble
from vjf_tpu.utils import checkpoint as jckpt
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.api import VJF
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF
from vjf_tpu_torch.parallel import ensemble as TE
from vjf_tpu_torch.parallel import (
    EnsembleSnapshot,
    fit_ensemble,
    forecast_ensemble,
    init_ensemble,
    run_epoch_ensemble,
)
from vjf_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SAME = dict(rtol=1e-10, atol=1e-12)
EPOCH_TOL = dict(rtol=1e-6, atol=1e-7)
PORT_TOL = dict(rtol=1e-12, atol=1e-12)


def _cfg(**kw):
    base = dict(ydim=8, xdim=2, udim=0, n_rbf=10, hidden_sizes=(6,), likelihood="gaussian",
                dtype="float64", rtol=0.05, stop_patience=1, rls_backend="nsv")
    base.update(kw)
    return VJFConfig(**base)


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _ring(seed, T=60, B=3, ydim=8, scale=1.0):
    rng = np.random.default_rng(seed)
    th = np.cumsum(0.15 + 0.01 * rng.normal(size=T))
    x = np.stack([np.cos(th), np.sin(th)], axis=-1) * scale
    c = rng.normal(size=(ydim, 2))
    return (x @ c.T)[:, None, :] + 0.1 * rng.normal(size=(T, B, ydim))


def _np_leaves(state):
    return convert.flatten(convert.state_to_numpy(state))


def _states_equal(a, b, tol=None):
    la, lb = _np_leaves(a), _np_leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        if tol is None:
            assert np.array_equal(la[k], lb[k]), k
        else:
            np.testing.assert_allclose(la[k], lb[k], err_msg=k, **tol)


def _close_to_jax(tstate, jstate, tol):
    a = convert.flatten(jax.tree.map(np.asarray, jstate))
    b = _np_leaves(tstate)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k], np.float64), np.asarray(a[k], np.float64),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------------------
# warm_gate and multistep_refine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warm", [True, False])
def test_warm_gate_matches_static_flags_and_jax(warm):
    """``run_epoch`` with a constant ``warm_gate`` gives the static-flag
    epoch bit for bit in the port, and JAX's static-flag epoch within
    ``EPOCH_TOL`` (``tests/test_ensemble.py`` holds JAX's gate against its
    static flags)."""
    cfg = _cfg()
    pcfg = _port_cfg(cfg)
    jstate = jcore.init_state(jax.random.PRNGKey(3), cfg)
    tstate = convert.state_from_numpy(pcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    y = _ring(0, T=12)
    rng = np.random.default_rng(1)
    eps = rng.normal(size=(2, 12, 3, 2))
    jus = jnp.zeros((12, 3, 0))
    tus = torch.zeros(12, 3, 0, dtype=torch.float64)
    lr = 1e-3
    static = dict(sgd=True, update=True, warm_up=warm, train_decoder=warm)
    gated = dict(sgd=True, update=True, warm_up=False, train_decoder=False)
    tnoise = (torch.tensor(eps[0]), torch.tensor(eps[1]))
    jnoise = (jnp.asarray(eps[0]), jnp.asarray(eps[1]))
    ref = tcore.run_epoch(pcfg, tcfg.StepFlags(**static), tstate, torch.tensor(y), tus, 0, lr,
                          noise=tnoise)
    got = tcore.run_epoch(pcfg, tcfg.StepFlags(**gated), tstate, torch.tensor(y), tus, 0, lr,
                          noise=tnoise, warm_gate=torch.tensor(1.0 if warm else 0.0,
                                                               dtype=torch.float64))
    _states_equal(got.state, ref.state)
    assert torch.equal(got.metrics.loss, ref.metrics.loss)
    assert torch.equal(got.q_means, ref.q_means)
    j = jcore.run_epoch(cfg, JFlags(**static), jstate, jnp.asarray(y), jus,
                        jax.random.PRNGKey(0), lr, noise=jnoise)
    _close_to_jax(got.state, j.state, EPOCH_TOL)
    np.testing.assert_allclose(got.metrics.loss.numpy(), np.asarray(j.metrics.loss),
                               **EPOCH_TOL)
    np.testing.assert_allclose(got.q_means.numpy(), np.asarray(j.q_means), **EPOCH_TOL)


def test_warm_gate_selects_per_member_phase():
    """A member-wise gate over ``run_epoch_ensemble``: each member gets its
    own static-flag epoch (the phase-mixed ensemble epoch)."""
    cfg = _port_cfg(_cfg())
    states = init_ensemble(4, cfg, 2, device="cpu")
    y = torch.tensor(_ring(1, T=16))
    us = torch.zeros(16, 3, 0, dtype=torch.float64)
    flags = tcfg.StepFlags(warm_up=False, train_decoder=False)
    res = run_epoch_ensemble(cfg, flags, states, y, us, [7, 8], 1e-3, warm_gate=[1.0, 0.0])
    for m, warm in enumerate((True, False)):
        solo = tcore.run_epoch(cfg, tcfg.StepFlags(warm_up=warm, train_decoder=warm),
                               states[m], y, us, [7, 8][m], 1e-3)
        _states_equal(res.state[m], solo.state)
        assert torch.equal(res.q_means[m], solo.q_means)


@pytest.mark.parametrize("horizon", [3, 5])
def test_multistep_refine_matches_jax(horizon):
    cfg = _cfg(multistep_refine=horizon, leak=0.05)
    pcfg = _port_cfg(cfg)
    jstate = jcore.init_state(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(horizon)
    # a trained weight mean, so the rollout moves
    w = 0.1 * rng.normal(size=np.asarray(jstate.dynamics.blr.w_mean).shape)
    jstate = jstate._replace(dynamics=jstate.dynamics._replace(
        blr=jstate.dynamics.blr._replace(w_mean=jnp.asarray(w))))
    tstate = convert.state_from_numpy(pcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    mu = rng.normal(size=(30, 3, 2))
    got = tcore.multistep_refine(pcfg, tstate, torch.tensor(mu))
    want = jcore.multistep_refine(cfg, jstate, jnp.asarray(mu))
    np.testing.assert_allclose(got.dynamics.blr.w_mean.numpy(),
                               np.asarray(want.dynamics.blr.w_mean), **SAME)
    assert not np.allclose(got.dynamics.blr.w_mean.numpy(), w)


def test_multistep_refine_in_fit_is_deprecated_and_guarded():
    cfg = _port_cfg(_cfg(multistep_refine=5, warmup_max=2))
    st = tcore.init_state(0, cfg, device="cpu")
    y = _ring(21)
    with pytest.warns(DeprecationWarning, match="multistep_refine is deprecated"):
        res = tcore.fit(cfg, st, y, seed=3, max_iter=4)
    assert np.isfinite(res.loss)
    with pytest.raises(ValueError, match="autonomous"):
        tcore.fit(cfg, st, y, seed=3, max_iter=2, mask=np.ones(60))
    bad = cfg.replace(udim=1)
    with pytest.raises(ValueError, match="autonomous"):
        fit_ensemble(bad, init_ensemble(0, bad, 2, device="cpu"), y, np.zeros((60, 1)),
                     seed=1, max_iter=2)


# ---------------------------------------------------------------------------
# member k of an ensemble == a solo fit of member k (inside the port)
# ---------------------------------------------------------------------------


def _mixed_pair(t=24):
    """Per-member data whose plateaus fire at different epochs (so the
    ensemble runs phase-mixed epochs), and at T 24 whose members stop at
    different epochs (8, and the last of 10)."""
    return np.stack([_ring(1, T=t), _ring(2, T=t, scale=0.3)])


@pytest.mark.parametrize("k_block", [1, 4])
def test_member_matches_solo_fit_with_phase_transitions(k_block, monkeypatch):
    cfg = _port_cfg(_cfg())
    ys = _mixed_pair()
    states = init_ensemble(0, cfg, 2, device="cpu")
    mixed = []
    real = TE._ensemble_epoch

    def spy(c, flags, *a, **kw):
        mixed.append((a[5] if len(a) > 5 else kw.get("warms")) is not None)
        return real(c, flags, *a, **kw)

    monkeypatch.setattr(TE, "_ensemble_epoch", spy)
    ens_losses = []
    # per epoch the members stop apart (8 and 10); in blocks of 4 the second is mixed
    max_iter = 10 if k_block == 1 else 8
    res = fit_ensemble(cfg, states, ys, seeds=[5, 6], max_iter=max_iter,
                       epochs_per_dispatch=k_block,
                       callback=lambda e, loss, r: ens_losses.append(np.array(loss)))
    assert any(mixed), "no phase-mixed epoch: the gated route was not exercised"
    for i in range(2):
        traj = []
        solo = tcore.fit(cfg, states[i], ys[i], seed=[5, 6][i], max_iter=max_iter,
                         epochs_per_dispatch=k_block,
                         callback=lambda e, loss, r: traj.append(loss))
        assert bool(res.warm_up[i]) == solo.warm_up
        assert int(res.epochs_run[i]) == solo.epochs_run
        assert float(res.lr[i]) == solo.lr
        np.testing.assert_allclose(res.loss[i], solo.loss, **PORT_TOL)
        _states_equal(res.states[i], solo.state, PORT_TOL)
        np.testing.assert_allclose(res.mu[i].numpy(), solo.mu.numpy(), **PORT_TOL)
        if k_block == 1:
            np.testing.assert_allclose(np.array(ens_losses)[:solo.epochs_run, i], traj,
                                       **PORT_TOL)
    if k_block == 1:
        assert res.epochs_run[0] != res.epochs_run[1]


def test_member_matches_solo_with_multistep_refine():
    cfg = _port_cfg(_cfg(multistep_refine=5, multistep_weight=0.3, warmup_max=2))
    ys = np.stack([_ring(21, T=30), _ring(22, T=30)])
    states = init_ensemble(1, cfg, 2, device="cpu")
    with pytest.warns(DeprecationWarning):
        res = fit_ensemble(cfg, states, ys, seeds=[8, 9], max_iter=4)
    for i in range(2):
        with pytest.warns(DeprecationWarning):
            solo = tcore.fit(cfg, states[i], ys[i], seed=[8, 9][i], max_iter=4)
        _states_equal(res.states[i], solo.state, PORT_TOL)


def test_fit_ensemble_shared_data_masks_and_facade():
    """A seed ensemble on one shared data set: members differ; a shared
    ragged mask makes the padding inert (NaN gives the same losses); the
    facade returns fitted members."""
    cfg = _port_cfg(_cfg())
    y = _ring(6, T=24)
    states = init_ensemble(2, cfg, 3, device="cpu")
    res = fit_ensemble(cfg, states, y, seed=1, max_iter=2)
    assert res.mu.shape == (3, 24, 3, 2) and np.all(np.isfinite(res.loss))
    w = [s.params.decoder.weight for s in res.states]
    assert not torch.allclose(w[0], w[1])
    mask = np.ones((24, 3))
    mask[18:, 1] = 0.0
    y_bad = y.copy()
    y_bad[18:, 1] = np.nan
    r1 = fit_ensemble(cfg, states[:2], y, seeds=[1, 2], max_iter=2, mask=mask)
    r2 = fit_ensemble(cfg, states[:2], y_bad, seeds=[1, 2], max_iter=2, mask=mask)
    np.testing.assert_array_equal(r1.loss, r2.loss)

    model = VJF.make_model(8, 2, n_rbf=10, hidden_sizes=[6], likelihood="gaussian",
                           dtype="float64", rtol=0.05, stop_patience=1, device="cpu")
    before = _np_leaves(model.state)
    fres, members = model.fit_ensemble(y, n_models=2, max_iter=3, seed=11)
    assert len(members) == 2 and all(np.array_equal(v, _np_leaves(model.state)[k])
                                     for k, v in before.items())
    for i, m in enumerate(members):
        assert m._decoder_frozen == (not bool(fres.warm_up[i]))
        assert torch.isfinite(m.forecast(np.zeros((1, 2)), n_step=5)[0]).all()
    assert not torch.allclose(members[0].state.params.decoder.weight,
                              members[1].state.params.decoder.weight)


# ---------------------------------------------------------------------------
# forecasting, conversion, snapshots
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ensemble():
    """A JAX ensemble of 3 members at ``_cfg()`` (one compiled trace for
    the tests that read it)."""
    return jax.jit(jinit_ensemble, static_argnums=(1, 2))(jax.random.PRNGKey(4), _cfg(), 3)


def test_forecast_ensemble_matches_jax_and_member_loop(monkeypatch, jax_ensemble):
    cfg = _cfg()
    pcfg = _port_cfg(cfg)
    n, n_step = 3, 6
    jstates = jax_ensemble
    tstates = convert.ensemble_from_numpy(pcfg, jax.tree.map(np.asarray, jstates),
                                          device="cpu")
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(n, 2, 2))
    # seeds drawn from the base seed, one a member: the member loop
    xs, ys = forecast_ensemble(pcfg, tstates, torch.tensor(x0), 9, n_step)
    assert xs.shape == (n, n_step + 1, 2, 2) and ys.shape == (n, n_step + 1, 2, 8)
    seeds = TE.member_seeds(9, n)
    for i in range(n):
        xi, yi = tcore.forecast(pcfg, tstates[i], torch.tensor(x0[i]), seeds[i], n_step=n_step)
        assert torch.equal(xs[i], xi) and torch.equal(ys[i], yi)
    # the same weight draw at every step on both sides
    eps_w = rng.normal(size=(10, 2))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.broadcast_to(
                            jnp.asarray(eps_w, dtype), shape))
    draws = [(torch.tensor(eps_w).expand(n_step, 10, 2), None)] * n
    txs, tys = forecast_ensemble(pcfg, tstates, torch.tensor(x0), None, n_step, draws=draws)
    # traced now, with the patched draw (no earlier call has this cfg)
    jxs, jys = jforecast_ensemble(cfg, jstates, jnp.asarray(x0), jax.random.PRNGKey(0), n_step)
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), **SAME)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), **SAME)


def test_ensemble_state_converts_from_and_to_jax(jax_ensemble):
    cfg = _cfg()
    jstates = jax_ensemble
    tree = jax.tree.map(np.asarray, jstates)
    tstates = convert.ensemble_from_numpy(_port_cfg(cfg), tree, device="cpu")
    assert isinstance(tstates, list) and len(tstates) == 3
    a = convert.flatten(tree)
    b = convert.flatten(convert.ensemble_to_numpy(tstates))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    one = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(lambda x: np.asarray(x[1]),
                                                                jstates), device="cpu")
    _states_equal(tstates[1], one)


@pytest.mark.parametrize("k_block", [1, 2])
def test_snapshot_resumes_bit_for_bit(k_block, tmp_path):
    """An interrupted ensemble fit resumed from its snapshot ends with the
    bits of the uninterrupted one, selection tracker included; the snapshot
    digests the config as the JAX package does."""
    cfg = _port_cfg(_cfg(select="forecast", select_horizon=5, select_starts=3))
    ys = _mixed_pair(t=12)
    states = init_ensemble(0, cfg, 2, device="cpu")
    kw = dict(seeds=[5, 6], epochs_per_dispatch=k_block)
    full = fit_ensemble(cfg, states, ys, max_iter=6, **kw)
    path = str(tmp_path / "ens.pt")
    fit_ensemble(cfg, states, ys, max_iter=4, checkpoint_path=path, checkpoint_every=2, **kw)
    snap = tckpt.load_ensemble_checkpoint(path, device="cpu")
    assert isinstance(snap, EnsembleSnapshot) and snap.epoch == 4
    assert all(snap.tracker[4])   # the tracker already holds a pick for each member
    assert snap.cfg_digest == bytes(jckpt.config_digest(_cfg(
        select="forecast", select_horizon=5, select_starts=3))).hex()
    other = init_ensemble(99, cfg, 2, device="cpu")   # superseded by the snapshot
    res = fit_ensemble(cfg, other, ys, max_iter=6, resume_from=path, seeds=[0, 0],
                       epochs_per_dispatch=k_block)
    for i in range(2):
        _states_equal(res.states[i], full.states[i])
    assert torch.equal(res.mu, full.mu)
    np.testing.assert_array_equal(res.loss, full.loss)
    np.testing.assert_array_equal(res.selected_epoch, full.selected_epoch)
    assert (res.epochs_run == full.epochs_run).all() and (res.lr == full.lr).all()
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        fit_ensemble(cfg, states, ys, max_iter=6, resume_from=path, seeds=[5, 6],
                     epochs_per_dispatch=k_block + 2)
    with pytest.raises(ValueError, match="different config"):
        fit_ensemble(cfg.replace(lr=0.5), states, ys, max_iter=6, resume_from=path,
                     seeds=[5, 6], epochs_per_dispatch=k_block)


def test_fit_ensemble_mesh_names_item_13():
    """``fit_ensemble(mesh=...)`` is ported (item 13): a mesh that is not a
    dp process group raises ``ValueError`` naming it."""
    cfg = _port_cfg(_cfg())
    with pytest.raises(ValueError, match="dp process group"):
        fit_ensemble(cfg, init_ensemble(0, cfg, 2, device="cpu"), _ring(0), seed=0,
                     mesh=object())


# ---------------------------------------------------------------------------
# the member-axis launchers' plain versions
# ---------------------------------------------------------------------------


def _fused_cfg(**kw):
    base = dict(likelihood="poisson", fused_step="on", fused_epoch="mega", ns_prefix=4)
    base.update(kw)
    return _port_cfg(_cfg(**base))


def test_member_plain_versions_equal_the_solo_loop():
    cfg = _fused_cfg()
    states = init_ensemble(3, cfg, 3, device="cpu")
    carry = TF.stack_carries([TF.pad_carry(cfg, s)._replace(
        rng_seed=torch.full((1, 1), 10 + m, dtype=torch.int32)) for m, s in enumerate(states)])
    g = torch.Generator().manual_seed(0)
    ys = torch.poisson(torch.full((3, 6, 2, 8), 0.7, dtype=torch.float64), generator=g)
    qm = torch.randn(3, 2, 2, generator=g, dtype=torch.float64)
    qlv = torch.randn(3, 2, 2, generator=g, dtype=torch.float64)
    lr = torch.tensor(1e-3, dtype=torch.float64)
    flags = tcfg.StepFlags()
    step = TF.fused_step_call(cfg, flags, carry, qm, qlv, ys[:, 0], None, None, None, lr)
    mega = TF.mega_epoch_call(cfg, flags, carry, qm, qlv, ys[0], None, None, None, lr,
                              mask=torch.ones(6, 2))
    for m in range(3):
        c = TF.member_carry(carry, m)
        s = TF.fused_step_plain(cfg, flags, c, qm[m], qlv[m], ys[m, 0], None, None, None, lr)
        for name in ("q_pack", "g_vec", "xt", "xs", "scal"):
            assert torch.equal(getattr(s, name), getattr(step, name)[m]), name
        assert torch.equal(s.carry.w_dyn, step.carry.w_dyn[m])
        c2, qp, sc = TF.mega_epoch_plain(cfg, flags, c, qm[m], qlv[m], ys[0], None, None, None,
                                         lr, mask=torch.ones(6, 2))
        assert torch.equal(qp, mega[1][m]) and torch.equal(sc, mega[2][m])
        assert torch.equal(c2.p_mat, mega[0].p_mat[m]) and torch.equal(c2.v_mat,
                                                                       mega[0].v_mat[m])


@pytest.mark.parametrize("shared", [True, False])
def test_member_epoch_equals_solo_epochs(shared):
    """``run_epoch_fused`` on a list of states (the prefix's member steps
    with the stacked exact fallback, then one member mega launch) against
    ``run_epoch_fused`` per member."""
    cfg = _fused_cfg(rls_shrink=0.99, chol_jitter=1e-3)
    states = init_ensemble(5, cfg, 3, device="cpu")
    g = torch.Generator().manual_seed(1)
    shape = (10, 2, 8) if shared else (3, 10, 2, 8)
    ys = torch.poisson(torch.full(shape, 0.6, dtype=torch.float64), generator=g)
    us = torch.zeros(10, 2, 0, dtype=torch.float64)
    res = TF.run_epoch_fused(cfg, tcfg.StepFlags(), states, ys, us, [1, 2, 3], 1e-3)
    for m in range(3):
        solo = TF.run_epoch_fused(cfg, tcfg.StepFlags(), states[m], ys if shared else ys[m],
                                  us, m + 1, 1e-3)
        _states_equal(res.state[m], solo.state, PORT_TOL)
        np.testing.assert_allclose(res.q_means[m].numpy(), solo.q_means.numpy(), **PORT_TOL)
        np.testing.assert_allclose(res.metrics.loss[m].numpy(), solo.metrics.loss.numpy(),
                                   **PORT_TOL)
        assert torch.equal(torch.isfinite(res.metrics.tau[m]), torch.isfinite(solo.metrics.tau))


def test_member_launch_checks_its_operands():
    """The member form of ``_launch`` (a stacked carry) refuses what the
    kernel cannot read: a CPU tensor."""
    cfg = _fused_cfg()
    carry = TF.stack_carries([TF.pad_carry(cfg, s) for s in init_ensemble(0, cfg, 2,
                                                                          device="cpu")])
    q = torch.zeros(2, 2, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="expected a tensor on"):
        TF._launch("mega_epoch", cfg, tcfg.StepFlags(), carry, q, q, torch.zeros(4, 2, 8),
                   None, None, None, torch.tensor(1e-3), torch.empty(2, 4, 2, 2, 2),
                   torch.empty(2, 4, 8))


# ---------------------------------------------------------------------------
# decisions against JAX on scripted epochs, demotion, prefix-free
# ---------------------------------------------------------------------------

SC_T, SC_PREFIX, SC_N = 24, 8, 3


def _tau_rows(taus, hots):
    """Per member a (T,) tau stream: 0 in the prefix, then ``tau`` with the
    ``hot`` share of the segment skipped (inf)."""
    seg = SC_T - SC_PREFIX
    rows = np.zeros((len(taus), SC_T))
    for i, (t, h) in enumerate(zip(taus, hots)):
        rows[i, SC_PREFIX:] = t
        rows[i, SC_PREFIX:SC_PREFIX + int(round(h * seg))] = np.inf
    return rows


def _pad_rows(vals, n):
    """A script's rows for ``n`` members: the JAX package pads a re-run's
    members to a power of two by repeating the first."""
    vals = list(vals)
    return np.array(vals + [vals[0]] * (n - len(vals)))[:n]


def _scripted_epoch(script, log, fw):
    calls = iter(script)

    def epoch(cfg, flags, *a, **kw):
        if fw == "jax":
            sts, y, lr, warms = a[2], a[3], a[6], a[7]
            n = int(jax.tree_util.tree_leaves(sts)[0].shape[0])
        else:
            sts, y, lr = a[0], a[1], a[4]
            warms = a[5] if len(a) > 5 else kw.get("warms")
            n = len(sts)
        losses, taus, hots = next(calls)
        gated = warms is not None or cfg.fused_step == "off"
        log.append((cfg.ns_prefix, cfg.fused_step, flags.warm_up,
                    None if warms is None else [float(w) for w in np.asarray(warms)],
                    float(np.float32(lr)), min(n, len(losses))))
        loss = np.repeat(_pad_rows(losses, n)[:, None], SC_T, axis=1).astype(np.float32)
        tau = None if gated else _tau_rows(_pad_rows(taus, n), _pad_rows(hots, n)).astype(
            np.float32)
        q = np.random.default_rng(len(log)).normal(size=(n, SC_T, y.shape[-2], 2)).astype(
            np.float32)
        arr = jnp.asarray if fw == "jax" else torch.tensor
        core = jcore if fw == "jax" else tcore
        metrics = core.Metrics(*(arr(loss) for _ in range(4)),
                               tau=None if tau is None else arr(tau))
        return core.EpochResult(sts, arr(q), arr(q), metrics)

    return epoch


def _scripted_epochs(script, log, fw):
    calls = iter(script)

    def epochs(cfg, flags, *a, **kw):
        if fw == "jax":
            sts, y, lrs, warms = a[2], a[3], a[6], a[7]
            n = int(jax.tree_util.tree_leaves(sts)[0].shape[0])
        else:
            sts, y, lrs = a[0], a[1], a[4]
            warms = a[5] if len(a) > 5 else kw.get("warms")
            n = len(sts)
        losses, taus, hots = next(calls)
        log.append((cfg.ns_prefix, cfg.fused_step, flags.warm_up,
                    None if warms is None else [float(w) for w in np.asarray(warms)],
                    [float(np.float32(v)) for v in np.asarray(lrs)], min(n, len(losses))))
        loss, tau, hot = (_pad_rows(v, n).astype(np.float32) for v in (losses, taus, hots))
        q = np.random.default_rng(len(log)).normal(size=(n, SC_T, y.shape[-2], 2)).astype(
            np.float32)
        arr = jnp.asarray if fw == "jax" else torch.tensor
        core = jcore if fw == "jax" else tcore
        metrics = core.Metrics(*(arr(loss) for _ in range(5)))
        return core.EpochsResult(sts, arr(q), arr(q), arr(loss), metrics, arr(tau), arr(hot))

    return epochs


# per dispatch: (losses, max taus, hot fractions) by member; a re-run of hot
# members is its own dispatch with their rows
SCRIPTS = {
    # members 0 and 2 leave warm-up at epoch 1, member 1 at epoch 2 (a
    # phase-mixed epoch between); a clean epoch engages prefix-free; member
    # 1 runs hot and re-runs alone; all hot: the ensemble demotes, and the
    # re-probe follows; members 0 and 1 converge before member 2
    "epochs": (1, dict(max_iter=12, warmup_max=0, repromote_after=2, stop_patience=2), [
        ([50.0, 60.0, 70.0], [0.0] * 3, [0.0] * 3),
        ([50.1, 45.0, 70.2], [0.0] * 3, [0.0] * 3),
        ([40.0, 46.0, 60.0], [0.0] * 3, [0.0] * 3),
        ([30.0, 29.0, 50.0], [0.01, 0.02, 0.03], [0.0] * 3),
        ([25.0, 24.0, 45.0], [0.01, 0.6, 0.02], [0.0, 0.5, 0.0]),
        ([23.5], [0.0], [0.0]),
        ([22.0, 20.0, 40.0], [0.8, 0.9, 0.8], [0.25, 0.25, 0.25]),
        ([21.0, 19.5, 39.0], [0.0] * 3, [0.0] * 3),
        ([20.9, 19.4, 38.9], [0.0] * 3, [0.0] * 3),
        ([20.8, 19.0, 35.0], [0.0] * 3, [0.0] * 3),
        ([20.8, 19.0, 35.3], [0.0] * 3, [0.0] * 3),
        ([20.8, 19.0, 35.31], [0.0] * 3, [0.0] * 3),
    ]),
    # blocks of 2: members 0 and 2 leave warm-up at the epoch-4 boundary,
    # member 1 is forced at warmup_max (a phase-mixed block between); a
    # clean block engages prefix-free; member 1's block runs hot and re-runs
    # alone, which revokes it
    "blocks": (2, dict(max_iter=12, warmup_max=6, repromote_after=2, stop_patience=1), [
        ([[50.0, 40.0], [60.0, 50.0], [70.0, 60.0]], [[0.0] * 2] * 3, [[0.0] * 2] * 3),
        ([[40.5, 40.0], [45.0, 40.0], [60.5, 60.0]], [[0.0] * 2] * 3, [[0.0] * 2] * 3),
        ([[30.0, 25.0], [35.0, 30.0], [50.0, 45.0]], [[0.0] * 2] * 3, [[0.0] * 2] * 3),
        ([[20.0, 15.0], [25.0, 20.0], [40.0, 35.0]], [[0.01, 0.02]] * 3, [[0.0] * 2] * 3),
        ([[12.0, 10.0], [16.0, 14.0], [30.0, 25.0]],
         [[0.01, 0.01], [0.3, 0.6], [0.01, 0.01]], [[0.0, 0.0], [0.0, 0.5], [0.0, 0.0]]),
        ([[13.0, 11.0]], [[0.0, 0.0]], [[0.0, 0.0]]),
        ([[9.0, 9.0], [10.0, 9.0], [20.0, 15.0]], [[0.0] * 2] * 3, [[0.0] * 2] * 3),
    ]),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_fit_ensemble_makes_the_jax_decisions(name, monkeypatch, jax_ensemble):
    """Dispatch by dispatch: each member's warm-up end (phase-mixed epochs
    with their gates), prefix-free engage and revoke, a hot member re-run
    alone, the whole-ensemble demotion and re-probe, convergence, the
    learning rate; and the results' epochs_run, phases, lr and loss."""
    k, kw, script = SCRIPTS[name]
    kw = dict(kw)
    max_iter = kw.pop("max_iter")
    cfg = _cfg(dtype="float32", fused_step="on", fused_epoch="mega", ns_prefix=SC_PREFIX,
               rtol=0.05, lr=1e-2, lr_decay=0.9, demote_hot_frac=0.1, **kw)
    y = _ring(7, T=SC_T).astype(np.float32)
    logs, results = {}, {}
    for fw in ("jax", "torch"):
        logs[fw] = []
        mod = JE if fw == "jax" else TE
        # the states pass through: the decisions read only the scripted rows
        monkeypatch.setattr(mod, "_ensemble_repair", lambda c, fl, n_b, sts: sts)
        monkeypatch.setattr(mod, "_ensemble_boot", (lambda c, u_ax, sts, *a: sts) if fw == "jax"
                            else (lambda c, sts, *a: sts))
        make = _scripted_epoch if k == 1 else _scripted_epochs
        monkeypatch.setattr(mod, "_ensemble_epoch" if k == 1 else "_ensemble_epochs",
                            make(script, logs[fw], fw))
        if fw == "jax":
            # the states pass through the scripted epochs: any of the right
            # widths will do
            results[fw] = jfit_ensemble(cfg, jax_ensemble, y, key=jax.random.PRNGKey(2),
                                        max_iter=max_iter, epochs_per_dispatch=k)
        else:
            st = init_ensemble(0, _port_cfg(cfg), SC_N, device="cpu")
            results[fw] = fit_ensemble(_port_cfg(cfg), st, y, seed=2, max_iter=max_iter,
                                       epochs_per_dispatch=k)
    assert logs["torch"] == logs["jax"]
    assert len(logs["jax"]) == len(script), "the script and the fit loop disagree"
    log = logs["jax"]
    assert any(e[3] is not None for e in log), "no phase-mixed dispatch"
    assert any(e[0] == 0 for e in log), "prefix-free never engaged"
    assert any(e[1] == "off" and e[5] < SC_N for e in log), "no per-member re-run"
    j, t = results["jax"], results["torch"]
    np.testing.assert_array_equal(t.epochs_run, j.epochs_run)
    np.testing.assert_array_equal(t.warm_up, j.warm_up)
    np.testing.assert_allclose(t.lr, j.lr, rtol=1e-12)
    np.testing.assert_allclose(t.loss, j.loss, rtol=1e-6)


def _force_hot(monkeypatch, member):
    """Member ``member`` reads hot on every watched epoch."""
    real = TE._member_tau_stats

    def stats(cfg, tau, t_len, n, dtype, device):
        max_tau, hot = real(cfg, tau, t_len, n, dtype, device)
        if tau is not None and n > member:
            hot = hot.clone()
            hot[member] = 1.0
        return max_tau, hot

    monkeypatch.setattr(TE, "_member_tau_stats", stats)


@pytest.mark.parametrize("k_block", [1, 2])
def test_hot_member_reruns_alone(k_block, monkeypatch, caplog):
    """A forced-hot member re-runs on the autograd route, and exactly the
    hot members are gathered (the JAX package pads them to a power of two:
    a deviation that changes no result); the healthy members keep the bits
    of the run without the demotion."""
    cfg = _fused_cfg(warmup_max=1, rtol=0.0, rls_shrink=0.99, chol_jitter=1e-3)
    y = _ring(3, T=12)
    states = init_ensemble(7, cfg, 4, device="cpu")
    kw = dict(seeds=[1, 2, 3, 4], max_iter=3, epochs_per_dispatch=k_block)
    clean = fit_ensemble(cfg, states, y, **kw)
    _force_hot(monkeypatch, 1)
    subs = []
    real = TE._ensemble_epoch

    def spy(c, flags, sts, *a, **k):
        if c.fused_step == "off":
            subs.append(len(sts))
        return real(c, flags, sts, *a, **k)

    monkeypatch.setattr(TE, "_ensemble_epoch", spy)
    with caplog.at_level(logging.WARNING, logger="vjf_tpu_torch"):
        hot = fit_ensemble(cfg, states, y, **kw)
    assert subs and all(s == 1 for s in subs), subs
    assert any("re-running only those members" in r.message for r in caplog.records)
    for i in (0, 2, 3):
        _states_equal(hot.states[i], clean.states[i])
        assert torch.equal(hot.mu[i], clean.mu[i])
    assert not torch.equal(hot.mu[1], clean.mu[1])
    assert TE._hot_indices(np.array([0, 1, 1, 1], bool)).tolist() == [1, 2, 3]
    assert JE._padded_hot_indices(np.array([0, 1, 1, 1], bool)).tolist() == [1, 2, 3, 1]


@pytest.mark.parametrize("k_block", [1, 3])
def test_prefix_free_dispatch_wiring(monkeypatch, k_block):
    """Once the (forced) decision engages, a later dispatch runs with
    ``ns_prefix=0``, and the first dispatch after warm-up still carried the
    full prefix (what the JAX test's ``in (8, 0)`` meant to pin)."""
    cfg = _port_cfg(_cfg(likelihood="poisson", dtype="float32", fused_step="on",
                         fused_epoch="mega", ns_prefix=8, warmup_max=2, rtol=0.0))
    ys = np.stack([_ring(30 + i, T=16) for i in range(2)]).astype(np.float32)
    states = init_ensemble(0, cfg, 2, device="cpu")
    monkeypatch.setattr(TE, "_prefix_free_next", lambda cur, h, t: True)
    seen = []
    real = TE._ensemble_epoch

    def spy(c, flags, *a, **kw):
        seen.append((c.ns_prefix, flags.warm_up))
        return real(c, flags, *a, **kw)

    monkeypatch.setattr(TE, "_ensemble_epoch", spy)
    res = fit_ensemble(cfg, states, np.abs(ys), seed=9, max_iter=4 * k_block,
                       epochs_per_dispatch=k_block)
    assert np.isfinite(res.loss).all()
    assert seen[0] == (8, True)
    first_rls = next(i for i, (_, warm) in enumerate(seen) if not warm)
    assert seen[first_rls][0] == 8, seen
    assert any(p == 0 for p, _ in seen), f"prefix-free never engaged: {seen}"
