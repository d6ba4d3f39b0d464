"""Training over several ranks in the port (``parallel/sharded.py``: the
relaxed-sync merge and epoch; ``fit(mesh=...)``, ``fit_ensemble(mesh=...)``,
``smooth_batch``/``kfold_channel_eval`` with ``mesh=``) against the JAX
package's ``_merge_local_states`` and ``run_epoch_sync_every`` on a CPU
``dp`` mesh, and against the port's own single-process calls.

In this process: the merge math on two per-device states against JAX's under
``shard_map`` on a 2-device mesh (both precision-carrying backends, the RLS
on and off, ``sync_trust`` 0 and 0.25, float64); the relaxed-sync epoch at
world size 1 (gloo over a ``HashStore``) against JAX's on one device with
JAX's own per-segment draws injected; JAX's tests of the same behaviour
(validation, the warm-up merge, ``sync_trust``, the two warnings, masks),
where JAX's 8-device epoch is reproduced by :func:`_ranks_epoch`; and the
refusals. One two-process spawn (gloo over a free localhost port, one 90 s
deadline, both ranks killed and reaped in ``finally``) runs the world-2
cases: the relaxed-sync epoch against JAX's on 2 devices, exact-sync
``fit(mesh=...)`` against the single-process fit with every rank's state
bit-equal to rank 0's, ``fit_ensemble(mesh=...)`` member by member bit for
bit, the smoother and the k-fold evaluation, a checkpoint written at
world size 2 and resumed, and the autograd epoch and ``fit`` over the
``(2, 1)`` and ``(1, 2)`` meshes (``tests/test_torch_tp.py``'s jobs and
checks, whose four-process spawn runs ``(2, 2)``). The workers import
torch and the port only; the parent writes their inputs, computes every
reference while they run and compares."""
import logging
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.models import evaluate as tev
from vjf_tpu_torch.models import smoothing as tsm
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.parallel import fit_ensemble, init_ensemble, make_dp_group
from vjf_tpu_torch.parallel.sharded import (
    merge_contribution,
    merge_from_sums,
    run_epoch_sync_every,
)
from vjf_tpu_torch.types import Gaussian

from test_torch_tp import (
    CASES,
    FIT_CASES,
    TP_JOBS,
    check_fit_case,
    check_others,
    check_tp_case,
    tp_job,
    tp_refs,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# float64, the same operations in another order: rounding only
TOL = dict(rtol=1e-9, atol=1e-12)
# the relaxed-sync epoch against JAX's at float64: the port divides the
# running-variance counters in float64 where JAX divides int32 counters into
# float32 weights (ROADMAP Queue 3), about 1e-7 a step
EPOCH_TOL = dict(rtol=1e-5, atol=1e-7)
K_MERGE = 4
MERGE_KW = dict(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), likelihood="gaussian",
                dtype="float64", rls_shrink=0.99, chol_jitter=1e-3)
# the relaxed-sync epochs: JAX's test_sync_every_single_device_identity
SYNC_KW = dict(ydim=8, xdim=2, n_rbf=10, hidden_sizes=(6,), likelihood="gaussian",
               dtype="float64", rls_backend="precision")


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec

    from vjf_tpu.config import StepFlags, VJFConfig
    from vjf_tpu.models import vjf as jcore
    from vjf_tpu.parallel import make_mesh
    from vjf_tpu.parallel import sharded as jsh

    sync = jax.jit(jsh.run_epoch_sync_every,
                   static_argnames=("cfg", "flags", "mesh", "sync_every"))
    return types.SimpleNamespace(jax=jax, jnp=jnp, shard_map=shard_map, P=PartitionSpec,
                                 StepFlags=StepFlags, VJFConfig=VJFConfig, core=jcore,
                                 make_mesh=make_mesh, sh=jsh, sync=sync)


@pytest.fixture(scope="module")
def group1():
    """A real world-size-1 gloo group, in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_dp_group()
    finally:
        dist.destroy_process_group()


def _path(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path)


def _leaves(state) -> dict:
    return convert.flatten(convert.state_to_numpy(state))


def _jax_leaves(jx, tree) -> dict:
    paths, _ = jx.jax.tree_util.tree_flatten_with_path(tree)
    return {_path(p): np.asarray(x) for p, x in paths}


def _close_leaves(got: dict, want: dict, tol=TOL, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=float),
                                   np.asarray(want[k], dtype=float), err_msg=f"{what} {k}",
                                   **tol)


def _pair(jx, leaves: dict, **kw):
    """(JAX state, port state on the CPU) from one set of leaves, put into
    the structure of JAX's ``init_state`` (``eval_shape``: no compile)."""
    jax, jnp = jx.jax, jx.jnp
    jc = jx.VJFConfig(**kw)
    shapes = jax.eval_shape(lambda: jx.core.init_state(jax.random.PRNGKey(0), jc))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    assert sorted(_path(p) for p, _ in paths) == sorted(leaves)
    js = jax.tree.unflatten(treedef, [jnp.asarray(leaves[_path(p)], leaf.dtype)
                                      for p, leaf in paths])
    return js, convert.state_from_numpy(tcfg.VJFConfig(**kw), jax.tree.map(np.asarray, js),
                                        device="cpu")


def _with_precision(leaves: dict, p: np.ndarray) -> dict:
    """``leaves`` with the weight posterior's precision ``p`` and its
    derived leaves (V for nsv; the factor and ``inv(L)^T`` for precision)."""
    out = dict(leaves)
    out["dynamics.blr.precision"] = p
    if "dynamics.blr.cov" in out:
        out["dynamics.blr.cov"] = np.linalg.inv(p)
    if "dynamics.blr.prec_chol" in out:
        chol = np.linalg.cholesky(p)
        out["dynamics.blr.prec_chol"] = chol
        out["dynamics.blr.prec_chol_inv_t"] = np.linalg.inv(chol).T
    return out


def _base_leaves(kw: dict, seed: int = 0) -> dict:
    """A fresh state's leaves with random weights and a PD precision."""
    leaves = _leaves(tcore.init_state(seed, tcfg.VJFConfig(**kw), device="cpu"))
    rng = np.random.default_rng(seed)
    nf, no = leaves["dynamics.blr.w_mean"].shape
    a = rng.normal(size=(nf, nf))
    leaves["dynamics.blr.w_mean"] = 0.4 * rng.normal(size=(nf, no))
    return _with_precision(leaves, np.eye(nf) + a @ a.T / nf)


def _merge_case(jx, backend, rls_active, trust, seed=0):
    """The start state and two ranks' advanced states, as each pair."""
    kw = dict(MERGE_KW, rls_backend=backend, sync_trust=trust)
    base = _base_leaves(kw, seed)
    rng = np.random.default_rng(seed + 1)
    nf, no = base["dynamics.blr.w_mean"].shape
    lam = kw["rls_shrink"] ** K_MERGE
    jacc = kw["chol_jitter"] * (1.0 - lam) / (1.0 - kw["rls_shrink"])
    p0 = base["dynamics.blr.precision"]
    locs = []
    for c in range(2):
        f = rng.normal(size=(3 * K_MERGE, nf))
        p = lam * p0 + jacc * np.eye(nf) + f.T @ f if rls_active else p0
        lv = _with_precision(base, p)
        lv["dynamics.blr.w_mean"] = base["dynamics.blr.w_mean"] + 0.3 * rng.normal(size=(nf, no))
        for k in lv:
            if k.startswith("params."):
                lv[k] = base[k] + 0.05 * rng.normal(size=np.shape(base[k]))
        lv["dynamics.logvar"] = base["dynamics.logvar"] + 0.1 * rng.normal()
        lv["dynamics.n_sample"] = base["dynamics.n_sample"] + 3 + c
        lv["lik_n_sample"] = base["lik_n_sample"] + 2.0 + c
        locs.append(_pair(jx, lv, **kw))
    return kw, _pair(jx, base, **kw), locs


# ---------------------------------------------------------------------------
# the merge math against JAX's _merge_local_states under shard_map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trust", [0.0, 0.25])
@pytest.mark.parametrize("rls_active", [True, False])
@pytest.mark.parametrize("backend", ["nsv", "precision"])
def test_merge_matches_jax(jx, backend, rls_active, trust):
    jax, jnp, P = jx.jax, jx.jnp, jx.P
    kw, (j0, t0), locs = _merge_case(jx, backend, rls_active, trust)
    jc = jx.VJFConfig(**kw)
    mesh = jx.make_mesh(2, axis_names=("dp",))
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), locs[0][0], locs[1][0])

    def per_device(s0, sl):
        merged = jx.sh._merge_local_states(jc, s0, jax.tree.map(lambda x: x[0], sl), "dp", 2,
                                           K_MERGE, rls_active=rls_active)
        return jax.tree.map(lambda x: x[None], merged)

    out = jax.jit(jx.shard_map(per_device, mesh=mesh, in_specs=(P(), P("dp")),
                               out_specs=P("dp"), check_vma=False))(j0, stacked)
    summed = merge_contribution(t0, locs[0][1]) + merge_contribution(t0, locs[1][1])
    for dev in range(2):
        want = _jax_leaves(jx, jax.tree.map(lambda x: x[dev], out))
        got = merge_from_sums(tcfg.VJFConfig(**kw), t0, locs[dev][1], summed, 2, K_MERGE,
                              rls_active)
        _close_leaves(_leaves(got), want, what=f"rank {dev}")
    if rls_active and trust:
        undamped = merge_from_sums(tcfg.VJFConfig(**dict(kw, sync_trust=0.0)), t0,
                                   locs[0][1], summed, 2, K_MERGE, rls_active)
        assert not torch.allclose(undamped.dynamics.blr.w_mean, got.dynamics.blr.w_mean), \
            "the trust region never bound"


def test_merge_refuses_the_covariance_backend(jx):
    kw = dict(MERGE_KW, rls_backend="covariance", chol_jitter=0.0)
    st = tcore.init_state(0, tcfg.VJFConfig(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="covariance backend cannot merge"):
        merge_contribution(st, st)


# ---------------------------------------------------------------------------
# the relaxed-sync epoch
# ---------------------------------------------------------------------------


def _jax_draws(jx, key, n_seg: int, k: int, b_local: int, dev: int, xd: int):
    """What JAX's relaxed-sync epoch draws on device ``dev``: its segment
    keys (``split``), each folded with the device, and the (K, 2, B_local,
    xd) normals ``core.run_epoch`` draws from it; as (eps_s, eps_t), each
    (T, B_local, xd)."""
    jax = jx.jax
    keys = jax.random.split(key, n_seg)
    eps = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(keys[i], dev), (k, 2, b_local, xd), jx.jnp.float64))
        for i in range(n_seg)])
    return torch.tensor(eps[:, 0]), torch.tensor(eps[:, 1])


def _sync_inputs(jx, t_len: int, b: int, seed: int = 0, **over):
    kw = dict(SYNC_KW, **over)
    js, ts = _pair(jx, _base_leaves(kw, seed), **kw)
    rng = np.random.default_rng(seed + 7)
    ys = rng.normal(size=(t_len, b, kw["ydim"]))
    return kw, js, ts, ys, np.zeros((t_len, b, 0))


def _epoch_outputs(res, rows=slice(None)) -> dict:
    return {"state": _leaves(res.state), "q_means": np.asarray(res.q_means)[:, rows],
            "loss": np.asarray(res.metrics.loss)}


def _compare_epoch(got: dict, want: dict, tol=EPOCH_TOL):
    _close_leaves(got["state"], want["state"], tol, "state")
    for k in ("q_means", "loss"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_sync_every_world1_matches_jax(jx, group1):
    """JAX's ``test_sync_every_single_device_identity`` setting (float64,
    the precision backend, the autograd route), JAX's segment draws
    injected: the epoch and its merges at one rank."""
    jnp = jx.jnp
    t_len, b, k = 32, 4, 8
    kw, js, ts, ys, us = _sync_inputs(jx, t_len, b)
    key, lr = jx.jax.random.PRNGKey(3), 1e-3
    ref = jx.sync(
        jx.VJFConfig(**kw), jx.StepFlags(warm_up=False, train_decoder=False), js,
        jnp.asarray(ys), jnp.asarray(us), key, jnp.asarray(lr, jnp.float64),
        jx.make_mesh(1, axis_names=("dp",)), sync_every=k)
    eps = _jax_draws(jx, key, t_len // k, k, b, 0, kw["xdim"])
    got = run_epoch_sync_every(tcfg.VJFConfig(**kw), tcfg.StepFlags(warm_up=False,
                                                                    train_decoder=False),
                               ts, torch.tensor(ys), torch.tensor(us), 0, lr, group1, k,
                               noise=eps)
    want = {"state": _jax_leaves(jx, ref.state), "q_means": np.asarray(ref.q_means),
            "loss": np.asarray(ref.metrics.loss)}
    _compare_epoch(_epoch_outputs(got), want)


def _ranks_epoch(cfg, flags, state, ys, us, noise, n_dev: int, k: int, lr):
    """The relaxed-sync epoch of ``n_dev`` ranks in this process, as JAX's
    tests run it on an 8-device mesh: each rank's segments through
    ``models.vjf.run_epoch`` on its trials, the ranks' merge contributions
    summed where ``run_epoch_sync_every`` all-reduces them. Returns the last
    boundary's start state, the ranks' advanced states and their sum."""
    t_len, b = ys.shape[:2]
    per = b // n_dev
    rls_active = flags.update and flags.update_transition and not flags.warm_up
    st, qs = state, [None] * n_dev
    for i in range(t_len // k):
        rows = slice(i * k, (i + 1) * k)
        c = cfg if i == 0 else cfg.replace(ns_prefix=0)
        outs = []
        for r in range(n_dev):
            cols = slice(r * per, (r + 1) * per)
            res = tcore.run_epoch(c, flags, st, ys[rows, cols], us[rows, cols], 0, lr,
                                  noise=(noise[0][rows, cols], noise[1][rows, cols]), q0=qs[r])
            qs[r] = Gaussian(res.q_means[-1], res.q_logvars[-1])
            outs.append(res.state)
        summed = sum(merge_contribution(st, o) for o in outs)
        start, st = st, merge_from_sums(cfg, st, outs[0], summed, n_dev, k, rls_active)
    return start, outs, summed, st


def test_sync_every_validation(group1):
    """JAX's ``test_sync_every_validation``: K must divide the epoch."""
    cfg = tcfg.VJFConfig(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), dtype="float64")
    state = tcore.init_state(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="divide the epoch"):
        run_epoch_sync_every(cfg, tcfg.StepFlags(), state, torch.zeros(30, 4, 6),
                             torch.zeros(30, 4, 0), 0, 1e-3, group1, 7)


def test_sync_every_warmup_merge_is_identity():
    """JAX's ``test_sync_every_warmup_merge_is_identity`` (8 ranks, K 8): in
    warm-up every rank ends a segment at P0, so the merge subtracts the
    undecayed base and P stays P0."""
    cfg = tcfg.VJFConfig(**dict(SYNC_KW, rls_shrink=0.999, chol_jitter=1e-3))
    state = tcore.init_state(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    ys = torch.randn(64, 8, cfg.ydim, generator=g, dtype=torch.float64)
    noise = tuple(torch.randn(64, 8, cfg.xdim, generator=g, dtype=torch.float64)
                  for _ in range(2))
    *_, out = _ranks_epoch(cfg, tcfg.StepFlags(warm_up=True, train_decoder=True), state, ys,
                           torch.zeros(64, 8, 0, dtype=torch.float64), noise, 8, 8, 1e-3)
    np.testing.assert_allclose(out.dynamics.blr.precision, state.dynamics.blr.precision,
                               rtol=1e-9, atol=1e-11)


def test_sync_trust_damps_merged_weight_step():
    """JAX's ``test_sync_trust_damps_merged_weight_step`` (8 ranks, one
    merge at the epoch's end): the damped step lands on the trust sphere
    along the undamped one's direction; P is untouched."""
    cfg0 = tcfg.VJFConfig(**dict(SYNC_KW, ydim=10, n_rbf=12, hidden_sizes=(8,),
                                 rls_shrink=0.999, chol_jitter=1e-3))
    state = tcore.init_state(0, cfg0, device="cpu")
    rng = np.random.default_rng(0)
    ys = torch.tensor(rng.normal(size=(32, 8, cfg0.ydim)) * 5.0)
    noise = tuple(torch.tensor(rng.normal(size=(32, 8, cfg0.xdim))) for _ in range(2))
    start, outs, summed, _ = _ranks_epoch(
        cfg0, tcfg.StepFlags(warm_up=False, train_decoder=False), state, ys,
        torch.zeros(32, 8, 0, dtype=torch.float64), noise, 8, 32, 1e-2)
    merged = {t: merge_from_sums(cfg0.replace(sync_every=0, sync_trust=t), start, outs[0],
                                 summed, 8, 32) for t in (0.0, 0.05)}
    w0 = state.dynamics.blr.w_mean.numpy()
    radius = 0.05 * max(np.linalg.norm(w0), 1.0)
    dw_un = merged[0.0].dynamics.blr.w_mean.numpy() - w0
    dw_tr = merged[0.05].dynamics.blr.w_mean.numpy() - w0
    d_un = np.linalg.norm(dw_un)
    assert d_un > radius
    np.testing.assert_allclose(np.linalg.norm(dw_tr), radius, rtol=1e-9)
    np.testing.assert_allclose(dw_tr, (radius / d_un) * dw_un, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(merged[0.05].dynamics.blr.precision,
                               merged[0.0].dynamics.blr.precision, rtol=1e-12, atol=1e-14)


def _warn_fit(group, caplog, **over):
    rng = np.random.default_rng(0)
    y = rng.normal(size=(16, 8, 6)).astype(np.float32)
    cfg = tcfg.VJFConfig(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), likelihood="gaussian",
                         dtype="float32", rls_backend="nsv", sync_every=8, warmup_max=1,
                         **over)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="vjf_tpu_torch"):
        res = tcore.fit(cfg, tcore.init_state(0, cfg, device="cpu"), y, seed=0, max_iter=2,
                        mesh=group)
    assert np.isfinite(res.loss) and res.mu.shape == (16, 8, 2)
    return [r.getMessage() for r in caplog.records]


def test_sync_every_unconditioned_warns(group1, caplog):
    """JAX's ``test_sync_every_unconditioned_warns``."""
    assert any("pure accumulation" in m for m in _warn_fit(group1, caplog))
    assert not any("pure accumulation" in m for m in _warn_fit(
        group1, caplog, rls_shrink=0.999, chol_jitter=1e-3))


def test_sync_every_without_forecast_select_warns(group1, caplog):
    """JAX's ``test_sync_every_without_forecast_select_warns``."""
    forget = dict(rls_shrink=0.999, chol_jitter=1e-3)
    assert any("forecast" in m for m in _warn_fit(group1, caplog, **forget))
    assert not any("destroy forecast skill" in m for m in _warn_fit(
        group1, caplog, select="forecast", select_horizon=3, select_starts=4, **forget))


def test_relaxed_sync_refuses_masks_and_mesh_refusals(group1):
    """JAX's ``test_sync_every_8dev_trains`` refusal (masks under relaxed
    sync) and ``mesh`` with ``noise_hook``; a configuration the kernels
    refuse trains under exact sync on the autograd route over the group,
    per epoch and blocked, as the one-process fit does."""
    cfg = tcfg.VJFConfig(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), rls_backend="nsv",
                         sync_every=0, warmup_max=2)
    state = tcore.init_state(0, cfg, device="cpu")
    y = np.zeros((16, 4, 6), np.float32)
    with pytest.raises(ValueError, match="masks"):
        tcore.fit(cfg, state, y, seed=0, max_iter=2, mesh=group1, mask=np.ones((16, 4)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tcore.fit(cfg, state, y, seed=0, max_iter=2, mesh=group1, noise_hook=lambda e: None)
    exact = cfg.replace(sync_every=1, fused_step="off", dtype="float64")
    state = tcore.init_state(0, exact, device="cpu")
    y = np.random.default_rng(0).normal(size=(16, 4, 6))
    for k, max_iter in ((1, 1), (2, 2)):
        got = tcore.fit(exact, state, y, seed=0, max_iter=max_iter, mesh=group1,
                        epochs_per_dispatch=k)
        want = tcore.fit(exact, state, y, seed=0, max_iter=max_iter, epochs_per_dispatch=k)
        assert got.epochs_run == want.epochs_run == max_iter
        _close_leaves(_leaves(got.state), _leaves(want.state), TOL, f"k={k}")
        np.testing.assert_allclose(got.mu.numpy(), want.mu.numpy(), **TOL)


# ---------------------------------------------------------------------------
# two ranks in two processes
# ---------------------------------------------------------------------------

_WORKER = r"""
import datetime
import sys
import torch
import torch.distributed as dist
from vjf_tpu_torch import convert
from vjf_tpu_torch.config import StepFlags
from vjf_tpu_torch.models import evaluate as tev
from vjf_tpu_torch.models import smoothing as tsm
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.parallel import (fit_ensemble, make_dp_group, make_mesh,
                                    run_epoch_sync_every, shard_data)

rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60),
                        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)


def leaves(st):
    return convert.flatten(convert.state_to_numpy(st))

""" + TP_JOBS + r"""
try:
    group = make_dp_group()
    job = torch.load(f"{path}/job.pt", weights_only=False)
    out = {}

    s = job["sync"]
    ys, us = shard_data(s["ys"], s["us"], group)
    res = run_epoch_sync_every(s["cfg"], StepFlags(warm_up=False, train_decoder=False),
                               s["state"], ys, us, 0, s["lr"], group, s["k"],
                               noise=s["noise"][rank])
    out["sync"] = {"state": leaves(res.state), "q_means": res.q_means.numpy(),
                   "loss": res.metrics.loss.numpy()}

    f = job["fit"]
    state = f["state"]
    if rank:   # fit must start from rank 0's state
        state = state._replace(lik_n_sample=state.lik_n_sample + 5.0)
    res = tcore.fit(f["cfg"], state, f["y"], seed=f["seed"], max_iter=f["max_iter"], mesh=group)
    out["fit"] = {"state": leaves(res.state), "mu": res.mu.numpy(), "loss": res.loss,
                  "epochs_run": res.epochs_run, "warm_up": res.warm_up}
    ck = f"{path}/fit.snap"
    tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=f["max_iter"] // 2,
              mesh=group, checkpoint_path=ck, checkpoint_every=f["max_iter"] // 2)
    res = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=f["max_iter"],
                    mesh=group, resume_from=ck)
    out["resumed"] = {"state": leaves(res.state), "mu": res.mu.numpy(), "loss": res.loss}
    res = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=f["max_iter"],
                    mesh=group, epochs_per_dispatch=2)
    out["blocked"] = {"state": leaves(res.state), "mu": res.mu.numpy(), "loss": res.loss}

    for name in ("ens", "ens_fused"):
        e = job[name]
        for k, max_iter in e["runs"]:
            res = fit_ensemble(e["cfg"], e["states"], e["y"], seeds=e["seeds"],
                               max_iter=max_iter, epochs_per_dispatch=k, mesh=group)
            out[f"{name}{k}"] = {"states": [leaves(st) for st in res.states],
                                 "mu": res.mu.numpy(), "loss": res.loss,
                                 "epochs_run": res.epochs_run}

    m = job["smooth"]
    outs = {}
    for name, y in (("even", m["y"]), ("odd", m["y"][:, :3])):
        filt, sm = tsm.smooth_batch(m["cfg"], m["state"], y, n_iter=2, mesh=group)
        outs[name] = [t.numpy() for t in (*filt, *sm)]
    for vm in (False, True):
        kf = tev.kfold_channel_eval(m["cfg"], m["state"], m["y"], n_folds=2, n_iter=2,
                                    vmap_folds=vm, mesh=group)
        outs[f"kfold{int(vm)}"] = [kf.loglik, kf.loglik_null, kf.bits_per_spike]
    out["smooth"] = outs
    for shape in job["tp"]["layouts"]:
        out[f"tp{shape}"] = run_tp_jobs(job["tp"], make_mesh(shape=shape), leaves)
    torch.save(out, f"{path}/out{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fit_job():
    rng = np.random.default_rng(17)
    t_len, b = 24, 8
    t = np.arange(t_len) * 0.1
    lat = np.stack([np.sin(t[:, None] + rng.uniform(0, 6.3, b)),
                    np.cos(t[:, None] + rng.uniform(0, 6.3, b))], -1)
    y = lat @ rng.normal(size=(2, 6)) + 0.1 * rng.normal(size=(t_len, b, 6))
    cfg = tcfg.VJFConfig(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), likelihood="gaussian",
                         dtype="float64", rls_backend="nsv", fused_step="on",
                         matmul_dtype="float32", lr=3e-3, rtol=1e-12, warmup_max=2)
    return dict(cfg=cfg, state=tcore.init_state(0, cfg, device="cpu"), y=torch.tensor(y),
                seed=5, max_iter=4)


def _ring(seed, t_len, scale=1.0):
    rng = np.random.default_rng(seed)
    th = np.cumsum(0.15 + 0.01 * rng.normal(size=t_len))
    x = np.stack([np.cos(th), np.sin(th)], axis=-1) * scale
    return (x @ rng.normal(size=(8, 2)).T)[:, None, :] + 0.1 * rng.normal(size=(t_len, 3, 8))


def _ens_jobs():
    """Two ensembles. "ens": tests/test_torch_ensemble.py's per-member pair,
    whose members leave warm-up and stop at different epochs (phase-mixed
    epochs, the all-member decisions), one member a rank, per epoch (10
    epochs) and in blocks of 4 (8). "ens_fused": four members of one data
    set through the member-axis launchers' plain versions, two a rank."""
    cfg = tcfg.VJFConfig(ydim=8, xdim=2, n_rbf=10, hidden_sizes=(6,), likelihood="gaussian",
                         dtype="float64", rtol=0.05, stop_patience=1, rls_backend="nsv")
    mixed = dict(cfg=cfg, states=init_ensemble(0, cfg, 2, device="cpu"),
                 y=torch.tensor(np.stack([_ring(1, 24), _ring(2, 24, scale=0.3)])),
                 seeds=[5, 6], runs=((1, 10), (4, 8)))
    fused = cfg.replace(fused_step="on", matmul_dtype="float32", warmup_max=2)
    return {"ens": mixed,
            "ens_fused": dict(cfg=fused, states=init_ensemble(1, fused, 4, device="cpu"),
                              y=torch.tensor(_ring(3, 24)), seeds=[11, 12, 13, 14],
                              runs=((1, 4),))}


def _smooth_job():
    cfg = tcfg.VJFConfig(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), likelihood="poisson",
                         dtype="float64", rls_backend="nsv")
    state = tcore.init_state(0, cfg, device="cpu")
    rng = np.random.default_rng(5)
    state = state._replace(dynamics=state.dynamics._replace(blr=state.dynamics.blr._replace(
        w_mean=torch.tensor(0.3 * rng.normal(size=tuple(state.dynamics.blr.w_mean.shape))))))
    y = torch.tensor(rng.poisson(1.5, size=(13, 4, 6)).astype(np.float64))
    return dict(cfg=cfg, state=state, y=y)


def _solo_refs(job) -> dict:
    """The single-process port's results on the workers' inputs."""
    refs = {}
    f = job["fit"]
    for key, k in (("fit", 1), ("blocked", 2)):
        res = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=f["max_iter"],
                        epochs_per_dispatch=k)
        refs[key] = {"state": _leaves(res.state), "mu": res.mu.numpy(), "loss": res.loss,
                     "epochs_run": res.epochs_run, "warm_up": res.warm_up}
    for name in ("ens", "ens_fused"):
        e = job[name]
        for k, max_iter in e["runs"]:
            res = fit_ensemble(e["cfg"], e["states"], e["y"], seeds=e["seeds"],
                               max_iter=max_iter, epochs_per_dispatch=k)
            refs[f"{name}{k}"] = {"states": [_leaves(st) for st in res.states],
                                  "mu": res.mu.numpy(), "loss": res.loss,
                                  "epochs_run": res.epochs_run}
    m = job["smooth"]
    outs = {}
    for name, y in (("even", m["y"]), ("odd", m["y"][:, :3])):
        filt, sm = tsm.smooth_batch(m["cfg"], m["state"], y, n_iter=2)
        outs[name] = [t.numpy() for t in (*filt, *sm)]
    for vm in (False, True):
        kf = tev.kfold_channel_eval(m["cfg"], m["state"], m["y"], n_folds=2, n_iter=2,
                                    vmap_folds=vm)
        outs[f"kfold{int(vm)}"] = [kf.loglik, kf.loglik_null, kf.bits_per_spike]
    refs["smooth"] = outs
    return refs


@pytest.fixture(scope="module")
def world2(jx, tmp_path_factory):
    """The workers' outputs (one per rank) and every reference."""
    jnp = jx.jnp
    tmp = tmp_path_factory.mktemp("world2")
    t_len, b, k = 32, 4, 8
    kw, js, ts, ys, us = _sync_inputs(jx, t_len, b, seed=1)
    key, lr = jx.jax.random.PRNGKey(4), 1e-3
    noise = [_jax_draws(jx, key, t_len // k, k, b // 2, dev, kw["xdim"]) for dev in range(2)]
    job = {"sync": dict(cfg=tcfg.VJFConfig(**kw), state=ts, ys=torch.tensor(ys),
                        us=torch.tensor(us), lr=lr, k=k, noise=noise),
           "fit": _fit_job(), **_ens_jobs(), "smooth": _smooth_job(),
           "tp": tp_job(TP_LAYOUTS)}
    torch.save(job, tmp / "job.pt")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", port, str(tmp)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    # one deadline for both ranks; whatever happens, both are killed and
    # reaped before the fixture returns
    deadline = time.monotonic() + 90.0
    try:
        ref = jx.sync(
            jx.VJFConfig(**kw), jx.StepFlags(warm_up=False, train_decoder=False), js,
            jnp.asarray(ys), jnp.asarray(us), key, jnp.asarray(lr, jnp.float64),
            jx.make_mesh(2, axis_names=("dp",)), sync_every=k)
        refs = _solo_refs(job)
        refs["sync"] = {"state": _jax_leaves(jx, ref.state), "q_means": np.asarray(ref.q_means),
                        "loss": np.asarray(ref.metrics.loss)}
        refs["tp"] = tp_refs(_tp_jx(jx), job["tp"], gspmd_layouts=TP_LAYOUTS)
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(2)], refs


def test_world2_sync_every_matches_jax(world2):
    """Each rank's relaxed-sync epoch, JAX's draws of its device injected,
    against JAX's epoch on a 2-device mesh: the merged state, the rank's
    posterior rows and the averaged metrics."""
    outs, refs = world2
    want = refs["sync"]
    for r, out in enumerate(outs):
        rows = slice(2 * r, 2 * r + 2)
        _compare_epoch(out["sync"], dict(want, q_means=want["q_means"][:, rows]))
    assert all(np.array_equal(outs[0]["sync"]["state"][k], outs[1]["sync"]["state"][k])
               for k in want["state"])


def test_world2_exact_fit_matches_the_solo_fit(world2):
    """Exact-sync ``fit(mesh=...)`` at two ranks against the single-process
    ``fit`` on the same seed (the same Philox rows, float64: rounding
    only), per epoch and blocked; rank 1's state is rank 0's, bit for bit."""
    outs, refs = world2
    for key in ("fit", "blocked"):
        want = refs[key]
        for out in outs:
            got = out[key]
            _close_leaves(got["state"], want["state"], dict(rtol=1e-8, atol=1e-10), key)
            np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-8)
    assert outs[0]["fit"]["epochs_run"] == refs["fit"]["epochs_run"] == 4
    assert outs[0]["fit"]["warm_up"] == refs["fit"]["warm_up"] is False
    for key in ("fit", "blocked"):
        a, b = outs[0][key]["state"], outs[1][key]["state"]
        assert all(np.array_equal(a[k], b[k]) for k in a), key


def test_world2_resume_gives_the_uninterrupted_bits(world2):
    """A snapshot written by rank 0 at world size 2, resumed by both ranks,
    ends at the uninterrupted two-rank fit's bits."""
    outs, _ = world2
    for out in outs:
        a, b = out["resumed"], out["fit"]
        assert all(np.array_equal(a["state"][k], b["state"][k]) for k in b["state"])
        assert np.array_equal(a["mu"], b["mu"]) and a["loss"] == b["loss"]


def test_world2_fit_ensemble_members_are_bit_identical(world2):
    """``fit_ensemble(mesh=...)`` (:func:`_ens_jobs`): every member equals
    the single-process ensemble's bit for bit, on both ranks."""
    outs, refs = world2
    assert refs["ens1"]["epochs_run"][0] != refs["ens1"]["epochs_run"][1]
    for key in ("ens1", "ens4", "ens_fused1"):
        want = refs[key]
        for out in outs:
            got = out[key]
            assert np.array_equal(got["mu"], want["mu"]), key
            assert np.array_equal(got["loss"], want["loss"], equal_nan=True), key
            assert np.array_equal(got["epochs_run"], want["epochs_run"]), key
            for m, st in enumerate(want["states"]):
                assert all(np.array_equal(got["states"][m][k], st[k]) for k in st), (key, m)


def test_world2_smoothing_and_kfold_match_unsharded(world2):
    """``smooth_batch`` (B 4 over two ranks, and B 3, which every rank
    smooths whole) and ``kfold_channel_eval`` (fold loop and fold batches)
    with ``mesh=`` against the unsharded calls; float64, each trial smoothed
    alone either way."""
    outs, refs = world2
    want = refs["smooth"]
    for out in outs:
        for name in ("even", "odd"):
            for g, w in zip(out["smooth"][name], want[name]):
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12, err_msg=name)
        for name in ("kfold0", "kfold1"):
            np.testing.assert_allclose(out["smooth"][name], want[name], rtol=1e-10,
                                       err_msg=name)


TP_LAYOUTS = [(2, 1), (1, 2)]


def _tp_jx(jx):
    """``tests/test_torch_tp.py``'s JAX namespace from this file's."""
    epoch = jx.jax.jit(jx.core.run_epoch, static_argnames=("cfg", "flags"))
    return types.SimpleNamespace(**vars(jx), epoch=epoch)


def _tp_outs(world2, shape):
    outs, refs = world2
    return [o[f"tp{shape}"] for o in outs], refs["tp"]


@pytest.mark.parametrize("shape", TP_LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_world2_tp_epoch_matches(world2, name, shape):
    """The autograd epoch over the (2, 1) and (1, 2) meshes against JAX (one
    device, and GSPMD on the same CPU mesh for the GSPMD cases) and the
    port in one process; both ranks bit-equal; the decoder rows cut over
    ``tp`` inside the epoch, whole outside (``tests/test_torch_tp.py``)."""
    outs, refs = _tp_outs(world2, shape)
    assert all(o["shape"] == shape for o in outs)
    check_tp_case(outs, refs, name, shape)


@pytest.mark.parametrize("shape", TP_LAYOUTS)
def test_world2_tp_ensemble_and_smoother_take_the_mesh(world2, shape):
    """``fit_ensemble`` and ``smooth_batch`` over the (2, 1) and (1, 2)
    meshes: the one-process results (the ensemble bit for bit)."""
    outs, refs = _tp_outs(world2, shape)
    check_others(outs, refs)


@pytest.mark.parametrize("shape", TP_LAYOUTS)
@pytest.mark.parametrize("name", list(FIT_CASES))
def test_world2_tp_fit_matches_the_solo_fit(world2, name, shape):
    """Exact-sync ``fit(mesh=...)`` over the (2, 1) and (1, 2) meshes on the
    configurations the kernels refuse, against the one-process fit."""
    outs, refs = _tp_outs(world2, shape)
    check_fit_case(outs, refs, name)


def test_world1_exact_fit_over_a_group_matches_the_solo_fit(group1):
    """At one rank the exact-sync ``fit(mesh=...)`` is the solo fit up to
    rounding (float64, the same Philox rows), per epoch and blocked."""
    f = _fit_job()
    for k in (1, 3):
        want = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=3,
                         epochs_per_dispatch=k)
        got = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=3, mesh=group1,
                        epochs_per_dispatch=k)
        _close_leaves(_leaves(got.state), _leaves(want.state), dict(rtol=1e-8, atol=1e-10))
        assert got.warm_up == want.warm_up and got.epochs_run == want.epochs_run
