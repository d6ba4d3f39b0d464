"""The exact-sync autograd epoch over a ``dp`` x ``tp`` mesh
(``parallel/sharded.py:run_epoch_autograd_sharded``, ``make_mesh``, the
``tp`` axis) against the JAX package's ``core.run_epoch`` on one device
(the noise injected) and its ``make_sharded_epoch(fused_step='off')``
under GSPMD on a CPU mesh, and against the port in one process.

In this process: ``make_mesh``'s layout against JAX's, the route decided
on the whole batch (SGP's gate) and on the launch's (shared memory), and
the shardings at one rank. One four-process spawn (gloo over a free
localhost port, one 90 s deadline, every rank killed and reaped in
``finally``) runs the ``(2, 2)`` layout: the epoch cases of
:data:`CASES` (every regression backend, both likelihoods, the masks, a
``ydim`` that ``tp`` does not divide), the decoder rows cut inside an epoch
and whole outside it, every rank's state bit-equal to rank 0's, and
exact-sync ``fit(mesh=...)`` per epoch and blocked on every configuration
the kernels refuse. The ``(2, 1)`` and ``(1, 2)`` layouts run the same
jobs in ``tests/test_torch_multirank.py``'s two-process spawn. The workers
import torch and the port only; the parent computes every reference while
they run."""
import dataclasses
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF
from vjf_tpu_torch.parallel import Mesh, channel_rows, shard_data
from vjf_tpu_torch.parallel.mesh import mesh_shape
from vjf_tpu_torch.parallel.sharded import fused_route

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# the port over ranks against the port in one process: float64, the same
# operations in another order
TOL = dict(rtol=1e-9, atol=1e-12)
# against the JAX package at float64: the port divides the running-variance
# counters in float64 where JAX divides int32 counters into float32 weights
# (ROADMAP Queue 3), about 1e-7 a step
EPOCH_TOL = dict(rtol=1e-5, atol=1e-7)
# fit(mesh=...) against the one-process fit: float64, rounding only, grown
# by the bootstrap's pooled solve and eigh (the 130-feature precision form
# and the SGP whitener read 1.9e-7 and 5.9e-8); tighter than the FIT_TOL of
# tests/test_torch_fit.py (rtol 2e-3, atol 1e-5, the port against JAX)
FIT_TOL = dict(rtol=1e-6, atol=1e-8)
T_LEN, N_BATCH, LR, SEED = 8, 4, 1e-2, 3
BASE = dict(xdim=2, n_rbf=8, hidden_sizes=(5,), dtype="float64", rls_shrink=1.0)
# epoch cases: config overrides, the masks, ydim, the warm-up flag
CASES = {
    "nsv_off_poisson": dict(cfg=dict(rls_backend="nsv", fused_step="off",
                                     likelihood="poisson")),
    "precision_gaussian_mask": dict(cfg=dict(likelihood="gaussian"), mask=True),
    "covariance_gaussian_cmask": dict(cfg=dict(rls_backend="covariance",
                                               likelihood="gaussian"), cmask=True),
    "kalman_poisson_both": dict(cfg=dict(dynamics_update="kalman", likelihood="poisson"),
                                mask=True, cmask=True),
    "kalman_quirk_gaussian": dict(cfg=dict(dynamics_update="kalman", joseph_quirk=True,
                                           likelihood="gaussian")),
    "odd_ydim_gaussian_cmask": dict(cfg=dict(likelihood="gaussian"), ydim=5, cmask=True),
    "sgp_small_batch": dict(cfg=dict(dynamics="sgp", n_inducing=8, rls_backend="nsv",
                                     likelihood="gaussian"), mask=True),
    "warmup_poisson": dict(cfg=dict(likelihood="poisson"), warm_up=True),
}
# the cases also held against JAX's make_sharded_epoch on the CPU mesh
GSPMD_CASES = ("precision_gaussian_mask", "kalman_poisson_both")
# fit(mesh=...) on configurations the kernels refuse (float64 takes the
# precision form under 'auto'): (overrides, blocked, trials)
FIT_CASES = {
    "fit_off": (dict(rls_backend="nsv", fused_step="off"), False, 8),
    "fit_precision": (dict(), True, 8),
    "fit_covariance": (dict(rls_backend="covariance"), False, 8),
    "fit_kalman": (dict(dynamics_update="kalman"), True, 8),
    "fit_sgp_small": (dict(dynamics="sgp", n_inducing=8, rls_backend="nsv"), False, 4),
    "fit_wide": (dict(n_rbf=130), False, 8),
}


def case_cfg(name: str) -> tcfg.VJFConfig:
    c = CASES[name]
    return tcfg.VJFConfig(**dict(BASE, ydim=c.get("ydim", 6), **c["cfg"]))


def case_data(name: str, b: int = N_BATCH, t_len: int = T_LEN, seed: int = 0):
    """``(ys, us, mask, channel_mask)``, numpy, NaN at every masked entry."""
    c, cfg = CASES[name], case_cfg(name)
    rng = np.random.default_rng(seed)
    ys = (rng.poisson(1.0, (t_len, b, cfg.ydim)) if cfg.likelihood == "poisson"
          else rng.normal(size=(t_len, b, cfg.ydim))).astype(np.float64)
    mask = cm = None
    if c.get("mask"):
        mask = np.ones((t_len, b))
        mask[t_len // 2:, 1] = 0.0
        ys[mask == 0] = np.nan
    if c.get("cmask"):
        cm = (rng.uniform(size=(t_len, b, cfg.ydim)) > 0.15).astype(np.float64)
        cm[:, :, 0] = 1.0
        ys[cm == 0] = np.nan
    return ys, np.zeros((t_len, b, 0)), mask, cm


def _t(x):
    return None if x is None else torch.tensor(x)


def tp_job(layouts) -> dict:
    """The workers' inputs: per case the config, state, data, the JAX draw
    of the epoch's noise (``eps``, (T, 2, B, xdim)); per fit case its
    config, state and data."""
    import jax

    key = jax.random.PRNGKey(SEED)
    epochs = {}
    for name, c in CASES.items():
        cfg = case_cfg(name)
        ys, us, mask, cm = case_data(name)
        eps = np.asarray(jax.random.normal(key, (T_LEN, 2, N_BATCH, cfg.xdim), "float64"))
        epochs[name] = dict(cfg=cfg, state=tcore.init_state(0, cfg, device="cpu"), ys=_t(ys),
                            us=_t(us), mask=_t(mask), cm=_t(cm), eps=_t(eps), lr=LR, seed=SEED,
                            flags=tcfg.StepFlags(warm_up=bool(c.get("warm_up")),
                                                 train_decoder=True))
    return {"layouts": list(layouts), "epochs": epochs, "fits": fit_jobs(),
            "others": other_jobs()}


def other_jobs() -> dict:
    """``fit_ensemble`` (4 members, 2 epochs) and ``smooth_batch`` over the
    mesh: both spread their work over its ``dp`` axis."""
    cfg = tcfg.VJFConfig(**dict(BASE, ydim=6, likelihood="gaussian", rls_backend="nsv",
                                rtol=0.05, stop_patience=1, warmup_max=1))
    rng = np.random.default_rng(9)
    y = torch.tensor(rng.normal(size=(12, 4, 6)))
    from vjf_tpu_torch.parallel import init_ensemble

    return dict(cfg=cfg, states=init_ensemble(0, cfg, 4, device="cpu"), y=y,
                seeds=[5, 6, 7, 8], state=tcore.init_state(1, cfg, device="cpu"))


def fit_jobs() -> dict:
    rng = np.random.default_rng(17)
    t_len, b = 24, 8
    t = np.arange(t_len) * 0.1
    lat = np.stack([np.sin(t[:, None] + rng.uniform(0, 6.3, b)),
                    np.cos(t[:, None] + rng.uniform(0, 6.3, b))], -1)
    y = lat @ rng.normal(size=(2, 6)) + 0.1 * rng.normal(size=(t_len, b, 6))
    out = {}
    for name, (over, blocked, trials) in FIT_CASES.items():
        cfg = tcfg.VJFConfig(**dict(BASE, ydim=6, likelihood="gaussian", lr=3e-3, rtol=1e-12,
                                    warmup_max=2, **over))
        out[name] = dict(cfg=cfg, state=tcore.init_state(0, cfg, device="cpu"),
                         y=torch.tensor(y[:, :trials]), seed=5, max_iter=3,
                         k=2 if blocked else 1)
    return out


# The workers' job runner (both spawns exec it): per layout a mesh, every
# epoch case with JAX's noise injected and with the seed, every fit case.
TP_JOBS = r'''
def run_tp_jobs(job, mesh, leaves):
    import vjf_tpu_torch.parallel.sharded as S
    from vjf_tpu_torch.models import vjf as tcore
    from vjf_tpu_torch.models.smoothing import smooth_batch
    from vjf_tpu_torch.parallel import fit_ensemble

    seen = []
    step = S.filter_step_sharded

    def spy(*args, **kw):
        seen.append(tuple(args[2].params.decoder.weight.shape))
        return step(*args, **kw)

    out = {"coords": mesh.coords, "shape": mesh.shape}
    S.filter_step_sharded = spy
    try:
        for name, e in job["epochs"].items():
            y_l, u_l = S.shard_data(e["ys"], e["us"], mesh)
            e_l = S.shard_trials(e["eps"][:, 0], e["eps"][:, 1], mesh)
            seen.clear()
            inj = S.run_epoch_autograd_sharded(e["cfg"], e["flags"], e["state"], y_l, u_l, 0,
                                               e["lr"], mesh, noise=e_l, mask=e["mask"],
                                               channel_mask=e["cm"])
            inside = sorted(set(seen))
            seeded = S.make_sharded_epoch(e["cfg"], e["flags"], mesh)(
                e["state"], e["ys"], e["us"], e["seed"], e["lr"], mask=e["mask"],
                channel_mask=e["cm"])
            out[name] = {
                "inj": {"state": leaves(inj.state), "q_means": inj.q_means.numpy(),
                        "loss": inj.metrics.loss.numpy()},
                "seeded": {"state": leaves(seeded.state), "q_means": seeded.q_means.numpy(),
                           "loss": seeded.metrics.loss.numpy()},
                "dec_inside": inside,
                "dec_outside": tuple(inj.state.params.decoder.weight.shape)}
    finally:
        S.filter_step_sharded = step
    for name, f in job["fits"].items():
        res = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=f["max_iter"],
                        mesh=mesh, epochs_per_dispatch=f["k"])
        out[name] = {"state": leaves(res.state), "mu": res.mu.numpy(), "loss": res.loss,
                     "epochs_run": res.epochs_run, "warm_up": res.warm_up}
    o = job["others"]
    ens = fit_ensemble(o["cfg"], o["states"], o["y"], seeds=o["seeds"], max_iter=2, mesh=mesh)
    _, sm = smooth_batch(o["cfg"], o["state"], o["y"], mesh=mesh)
    out["others"] = {"ens": [leaves(st) for st in ens.states], "ens_mu": ens.mu.numpy(),
                     "smooth": sm.means.numpy()}
    return out
'''


def _leaves(state) -> dict:
    return convert.flatten(convert.state_to_numpy(state))


def _jax_path(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path)


def _jax_cfg(jx, cfg):
    return jx.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _jax_state(jx, cfg, state):
    """The port's ``state`` in the structure of JAX's ``init_state``
    (``eval_shape``: nothing compiles)."""
    jax, jnp = jx.jax, jx.jnp
    leaves = _leaves(state)
    shapes = jax.eval_shape(lambda: jx.core.init_state(jax.random.PRNGKey(0), _jax_cfg(jx, cfg)))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    assert sorted(_jax_path(p) for p, _ in paths) == sorted(leaves)
    return jax.tree.unflatten(treedef, [jnp.asarray(leaves[_jax_path(p)], leaf.dtype)
                                        for p, leaf in paths])


def _jax_leaves(jx, tree) -> dict:
    paths, _ = jx.jax.tree_util.tree_flatten_with_path(tree)
    return {_jax_path(p): np.asarray(x) for p, x in paths}


def _epoch_dict(res, jax_leaves=None) -> dict:
    return {"state": jax_leaves if jax_leaves is not None else _leaves(res.state),
            "q_means": np.asarray(res.q_means), "loss": np.asarray(res.metrics.loss)}


def tp_refs(jx, job, gspmd_layouts=()) -> dict:
    """Every reference of the workers' outputs: per epoch case JAX's
    one-device epoch with the injected noise (``jax``), the port's
    one-process epoch with it (``port``) and with the seed (``seeded``); per
    layout in ``gspmd_layouts`` and case of :data:`GSPMD_CASES` JAX's
    ``make_sharded_epoch(fused_step='off')`` on that CPU mesh; per fit case
    the one-process fit."""
    jax, jnp = jx.jax, jx.jnp
    key = jax.random.PRNGKey(SEED)
    refs = {}
    for name, e in job["epochs"].items():
        cfg, flags = e["cfg"], e["flags"]
        jcfg, js = _jax_cfg(jx, cfg), _jax_state(jx, cfg, e["state"])
        jflags = jx.StepFlags(warm_up=flags.warm_up, train_decoder=flags.train_decoder)
        eps = e["eps"].numpy()
        kw = {k: jnp.asarray(e[m].numpy()) for k, m in (("mask", "mask"), ("channel_mask", "cm"))
              if e[m] is not None}
        ys, us = jnp.asarray(e["ys"].numpy()), jnp.asarray(e["us"].numpy())
        lr = jnp.asarray(LR, jnp.float64)
        one = jx.epoch(jcfg, jflags, js, ys, us, key, lr,
                       noise=(jnp.asarray(eps[:, 0]), jnp.asarray(eps[:, 1])), **kw)
        noise = (e["eps"][:, 0], e["eps"][:, 1])
        refs[name] = {
            "jax": _epoch_dict(one, _jax_leaves(jx, one.state)),
            "port": _epoch_dict(tcore.run_epoch(cfg, flags, e["state"], e["ys"], e["us"], 0, LR,
                                                noise=noise, mask=e["mask"],
                                                channel_mask=e["cm"])),
            "seeded": _epoch_dict(tcore.run_epoch(cfg, flags, e["state"], e["ys"], e["us"], SEED,
                                                  LR, mask=e["mask"], channel_mask=e["cm"]))}
        for shape in gspmd_layouts:
            if name not in GSPMD_CASES:
                continue
            mesh = (jx.make_mesh(shape[0], axis_names=("dp",)) if shape[1] == 1
                    else jx.make_mesh(shape[0] * shape[1], axis_names=("dp", "tp")))
            fn = jx.sh.make_sharded_epoch(jcfg.replace(fused_step="off"), jflags, mesh,
                                          donate=False)
            got = fn(js, ys, us, key, lr, **kw)
            refs[name][f"gspmd{shape}"] = _epoch_dict(got, _jax_leaves(jx, got.state))
    for name, f in job["fits"].items():
        res = tcore.fit(f["cfg"], f["state"], f["y"], seed=f["seed"], max_iter=f["max_iter"],
                        epochs_per_dispatch=f["k"])
        refs[name] = {"state": _leaves(res.state), "mu": res.mu.numpy(), "loss": res.loss,
                      "epochs_run": res.epochs_run, "warm_up": res.warm_up}
    from vjf_tpu_torch.models.smoothing import smooth_batch
    from vjf_tpu_torch.parallel import fit_ensemble

    o = job["others"]
    ens = fit_ensemble(o["cfg"], o["states"], o["y"], seeds=o["seeds"], max_iter=2)
    _, sm = smooth_batch(o["cfg"], o["state"], o["y"])
    refs["others"] = {"ens": [_leaves(st) for st in ens.states], "ens_mu": ens.mu.numpy(),
                      "smooth": sm.means.numpy()}
    return refs


def _close_leaves(got: dict, want: dict, tol, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=float),
                                   np.asarray(want[k], dtype=float), err_msg=f"{what} {k}",
                                   **tol)


def _close_epoch(got: dict, want: dict, rows: slice, tol, what: str):
    _close_leaves(got["state"], want["state"], tol, what)
    np.testing.assert_allclose(got["q_means"], want["q_means"][:, rows], err_msg=what, **tol)
    np.testing.assert_allclose(got["loss"], want["loss"], err_msg=what, **tol)


def check_tp_case(outs: list, refs: dict, name: str, shape) -> None:
    """One epoch case on one layout (``outs``: every rank's worker output)."""
    cfg = case_cfg(name)
    n_dp, n_tp = shape
    per = N_BATCH // n_dp
    cut = n_tp > 1 and cfg.ydim % n_tp == 0
    want = refs[name]
    for out in outs:
        d = out["coords"][0]
        rows = slice(d * per, (d + 1) * per)
        got = out[name]
        what = f"{name} {shape} rank {out['coords']}"
        _close_epoch(got["inj"], want["port"], rows, TOL, what + " vs the port")
        _close_epoch(got["inj"], want["jax"], rows, EPOCH_TOL, what + " vs JAX")
        if f"gspmd{shape}" in want:
            _close_epoch(got["inj"], want[f"gspmd{shape}"], rows, EPOCH_TOL,
                         what + " vs JAX's make_sharded_epoch")
        _close_epoch(got["seeded"], want["seeded"], rows, TOL, what + " seeded")
        inside = (cfg.ydim // n_tp if cut else cfg.ydim, cfg.xdim)
        assert got["dec_inside"] == [inside], (what, got["dec_inside"])
        assert got["dec_outside"] == (cfg.ydim, cfg.xdim), what
    for out in outs[1:]:
        for run in ("inj", "seeded"):
            a, b = outs[0][name][run]["state"], out[name][run]["state"]
            assert all(np.array_equal(a[k], b[k]) for k in a), (name, shape, run)


def check_others(outs: list, refs: dict) -> None:
    """``fit_ensemble`` over the mesh: every member bit for bit the one
    process's; ``smooth_batch``: float64, each trial smoothed alone."""
    want = refs["others"]
    for out in outs:
        got = out["others"]
        assert np.array_equal(got["ens_mu"], want["ens_mu"])
        for m, st in enumerate(want["ens"]):
            assert all(np.array_equal(got["ens"][m][k], st[k]) for k in st), m
        np.testing.assert_allclose(got["smooth"], want["smooth"], rtol=1e-10, atol=1e-12)


def check_fit_case(outs: list, refs: dict, name: str) -> None:
    want = refs[name]
    for out in outs:
        got = out[name]
        _close_leaves(got["state"], want["state"], FIT_TOL, name)
        np.testing.assert_allclose(got["mu"], want["mu"], err_msg=name, **FIT_TOL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=FIT_TOL["rtol"])
        assert got["epochs_run"] == want["epochs_run"] and got["warm_up"] == want["warm_up"]
    assert want["warm_up"] is False, name
    for out in outs[1:]:
        a, b = outs[0][name]["state"], out[name]["state"]
        assert all(np.array_equal(a[k], b[k]) for k in a), name


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from vjf_tpu.config import StepFlags, VJFConfig
    from vjf_tpu.models import vjf as jcore
    from vjf_tpu.parallel import make_mesh
    from vjf_tpu.parallel import sharded as jsh

    epoch = jax.jit(jcore.run_epoch, static_argnames=("cfg", "flags"))
    return types.SimpleNamespace(jax=jax, jnp=jnp, StepFlags=StepFlags, VJFConfig=VJFConfig,
                                 core=jcore, make_mesh=make_mesh, sh=jsh, epoch=epoch)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_default_layout_matches_jax(jx, n):
    """JAX's ``make_mesh(n, ("dp", "tp"))`` and ``("dp",)`` against
    ``mesh_shape``, and each device's place against ``divmod(r, tp)``."""
    devices = jx.jax.devices()[:n]
    for names in (("dp", "tp"), ("dp",)):
        mesh = jx.make_mesh(n, axis_names=names)
        n_dp, n_tp = mesh_shape(n, names)
        assert (mesh.shape["dp"], mesh.shape.get("tp", 1)) == (n_dp, n_tp)
        grid = np.asarray(mesh.devices).reshape(n_dp, n_tp)
        for r, dev in enumerate(devices):
            assert tuple(int(i) for i in np.argwhere(grid == dev)[0]) == divmod(r, n_tp)
    assert mesh_shape(8, shape=(2, 4)) == (2, 4) and mesh_shape(8, shape=(8,)) == (8, 1)
    with pytest.raises(ValueError, match="does not lay out"):
        mesh_shape(n, shape=(n + 1, 1))


class _FakeLib:
    """The kernels' shared-memory queries without a build: 30,000 bytes a
    trial of the launch, against the card's 232,448."""

    def vjf_smem_bytes(self, args):
        return 30000 * args._obj.B

    def vjf_smem_limit(self):
        return 232448


def _fake_mesh(n_dp: int) -> Mesh:
    """A mesh's shape without its groups: what the route reads."""
    return Mesh(dp=None, tp=None, everyone=None, coords=(0, 0), shape=(n_dp, 1))


def test_route_is_decided_on_the_whole_batch(monkeypatch):
    """SGP at B 8 over two ranks takes the fused route, as the JAX package
    decides it on its global array: the small-batch gate reads the whole
    batch (8, not below ``sgp_fused_min_batch``), the shared memory the 4
    trials a launch carries. The old decision, every gate on the rank's 4
    trials, refused it; at one rank the 8 trials of a launch exceed the
    shared memory."""
    monkeypatch.setattr(TF, "_on_cuda", lambda t: True)
    monkeypatch.setattr(TF, "_routed_away", set())
    monkeypatch.setattr(TF, "_library", lambda: _FakeLib())
    cfg = tcfg.VJFConfig(ydim=6, xdim=2, dynamics="sgp", n_inducing=10, hidden_sizes=(5,),
                         dtype="float32", rls_backend="nsv", fused_step="auto")
    state = tcore.init_state(0, cfg, device="cpu")
    assert fused_route(cfg, state, 8, _fake_mesh(2))
    assert not TF.fused_enabled(cfg, state, n_batch=4)          # the old decision
    assert not fused_route(cfg, state, 8, _fake_mesh(1))        # 240,000 bytes a block
    assert not fused_route(cfg, state, 4, _fake_mesh(2))        # SGP below 8 trials
    nsv = cfg.replace(dynamics="rbf")
    assert fused_route(nsv, tcore.init_state(0, nsv, device="cpu"), 4, _fake_mesh(2))


def test_shardings_follow_the_jax_rule():
    """``channel_rows`` cuts the channels over ``tp`` exactly where it
    divides ``ydim``; ``shard_data`` cuts trials over ``dp`` and those
    channels, never the controls."""
    ys, us = torch.arange(2 * 4 * 6.0).reshape(2, 4, 6), torch.ones(2, 4, 3)
    mesh = Mesh(dp=None, tp="tp-group", everyone=None, coords=(1, 1), shape=(2, 2))
    chans = channel_rows(6, mesh)
    assert (chans.group, chans.lo, chans.hi) == ("tp-group", 3, 6)
    assert channel_rows(5, mesh) is None
    assert channel_rows(6, mesh._replace(tp=None, shape=(4, 1))) is None
    y_l, u_l = shard_data(ys, us, mesh)
    assert torch.equal(y_l, ys[:, 2:4, 3:6]) and torch.equal(u_l, us[:, 2:4])
    y_l, _ = shard_data(ys[..., :5], us, mesh)
    assert torch.equal(y_l, ys[:, 2:4, :5])
    with pytest.raises(ValueError, match="does not split"):
        shard_data(ys[:, :3], us[:, :3], mesh)


def test_broadcast_sends_contiguous_leaves(monkeypatch):
    """A state leaf laid out column-major (as the card's factorisations
    return them; the first chip run of ``fit(mesh=...)`` with the precision
    form failed in NCCL's broadcast of one): every leaf travels contiguous,
    and the receiving copy keeps the owner's values."""
    import torch.distributed as dist

    from vjf_tpu_torch.parallel.sharded import broadcast_tree, shard_state

    cfg = tcfg.VJFConfig(ydim=6, xdim=2, n_rbf=8, hidden_sizes=(5,), rls_backend="precision")
    state = tcore.init_state(0, cfg, device="cpu")
    blr = state.dynamics.blr
    u = torch.randn(blr.prec_chol_inv_t.shape, generator=torch.Generator().manual_seed(0))
    state = state._replace(dynamics=state.dynamics._replace(
        blr=blr._replace(prec_chol_inv_t=u.T.contiguous().T)))
    assert not state.dynamics.blr.prec_chol_inv_t.is_contiguous()
    sent = []
    real = dist.broadcast

    def checked(t, src, group=None):
        sent.append(t.is_contiguous())
        return real(t, src, group=group)

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "broadcast", checked)
        out = shard_state(cfg, state, dist.group.WORLD)
        again = broadcast_tree(state, 0, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert sent and all(sent)
    for got in (out, again):
        assert all(np.array_equal(a, b) for a, b in zip(_leaves(got).values(),
                                                        _leaves(state).values()))


# ---------------------------------------------------------------------------
# four ranks in four processes: the (2, 2) layout
# ---------------------------------------------------------------------------

_WORKER = r"""
import datetime
import sys
import torch
import torch.distributed as dist
from vjf_tpu_torch import convert
from vjf_tpu_torch.parallel import make_mesh

rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60),
                        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)


def leaves(st):
    return convert.flatten(convert.state_to_numpy(st))

""" + TP_JOBS + r"""
try:
    job = torch.load(f"{path}/job.pt", weights_only=False)
    mesh = make_mesh()
    torch.save(run_tp_jobs(job, mesh, leaves), f"{path}/out{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world4(jx, tmp_path_factory):
    """The four workers' outputs (``make_mesh()``'s default layout at world
    size 4, (2, 2)) and every reference."""
    tmp = tmp_path_factory.mktemp("world4")
    job = tp_job([(2, 2)])
    torch.save(job, tmp / "job.pt")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4", port, str(tmp)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    # one deadline for every rank; whatever happens, each is killed and
    # reaped before the fixture returns
    deadline = time.monotonic() + 90.0
    try:
        refs = tp_refs(jx, job, gspmd_layouts=[(2, 2)])
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(4)], refs


def test_world4_mesh_is_the_default_layout(world4):
    outs, _ = world4
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o["shape"] == (2, 2) for o in outs)


@pytest.mark.parametrize("name", list(CASES))
def test_world4_epoch_matches(world4, name):
    """The (2, 2) layout's epoch against JAX (one device, and GSPMD for
    :data:`GSPMD_CASES`) and the port in one process; the ranks bit-equal;
    the decoder rows cut inside the epoch, whole outside."""
    outs, refs = world4
    check_tp_case(outs, refs, name, (2, 2))


def test_world4_ensemble_and_smoother_take_the_mesh(world4):
    """``fit_ensemble`` and ``smooth_batch`` over the (2, 2) mesh use its
    ``dp`` axis: the one-process results (the ensemble bit for bit)."""
    outs, refs = world4
    check_others(outs, refs)


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_world4_fit_matches_the_solo_fit(world4, name):
    """Exact-sync ``fit(mesh=...)`` over (2, 2), per epoch or blocked, on a
    configuration the kernels refuse, against the one-process fit; every
    rank's state is rank 0's, bit for bit."""
    outs, refs = world4
    check_fit_case(outs, refs, name)
