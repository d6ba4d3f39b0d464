"""The port's exact-sync sharded path against the JAX package's: phase 1
(``forward_sums``) on one shard, the flat sums layout, ``step_apply`` from the
sums, the stats-based exact fallback, and the sharded epoch at world sizes 1
and 2 (gloo on the CPU) against ``run_epoch_fused_sharded`` on a 2-device
``dp`` mesh. Also the two entry-point repairs: the card as the default
device, and ``ns_prefix_free`` validation.

JAX is imported inside the ``jx`` fixture only; the 2-rank test's worker
processes import torch, numpy and the port alone."""
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
import torch.distributed as dist

from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF
from vjf_tpu_torch.ops import rng as trng
from vjf_tpu_torch.parallel import (
    make_dp_group,
    make_sharded_epoch,
    make_sharded_epochs,
    run_epoch_fused_sharded,
    shard_data,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

T, B, XD, YD = 12, 8, 3, 12
# float64: the same algorithm, so only rounding differs; float32: the
# tolerances of tests/test_sharding.py:186-197 (the JAX sharded epoch
# against the single-device one), per output
TOL64 = dict(rtol=1e-8, atol=1e-8)
TOL32 = {"loss": dict(rtol=5e-4, atol=5e-4), "q_means": dict(rtol=1e-3, atol=1e-4),
         "w_mean": dict(rtol=1e-3, atol=1e-4), "cov": dict(rtol=1e-3, atol=1e-4),
         "logvar": dict(rtol=1e-4, atol=0.0)}
# phase 1 and the apply alone, float32: one step, summation order only
TOL32_STEP = dict(rtol=1e-4, atol=1e-5)


def _tol(dtype, name=None):
    if dtype == "float64":
        return TOL64
    return TOL32[name] if name else TOL32_STEP


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from vjf_tpu.config import StepFlags, VJFConfig
    from vjf_tpu.models import vjf as jcore
    from vjf_tpu.ops.pallas import fused_step as JF
    from vjf_tpu.parallel import make_mesh
    from vjf_tpu.parallel.sharded import run_epoch_fused_sharded as j_sharded

    return types.SimpleNamespace(jax=jax, jnp=jnp, StepFlags=StepFlags, VJFConfig=VJFConfig,
                                 core=jcore, F=JF, make_mesh=make_mesh, sharded=j_sharded)


def _cfg(jx, dtype, likelihood="poisson", udim=0):
    return jx.VJFConfig(ydim=YD, xdim=XD, udim=udim, n_rbf=20, hidden_sizes=(10,),
                        likelihood=likelihood, dtype=dtype, rls_backend="nsv",
                        fused_step="on", matmul_dtype="float32")


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _data(dtype, likelihood="poisson", udim=0, seed=0):
    rng = np.random.default_rng(seed)
    npdt = np.dtype(dtype)
    ys = (rng.poisson(1.0, (T, B, YD)) if likelihood == "poisson"
          else rng.normal(size=(T, B, YD))).astype(npdt)
    us = rng.normal(size=(T, B, udim)).astype(npdt)
    eps = rng.normal(size=(2, T, B, XD)).astype(npdt)
    q = (0.3 * rng.normal(size=(2, B, XD))).astype(npdt)
    return ys, us, eps, q


def _states(jx, cfg, seed=0):
    state = jx.core.init_state(jx.jax.random.PRNGKey(seed), cfg)
    tstate = convert.state_from_numpy(_port_cfg(cfg), jx.jax.tree.map(np.asarray, state),
                                      device="cpu")
    return state, tstate


def _close(got, ref, tol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               err_msg=name, **tol)


def _sums_by_leaf(sums):
    """{field or field.i: array} of a FusedSums (JAX or port); None dropped."""
    out = {}
    for k in TF.FusedSums._fields:
        v = getattr(sums, k)
        if isinstance(v, tuple):
            out.update({f"{k}.{i}": x for i, x in enumerate(v)})
        elif v is not None:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# phase 1, the flat layout, the apply and the fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("likelihood,udim", [("poisson", 0), ("gaussian", 2)])
def test_forward_sums_matches_jax(jx, dtype, likelihood, udim):
    """The second half of the trials with the GLOBAL inv_b, against JAX's
    forward_sums_call (interpret mode): every FusedSums leaf and the q pack."""
    cfg = _cfg(jx, dtype, likelihood, udim)
    state, tstate = _states(jx, cfg)
    ys, us, eps, q = _data(dtype, likelihood, udim)
    rows = slice(B // 2, B)
    y, u, e_s, e_t = ys[0, rows], us[0, rows], eps[0, 0, rows], eps[1, 0, rows]
    qm, qlv = q[0, rows], q[1, rows]
    jnp = jx.jnp
    ref, rqm, rqlv = jx.F.forward_sums_call(
        cfg, jx.StepFlags(), jx.F.pad_carry(cfg, state), jnp.asarray(qm), jnp.asarray(qlv),
        jnp.asarray(y), jnp.asarray(u) if udim else None, jnp.asarray(e_s), jnp.asarray(e_t),
        1.0 / B, interpret=True)
    tc = _port_cfg(cfg)
    t = torch.tensor
    flat, q_pack = TF.forward_sums_plain(
        tc, tcfg.StepFlags(), TF.pad_carry(tc, tstate), t(qm), t(qlv), t(y),
        t(u) if udim else None, t(e_s), t(e_t), 1.0 / B)
    got = TF.unpack_sums(flat, TF.pad_carry(tc, tstate))
    a, b = _sums_by_leaf(ref), _sums_by_leaf(got)
    assert a.keys() == b.keys()
    for k in a:
        _close(b[k], a[k], _tol(dtype), k)
    _close(q_pack[0], rqm, _tol(dtype), "qt_mean")
    _close(q_pack[1], rqlv, _tol(dtype), "qt_logvar")


def test_pack_round_trip_and_shards_add_up(jx):
    """unpack(pack(s)) is s, bit for bit; the packs of two shards with the
    global inv_b add up to the pack of the whole batch."""
    cfg = _cfg(jx, "float64", "gaussian", udim=2)
    _, tstate = _states(jx, cfg)
    ys, us, eps, q = _data("float64", "gaussian", udim=2)
    tc = _port_cfg(cfg)
    carry = TF.pad_carry(tc, tstate)
    t = torch.tensor

    def pack(rows):
        return TF.forward_sums_plain(tc, tcfg.StepFlags(), carry, t(q[0, rows]), t(q[1, rows]),
                                     t(ys[0, rows]), t(us[0, rows]), t(eps[0, 0, rows]),
                                     t(eps[1, 0, rows]), 1.0 / B)[0]

    whole = pack(slice(0, B))
    assert whole.numel() == TF.sums_size(carry)
    sums = TF.unpack_sums(whole, carry)
    assert torch.equal(TF.pack_sums(sums), whole)
    assert sums.g_w_in_u is not None and sums.g_w_in_u.shape == carry.w_in_u.shape
    halves = pack(slice(0, B // 2)) + pack(slice(B // 2, B))
    np.testing.assert_allclose(halves.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="floats"):
        TF.unpack_sums(whole[:-1], carry)


def _apply_pair(jx, dtype, scale=1.0):
    """JAX and port (new carry, scal, g_vec, sums, carry) of one step's
    apply from the sums alone; ``scale`` multiplies P and divides V."""
    cfg = _cfg(jx, dtype)
    state, tstate = _states(jx, cfg)
    ys, _, eps, q = _data(dtype)
    jnp = jx.jnp
    carry = jx.F.pad_carry(cfg, state)
    carry = carry._replace(p_mat=carry.p_mat * scale, v_mat=carry.v_mat / scale)
    sums, _ = jx.F.step_forward_sums(cfg, jx.StepFlags(), carry, jnp.asarray(q[0]),
                                     jnp.asarray(q[1]), jnp.asarray(ys[0]), None,
                                     jnp.asarray(eps[0, 0]), jnp.asarray(eps[1, 0]), 1.0 / B)
    lr = jnp.asarray(1e-3, dtype)
    ref = jx.F.step_apply(cfg, jx.StepFlags(), carry, sums, lr, B)
    tc = _port_cfg(cfg)
    tcarry = TF.pad_carry(tc, tstate)
    tcarry = tcarry._replace(p_mat=tcarry.p_mat * scale, v_mat=tcarry.v_mat / scale)
    tsums = TF.FusedSums(**{
        k: (None if v is None else tuple(torch.tensor(np.asarray(x)) for x in v)
            if isinstance(v, tuple) else torch.tensor(np.asarray(v)))
        for k, v in sums._asdict().items() if k in TF.FusedSums._fields})
    got = TF.step_apply(tc, tcfg.StepFlags(), tcarry, tsums, torch.tensor(1e-3, dtype=tc.tdtype), B)
    return cfg, tc, (ref, sums, carry), (got, tsums, tcarry)


def _compare_carry(ref_carry, got_carry, tol):
    a = convert.flatten(ref_carry._asdict())
    b = convert.flatten(got_carry._asdict())
    assert a.keys() == b.keys()
    for k in a:
        _close(b[k].numpy(), np.asarray(a[k]), tol, k)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_apply_from_sums_matches_jax(jx, dtype):
    """``step_apply`` without per-trial inputs: the state-noise MSE from the
    summed statistics, against JAX's ``step_apply(..., feat=None)``."""
    _, _, (ref, _, _), (got, _, _) = _apply_pair(jx, dtype)
    _compare_carry(ref[0], got[0], _tol(dtype))
    for k in ref[1]._fields:
        _close(getattr(got[1], k).numpy(), np.asarray(getattr(ref[1], k)), _tol(dtype), k)
    _close(got[2].numpy(), np.asarray(ref[2]), _tol(dtype), "g_vec")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case,scale", [("fires", 1.0), ("stays_below", 1e3)])
def test_exact_fallback_sums_matches_jax(jx, dtype, case, scale):
    cfg, tc, (ref, sums, carry), (got, tsums, tcarry) = _apply_pair(jx, dtype, scale)
    tau = float(np.asarray(ref[1].tau)[0, 0])
    assert (tau >= TF.NS_TAU_THRESHOLD) == (case == "fires"), tau
    r = jx.F.exact_v_fallback_sums(cfg, ref[0], carry, sums, ref[2], ref[1].tau[0, 0], B)
    g = TF.exact_v_fallback_sums(tc, got[0], tcarry, tsums, got[2], got[1].tau[0, 0], B)
    _compare_carry(r, g, _tol(dtype))
    moved = not torch.equal(g.v_mat, got[0].v_mat)
    assert moved == (case == "fires")


def test_philox_row_offset_draws_rows_of_the_whole_batch():
    seed, count = torch.tensor(7), torch.tensor(3)
    whole = trng.box_muller_latents(seed, count, B, XD)
    for r in range(2):
        part = trng.box_muller_latents(seed, count, B // 2, XD, row0=r * B // 2)
        rows = slice(r * B // 2, (r + 1) * B // 2)
        assert torch.equal(part[0], whole[0][rows]) and torch.equal(part[1], whole[1][rows])


# ---------------------------------------------------------------------------
# the sharded epoch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_epochs(jx):
    """Per dtype: the inputs and JAX's sharded epoch on a 2-device dp mesh."""
    out = {}
    mesh = jx.make_mesh(2, axis_names=("dp",))
    for dtype in ("float64", "float32"):
        cfg = _cfg(jx, dtype)
        state, tstate = _states(jx, cfg)
        ys, us, eps, _ = _data(dtype)
        jnp = jx.jnp
        key = jx.jax.random.PRNGKey(0)
        lr = 1e-3
        ref = jx.sharded(cfg, jx.StepFlags(), state, jnp.asarray(ys), jnp.asarray(us), key,
                         jnp.asarray(lr, dtype), mesh,
                         noise=(jnp.asarray(eps[0]), jnp.asarray(eps[1])), interpret=True)
        tau = np.asarray(ref.metrics.tau)
        assert tau.max() >= TF.NS_TAU_THRESHOLD, "the exact fallback never ran"
        blr = ref.state.dynamics.blr
        out[dtype] = dict(
            cfg=_port_cfg(cfg), state=tstate, ys=ys, us=us, eps=eps, lr=lr,
            ref={"loss": np.asarray(ref.metrics.loss), "q_means": np.asarray(ref.q_means),
                 "w_mean": np.asarray(blr.w_mean), "cov": np.asarray(blr.cov),
                 "logvar": np.asarray(ref.state.dynamics.logvar)})
    return out


def _epoch_outputs(res):
    blr = res.state.dynamics.blr
    return {"loss": res.metrics.loss, "q_means": res.q_means, "w_mean": blr.w_mean,
            "cov": blr.cov, "logvar": res.state.dynamics.logvar}


def _compare_epoch(got, ref, dtype, rows=slice(None)):
    for k, r in ref.items():
        _close(got[k], r[:, rows] if k == "q_means" else r, _tol(dtype, k), k)


@pytest.fixture(scope="module")
def group1():
    """A real world-size-1 gloo group, in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_dp_group()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_epoch_world1_matches_jax(jax_epochs, group1, dtype):
    e = jax_epochs[dtype]
    t = torch.tensor
    before = TF.launches["forward_sums"]
    res = run_epoch_fused_sharded(e["cfg"], tcfg.StepFlags(), e["state"], t(e["ys"]),
                                  t(e["us"]), 0, e["lr"], group1,
                                  noise=(t(e["eps"][0]), t(e["eps"][1])))
    assert TF.launches["forward_sums"] == before   # CPU tensors: the plain version
    _compare_epoch(_epoch_outputs(res), e["ref"], dtype)


_WORKER = r"""
import datetime
import sys
import torch
import torch.distributed as dist
from vjf_tpu_torch.config import StepFlags
from vjf_tpu_torch.parallel import make_dp_group, run_epoch_fused_sharded, shard_data, shard_state

rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60),
                        init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
try:
    group = make_dp_group()
    out = {}
    for dtype, j in torch.load(f"{path}/job.pt", weights_only=False).items():
        state = j["state"]
        if rank:   # shard_state must replace this rank's leaves with rank 0's
            state = state._replace(lik_n_sample=state.lik_n_sample + 5.0)
            state.params.decoder.weight.data.zero_()
        state = shard_state(j["cfg"], state, group)
        ys, us = shard_data(j["ys"], j["us"], group)
        eps = shard_data(j["eps"][0], j["eps"][1], group)
        res = run_epoch_fused_sharded(j["cfg"], StepFlags(), state, ys, us, 0, j["lr"], group,
                                      noise=eps)
        blr = res.state.dynamics.blr
        out[dtype] = {"loss": res.metrics.loss, "q_means": res.q_means, "w_mean": blr.w_mean,
                      "cov": blr.cov, "logvar": res.state.dynamics.logvar}
    torch.save(out, f"{path}/out{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_epoch_world2_matches_jax(jax_epochs, tmp_path):
    """Two gloo ranks in two processes, each with half the trials, against
    JAX's 2-device sharded epoch: each rank's posteriors are its rows, and
    both hold the same global state."""
    t = torch.tensor
    job = {d: dict(cfg=e["cfg"], state=e["state"], ys=t(e["ys"]), us=t(e["us"]),
                   eps=(t(e["eps"][0]), t(e["eps"][1])), lr=e["lr"])
           for d, e in jax_epochs.items()}
    torch.save(job, tmp_path / "job.pt")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", port, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    # one deadline for both ranks; whatever happens, both are killed and
    # reaped before the test ends
    deadline = time.monotonic() + 60.0
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(2):
        out = torch.load(tmp_path / f"out{r}.pt")
        for dtype, e in jax_epochs.items():
            _compare_epoch(out[dtype], e["ref"], dtype, rows=slice(r * B // 2, (r + 1) * B // 2))


def test_make_sharded_epoch_routes(jax_epochs, group1):
    e = jax_epochs["float32"]
    t = torch.tensor
    ys, us = t(e["ys"][:2]), t(e["us"][:2])
    epoch = make_sharded_epoch(e["cfg"], tcfg.StepFlags(), group1)
    res = epoch(e["state"], ys, us, 0, e["lr"])
    direct = run_epoch_fused_sharded(e["cfg"], tcfg.StepFlags(), e["state"], ys, us, 0,
                                     e["lr"], group1)
    assert torch.equal(res.q_means, direct.q_means) and torch.isfinite(res.metrics.loss).all()
    # the masks ride the route (ported; tests/test_torch_masks.py)
    mask = torch.ones(2, B)
    mask[1, 0] = 0.0
    masked = epoch(e["state"], ys, us, 0, e["lr"], mask=mask)
    assert torch.equal(masked.q_means, run_epoch_fused_sharded(
        e["cfg"], tcfg.StepFlags(), e["state"], ys, us, 0, e["lr"], group1, mask=mask).q_means)
    assert torch.equal(masked.q_means[1, 0], masked.q_means[0, 0])
    epochs = make_sharded_epochs(e["cfg"], tcfg.StepFlags(), group1)(
        e["state"], ys, us, [0, 1], [e["lr"], e["lr"]])
    assert torch.equal(epochs.epoch_loss[0], torch.mean(res.metrics.loss))
    assert epochs.epoch_loss.shape == (2,) and torch.isfinite(epochs.epoch_loss).all()
    # a configuration the fused route does not take runs the autograd route
    # over the group, as the one-device autograd epoch on the same seed
    off = e["cfg"].replace(fused_step="off")
    xla = make_sharded_epoch(off, tcfg.StepFlags(), group1)(e["state"], ys, us, 0, e["lr"])
    one = tcore.run_epoch(off, tcfg.StepFlags(), e["state"], ys, us, 0, e["lr"])
    assert xla.metrics.tau is None and torch.isfinite(xla.metrics.loss).all()
    for k in ("loss", "q_means", "w_mean"):
        _close(_epoch_outputs(xla)[k], _epoch_outputs(one)[k], _tol("float32", k), k)
    with pytest.raises(ValueError, match="process group"):
        run_epoch_fused_sharded(e["cfg"], tcfg.StepFlags(), e["state"], ys, us, 0, e["lr"], None)
    assert shard_data(ys, us, group1)[0].shape == ys.shape


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works there")
    cfg = tcfg.VJFConfig(ydim=4, xdim=2, n_rbf=5, hidden_sizes=(3,), rls_backend="nsv")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tcore.init_state(0, cfg)
    assert tcore.init_state(0, cfg, device="cpu").dynamics.blr.precision.device.type == "cpu"


def test_config_rejects_an_unknown_ns_prefix_free():
    with pytest.raises(ValueError, match="ns_prefix_free"):
        tcfg.VJFConfig(ydim=4, xdim=2, ns_prefix_free="atuo")
    assert tcfg.VJFConfig(ydim=4, xdim=2, ns_prefix_free="off").ns_prefix_free == "off"
