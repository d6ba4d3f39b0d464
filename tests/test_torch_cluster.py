"""The thread-block cluster's split of a batch, mirrored in Python
(``cluster_rows``), and what the kernels rely on: phase 1 on the blocks'
ragged trial slices, each with its row offset and the whole batch's 1/B,
summed in rank order, is phase 1 on the whole batch. Also what ``_launch``
takes and refuses without a card. The JAX package's phase 1 is the reference for the
summed slices."""
import contextlib
import ctypes
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF

import torch_tile_plan as TP

torch.set_num_threads(1)

BATCHES = [1, 5, 8, 250, 256]
XD, YD, UD = 3, 12, 2


@pytest.mark.parametrize("size", [4, 8, 16])
@pytest.mark.parametrize("b", BATCHES)
def test_cluster_rows_cover_every_trial_once_in_order(b, size):
    blocks = [TF.cluster_rows(r, b, size) for r in range(size)]
    assert [i for rows in blocks for i in rows] == list(range(b))
    per = -(-b // size)
    assert all(len(rows) <= per for rows in blocks)
    # the full blocks come first: a short or empty block is followed by empty ones only
    lengths = [len(rows) for rows in blocks]
    short = next((i for i, n in enumerate(lengths) if n < per), size)
    assert all(n == 0 for n in lengths[short + 1:])


def test_cluster_rows_default_is_the_built_size():
    assert TF.cluster_size() == 8
    assert list(TF.cluster_rows(7, 250)) == list(range(224, 250))
    assert len(TF.cluster_rows(5, 5)) == 0


def _cfg(dtype="float64", likelihood="gaussian", **kw):
    base = dict(ydim=YD, xdim=XD, udim=UD, n_rbf=10, hidden_sizes=(8, 6), likelihood=likelihood,
                dtype=dtype, rls_backend="nsv", fused_step="on", matmul_dtype="float32")
    base.update(kw)
    return tcfg.VJFConfig(**base)


def _operands(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    dt = cfg.tdtype
    t = lambda a: torch.tensor(a, dtype=dt)   # noqa: E731
    y = t(rng.poisson(1.0, (b, YD)) if cfg.likelihood == "poisson" else rng.normal(size=(b, YD)))
    u = t(rng.normal(size=(b, UD)))
    q = t(0.3 * rng.normal(size=(2, b, XD)))
    carry = TF.pad_carry(cfg, tcore.init_state(0, cfg, device="cpu"))
    carry = carry._replace(rng_seed=torch.full((1, 1), 31, dtype=torch.int32),
                           rng_count=torch.full((1, 1), 4, dtype=torch.int32))
    return carry, q[0], q[1], y, u


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
@pytest.mark.parametrize("b", BATCHES)
def test_ragged_slices_in_rank_order_equal_the_whole_batch(b, likelihood):
    """float64, in-kernel (Philox) noise: the blocks' sums add up to the
    whole batch's to 1e-12, and their posteriors are the whole batch's to
    1e-13 (the CPU's matrix product picks its blocking by the batch's size,
    so the last bit may differ; on the card the kernel's are bit-identical,
    which ``chip_smoke.py`` checks)."""
    cfg, flags = _cfg(likelihood=likelihood), tcfg.StepFlags()
    carry, qm, qlv, y, u = _operands(cfg, b)
    inv_b = 1.0 / b
    whole, q_whole = TF.forward_sums_plain(cfg, flags, carry, qm, qlv, y, u, None, None, inv_b)
    total, q_parts = torch.zeros_like(whole), []
    for r in range(TF.cluster_size()):
        rows = TF.cluster_rows(r, b)
        if len(rows) == 0:
            continue   # an empty block adds zeros
        sl = slice(rows.start, rows.stop)
        part, q = TF.forward_sums_plain(cfg, flags, carry, qm[sl], qlv[sl], y[sl], u[sl], None,
                                        None, inv_b, row0=rows.start)
        total = total + part
        q_parts.append(q)
    assert float((torch.cat(q_parts, dim=1) - q_whole).abs().max()) <= 1e-13
    scale = whole.abs().max()
    assert float((total - whole).abs().max()) <= 1e-12 * float(scale)


def test_ragged_slices_draw_the_whole_batchs_philox_rows():
    from vjf_tpu_torch.ops import rng as trng

    b = 250
    seed, count = torch.tensor(31), torch.tensor(4)
    whole = trng.normals(seed, count, b, 2 * XD)
    parts = [trng.normals(seed, count, len(rows), 2 * XD, row0=rows.start)
             for rows in (TF.cluster_rows(r, b) for r in range(TF.cluster_size())) if len(rows)]
    assert torch.equal(torch.cat(parts), whole)


def test_ragged_slices_match_the_jax_phase_one():
    """The summed slices against the JAX package's phase 1 on the whole
    batch (float32, given noise): the tolerance of the sharded tests, f32
    sums in another order."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from vjf_tpu.config import StepFlags, VJFConfig
    from vjf_tpu.models import vjf as jcore
    from vjf_tpu.ops.pallas import fused_step as JF
    from vjf_tpu_torch import convert

    b = 13
    tc = _cfg(dtype="float32")
    jcfg = VJFConfig(**{f.name: getattr(tc, f.name) for f in dataclasses.fields(VJFConfig)})
    state = jcore.init_state(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    y = rng.normal(size=(b, YD)).astype(np.float32)
    u = rng.normal(size=(b, UD)).astype(np.float32)
    q = (0.3 * rng.normal(size=(2, b, XD))).astype(np.float32)
    eps = rng.normal(size=(2, b, XD)).astype(np.float32)
    ref, _, _ = JF.forward_sums_call(jcfg, StepFlags(), JF.pad_carry(jcfg, state),
                                     *(jnp.asarray(a) for a in (q[0], q[1], y, u, eps[0], eps[1])),
                                     1.0 / b, interpret=True)
    carry = TF.pad_carry(tc, convert.state_from_numpy(tc, jax.tree.map(np.asarray, state),
                                                      device="cpu"))
    t = torch.tensor
    total = 0
    for r in range(TF.cluster_size()):
        rows = TF.cluster_rows(r, b)
        sl = slice(rows.start, rows.stop)
        if len(rows):
            part, _ = TF.forward_sums_plain(tc, tcfg.StepFlags(), carry, t(q[0][sl]), t(q[1][sl]),
                                            t(y[sl]), t(u[sl]), t(eps[0][sl]), t(eps[1][sl]),
                                            1.0 / b, row0=rows.start)
            total = total + part
    got = TF.unpack_sums(total, carry)
    for k in TF.FusedSums._fields:
        r, g = getattr(ref, k), getattr(got, k)
        pairs = zip(r, g) if isinstance(r, tuple) else [] if r is None else [(r, g)]
        for rv, gv in pairs:
            rv = np.asarray(rv, np.float64)
            np.testing.assert_allclose(np.asarray(gv, np.float64), rv, rtol=2e-4,
                                       atol=2e-4 * max(float(np.abs(rv).max()), 1e-3), err_msg=k)


def _launch_args(cfg, b=4, steps=2):
    carry, qm, qlv, y, u = _operands(cfg, b)
    dt = cfg.tdtype
    ys, us = y[None].repeat(steps, 1, 1), u[None].repeat(steps, 1, 1)
    q_pack = torch.empty((steps, 2, b, XD), dtype=dt)
    scal = torch.empty((steps, 8), dtype=dt)
    return (cfg, tcfg.StepFlags(), carry, qm, qlv, ys, us, None, None, torch.tensor(1e-3, dtype=dt),
            q_pack, scal)


def test_launch_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="expected a tensor on"):
        TF._launch("mega_epoch", *_launch_args(_cfg(dtype="float32")))


class _RecordingLib(TP.MirrorLib):
    """The mirror's size queries, and launchers that record what they are
    given: the arguments, and the layer table the kernel would copy."""

    def __init__(self):
        self.calls = []

    def vjf_workspace_floats(self, args):
        return 1

    def vjf_mega_epoch(self, args, stream):
        a = args._obj
        table = torch.frombuffer((ctypes.c_int64 * (3 * a.n_layers)).from_address(a.layers),
                                 dtype=torch.int64).reshape(a.n_layers, 3).clone()
        self.calls.append((a.n_layers, a.widths[:a.n_layers], table))
        return 0


@pytest.mark.parametrize("kw, what", [
    (dict(hidden_sizes=(8,) * 9), None),
    (dict(hidden_sizes=(3,) * 16), None),
    (dict(hidden_sizes=(16000,)), "shared memory"),
])
def test_launch_refuses_a_shape_the_kernel_does_not_take(kw, what, monkeypatch):
    """A block past the card's shared memory at the smallest plan (a hidden
    layer of 16,000: a tile's activations alone; 512 padded features,
    refused until the panels could live in L2, are taken) is refused; nine
    and sixteen hidden layers, refused until the layer table replaced the
    kernel's arrays of eight, reach the library's launch with every layer in
    the table (weights, bias, width). Host tensors stand in for the card's."""
    lib = _RecordingLib()
    monkeypatch.setattr(TF, "_library", lambda: lib)
    monkeypatch.setattr(TF, "_ptr", lambda t, *a, **k: None if t is None else t.data_ptr())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: types.SimpleNamespace(
        cuda_stream=0))
    args = _launch_args(_cfg(dtype="float32", **kw))
    if what is not None:
        with pytest.raises(ValueError, match=what):
            TF._launch("mega_epoch", *args)
        assert not lib.calls
        return
    TF._launch("mega_epoch", *args)
    widths, carry = list(kw["hidden_sizes"]), args[2]
    assert [(n, w) for n, w, _ in lib.calls] == [(len(widths), widths)]
    table = lib.calls[0][2]
    assert table[:, 2].tolist() == widths
    assert table[0, 0] == 0 and table[1:, 0].tolist() == [w.data_ptr() for w in carry.w_hidden]
    assert table[:, 1].tolist() == [b.data_ptr() for b in carry.b_hidden]


# (config, trials, trial mask, channel mask, the plan recorded: tile_rows,
# stage_rows, sub_rows); the last rows are chip_smoke.py's "shapes.plans"
MIRROR_SHAPES = [
    (dict(), 256, False, False, (32, 128, 0)), (dict(), 256, True, True, (32, 128, 0)),
    (dict(), 512, False, False, (32, 128, 0)), (dict(), 1024, False, False, (32, 128, 0)),
    (dict(), 512, True, True, (16, 128, 0)), (dict(n_rbf=200), 256, False, True, (32, 16, 16)),
    (dict(dynamics="sgp", n_inducing=200), 256, False, False, (32, 16, 0)),
    (dict(hidden_sizes=(64, 64, 64, 64)), 256, False, False, (32, 128, 0)),
    (dict(hidden_sizes=(128,)), 256, False, False, (32, 128, 0)),
    (dict(hidden_sizes=(8,) * 8), 300, True, False, (38, 128, 0)),
    (dict(udim=3, hidden_sizes=(32, 16)), 2048, False, False, (16, 128, 0)),
    (dict(n_rbf=400), 256, False, False, (16, 16, 16)),
    (dict(dynamics="sgp", n_inducing=400), 256, False, False, (16, 16, 16)),
    (dict(n_rbf=200), 256, True, True, (32, 16, 16)), (dict(), 4096, False, False, (48, 128, 16)),
    (dict(), 8192, True, True, (32, 128, 16)), (dict(n_rbf=1000), 256, True, True, (8, 8, 8)),
    (dict(hidden_sizes=(32,) * 9), 256, False, False, (32, 128, 0)),
    (dict(hidden_sizes=(3,) * 16), 256, True, True, (32, 128, 0)),
    (dict(hidden_sizes=(32,) * 16), 4096, False, True, (16, 128, 16)),
] + [(dict(ydim=yd, n_rbf=n_rbf), 256, m in ("mask", "both"), m in ("cmask", "both"), plan[:3])
     for plan, (yd, n_rbf, m) in [
         ((16, 16, 8), (200, 768, "")), ((8, 16, 16), (200, 640, "cmask")),
         ((8, 16, 8), (200, 768, "cmask")), ((8, 16, 4), (200, 896, "")),
         ((8, 8, 4), (200, 1280, "")), ((8, 4, 4), (200, 1408, "cmask")),
         ((8, 8, 8), (200, 1024, "both")), ((4, 128, 16), (2500, 128, "")),
         ((4, 16, 16), (2500, 256, "")), ((4, 16, 16), (2500, 256, "mask")),
         ((4, 32, 4), (2500, 128, "cmask")), ((4, 16, 4), (200, 896, "cmask")),
         ((4, 8, 8), (200, 1152, "cmask")), ((4, 4, 8), (2500, 896, "")),
         ((4, 8, 4), (200, 1408, "")), ((4, 4, 4), (200, 1664, "cmask"))]]
_MIRROR_BASE = dict(ydim=200, xdim=10, n_rbf=100, hidden_sizes=(32,), likelihood="poisson",
                    dtype="float32", rls_backend="nsv")


@pytest.mark.parametrize("kw, b, mask, cmask, plan", MIRROR_SHAPES)
def test_mirror_plans_are_the_recorded_ones(kw, b, mask, cmask, plan):
    """The mirror's plan of each shape is the one recorded here (and, for
    the shapes.plans rows, the plan chip_smoke.py names the row by), within
    the card's shared memory: a change to the head of a block's shared
    memory or to the plan that moves one shows here."""
    cfg = tcfg.VJFConfig(**{**_MIRROR_BASE, **kw})
    got = TP.tile_plan(cfg, b, mask, cmask, cluster=8)
    assert (got.tile, got.kc, got.sp) == plan and got.smem_bytes <= TP.SMEM_LIMIT


def test_chip_smoke_plan_rows_are_the_mirrors():
    """Every row of chip_smoke.py's PLAN_ROWS is a MIRROR_SHAPES row with the
    plan it is keyed by."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rows = {(kw.get("ydim"), kw.get("n_rbf"), m, c): p for kw, _, m, c, p in MIRROR_SHAPES}
    for key, (yd, n_rbf, masks) in chip_smoke.PLAN_ROWS.items():
        m, c = masks in ("mask", "both"), masks in ("cmask", "both")
        assert rows[(yd, n_rbf, m, c)] == key[:3], key


@pytest.mark.card
@pytest.mark.parametrize("kw, b, mask, cmask, plan", MIRROR_SHAPES)
def test_tile_plan_mirror_matches_the_library(kw, b, mask, cmask, plan):
    """The tests' mirror of the kernels' tile plan and shared-memory layout
    (``tests/torch_tile_plan.py``) against the library's own answers:
    ``vjf_smem_bytes`` and the tile, chunk and sub-panel of
    ``vjf_cluster_info``, which must be the plan recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the library's size queries)")
    cfg = tcfg.VJFConfig(**{**_MIRROR_BASE, **kw})
    lib = TF._library()
    a = TF._dims(cfg, b, mask=mask, cmask=cmask)
    got = TP.plan_of(a)
    assert lib.vjf_smem_bytes(ctypes.byref(a)) == got.smem_bytes
    if got.smem_bytes <= lib.vjf_smem_limit():
        out = (ctypes.c_int * 9)()
        assert lib.vjf_cluster_info(ctypes.byref(a), out) == 0
        assert (out[2], out[6], out[7], out[8]) == (got.smem_bytes, got.tile, got.kc, got.sp)
        assert (out[6], out[7], out[8]) == plan


@pytest.mark.card
def test_member_kernels_match_plain_and_solo_on_the_card():
    """The member axis of the launch (one cluster a member along
    ``gridDim.y``): the N-member mega launch against its plain version, and
    member m bit for bit against a solo launch of member m."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the member-axis CUDA kernels)")
    from vjf_tpu_torch.parallel import init_ensemble

    dev = torch.device("cuda")
    cfg = tcfg.VJFConfig(ydim=8, xdim=2, n_rbf=10, hidden_sizes=(6,), likelihood="poisson",
                         dtype="float32", rls_backend="nsv", fused_step="on",
                         fused_epoch="mega", ns_prefix=4)
    carry = TF.stack_carries([TF.pad_carry(cfg, s) for s in init_ensemble(3, cfg, 3,
                                                                          device=dev)])
    g = torch.Generator(device=dev).manual_seed(0)
    ys = torch.poisson(torch.full((3, 16, 8, 8), 0.5, device=dev), generator=g)
    q = torch.zeros(3, 8, 2, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    flags = tcfg.StepFlags()

    def clone(c):
        return c._replace(**{k: (v.clone() if isinstance(v, torch.Tensor) else tuple(
            x.clone() for x in v) if isinstance(v, tuple) else v)
            for k, v in c._asdict().items()})

    got = TF.mega_epoch_call(cfg, flags, clone(carry), q, q, ys, None, None, None, lr)
    ref = TF.mega_epoch_plain(cfg, flags, clone(carry), q, q, ys, None, None, None, lr)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-3, atol=1e-3)
    for m in range(3):
        solo = TF.mega_epoch_call(cfg, flags, clone(TF.member_carry(carry, m)), q[m], q[m],
                                  ys[m], None, None, None, lr)
        assert torch.equal(solo[1], got[1][m]) and torch.equal(solo[0].w_dyn, got[0].w_dyn[m])
