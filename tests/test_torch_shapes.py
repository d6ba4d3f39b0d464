"""Shapes the TPU kernels take that the CUDA kernels take since they run
phase 1 over tiles of a block's trials and stage the Newton-Schulz operand
in chunks: 256 padded features (RBF and SGP), a hidden layer of width 96 and
four hidden layers; and since the L2 route (the trials' state and phase 2's
panels in the L2 workspace, the Newton-Schulz left operand staged in
sub-panels): 384 and 512 padded features (RBF and SGP); and since the
layer table (the hidden layers' weights, biases and widths copied into each
block's shared memory in place of arrays of eight): nine and twelve hidden
layers, and the state of nine layers through ``convert``. The port's plain
versions of the three kernels at those shapes against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs and injected
noise; one epoch through ``run_epoch(fused_step='on')`` at 256 padded
features against JAX's fused epoch; and the mirror of the kernels' tile plan
(``tests/torch_tile_plan.py``: ``plan_of``, ``block_tiles``). The CUDA
kernels at these shapes, at 512, 1024 and 4096 trials and at 256 padded
features with both masks run on the card: ``python3 chip_smoke.py``, phase
"shapes"."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.config import StepFlags, VJFConfig
from vjf_tpu.models import vjf as jcore
from vjf_tpu.ops.pallas import fused_step as JF
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF

import torch_tile_plan as TP

torch.set_num_threads(1)

B, YD, XD, T = 8, 12, 2, 4
# f32, the plain versions against the Pallas kernels: the summation orders
# differ (tests/test_torch_fused_step.py:TOL["float32"])
TOL = 2e-4
LR = 0.02
SHAPES = {
    "n_rbf=200": dict(n_rbf=200),
    "n_inducing=200": dict(dynamics="sgp", n_inducing=200),
    "hidden=(96,)": dict(hidden_sizes=(96,)),
    "four_layers": dict(hidden_sizes=(8, 8, 8, 8)),
    "n_rbf=300": dict(n_rbf=300),
    "n_inducing=300": dict(dynamics="sgp", n_inducing=300),
    "n_rbf=400": dict(n_rbf=400),
    "n_inducing=400": dict(dynamics="sgp", n_inducing=400),
    "nine_layers": dict(hidden_sizes=(8,) * 9),
    "twelve_layers": dict(hidden_sizes=(4, 5, 6, 7, 8, 4, 5, 6, 7, 8, 6, 5)),
}
# padded features of the shapes that set them; the L2 route past 256
PADDED = {"n_rbf=200": 256, "n_inducing=200": 256, "n_rbf=300": 384, "n_inducing=300": 384,
          "n_rbf=400": 512, "n_inducing=400": 512}
_j_init_state = jax.jit(jcore.init_state, static_argnames=("cfg", "backend", "batch_hint"))


def _cfg(**kw):
    base = dict(ydim=YD, xdim=XD, udim=0, n_rbf=14, hidden_sizes=(8,), likelihood="poisson",
                dtype="float32", rls_backend="nsv", fused_step="on", matmul_dtype="float32")
    base.update(kw)
    return VJFConfig(**base)


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _data(seed):
    rng = np.random.default_rng(seed)
    y = rng.poisson(1.0, (T, B, YD)).astype(np.float32)
    eps = rng.normal(size=(2, T, B, XD)).astype(np.float32)
    q = (0.5 * rng.normal(size=(2, B, XD))).astype(np.float32)
    return y, eps, q


def _carries(cfg, state, tc, tstate):
    """Both packages' padded carries with the weight posterior at precision
    1e4 I, so that tau stays below the mega segment's skip and every step
    updates P and V (the Newton-Schulz products run)."""
    jc, tcar = JF.pad_carry(cfg, state), TF.pad_carry(tc, tstate)
    nfp = tcar.p_mat.shape[0]
    eye = np.eye(nfp, dtype=np.float32)
    jc = jc._replace(p_mat=jnp.asarray(1e4 * eye), v_mat=jnp.asarray(eye / 1e4))
    tcar = tcar._replace(p_mat=torch.tensor(1e4 * eye), v_mat=torch.tensor(eye / 1e4))
    return jc, tcar


def _flat_jax(tree):
    return convert.flatten(jax.tree.map(np.asarray, tree))


def _sums(sums):
    out = {}
    for k in TF.FusedSums._fields:
        v = getattr(sums, k)
        if isinstance(v, tuple):
            out.update({f"{k}.{i}": np.asarray(x) for i, x in enumerate(v)})
        elif v is not None:
            out[k] = np.asarray(v)
    return out


def _tree_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def shape_runs():
    """Each shape's three launchers in both packages: JAX's Pallas kernels
    in interpret mode, the port's plain versions (its launchers on CPU
    tensors). Computed once."""
    out = {}
    for i, (name, kw) in enumerate(SHAPES.items()):
        cfg = _cfg(**kw)
        tc = _port_cfg(cfg)
        state = _j_init_state(jax.random.PRNGKey(i), cfg)
        tstate = convert.state_from_numpy(tc, jax.tree.map(np.asarray, state), device="cpu")
        y, eps, q = _data(10 + i)
        jc, tcar = _carries(cfg, state, tc, tstate)
        j, t = jnp.asarray, torch.tensor
        lr_j, lr_t = jnp.asarray(LR, jnp.float32), torch.tensor(LR)
        step = (JF.fused_step_call(cfg, StepFlags(), jc, j(q[0]), j(q[1]), j(y[0]), None,
                                   j(eps[0, 0]), j(eps[1, 0]), lr_j, interpret=True),
                TF.fused_step_call(tc, tcfg.StepFlags(), tcar, t(q[0]), t(q[1]), t(y[0]), None,
                                   t(eps[0, 0]), t(eps[1, 0]), lr_t))
        mega = (JF.mega_epoch_call(cfg, StepFlags(), jc, j(q[0]), j(q[1]), j(y), None,
                                   j(eps[0]), j(eps[1]), lr_j, interpret=True),
                TF.mega_epoch_call(tc, tcfg.StepFlags(), tcar, t(q[0]), t(q[1]), t(y), None,
                                   t(eps[0]), t(eps[1]), lr_t))
        sums = (JF.forward_sums_call(cfg, StepFlags(), jc, j(q[0]), j(q[1]), j(y[0]), None,
                                     j(eps[0, 0]), j(eps[1, 0]), 1.0 / B, interpret=True),
                TF.forward_sums_call(tc, tcfg.StepFlags(), tcar, t(q[0]), t(q[1]), t(y[0]),
                                     None, t(eps[0, 0]), t(eps[1, 0]), 1.0 / B))
        out[name] = dict(cfg=tc, carry=tcar, step=step, mega=mega, sums=sums)
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_shape_is_within_the_kernel_limits(shape_runs, name):
    """Each shape is one the CUDA kernels take (it was refused before they
    had trial tiles and chunked staging, or, past 256 padded features, the
    L2 route); the panels of 384 and 512 padded features live in L2."""
    tc = shape_runs[name]["cfg"]
    assert TF.kernel_limits(tc, B, on_card=False) is None
    nfp = shape_runs[name]["carry"].p_mat.shape[0]
    assert nfp == PADDED.get(name, 128)
    plan = TP.tile_plan(tc, B)
    assert plan.kc == (16 if nfp > 128 else nfp)
    assert (plan.sp > 0) == (nfp > 256) and plan.smem_bytes <= TP.SMEM_LIMIT


@pytest.mark.parametrize("name", list(SHAPES))
def test_fused_step_plain_matches_the_pallas_kernel(shape_runs, name):
    ref, got = shape_runs[name]["step"]
    want = _flat_jax(ref._asdict())
    _tree_close({k: v.numpy() for k, v in convert.flatten(got._asdict()).items()}, want)


@pytest.mark.parametrize("name", list(SHAPES))
def test_mega_epoch_plain_matches_the_pallas_kernel(shape_runs, name):
    (jc, jq, js), (tcar, tq, ts) = shape_runs[name]["mega"]
    assert bool((ts[:, 4] < TF.NS_TAU_MAX).all())   # every step updated P and V
    _tree_close({k: v.numpy() for k, v in convert.flatten(tcar._asdict()).items()},
                _flat_jax(jc._asdict()))
    _tree_close({"q_pack": tq.numpy(), "scal": ts.numpy()},
                {"q_pack": np.asarray(jq), "scal": np.asarray(js)})


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_sums_plain_matches_the_pallas_kernel(shape_runs, name):
    (ref, rqm, rqlv), (flat, q_pack) = shape_runs[name]["sums"]
    got = TF.unpack_sums(flat, shape_runs[name]["carry"])
    _tree_close(_sums(got), _sums(ref))
    _tree_close({"qt_m": q_pack[0].numpy(), "qt_lv": q_pack[1].numpy()},
                {"qt_m": np.asarray(rqm), "qt_lv": np.asarray(rqlv)})


def test_convert_carries_nine_hidden_layers_both_ways():
    """A JAX state of nine hidden layers through ``state_from_numpy`` and
    back (``state_to_numpy``), leaf for leaf and bit for bit, and its
    ensemble form (``ensemble_from_numpy``/``ensemble_to_numpy``)."""
    cfg = _cfg(hidden_sizes=(3, 4, 5, 6, 7, 8, 7, 6, 5))
    tc = _port_cfg(cfg)
    state = jax.tree.map(np.asarray, _j_init_state(jax.random.PRNGKey(3), cfg))
    tstate = convert.state_from_numpy(tc, state, device="cpu")
    assert [lin.weight.shape[0] for lin in tstate.params.recognition.layers] == [3, 4, 5, 6, 7,
                                                                                8, 7, 6, 5]
    want, got = _flat_jax(state), convert.flatten(convert.state_to_numpy(tstate))
    assert sum("recognition.layers." in k for k in got) == 18
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    stacked = jax.tree.map(lambda *x: np.stack(x), state, state)
    members = convert.ensemble_from_numpy(tc, stacked, device="cpu")
    back = convert.flatten(convert.ensemble_to_numpy(members))
    for k, v in _flat_jax(stacked).items():
        assert np.array_equal(back[k], v), k


def test_fused_epoch_at_256_padded_features_matches_jax():
    """``run_epoch(fused_step='on')`` at n_rbf 200 on CPU tensors (the plain
    versions: the per-step prefix with the exact fallback, then the mega
    segment) against JAX's fused epoch with the Pallas kernels in interpret
    mode, with the same injected noise (the tolerances of
    tests/test_fused_step.py's fused epoch)."""
    cfg = _cfg(n_rbf=200, ns_prefix=4)
    tc = _port_cfg(cfg)
    state = _j_init_state(jax.random.PRNGKey(7), cfg)
    tstate = convert.state_from_numpy(tc, jax.tree.map(np.asarray, state), device="cpu")
    rng = np.random.default_rng(8)
    t_len = 12
    ys = rng.poisson(1.0, (t_len, B, YD)).astype(np.float32)
    eps = rng.normal(size=(2, t_len, B, XD)).astype(np.float32)
    us = np.zeros((t_len, B, 0), np.float32)
    flags = StepFlags()
    ref = JF.run_epoch_fused(cfg, flags, state, jnp.asarray(ys), jnp.asarray(us),
                             jax.random.PRNGKey(0), jnp.asarray(1e-3, jnp.float32),
                             noise=(jnp.asarray(eps[0]), jnp.asarray(eps[1])), interpret=True)
    TF.reset_launches()
    got = tcore.run_epoch(tc, tcfg.StepFlags(), tstate, torch.tensor(ys), torch.tensor(us), 0,
                          1e-3, noise=(torch.tensor(eps[0]), torch.tensor(eps[1])))
    assert got.metrics.tau is not None and sum(TF.launches.values()) == 0   # plain versions
    np.testing.assert_allclose(got.metrics.loss.numpy(), np.asarray(ref.metrics.loss),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.q_means.numpy(), np.asarray(ref.q_means), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.state.dynamics.blr.w_mean.numpy(),
                               np.asarray(ref.state.dynamics.blr.w_mean), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the tile plan (a mirror of plan_tiles and carve_smem in csrc/fused_step.cu)
# ---------------------------------------------------------------------------


def _flagship(**kw):
    base = dict(ydim=200, xdim=10, udim=0, n_rbf=100, hidden_sizes=(32,),
                likelihood="poisson", dtype="float32", rls_backend="nsv")
    base.update(kw)
    return tcfg.VJFConfig(**base)


PLAN_CFGS = {
    "flagship": _flagship(),
    "sgp": _flagship(dynamics="sgp", n_inducing=100),
    "controls": _flagship(udim=3, hidden_sizes=(32, 16)),
    "n_rbf=200": _flagship(n_rbf=200),
    "four_layers": _flagship(hidden_sizes=(64, 64, 64, 64)),
    "small": _flagship(ydim=20, xdim=2, n_rbf=30, hidden_sizes=(8,)),
}
MASKS = [(False, False), (True, False), (False, True), (True, True)]
BATCHES = (1, 5, 16, 32, 250, 256, 300, 320, 384, 512, 1024, 2048)


@pytest.mark.parametrize("name", list(PLAN_CFGS))
def test_tile_plan_keeps_one_tile_where_the_parent_layout_fits(name):
    """Every shape the kernels took before trial tiles runs as one tile (the
    bits of the parent's kernel)."""
    cfg = PLAN_CFGS[name]
    seen = 0
    for b in BATCHES:
        for mask, cmask in MASKS:
            old = TP.parent_smem_bytes(cfg, b, mask, cmask)
            if TF._round_up(cfg.feature_dim) > 128 or old > TP.SMEM_LIMIT:
                continue
            plan = TP.tile_plan(cfg, b, mask, cmask)
            assert plan.tile == -(-b // 8) and plan.kc == TF._round_up(cfg.feature_dim)
            # the parent's layout, with the head grown from 1,440 bytes to
            # head_bytes (the layer table, the plan) and the 8 ELBO sums
            assert plan.smem_bytes <= old + TP.head_bytes(len(cfg.hidden_sizes)) - 1440 + 32
            seen += 1
    assert seen > 0 or name == "n_rbf=200"


def test_parent_layout_reproduces_the_recorded_bytes():
    """The parent's formula above gives the flagship's recorded 192,368
    bytes, 219,504 with both masks, and refuses 512 trials."""
    cfg = _flagship()
    assert TP.parent_smem_bytes(cfg, 256) == 192368
    assert TP.parent_smem_bytes(cfg, 256, True, True) == 219504
    assert TP.parent_smem_bytes(cfg, 512) > TP.SMEM_LIMIT


@pytest.mark.parametrize("name", list(PLAN_CFGS))
def test_tile_plan_tiles_are_the_largest_multiple_of_16_that_fits(name):
    cfg = PLAN_CFGS[name]
    for b in BATCHES:
        for mask, cmask in MASKS:
            plan = TP.tile_plan(cfg, b, mask, cmask)
            rows = -(-b // 8)
            assert 1 <= plan.tile <= rows
            if plan.tile == rows:
                continue
            assert plan.tile % 16 == 0
            # the whole block, and every larger multiple of 16, does not fit
            for bigger in [rows] + list(range(plan.tile + 16, rows, 16)):
                a = TF._dims(cfg, b, mask=mask, cmask=cmask)
                a.tile, a.kc, a.sp = bigger, plan.kc, plan.sp
                assert 4 * TP.smem_floats(a, 8) > TP.SMEM_LIMIT


@pytest.mark.parametrize("b", BATCHES + (2047, 4001))
def test_block_tiles_cover_every_trial_once(b):
    """Each block's tiles (the kernel's tile_of/n_tiles) hold each of its
    trials once, in order; a block without trials runs one empty tile."""
    for cfg in PLAN_CFGS.values():
        tile = TP.tile_plan(cfg, b, True, True).tile
        covered = []
        for r in range(8):
            rows = TF.cluster_rows(r, b, 8)
            tiles = TP.block_tiles(len(rows), tile)
            assert len(tiles) >= 1 and all(len(t) <= tile for t in tiles)
            covered += [rows.start + i for t in tiles for i in t]
        assert covered == list(range(b))


CARD_SHAPES = {
    "B=512": (_flagship(), 512, False, False),
    "B=1024": (_flagship(), 1024, False, False),
    "B=512,masks": (_flagship(), 512, True, True),
    "n_rbf=200": (_flagship(n_rbf=200), 256, False, False),
    "n_inducing=200": (_flagship(dynamics="sgp", n_inducing=200), 256, False, False),
    "hidden=(64,)*4": (_flagship(hidden_sizes=(64, 64, 64, 64)), 256, False, False),
    "hidden=(128,)": (_flagship(hidden_sizes=(128,)), 256, False, False),
    "n_rbf=400": (_flagship(n_rbf=400), 256, False, False),
    "n_inducing=400": (_flagship(dynamics="sgp", n_inducing=400), 256, False, False),
    "n_rbf=200,masks": (_flagship(n_rbf=200), 256, True, True),
    "B=4096": (_flagship(), 4096, False, False),
    "hidden=(32,)*9": (_flagship(hidden_sizes=(32,) * 9), 256, False, False),
}
# the card shapes that take the L2 route
L2_SHAPES = ("n_rbf=400", "n_inducing=400", "n_rbf=200,masks", "B=4096")


@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_card_shapes_take_the_kernels(name, monkeypatch, caplog):
    """The shapes ``chip_smoke.py`` drives in its "shapes" phase are within
    the card's shared memory (the query answered by the mirror), and
    'auto' takes the kernels with no warning; B 512 and 1024 and the masked
    B 512 run in tiles, the last four on the L2 route."""
    import logging

    cfg, b, mask, cmask = CARD_SHAPES[name]
    monkeypatch.setattr(TF, "_on_cuda", lambda t: True)
    monkeypatch.setattr(TF, "_routed_away", set())
    monkeypatch.setattr(TF, "_library", lambda: TP.MirrorLib())
    assert TF.kernel_limits(cfg, b, mask=mask, channel_mask=cmask) is None
    state = tcore.init_state(0, cfg.replace(fused_step="auto"), device="cpu")
    with caplog.at_level(logging.WARNING, logger=TF.__name__):
        assert TF.fused_enabled(cfg.replace(fused_step="auto"), state, n_batch=b, mask=mask,
                                channel_mask=cmask)
    assert not caplog.records
    plan = TP.tile_plan(cfg, b, mask, cmask)
    assert (plan.sp > 0) == (name in L2_SHAPES)
    if not plan.sp:
        assert (plan.tile < -(-b // 8)) == (b > 256)


@pytest.mark.parametrize("n_layers", [9, 12, 16])
def test_kernel_limits_take_any_number_of_layers(n_layers, monkeypatch):
    """The flagship at 9, 12 and 16 hidden layers of 32 and 256 trials is
    within the kernels' limits (the shared-memory query answered by the
    mirror; the arrays of eight layers refused a ninth), on one tile, the
    whole operand staged."""
    monkeypatch.setattr(TF, "_library", lambda: TP.MirrorLib())
    cfg = _flagship(hidden_sizes=(32,) * n_layers)
    assert TF.kernel_limits(cfg, 256, on_card=False) is None
    assert TF.kernel_limits(cfg, 256) is None
    plan = TP.tile_plan(cfg, 256)
    assert (plan.tile, plan.kc, plan.sp) == (32, 128, 0)


# ---------------------------------------------------------------------------
# the L2 route: the plan where the trials' state and the panels do not fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rbf, nfp", [(400, 512), (500, 512), (1000, 1024), (1790, 1792)])
def test_plan_takes_padded_features_on_the_l2_route(n_rbf, nfp):
    """At the flagship widths and 256 trials, 512 padded features and more
    fit a block on the L2 route (refused before: 679,536 bytes a block at
    512); 1024 take chunks and sub-panels of 8 rows and tiles of 8 trials,
    1792 are the most the plan admits."""
    for sgp in (False, True):
        cfg = (_flagship(dynamics="sgp", n_inducing=n_rbf) if sgp else _flagship(n_rbf=n_rbf))
        assert TF._round_up(cfg.feature_dim) == nfp
        plan = TP.tile_plan(cfg, 256)
        assert plan.sp > 0 and plan.smem_bytes <= TP.SMEM_LIMIT
        if nfp == 512:
            assert (plan.tile, plan.kc, plan.sp) == (16, 16, 16)
        if nfp == 1024:
            assert (plan.tile, plan.kc, plan.sp) == (8, 8, 8)
    over = TP.tile_plan(_flagship(n_rbf=1800), 256)
    assert over.smem_bytes > TP.SMEM_LIMIT and over[:2] == (4, 4) and over.sp == 4


@pytest.mark.parametrize("b", [4096, 8192, 65536])
@pytest.mark.parametrize("mask, cmask", MASKS)
def test_plan_takes_any_number_of_trials(b, mask, cmask):
    """The flagship at 4096 trials and more, with and without the masks:
    the trials' state and the trial mask's row stay out of shared memory,
    so a block fits whatever its trials (2,184 was the most before, 1,176
    with both masks); the tiles cover every trial once."""
    cfg = _flagship()
    plan = TP.tile_plan(cfg, b, mask, cmask)
    assert plan.sp == 16 and plan.kc == 128 and plan.smem_bytes <= TP.SMEM_LIMIT
    assert plan.tile % 16 == 0 and plan.tile < -(-b // 8)
    assert plan == TP.tile_plan(cfg, 4096, mask, cmask)   # the same plan at any B past it
    covered = []
    for r in range(8):
        rows = TF.cluster_rows(r, b, 8)
        covered += [rows.start + i for t in TP.block_tiles(len(rows), plan.tile) for i in t]
    assert covered == list(range(b))


def test_plan_keeps_the_resident_route_where_it_fits():
    """The L2 route is taken only where no tile fits with the trials' state
    and the panels resident: the largest flagship batch of the resident
    route (2,184 trials, tiles of 16) keeps it, one more block row takes
    the L2 route; 256 padded features at 256 trials keep it unmasked and
    with the trial mask, and take the L2 route with the channel mask (its
    two staging buffers, 253,552 bytes a block on the resident route)."""
    cfg = _flagship()
    assert TP.tile_plan(cfg, 2184).sp == 0 and TP.tile_plan(cfg, 2184).tile == 16
    assert TP.tile_plan(cfg, 2192).sp == 16
    wide = _flagship(n_rbf=200)
    assert TP.tile_plan(wide, 256).sp == 0 and TP.tile_plan(wide, 256, mask=True).sp == 0
    plan = TP.tile_plan(wide, 256, False, True)
    assert plan.sp == 16 and plan.tile == 32 and plan.smem_bytes <= TP.SMEM_LIMIT
    resident = TF._dims(wide, 256, cmask=True)
    resident.kc, resident.tile, resident.sp = 16, 16, 0
    assert 4 * TP.smem_floats(resident, 8) > TP.SMEM_LIMIT


def test_plan_tiles_below_the_quantum_only_on_the_l2_route():
    """Tiles of 8 or 4 trials appear only on the L2 route, and only where no
    multiple of 16 fits there."""
    for name, cfg in PLAN_CFGS.items():
        for b in BATCHES + (4096,):
            for mask, cmask in MASKS:
                plan = TP.tile_plan(cfg, b, mask, cmask)
                if plan.tile < 16 and plan.tile < -(-b // 8):
                    assert plan.sp > 0, (name, b, mask, cmask)
    cfg = _flagship(n_rbf=1000)
    plan = TP.tile_plan(cfg, 256)
    a = TF._dims(cfg, 256)
    a.tile, a.kc, a.sp = 16, plan.kc, plan.sp
    assert plan.tile == 8 and 4 * TP.smem_floats(a, 8) > TP.SMEM_LIMIT
