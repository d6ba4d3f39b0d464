"""Ragged trials and missing channels through the port, against the JAX
package on the same numpy inputs and injected noise: the plain step math,
the plain versions of the three kernels (against the Pallas kernels in
interpret mode), ``filter_step`` and the autograd epoch, the per-epoch
``fit`` with either mask, the sharded epoch at world size 1, and the
semantics the masks promise (``tests/test_masking.py`` for the port).

Masked entries of ``y`` and ``u`` hold NaN unless a test says otherwise:
the select that replaces them is part of what is checked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from vjf_tpu.config import StepFlags, VJFConfig
from vjf_tpu.models import dynamics as jdyn
from vjf_tpu.models import rbf as jrbf
from vjf_tpu.models import vjf as jcore
from vjf_tpu.ops.pallas import fused_step as JF
from vjf_tpu.types import Gaussian as JGaussian
from vjf_tpu.utils import ragged as jragged
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert, pad_trials, split_trials
from vjf_tpu_torch.models import dynamics as tdyn
from vjf_tpu_torch.models import rbf as trbf
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.ops import fused_step as TF
from vjf_tpu_torch.parallel import make_dp_group, run_epoch_fused_sharded
from vjf_tpu_torch.types import Gaussian

torch.set_num_threads(1)

B, YD, XD, UD, NF = 6, 12, 2, 1, 14
# float64, the same algorithm: only the order of sums differs
TOL64 = dict(rtol=1e-9, atol=1e-10)
# float32 step (the plain step against the Pallas kernel in interpret mode):
# summation order, amplified by the exact fallback's Cholesky
# (tests/test_torch_sharded.py:TOL32_STEP)
TOL32_STEP = dict(rtol=1e-4, atol=1e-5)
# a float64 epoch: the per-step exact inverse amplifies rounding by about
# cond(P)^2 (tests/test_torch_filter.py:EPOCH_TOL)
EPOCH_TOL = dict(rtol=1e-6, atol=1e-7)
MASKS = ("mask", "cmask", "both")


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _cfg(likelihood="poisson", dtype="float64", **kw):
    base = dict(ydim=YD, xdim=XD, udim=UD, n_rbf=NF, hidden_sizes=(8,), likelihood=likelihood,
                dtype=dtype, rls_backend="nsv", fused_step="off", matmul_dtype="float32")
    base.update(kw)
    return VJFConfig(**base)


def _pair(cfg, seed=1):
    state = jcore.init_state(jax.random.PRNGKey(seed), cfg, backend="nsv")
    tstate = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(np.asarray, state),
                                      device="cpu")
    return state, tstate


def _masks(which, lead=(), seed=0, empty_step=None):
    """(trial mask lead + (B,), channel mask lead + (B, YD)) per ``which``;
    the one not asked for is None. ``empty_step``: that step (of a leading
    time axis) has no valid trial."""
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=lead + (B,)) > 0.3).astype(np.float64)
    m[..., 0] = 1.0
    if empty_step is not None:
        m[empty_step] = 0.0
    cm = (rng.uniform(size=lead + (B, YD)) > 0.25).astype(np.float64)
    return (m if which in ("mask", "both") else None,
            cm if which in ("cmask", "both") else None)


def _data(likelihood, lead=(), seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed + 100)
    y = (rng.poisson(2.0, lead + (B, YD)) if likelihood == "poisson"
         else rng.normal(size=lead + (B, YD))).astype(dtype)
    u = rng.normal(size=lead + (B, UD)).astype(dtype)
    eps = rng.normal(size=(2,) + lead + (B, XD)).astype(dtype)
    q = (0.5 * rng.normal(size=(2, B, XD))).astype(dtype)
    return y, u, eps, q


def _holes(y, u, m, cm, fill=np.nan):
    """``y`` and ``u`` with ``fill`` at every masked entry."""
    y, u = y.copy(), u.copy()
    if cm is not None:
        y[cm == 0] = fill
    if m is not None:
        y[m == 0] = fill
        u[m == 0] = fill
    return y, u


def _close(got, want, name, tol=TOL64):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=name, **tol)


def _tree_close(got: dict, want: dict, tol=TOL64):
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], k, tol)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.tensor(x)


def _col(m):
    return None if m is None else m[:, None]


def _sums_by_leaf(sums):
    out = {}
    for k in TF.FusedSums._fields:
        v = getattr(sums, k)
        if isinstance(v, tuple):
            out.update({f"{k}.{i}": x for i, x in enumerate(v)})
        elif v is not None:
            out[k] = v
    return out


def _stepout(out):
    return convert.flatten({k: v for k, v in out._asdict().items()})


# ---------------------------------------------------------------------------
# the plain step math against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("likelihood", ["poisson", "gaussian"])
@pytest.mark.parametrize("which", MASKS)
def test_step_math_matches_jax(likelihood, which):
    """``step_math`` and the exact fallback with the masks, f64, tol 1e-9;
    the frozen rows of the posterior are their inputs bit for bit."""
    cfg = _cfg(likelihood)
    state, tstate = _pair(cfg)
    y, u, eps, q = _data(likelihood, seed=2)
    m, cm = _masks(which, seed=3)
    y, u = _holes(y, u, m, cm)
    carry, tc = JF.pad_carry(cfg, state), _port_cfg(cfg)
    tcarry = TF.pad_carry(tc, tstate)
    ref = JF.step_math(cfg, StepFlags(), carry, _j(q[0]), _j(q[1]), _j(y), _j(u), _j(eps[0]),
                       _j(eps[1]), jnp.asarray(0.02), mask=_j(_col(m)), cmask=_j(cm))
    # JAX's fallback reads the controls as given (NaN padding skips it): it
    # gets the masked rows' controls as 0, what its step saw (ROADMAP Queue 3)
    u0 = u if m is None else np.where(m[:, None] > 0, u, 0.0)
    ref = JF.exact_v_fallback(cfg, ref, carry, _j(u0), mask=_j(_col(m)))
    got = TF.step_math(tc, tcfg.StepFlags(), tcarry, _t(q[0]), _t(q[1]), _t(y), _t(u),
                       _t(eps[0]), _t(eps[1]), torch.tensor(0.02, dtype=torch.float64),
                       mask=_t(m), cmask=_t(cm))
    assert float(got.scal.tau) >= TF.NS_TAU_THRESHOLD      # the exact inverse is taken
    got = TF.exact_v_fallback(tc, got, tcarry, _t(u), mask=_t(m))
    _tree_close(_stepout(got), convert.flatten(jax.tree.map(np.asarray, ref._asdict())))
    if m is not None:
        dead = m == 0
        assert np.array_equal(got.qt_mean.numpy()[dead], q[0][dead])
        assert np.array_equal(got.qt_logvar.numpy()[dead], q[1][dead])
    for leaf in convert.flatten(got.carry._asdict()).values():
        assert torch.isfinite(leaf.double()).all()


@pytest.mark.parametrize("likelihood", ["poisson", "gaussian"])
def test_fully_masked_step_advances_nothing(likelihood):
    """No valid trial: loss and tau 0, the RLS recursion, the counters and
    the posterior stay (the running variances are recomputed from
    themselves, as in the reference)."""
    cfg = _cfg(likelihood)
    state, tstate = _pair(cfg)
    y, u, eps, q = _data(likelihood, seed=4)
    m = np.zeros(B)
    y, u = _holes(y, u, m, None)
    tc = _port_cfg(cfg)
    carry = TF.pad_carry(tc, tstate)
    got = TF.step_math(tc, tcfg.StepFlags(), carry, _t(q[0]), _t(q[1]), _t(y), _t(u),
                       _t(eps[0]), _t(eps[1]), torch.tensor(0.02, dtype=torch.float64),
                       mask=_t(m))
    jcarry = JF.pad_carry(cfg, state)
    ref = JF.step_math(cfg, StepFlags(), jcarry, _j(q[0]), _j(q[1]), _j(y), _j(u), _j(eps[0]),
                       _j(eps[1]), jnp.asarray(0.02), mask=_j(_col(m)))
    _tree_close(_stepout(got), convert.flatten(jax.tree.map(np.asarray, ref._asdict())))
    assert float(got.scal.loss) == 0.0 and float(got.scal.tau) == 0.0
    for k in ("p_mat", "v_mat", "w_dyn", "dyn_n", "w_in_y", "w_dec"):
        assert torch.equal(getattr(got.carry, k), getattr(carry, k)), k
    assert np.array_equal(got.qt_mean.numpy(), q[0])


@pytest.mark.parametrize("which", MASKS)
def test_forward_sums_plain_matches_jax(which):
    """Phase 1 on half the trials with a global inv_b (local_renorm off):
    every FusedSums leaf, ``cm_sum`` among them, and the unfrozen q pack."""
    cfg = _cfg("gaussian")
    state, tstate = _pair(cfg)
    y, u, eps, q = _data("gaussian", seed=5)
    m, cm = _masks(which, seed=6)
    y, u = _holes(y, u, m, cm)
    rows = slice(B // 2, B)
    inv_b = 1.0 / (m.sum() if m is not None else B)
    sl = (lambda a: None if a is None else a[rows])
    ref, per = JF.step_forward_sums(
        cfg, StepFlags(), JF.pad_carry(cfg, state), _j(q[0][rows]), _j(q[1][rows]),
        _j(y[rows]), _j(u[rows]), _j(eps[0][rows]), _j(eps[1][rows]), inv_b,
        mask=_j(_col(sl(m))), local_renorm=False, cmask=_j(sl(cm)))
    tc = _port_cfg(cfg)
    carry = TF.pad_carry(tc, tstate)
    flat, q_pack = TF.forward_sums_plain(
        tc, tcfg.StepFlags(), carry, _t(q[0][rows]), _t(q[1][rows]), _t(y[rows]), _t(u[rows]),
        _t(eps[0][rows]), _t(eps[1][rows]), inv_b, mask=_t(sl(m)), cmask=_t(sl(cm)))
    got = TF.unpack_sums(flat, carry, has_cm=cm is not None)
    _tree_close({k: v.numpy() for k, v in _sums_by_leaf(got).items()},
                {k: np.asarray(v) for k, v in _sums_by_leaf(ref).items()})
    _close(q_pack[0], per.qt_m, "qt_m")
    assert torch.equal(TF.pack_sums(got), flat)


# ---------------------------------------------------------------------------
# the plain versions of the three kernels against the Pallas kernels
# (interpret mode: slow, so one case each)
# ---------------------------------------------------------------------------


def _f32_pair():
    cfg = _cfg("poisson", dtype="float32", fused_step="on")
    state, tstate = _pair(cfg, seed=2)
    return cfg, state, tstate, _port_cfg(cfg)


def test_fused_step_plain_matches_the_pallas_kernel():
    """One step with both masks, f32, tol TOL32_STEP."""
    cfg, state, tstate, tc = _f32_pair()
    y, u, eps, q = _data("poisson", seed=7, dtype=np.float32)
    m, cm = _masks("both", seed=8)
    y, u = _holes(y, u, m, cm)
    m, cm = m.astype(np.float32), cm.astype(np.float32)
    ref = JF.fused_step_call(cfg, StepFlags(), JF.pad_carry(cfg, state), _j(q[0]), _j(q[1]),
                             _j(y), _j(u), _j(eps[0]), _j(eps[1]), jnp.asarray(0.02, jnp.float32),
                             interpret=True, mask=_j(_col(m)), cmask=_j(cm))
    got = TF.fused_step_call(tc, tcfg.StepFlags(), TF.pad_carry(tc, tstate), _t(q[0]),
                             _t(q[1]), _t(y), _t(u), _t(eps[0]), _t(eps[1]),
                             torch.tensor(0.02), mask=_t(m), cmask=_t(cm))
    _tree_close(_stepout(got), convert.flatten(jax.tree.map(np.asarray, ref._asdict())),
                TOL32_STEP)


def test_mega_epoch_plain_matches_the_pallas_kernel():
    """Six mega steps with both masks, one of them without a valid trial;
    under the trial mask both take 2 base Newton-Schulz iterations."""
    cfg, state, tstate, tc = _f32_pair()
    cfg = cfg.replace(ns_prefix=0)
    tc = _port_cfg(cfg)
    t_len = 6
    y, u, eps, q = _data("poisson", lead=(t_len,), seed=9, dtype=np.float32)
    m, cm = _masks("both", lead=(t_len,), seed=10, empty_step=3)
    y, u = _holes(y, u, m, cm)
    m, cm = m.astype(np.float32), cm.astype(np.float32)
    assert TF.mega_ns_base_iters(tc, 64, masked=True) == 2
    assert TF.mega_ns_base_iters(tc, 64) == 1
    # a post-warm-up posterior, so that the steps update V
    carry = JF.pad_carry(cfg, state)
    jc, jq, js = JF.mega_epoch_call(cfg, StepFlags(), carry, _j(q[0]), _j(q[1]), _j(y), _j(u),
                                    _j(eps[0]), _j(eps[1]), jnp.asarray(0.02, jnp.float32),
                                    interpret=True, mask=_j(m[:, :, None]), cmask=_j(cm))
    tcarry, tq, ts = TF.mega_epoch_call(tc, tcfg.StepFlags(), TF.pad_carry(tc, tstate),
                                        _t(q[0]), _t(q[1]), _t(y), _t(u), _t(eps[0]),
                                        _t(eps[1]), torch.tensor(0.02), mask=_t(m),
                                        cmask=_t(cm))
    _tree_close(convert.flatten(tcarry._asdict()),
                convert.flatten(jax.tree.map(np.asarray, jc._asdict())), TOL32_STEP)
    _close(tq, jq, "q_pack", TOL32_STEP)
    _close(ts, js, "scal", TOL32_STEP)
    assert float(ts[3, 0]) == 0.0 and float(ts[3, 4]) == 0.0


def test_forward_sums_plain_matches_the_pallas_kernel():
    """Phase 1 with both masks and the global inv_b, f32."""
    cfg, state, tstate, tc = _f32_pair()
    y, u, eps, q = _data("poisson", seed=11, dtype=np.float32)
    m, cm = _masks("both", seed=12)
    y, u = _holes(y, u, m, cm)
    m, cm = m.astype(np.float32), cm.astype(np.float32)
    inv_b = float(np.float32(1.0) / np.float32(m.sum()))
    ref, rqm, _ = JF.forward_sums_call(cfg, StepFlags(), JF.pad_carry(cfg, state), _j(q[0]),
                                       _j(q[1]), _j(y), _j(u), _j(eps[0]), _j(eps[1]), inv_b,
                                       interpret=True, mask=_j(_col(m)), cmask=_j(cm))
    carry = TF.pad_carry(tc, tstate)
    flat, q_pack = TF.forward_sums_call(tc, tcfg.StepFlags(), carry, _t(q[0]), _t(q[1]), _t(y),
                                        _t(u), _t(eps[0]), _t(eps[1]), inv_b, mask=_t(m),
                                        cmask=_t(cm))
    got = TF.unpack_sums(flat, carry, has_cm=True)
    _tree_close({k: v.numpy() for k, v in _sums_by_leaf(got).items()},
                {k: np.asarray(v) for k, v in _sums_by_leaf(ref).items()}, TOL32_STEP)
    _close(q_pack[0], rqm, "qt_m", TOL32_STEP)


# ---------------------------------------------------------------------------
# filter_step and the autograd epoch against JAX's XLA step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("likelihood", ["poisson", "gaussian"])
@pytest.mark.parametrize("which", MASKS)
def test_filter_step_matches_jax(likelihood, which):
    cfg = _cfg(likelihood)
    state, tstate = _pair(cfg)
    y, u, eps, q = _data(likelihood, seed=13)
    m, cm = _masks(which, seed=14)
    y, u = _holes(y, u, m, cm)
    jst, jq, jm = jcore.filter_step(cfg, StepFlags(), state, JGaussian(q[0], q[1]), y, u,
                                    eps[0], eps[1], jnp.asarray(0.05), mask=_j(m),
                                    channel_mask=_j(cm))
    tst, tq, tm = tcore.filter_step(_port_cfg(cfg), tcfg.StepFlags(), tstate,
                                    Gaussian(_t(q[0]), _t(q[1])), _t(y), _t(u), _t(eps[0]),
                                    _t(eps[1]), 0.05, mask=_t(m), channel_mask=_t(cm))
    _tree_close(convert.flatten(convert.state_to_numpy(tst)),
                convert.flatten(jax.tree.map(np.asarray, jst)))
    _close(tq.mean, jq.mean, "qt.mean")
    _close(tq.logvar, jq.logvar, "qt.logvar")
    for name in ("loss", "recon", "dynamics", "entropy"):
        _close(getattr(tm, name), getattr(jm, name), name)


@pytest.mark.parametrize("likelihood", ["poisson", "gaussian"])
def test_autograd_epoch_matches_jax(likelihood):
    """``run_epoch``'s autograd route, both masks and one empty step, over 12
    RLS steps against JAX's ``fused_step='off'`` epoch."""
    t_len = 12
    cfg = _cfg(likelihood)
    state, tstate = _pair(cfg)
    y, u, eps, _ = _data(likelihood, lead=(t_len,), seed=15)
    m, cm = _masks("both", lead=(t_len,), seed=16, empty_step=5)
    y, u = _holes(y, u, m, cm)
    ref = jcore.run_epoch(cfg, StepFlags(), state, _j(y), _j(u), jax.random.PRNGKey(0),
                          jnp.asarray(0.02), noise=(_j(eps[0]), _j(eps[1])), mask=_j(m),
                          channel_mask=_j(cm))
    got = tcore.run_epoch(_port_cfg(cfg), tcfg.StepFlags(), tstate, _t(y), _t(u), 0, 0.02,
                          noise=(_t(eps[0]), _t(eps[1])), mask=_t(m), channel_mask=_t(cm))
    for name in ("loss", "recon", "dynamics", "entropy"):
        _close(getattr(got.metrics, name), getattr(ref.metrics, name), name, EPOCH_TOL)
    _close(got.q_means, ref.q_means, "q_means", EPOCH_TOL)
    _tree_close(convert.flatten(convert.state_to_numpy(got.state)),
                convert.flatten(jax.tree.map(np.asarray, ref.state)), EPOCH_TOL)
    assert float(got.metrics.loss[5]) == 0.0


# ---------------------------------------------------------------------------
# per-epoch fit with a mask, against JAX's fit (tests/test_torch_fit.py's setup)
# ---------------------------------------------------------------------------

FIT_T, FIT_B = 30, 3
# the JAX epoch weighs the state-noise running variance in float32 (its
# int32 counter; tests/test_torch_fit.py:FIT_TOL): the RLS epochs drift
# apart by about 1e-7 a step
FIT_TOL = dict(rtol=2e-3, atol=1e-5)


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


@pytest.mark.parametrize("which", ["mask", "channel_mask"])
def test_fit_matches_jax(which, monkeypatch):
    """Warm-up, the plateau, the bootstrap on the valid pairs, RLS epochs:
    every state leaf, the posteriors and the loss at FIT_TOL."""
    max_iter = 6
    cfg = _cfg("gaussian", udim=0, lr=0.05, rtol=0.1, warmup_max=3)
    rng = np.random.default_rng(17)
    phase = np.linspace(0, 4 * np.pi, FIT_T)
    x = np.stack([np.sin(phase), np.cos(phase)], axis=-1)
    y = x @ rng.normal(size=(XD, YD)) + 0.1 * rng.normal(size=(FIT_B, FIT_T, YD))
    y = np.ascontiguousarray(y.transpose(1, 0, 2))
    eps = rng.normal(size=(max_iter, 2, FIT_T, FIT_B, XD))
    unit = rng.uniform(size=(NF, XD))
    if which == "mask":
        msk = np.ones((FIT_T, FIT_B))
        msk[20:, 1] = 0.0          # trial 1 ends at 20, trial 2 at 25
        msk[25:, 2] = 0.0
        y[msk == 0] = np.nan
        kw = dict(mask=msk)
    else:
        msk = (rng.uniform(size=(FIT_T, FIT_B, YD)) > 0.2).astype(np.float64)
        y[msk == 0] = np.nan
        kw = dict(channel_mask=msk)
    _patch_reinit(monkeypatch, unit)
    state, tstate = _pair(cfg, seed=0)
    ref = jcore.fit(cfg, state, y, key=jax.random.PRNGKey(1), max_iter=max_iter,
                    noise_hook=lambda e: (jnp.asarray(eps[e, 0]), jnp.asarray(eps[e, 1])),
                    donate=False, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tcore.fit(_port_cfg(cfg), tstate, y, seed=1, max_iter=max_iter,
                    noise_hook=lambda e: (torch.tensor(eps[e, 0]), torch.tensor(eps[e, 1])),
                    **kw)
    assert not ref.warm_up and (got.warm_up, got.epochs_run) == (ref.warm_up, ref.epochs_run)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=1e-5)
    _close(got.mu, ref.mu, "mu", FIT_TOL)
    _tree_close(convert.flatten(convert.state_to_numpy(got.state)),
                convert.flatten(jax.tree.map(np.asarray, ref.state)), FIT_TOL)
    assert torch.isfinite(got.mu).all()


# ---------------------------------------------------------------------------
# the sharded epoch at world size 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group1():
    """A real world-size-1 gloo group, in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_dp_group()
    finally:
        dist.destroy_process_group()


def test_sharded_epoch_world1_matches_single_device(group1):
    """Both masks, one empty step, the NaN padding: the sharded epoch (phase
    1 with the global 1/count, the all-reduced ``cm_sum``, ``step_apply``
    with the valid count, the frozen carry) against the single-device
    stepwise epoch, f64 at EPOCH_TOL."""
    t_len = 16
    cfg = _cfg("gaussian", fused_step="on", ns_prefix=4)
    _, tstate = _pair(cfg, seed=3)
    tc = _port_cfg(cfg)
    y, u, eps, _ = _data("gaussian", lead=(t_len,), seed=18)
    m, cm = _masks("both", lead=(t_len,), seed=19, empty_step=2)
    y, u = _holes(y, u, m, cm)
    args = (_t(y), _t(u), 0, 0.02)
    kw = dict(noise=(_t(eps[0]), _t(eps[1])), mask=_t(m), channel_mask=_t(cm))
    got = run_epoch_fused_sharded(tc, tcfg.StepFlags(), tstate, *args, group1, **kw)
    ref = tcore.run_epoch(tc.replace(fused_epoch="stepwise"), tcfg.StepFlags(), tstate, *args,
                          **kw)
    assert bool((ref.metrics.tau >= TF.NS_TAU_THRESHOLD).any())
    for name in ("loss", "tau"):
        _close(getattr(got.metrics, name), getattr(ref.metrics, name), name, EPOCH_TOL)
    _close(got.q_means, ref.q_means, "q_means", EPOCH_TOL)
    _tree_close(convert.flatten(convert.state_to_numpy(got.state)),
                convert.flatten(convert.state_to_numpy(ref.state)), EPOCH_TOL)
    dead = m == 0
    assert np.array_equal(got.q_means.numpy()[1:][dead[1:]],
                          got.q_means.numpy()[:-1][dead[1:]])


# ---------------------------------------------------------------------------
# what the masks promise (tests/test_masking.py for the port)
# ---------------------------------------------------------------------------


def _epoch(cfg, state, y, u, eps, **kw):
    return tcore.run_epoch(cfg, tcfg.StepFlags(), state, _t(y), _t(u), 0, 0.02,
                           noise=(_t(eps[0]), _t(eps[1])), **kw)


ROUTES = {"fused": dict(fused_step="on", ns_prefix=3), "autograd": dict(fused_step="off")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_all_ones_masks_equal_the_unmasked_epoch(route):
    cfg = _port_cfg(_cfg("gaussian", **ROUTES[route]))
    state = tcore.init_state(0, cfg, device="cpu")
    y, u, eps, _ = _data("gaussian", lead=(8,), seed=20)
    ref = _epoch(cfg, state, y, u, eps)
    got = _epoch(cfg, state, y, u, eps, mask=torch.ones(8, B),
                 channel_mask=torch.ones(8, B, YD))
    _close(got.q_means, ref.q_means, "q_means", dict(rtol=1e-12, atol=1e-12))
    _close(got.metrics.loss, ref.metrics.loss, "loss", dict(rtol=1e-12, atol=1e-12))
    _tree_close(convert.flatten(convert.state_to_numpy(got.state)),
                convert.flatten(convert.state_to_numpy(ref.state)), dict(rtol=1e-12, atol=1e-12))


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_fully_masked_trial_equals_the_smaller_batch(route):
    cfg = _port_cfg(_cfg("poisson", **ROUTES[route]))
    state = tcore.init_state(0, cfg, device="cpu")
    y, u, eps, _ = _data("poisson", lead=(8,), seed=21)
    m = np.ones((8, B))
    m[:, 2] = 0.0
    yh, uh = _holes(y, u, m, None)
    got = _epoch(cfg, state, yh, uh, eps, mask=_t(m))
    keep = [i for i in range(B) if i != 2]
    ref = _epoch(cfg, state, y[:, keep], u[:, keep], eps[:, :, keep])
    _close(got.q_means[:, keep], ref.q_means, "q_means", TOL64)
    _close(got.metrics.loss, ref.metrics.loss, "loss", TOL64)
    _tree_close(convert.flatten(convert.state_to_numpy(got.state)),
                convert.flatten(convert.state_to_numpy(ref.state)), TOL64)


@pytest.mark.parametrize("route", list(ROUTES))
def test_masked_entries_do_not_matter(route):
    """NaN, 0 and 1e6 at every masked entry of y and u: the same bits."""
    cfg = _port_cfg(_cfg("gaussian", **ROUTES[route]))
    state = tcore.init_state(0, cfg, device="cpu")
    y, u, eps, _ = _data("gaussian", lead=(8,), seed=22)
    m, cm = _masks("both", lead=(8,), seed=23)
    runs = [_epoch(cfg, state, *_holes(y, u, m, cm, fill), eps, mask=_t(m), channel_mask=_t(cm))
            for fill in (np.nan, 0.0, 1e6)]
    for r in runs[1:]:
        assert torch.equal(r.q_means, runs[0].q_means)
        assert torch.equal(r.metrics.loss, runs[0].metrics.loss)
        a = convert.flatten(convert.state_to_numpy(r.state))
        b = convert.flatten(convert.state_to_numpy(runs[0].state))
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert torch.isfinite(runs[0].q_means).all()


def test_a_per_time_mask_promotes_along_time_at_t_equal_b():
    """(T,) is per time: at T == B it gains a trial axis, never transposed."""
    per_time = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    got = tcore._promote_mask(per_time, B, B, torch.float64, "cpu")
    assert torch.equal(got, per_time[:, None].expand(B, B).double())
    assert not torch.equal(got, got.T)
    cm = torch.ones(B, YD)
    cm[1, 3] = 0.0
    got_cm = tcore._promote_channel_mask(cm, (B, B, YD), torch.float64, "cpu")
    assert got_cm.shape == (B, B, YD) and bool((got_cm[1, :, 3] == 0).all())
    assert bool((got_cm[2, :, 3] == 1).all())


@pytest.mark.parametrize("case", ["short_step", "enough", "on", "rbf"])
def test_demote_masked_small_sgp(case):
    cfg = _port_cfg(_cfg("gaussian", dtype="float32", dynamics="sgp", n_inducing=10,
                         fused_step="on" if case == "on" else "auto"))
    if case == "rbf":
        cfg = cfg.replace(dynamics="rbf")
    m = torch.ones(5, 10)
    if case != "enough":
        m[3, 3:] = 0.0           # 3 valid trials at step 3, below sgp_fused_min_batch 8
    got = tcore._demote_masked_small_sgp(cfg, m)
    want = "off" if case == "short_step" else cfg.fused_step
    assert got.fused_step == want
    assert tcore._demote_masked_small_sgp(cfg, None) is cfg


@pytest.mark.parametrize("kw", ["mask", "channel_mask"])
def test_select_forecast_refuses_masks(kw):
    cfg = _port_cfg(_cfg("gaussian", select="forecast"))
    state = tcore.init_state(0, cfg, device="cpu")
    y = torch.zeros(20, B, YD, dtype=torch.float64)
    mask = {"mask": torch.ones(20, B), "channel_mask": torch.ones(20, B, YD)}[kw]
    with pytest.raises(ValueError, match="unmasked fits only"):
        tcore.fit(cfg, state, y, seed=0, max_iter=1, **{kw: mask})


def test_pad_and_split_trials_round_trip_as_in_jax():
    rng = np.random.default_rng(24)
    lengths = [7, 4, 9]
    ys = [rng.normal(size=(n, 3)) for n in lengths]
    us = [rng.normal(size=(n,)) for n in lengths]
    cms = [(rng.uniform(size=(n, 3)) > 0.3).astype(float) for n in lengths]
    got = pad_trials(ys, us, cms)
    ref = jragged.pad_trials(ys, us, cms)
    for a, b in zip(got[:4], ref[:4]):
        assert np.array_equal(a, b)
    assert got.lengths == lengths and got.y.shape == (9, 3, 3) and got.u.shape == (9, 3, 1)
    assert got.mask.sum(axis=0).tolist() == lengths
    for a, b in zip(split_trials(got.y, got.lengths), ys):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        split_trials(got.y, lengths[:2])


def test_the_launchers_take_masks_on_the_cpu():
    """A CPU tensor takes the plain version, masks and all; the flat sums
    carry ``cm_sum`` last."""
    cfg = _port_cfg(_cfg("poisson", dtype="float32", fused_step="on"))
    carry = TF.pad_carry(cfg, tcore.init_state(0, cfg, device="cpu"))
    y, u, eps, q = _data("poisson", seed=25, dtype=np.float32)
    m, cm = _masks("both", seed=26)
    y, u = _holes(y, u, m, cm)
    args = (_t(q[0]), _t(q[1]), _t(y), _t(u), _t(eps[0]), _t(eps[1]))
    out = TF.fused_step_call(cfg, tcfg.StepFlags(), carry, *args, torch.tensor(0.01),
                             mask=_t(m).float(), cmask=_t(cm).float())
    assert torch.isfinite(out.q_pack).all() and torch.isfinite(out.scal).all()
    flat, _ = TF.forward_sums_call(cfg, tcfg.StepFlags(), carry, *args, 0.25,
                                   mask=_t(m).float(), cmask=_t(cm).float())
    assert flat.shape == (TF.sums_size(carry, has_cm=True),)
    assert float(flat[-1]) == float((cm * m[:, None]).sum())
