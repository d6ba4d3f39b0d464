"""The port's fused epoch (prefix + exact fallback + mega segment) against the
JAX package's ``run_epoch_fused(interpret=True)`` with injected noise, and
the port's multi-epoch runner."""
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

torch.set_num_threads(1)

T, B, PREFIX = 24, 8, 8
# float64: the same algorithm, so only rounding differs; float32: the
# tolerances of tests/test_fused_step.py for a fused epoch against another
# formulation (24 steps of feedback through P, V and w)
TOL = {"float64": dict(rtol=1e-8, atol=1e-8), "float32": dict(rtol=1e-3, atol=2e-4)}


def _cfg(dtype):
    return VJFConfig(ydim=20, xdim=3, udim=2, n_rbf=30, hidden_sizes=(16, 8),
                     likelihood="poisson", dtype=dtype, rls_backend="nsv",
                     fused_step="on", matmul_dtype="float32", ns_prefix=PREFIX)


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    npdt = np.dtype(dtype)
    ys = rng.poisson(1.0, (T, B, 20)).astype(npdt)
    us = rng.normal(size=(T, B, 2)).astype(npdt)
    eps = rng.normal(size=(2, T, B, 3)).astype(npdt)
    return ys, us, eps


@pytest.fixture(scope="module", params=["float64", "float32"])
def epoch_pair(request):
    """(JAX EpochResult, port EpochResult) of one RLS-active epoch."""
    dtype = request.param
    cfg = _cfg(dtype)
    key = jax.random.PRNGKey(0)
    state = jcore.init_state(key, cfg)
    ys, us, eps = _data(dtype)
    lr = 1e-3
    ref = JF.run_epoch_fused(cfg, StepFlags(), state, jnp.asarray(ys), jnp.asarray(us), key,
                             jnp.asarray(lr, dtype), noise=(jnp.asarray(eps[0]),
                                                            jnp.asarray(eps[1])),
                             interpret=True)
    tc = _port_cfg(cfg)
    tstate = convert.state_from_numpy(tc, jax.tree.map(np.asarray, state), device="cpu")
    t = torch.tensor
    got = tcore.run_epoch(tc, tcfg.StepFlags(), tstate, t(ys), t(us), 0, lr,
                          noise=(t(eps[0]), t(eps[1])))
    return dtype, ref, got


def test_epoch_matches_jax(epoch_pair):
    dtype, ref, got = epoch_pair
    tol = TOL[dtype]

    def close(a, b, name):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), err_msg=name, **tol)

    tau = np.asarray(ref.metrics.tau)
    assert tau[:PREFIX].max() >= JF.NS_TAU_THRESHOLD, "the exact fallback never ran"
    close(got.metrics.loss, ref.metrics.loss, "loss")
    close(got.metrics.recon, ref.metrics.recon, "recon")
    close(got.metrics.dynamics, ref.metrics.dynamics, "dynamics")
    close(got.metrics.entropy, ref.metrics.entropy, "entropy")
    close(got.q_means, ref.q_means, "q_means")
    close(got.q_logvars, ref.q_logvars, "q_logvars")
    a = convert.flatten(jax.tree.map(np.asarray, ref.state))
    b = convert.flatten(convert.state_to_numpy(got.state))
    assert a.keys() == b.keys()
    for k in ("dynamics.blr.w_mean", "dynamics.blr.precision", "dynamics.blr.cov",
              "dynamics.logvar", "params.recognition.layers.0.w", "params.decoder.w"):
        close(b[k], a[k], k)
    assert int(b["dynamics.n_sample"]) == int(a["dynamics.n_sample"]) == T * B


def test_tau_stream_matches_jax(epoch_pair):
    dtype, ref, got = epoch_pair
    a, b = np.asarray(ref.metrics.tau), got.metrics.tau.numpy()
    np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a))
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=1e-3 if dtype == "float32" else 1e-8)


def test_run_epochs_chains_run_epoch():
    """Two epochs in one call == two chained calls with the same seeds (the
    in-kernel Philox noise path, plain version on the CPU)."""
    tc = _port_cfg(_cfg("float32"))
    state = tcore.init_state(0, tc, device="cpu")
    ys, us, _ = _data("float32", seed=1)
    ys, us = torch.tensor(ys), torch.tensor(us)
    seeds, lrs = [3, 4], [1e-3, 9e-4]
    out = tcore.run_epochs(tc, tcfg.StepFlags(), state, ys, us, seeds, lrs)
    st = state
    for i, (seed, lr) in enumerate(zip(seeds, lrs)):
        r = tcore.run_epoch(tc, tcfg.StepFlags(), st, ys, us, seed, lr)
        st = r.state
        assert torch.equal(out.epoch_loss[i], torch.mean(r.metrics.loss))
        max_tau, hot = tcore.epoch_tau_stats(tc, r.metrics, T, torch.float32)
        assert torch.equal(out.max_tau[i], max_tau) and torch.equal(out.hot_frac[i], hot)
    assert torch.equal(out.q_means, r.q_means)
    a = convert.flatten(convert.state_to_numpy(out.state))
    b = convert.flatten(convert.state_to_numpy(st))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert torch.isfinite(out.epoch_loss).all()


def test_epoch_runs_without_tf32_and_restores_it():
    """The fused epoch turns TF32 off while it runs and gives the caller's
    setting back."""
    tc = _port_cfg(_cfg("float32"))
    ys, us, _ = _data("float32", seed=3)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TF.full_f32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        tcore.run_epoch(tc, tcfg.StepFlags(warm_up=True),
                        tcore.init_state(0, tc, device="cpu"),
                        torch.tensor(ys[:2]), torch.tensor(us[:2]), 0, 1e-3)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_run_epochs_takes_generators():
    """A generator per epoch is the same as the seed it draws."""
    tc = _port_cfg(_cfg("float32"))
    state = tcore.init_state(0, tc, device="cpu")
    ys, us, _ = _data("float32", seed=2)
    ys, us = torch.tensor(ys[:12]), torch.tensor(us[:12])
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    seeds = [tcore.epoch_seed(torch.Generator().manual_seed(s)) for s in (5, 6)]
    a = tcore.run_epochs(tc, tcfg.StepFlags(), state, ys, us, gens, [1e-3, 1e-3])
    b = tcore.run_epochs(tc, tcfg.StepFlags(), state, ys, us, seeds, [1e-3, 1e-3])
    assert torch.equal(a.epoch_loss, b.epoch_loss) and torch.equal(a.q_means, b.q_means)
    assert seeds[0] != seeds[1]


@pytest.mark.parametrize("tau", [
    [5.0, 1.0, 0.01, 0.02, 0.3, 0.01],
    [5.0, np.inf, 0.01, np.inf, 0.69, 0.7],
    [5.0, 1.0, 0.0, 0.0, 0.0, 0.0],
], ids=["finite", "inf-markers", "zeros"])
def test_epoch_tau_stats_match_jax(tau):
    tau = np.asarray(tau)
    cfg = VJFConfig(ydim=4, xdim=2, ns_prefix=2)
    z = np.zeros_like(tau)
    jm = jcore.Metrics(z, z, z, z, tau=jnp.asarray(tau))
    tm = tcore.Metrics(*(torch.tensor(v) for v in (z, z, z, z)), tau=torch.tensor(tau))
    jmax, jhot = jcore.epoch_tau_stats(cfg, jm, len(tau), jnp.float64)
    tmax, thot = tcore.epoch_tau_stats(_port_cfg(cfg), tm, len(tau), torch.float64)
    assert float(tmax) == float(jmax)
    assert float(thot) == float(jhot)


def test_epoch_tau_stats_counts_nan_as_hot():
    """Deliberate deviation from the JAX package (which misses NaN)."""
    tau = np.asarray([5.0, 1.0, 0.01, np.nan, 0.02, 0.9])
    cfg = VJFConfig(ydim=4, xdim=2, ns_prefix=2)
    z = np.zeros_like(tau)
    jm = jcore.Metrics(z, z, z, z, tau=jnp.asarray(tau))
    tm = tcore.Metrics(*(torch.tensor(v) for v in (z, z, z, z)), tau=torch.tensor(tau))
    jmax, jhot = jcore.epoch_tau_stats(cfg, jm, len(tau), jnp.float64)
    tmax, thot = tcore.epoch_tau_stats(_port_cfg(cfg), tm, len(tau), torch.float64)
    assert float(tmax) == float(jmax) == 0.9
    assert float(jhot) == 0.25 and float(thot) == 0.5
