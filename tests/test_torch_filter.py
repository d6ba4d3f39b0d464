"""The port's autograd step and epoch (``models.vjf.filter_step``,
``run_epoch``'s autograd route) against the JAX package's ``filter_step``
and ``run_epoch(fused_step='off')`` at float64, same parameters, injected
noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjf_tpu.config import StepFlags, VJFConfig
from vjf_tpu.models import vjf as jcore
from vjf_tpu.types import Gaussian as JGaussian
from vjf_tpu_torch import config as tcfg
from vjf_tpu_torch import convert
from vjf_tpu_torch.models import vjf as tcore
from vjf_tpu_torch.types import Gaussian

torch.set_num_threads(1)

B, YD, XD, UD = 3, 6, 2, 1
# float64 on both sides, the same algorithm: only the order of sums differs
# (autograd against jax.grad, torch against XLA products)
TOL = dict(rtol=1e-9, atol=1e-11)
# over an epoch the exact inverse of each step (Cholesky, Newton triangular
# inverse) amplifies that rounding by about cond(P)^2: measured up to 2e-8
# relative in the loss and 5e-9 absolute in the posteriors over 20 steps
EPOCH_TOL = dict(rtol=1e-6, atol=1e-7)

FLAGS = {
    "default": StepFlags(),
    "warm_up": StepFlags(warm_up=True, train_decoder=True),
    "decoder_frozen": StepFlags(train_decoder=False),
    "no_sgd": StepFlags(sgd=False),
    "no_update": StepFlags(update=False),
    "no_lik_update": StepFlags(update_likelihood=False),
    "no_transition_update": StepFlags(update_transition=False),
}


def _cfg(likelihood, **kw):
    return VJFConfig(ydim=YD, xdim=XD, udim=UD, n_rbf=8, hidden_sizes=(5,),
                     likelihood=likelihood, dtype="float64", rls_backend="nsv",
                     fused_step="off", **kw)


def _port_cfg(cfg):
    return tcfg.VJFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _port_flags(flags):
    return tcfg.StepFlags(**dataclasses.asdict(flags))


def _pair(likelihood, **kw):
    cfg = _cfg(likelihood, **kw)
    state = jcore.init_state(jax.random.PRNGKey(1), cfg, backend="nsv")
    tstate = convert.state_from_numpy(_port_cfg(cfg), jax.tree.map(np.asarray, state),
                                      device="cpu")
    return cfg, state, tstate


def _inputs(likelihood, seed=0, t=None):
    rng = np.random.default_rng(seed)
    lead = () if t is None else (t,)
    y = (rng.poisson(2.0, lead + (B, YD)) if likelihood == "poisson"
         else rng.normal(size=lead + (B, YD))).astype(np.float64)
    u = rng.normal(size=lead + (B, UD))
    eps = rng.normal(size=(2,) + lead + (B, XD))
    q = 0.5 * rng.normal(size=(2, B, XD))
    return y, u, eps, q


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=name, **tol)


def _state_close(tstate, jstate, tol=TOL):
    a = convert.flatten(jax.tree.map(np.asarray, jstate))
    b = convert.flatten(convert.state_to_numpy(tstate))
    assert a.keys() == b.keys()
    for k in a:
        _close(b[k], a[k], k, tol)


def _leaves(tstate):
    return {k: v.copy() for k, v in convert.flatten(convert.state_to_numpy(tstate)).items()}


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
@pytest.mark.parametrize("flag_name", list(FLAGS))
def test_filter_step_matches_jax(likelihood, flag_name):
    flags = FLAGS[flag_name]
    cfg, state, tstate = _pair(likelihood)
    y, u, eps, q = _inputs(likelihood, seed=3)
    lr = 0.05
    jst, jq, jm = jcore.filter_step(cfg, flags, state, JGaussian(q[0], q[1]), y, u,
                                    eps[0], eps[1], jnp.asarray(lr))
    t = torch.tensor
    before = _leaves(tstate)
    tst, tq, tm = tcore.filter_step(_port_cfg(cfg), _port_flags(flags), tstate,
                                    Gaussian(t(q[0]), t(q[1])), t(y), t(u), t(eps[0]),
                                    t(eps[1]), lr)
    _state_close(tst, jst)
    _close(tq.mean, jq.mean, "qt.mean")
    _close(tq.logvar, jq.logvar, "qt.logvar")
    for name in ("loss", "recon", "dynamics", "entropy"):
        _close(getattr(tm, name), getattr(jm, name), name)
    after = _leaves(tstate)
    assert all(np.array_equal(before[k], after[k]) for k in before), "input state written"
    if flags.sgd:
        moved = convert.flatten(convert.state_to_numpy(tst))
        assert not np.array_equal(moved["params.recognition.layers.0.w"],
                                  before["params.recognition.layers.0.w"])
        assert np.array_equal(moved["params.decoder.w"], before["params.decoder.w"]) \
            == (not flags.train_decoder)


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
def test_non_finite_gradient_skips_the_sgd_step(likelihood):
    """A NaN in one trial's sampling noise makes every raw gradient NaN (0 x
    NaN through the zeroed loss term): the SGD step, the noise updates and
    RLS are all skipped, as in the JAX package."""
    cfg, state, tstate = _pair(likelihood)
    y, u, eps, q = _inputs(likelihood, seed=4)
    eps[1, 0, 0] = np.nan
    flags = StepFlags()
    jst, _, jm = jcore.filter_step(cfg, flags, state, JGaussian(q[0], q[1]), y, u, eps[0],
                                   eps[1], jnp.asarray(0.05))
    t = torch.tensor
    tst, _, tm = tcore.filter_step(_port_cfg(cfg), _port_flags(flags), tstate,
                                   Gaussian(t(q[0]), t(q[1])), t(y), t(u), t(eps[0]),
                                   t(eps[1]), 0.05)
    before = _leaves(tstate)
    after = _leaves(tst)
    for k in before:
        assert np.array_equal(before[k], after[k], equal_nan=True), k
    _state_close(tst, jst)
    _close(tm.loss, jm.loss, "loss")


@pytest.mark.parametrize("likelihood", ["gaussian", "poisson"])
def test_autograd_epoch_matches_jax(likelihood):
    """``run_epoch``'s autograd route over 20 RLS-active steps against the
    JAX package's XLA epoch with the same injected noise."""
    T = 20
    cfg, state, tstate = _pair(likelihood, ns_prefix=4)
    y, u, eps, _ = _inputs(likelihood, seed=5, t=T)
    lr = 0.02
    ref = jcore.run_epoch(cfg, StepFlags(), state, jnp.asarray(y), jnp.asarray(u),
                          jax.random.PRNGKey(0), jnp.asarray(lr),
                          noise=(jnp.asarray(eps[0]), jnp.asarray(eps[1])))
    t = torch.tensor
    got = tcore.run_epoch(_port_cfg(cfg), tcfg.StepFlags(), tstate, t(y), t(u), 0, lr,
                          noise=(t(eps[0]), t(eps[1])))
    assert got.metrics.tau is None
    for name in ("loss", "recon", "dynamics", "entropy"):
        _close(getattr(got.metrics, name), getattr(ref.metrics, name), name, EPOCH_TOL)
    _close(got.q_means, ref.q_means, "q_means", EPOCH_TOL)
    _close(got.q_logvars, ref.q_logvars, "q_logvars", EPOCH_TOL)
    _state_close(got.state, ref.state, EPOCH_TOL)


@pytest.mark.parametrize("route", ["autograd", "fused_plain"])
def test_epoch_leaves_the_input_state_as_it_was(route):
    """Both routes build new tensors: the state an epoch starts from (the
    fit loop's demotion backup and selection snapshot) is bit-identical
    afterwards."""
    cfg = _port_cfg(_cfg("poisson", ns_prefix=3).replace(
        fused_step="off" if route == "autograd" else "on"))
    state = tcore.init_state(0, cfg, device="cpu")
    y, u, _, _ = _inputs("poisson", seed=6, t=8)
    before = _leaves(state)
    res = tcore.run_epoch(cfg, tcfg.StepFlags(), state, torch.tensor(y), torch.tensor(u),
                          7, 1e-2)
    assert torch.isfinite(res.metrics.loss).all()
    after = _leaves(state)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert (res.metrics.tau is None) == (route == "autograd")


def test_autograd_epoch_draws_its_noise_from_the_seed():
    """Without injected noise the autograd route draws (T, 2, B, xdim)
    normals from a CPU generator seeded with the epoch seed: the same seed
    gives the same epoch, a generator gives the epoch of the seed it draws."""
    cfg = _port_cfg(_cfg("gaussian"))
    state = tcore.init_state(0, cfg, device="cpu")
    y, u, _, _ = _inputs("gaussian", seed=7, t=6)
    y, u = torch.tensor(y), torch.tensor(u)
    a = tcore.run_epoch(cfg, tcfg.StepFlags(), state, y, u, 11, 1e-2)
    g = torch.Generator().manual_seed(11)
    eps = torch.randn((6, 2, B, XD), generator=g, dtype=torch.float64)
    b = tcore.run_epoch(cfg, tcfg.StepFlags(), state, y, u, 0, 1e-2,
                        noise=(eps[:, 0], eps[:, 1]))
    assert torch.equal(a.q_means, b.q_means) and torch.equal(a.metrics.loss, b.metrics.loss)
    seed = tcore.epoch_seed(torch.Generator().manual_seed(3))
    c = tcore.run_epoch(cfg, tcfg.StepFlags(), state, y, u, torch.Generator().manual_seed(3),
                        1e-2)
    d = tcore.run_epoch(cfg, tcfg.StepFlags(), state, y, u, seed, 1e-2)
    assert torch.equal(c.q_means, d.q_means)
