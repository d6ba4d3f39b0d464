"""Sparse-GP dynamics (counterpart of ``vjf_tpu/gp/sgp.py``), the
transition module of ``cfg.dynamics='sgp'``.

In the whitened inducing-point parametrisation a sparse variational GP over
inducing points Z is a Bayesian linear regression: ``f(x) = phi(x) v`` with
features ``phi(x) = k(x, Z) W`` and prior ``v ~ N(0, I)``, so the SGP reuses
the RLS machinery of :mod:`..models.regression` and the transition
interface of :mod:`..models.dynamics`. The predictive variance adds the DTC
correction ``k(x, x) - |phi(x)|^2`` to ``diag(phi V phi^T)``.

``W`` is the symmetric whitener ``U diag(max(lam, floor))^{-1/2} U^T`` from
one eigh of ``K_zz`` (:func:`whiten_matrices`), never ``L_zz^{-T}``: SE Gram
matrices are numerically low-rank, an explicit triangular inverse cancels
catastrophically in f32, and the floored whitener keeps ``|phi|^2 <=
k(x, x)`` with a bounded operator norm. Whitening is one product, shared
by this module and the fused kernels (``ops/fused_step.py:pad_carry``).

Where the JAX package takes a PRNG key, the port takes an int seed or a CPU
``torch.Generator``; the bootstrap's unit draw can be injected. The weight
posterior takes any of the three RLS backends. Every product here runs in
full f32 on the card (no TF32). :class:`SGP` is the standalone sparse-GP
regression of the reference's test surface.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..config import VJFConfig
from ..models import dynamics as dyn
from ..models import regression
from ..models.rbf import uniform
from ..ops.functional import (
    all_finite,
    batch_weighted_mean,
    gaussian_loss,
    nonecat,
    tree_where,
)
from ..ops.fused_step import full_f32_matmul
from ..ops.linalg import inv_tril_transpose, safe_cholesky, tril_solve
from ..types import Gaussian
from .covfun import CovarianceFunction, SquaredExponential, _sqdist


def _jitter(dtype: torch.dtype) -> float:
    """PSD jitter of K(Z, Z): f32 needs a larger floor (the SE kernel turns
    near-singular fast as the lengthscale grows)."""
    return 1e-6 if dtype == torch.float64 else 1e-5


class SGPDynamicsState(NamedTuple):
    inducing: torch.Tensor         # Z, (m, xudim)
    whiten: torch.Tensor           # W = U max(lam, floor)^{-1/2} U^T
    whiten_inv: torch.Tensor       # W^{-1}: f(Z) = whiten_inv @ v is basis-free
    log_scale: torch.Tensor        # kernel hyperparameters, carried in the state
    log_lengthscale: torch.Tensor
    blr: regression.BLRState
    logvar: torch.Tensor           # scalar state noise
    n_sample: torch.Tensor         # running-var counter (int32)


@full_f32_matmul()
def whiten_matrices(kzz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(W, W^{-1})`` by one eigh with a relative eigenvalue floor, 1e-4
    of the largest in f32 and 1e-8 in f64: well above the eigensolver's
    noise, so that floored directions do not mix with large ones and break
    ``|phi|^2 <= k(x, x)``; the discarded directions carry under 1e-4 of the
    kernel's variance and reappear in the DTC correction."""
    lam, u = torch.linalg.eigh(kzz)
    rel = 1e-8 if kzz.dtype == torch.float64 else 1e-4
    floor = rel * torch.clamp(lam[-1], min=1e-30)
    lam_f = torch.maximum(lam, floor)
    return (u * lam_f ** -0.5) @ u.T, (u * lam_f ** 0.5) @ u.T


def _covfun(cfg: VJFConfig) -> CovarianceFunction:
    return SquaredExponential(cfg.sgp_scale, cfg.sgp_lengthscale)


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def init_sgp_dynamics(seed: Union[int, torch.Generator], cfg: VJFConfig,
                      backend: Optional[str] = None, device=None) -> SGPDynamicsState:
    """Inducing points U[-r, r) with ``r = cfg.centroid_init_range`` from a
    seed or a CPU generator, the whitener of ``K_zz + jitter I``, and a zero
    weight posterior of ``backend`` (default ``dynamics.resolve_backend``)."""
    backend = backend or dyn.resolve_backend(cfg)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    dtype, m = cfg.tdtype, cfg.n_inducing
    r = cfg.centroid_init_range
    inducing = uniform(gen, (m, cfg.xudim), -r, r, dtype=dtype, device=device)
    kzz = _covfun(cfg)(inducing, inducing)
    w, w_inv = whiten_matrices(kzz + _jitter(dtype) * _eye(m, kzz))
    return SGPDynamicsState(
        inducing=inducing,
        whiten=w,
        whiten_inv=w_inv,
        log_scale=torch.log(torch.tensor(cfg.sgp_scale, dtype=dtype, device=device)),
        log_lengthscale=torch.log(torch.tensor(cfg.sgp_lengthscale, dtype=dtype,
                                               device=device)),
        blr=dyn.init_blr(backend, m, cfg.xdim, dtype=dtype, device=device),
        logvar=torch.zeros((), dtype=dtype, device=device),
        n_sample=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# The transition interface (the surface of models.dynamics)
# ---------------------------------------------------------------------------


def _se_kernel(x1: torch.Tensor, x2: torch.Tensor, log_scale: torch.Tensor,
               log_lengthscale: torch.Tensor) -> torch.Tensor:
    """The SE Gram matrix from explicit log-hyperparameters, shared by
    :func:`_kernel` and the adaptation objective."""
    d2 = _sqdist(x1, x2)
    return torch.exp(2.0 * log_scale - 0.5 * d2 * torch.exp(-2.0 * log_lengthscale))


def _kernel(state: SGPDynamicsState, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return _se_kernel(x1, x2, state.log_scale, state.log_lengthscale)


@full_f32_matmul()
def features(state: SGPDynamicsState, x: torch.Tensor,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whitened kernel features ``phi(x) = k(xu, Z) W``, one product in full
    f32 (the fused kernels compute the same)."""
    kxz = _kernel(state, nonecat(x, u), state.inducing)
    return kxz @ state.whiten


def predict_from_features(state: SGPDynamicsState, x: torch.Tensor, feat: torch.Tensor,
                          leak: float = 0.0) -> Gaussian:
    """``N((1-leak) x + phi w, diag(phi V phi^T) + max(scale^2 - |phi|^2, 0))``."""
    g = regression.predict_gaussian(state.blr, feat)
    dtc = torch.clamp(torch.exp(2.0 * state.log_scale) - torch.sum(feat * feat, dim=-1),
                      min=0.0)
    var = torch.exp(g.logvar) + dtc[..., None]
    return Gaussian((1.0 - leak) * x + g.mean, torch.log(var + 1e-30))


def transition_gaussian(state: SGPDynamicsState, x: torch.Tensor,
                        u: Optional[torch.Tensor] = None, leak: float = 0.0) -> Gaussian:
    x = torch.atleast_2d(x)
    return predict_from_features(state, x, features(state, x, u), leak)


def update_from_features(cfg: VJFConfig, state: SGPDynamicsState, xt: torch.Tensor,
                         xs: torch.Tensor, feat: torch.Tensor, warm_up: bool = False,
                         weights: Optional[torch.Tensor] = None,
                         warm_gate: Optional[torch.Tensor] = None) -> SGPDynamicsState:
    """RLS on kernel features and the state-noise running variance
    (``dynamics.blr_residual_update``, ``weights`` the 0/1 trial mask,
    ``warm_gate`` an ensemble member's phase); the SGP always learns by
    RLS."""
    blr, logvar, n_sample = dyn.blr_residual_update(
        cfg, state.blr, state.logvar, state.n_sample, xt, xs, feat, warm_up=warm_up,
        weights=weights, update_rule="rls", warm_gate=warm_gate)
    return state._replace(blr=blr, logvar=logvar, n_sample=n_sample)


def dynamics_update(cfg: VJFConfig, state: SGPDynamicsState, xt: torch.Tensor,
                    xs: torch.Tensor, u: Optional[torch.Tensor] = None,
                    warm_up: bool = False,
                    weights: Optional[torch.Tensor] = None) -> SGPDynamicsState:
    xs, xt = torch.atleast_2d(xs), torch.atleast_2d(xt)
    return update_from_features(cfg, state, xt, xs, features(state, xs, u), warm_up=warm_up,
                                weights=weights)


@full_f32_matmul()
def dynamics_initialize(cfg: VJFConfig, generator: Optional[torch.Generator],
                        state: SGPDynamicsState, xt: torch.Tensor, xs: torch.Tensor,
                        u: Optional[torch.Tensor] = None,
                        unit: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None) -> SGPDynamicsState:
    """Bootstrap at the end of warm-up: inducing points re-placed U[-r, r)
    over the visited region (``r = max ||xu||``), re-whitened, then one
    pooled RLS on ``dx`` with the naive mse as noise, and the state noise set
    to the post-fit residual mse. The unit draw U[0, 1) of the inducing
    points' shape comes from ``generator`` (a CPU one) unless ``unit``
    injects it. ``weights``: the (N,) 0/1 validity of each pooled pair, as
    in ``dynamics.dynamics_initialize``."""
    xs, xt = torch.atleast_2d(xs), torch.atleast_2d(xt)
    xu = nonecat(xs, u)
    dx = xt - xs
    mse0 = dyn._pair_mse(dx, weights)
    r = torch.max(torch.linalg.vector_norm(xu, dim=-1))
    z = state.inducing
    if unit is None:
        unit = torch.rand(z.shape, generator=generator, dtype=z.dtype)
    inducing = (-1.0 + 2.0 * unit.to(dtype=z.dtype, device=z.device)) * r
    state = state._replace(inducing=inducing)
    kzz = _kernel(state, inducing, inducing)
    w, w_inv = whiten_matrices(kzz + _jitter(kzz.dtype) * _eye(kzz.shape[0], kzz))
    state = state._replace(whiten=w, whiten_inv=w_inv)
    feat = features(state, xs, u)
    if weights is not None:
        feat = feat * weights.to(feat.dtype)[:, None]
    blr = regression.one_shot_rls(state.blr, feat, dx, mse0, shrink=cfg.rls_shrink,
                                  jitter=cfg.chol_jitter)
    residual = dx - regression.predict_gaussian(blr, feat).mean
    return state._replace(blr=blr, logvar=torch.log(dyn._pair_mse(residual, weights)))


def dynamics_loss(state: SGPDynamicsState, pt: Gaussian, qt: Gaussian,
                  trace_quirk: bool = True, weights: Optional[torch.Tensor] = None,
                  count=None) -> torch.Tensor:
    return gaussian_loss(pt, qt, state.logvar, trace_quirk=trace_quirk, weights=weights,
                         count=count)


@full_f32_matmul()
def forecast(state: SGPDynamicsState, x0: torch.Tensor, generator: Optional[torch.Generator],
             n_step: int, u: Optional[torch.Tensor] = None, noise: bool = False,
             leak: float = 0.0, draws=None) -> torch.Tensor:
    """Sampled rollout on kernel features, a fresh weight sample per step
    (``dynamics.sampled_rollout``); V is factored once."""
    w_sqrt = regression.weight_sqrt(state.blr)

    def step(x, eps_w, ut):
        w = state.blr.w_mean + w_sqrt @ eps_w
        return (1.0 - leak) * x + features(state, x, ut) @ w

    return dyn.sampled_rollout(state.blr, state.logvar, step, x0, generator, n_step, u=u,
                               noise=noise, draws=draws)


# ---------------------------------------------------------------------------
# Kernel hyperparameter adaptation (epoch-granular)
# ---------------------------------------------------------------------------


@full_f32_matmul()
def hyperparam_nll(state: SGPDynamicsState, theta, xu: torch.Tensor, dx: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-step predictive NLL of the velocity targets under ``theta =
    (log_scale, log_lengthscale)``, holding the posterior mean at the
    inducing points ``f(Z) = W^{-1} v`` fixed (detached, so the objective is
    differentiable in theta alone): ``f(x) = k(x, Z) K(Z, Z)^{-1} f(Z)``,
    with the DTC correction in the noise term. NaN where ``K(Z, Z) + jitter
    I`` does not factor, as JAX's Cholesky makes it."""
    log_scale, log_ls = theta
    z = state.inducing
    f_z = (state.whiten_inv @ state.blr.w_mean).detach()
    sv = torch.exp(state.logvar).detach()
    kzz = _se_kernel(z, z, log_scale, log_ls) + _jitter(z.dtype) * _eye(z.shape[0], z)
    lzz, info = torch.linalg.cholesky_ex(kzz)
    kxz = _se_kernel(xu, z, log_scale, log_ls)
    mean = kxz @ torch.cholesky_solve(f_z, lzz)
    phi = torch.linalg.solve_triangular(lzz, kxz.T, upper=False).T
    dtc = torch.clamp(torch.exp(2.0 * log_scale) - torch.sum(phi * phi, dim=-1), min=0.0)
    s = sv + dtc[:, None] + 1e-12
    resid = dx - mean
    nll = 0.5 * batch_weighted_mean(torch.mean(resid * resid / s + torch.log(s), dim=-1),
                                    weights)
    return torch.where(info == 0, nll, torch.full_like(nll, float("nan")))


@full_f32_matmul()
def adapt_hyperparams(cfg: VJFConfig, state: SGPDynamicsState, xt: torch.Tensor,
                      xs: torch.Tensor, u: Optional[torch.Tensor] = None,
                      lr: Optional[float] = None, n_steps: Optional[int] = None,
                      weights: Optional[torch.Tensor] = None) -> SGPDynamicsState:
    """SGD on ``(log_scale, log_lengthscale)`` over the pooled one-step
    predictive NLL (:func:`hyperparam_nll`), then re-whiten and reproject
    the weight posterior through ``A = W_new W_old^{-1}``: ``v' = A v`` (the
    mean at Z is kept exactly), ``V' = A V A^T``, ``P' = A^{-T} P A^{-1}``
    (symmetrised and refactored for the precision form).

    Each step is finite-gated (a step whose gradient is not finite, or whose
    kernel does not factor, is skipped), clipped at ``cfg.clip`` and kept in
    the box [-5, 5]; the whole new state replaces the old one only where
    every leaf is finite. Runs once per epoch in ``fit`` when
    ``cfg.sgp_adapt_lr > 0``. The gates select on the device; the loop runs
    ``n_steps`` times without waiting for it."""
    lr = cfg.sgp_adapt_lr if lr is None else lr
    n_steps = cfg.sgp_adapt_steps if n_steps is None else n_steps
    xs, xt = torch.atleast_2d(xs), torch.atleast_2d(xt)
    xu = nonecat(xs, u).detach()
    dx = (xt - xs).detach()

    theta = (state.log_scale.detach(), state.log_lengthscale.detach())
    for _ in range(max(0, n_steps)):
        th = tuple(t.clone().requires_grad_() for t in theta)
        with torch.enable_grad():
            g = torch.autograd.grad(hyperparam_nll(state, th, xu, dx, weights=weights), th)
        g_ok = torch.isfinite(g[0]) & torch.isfinite(g[1])
        theta = tuple(
            torch.clamp(torch.where(g_ok, t - lr * torch.clamp(gi, -cfg.clip, cfg.clip), t),
                        -5.0, 5.0)
            for t, gi in zip(theta, g))
    log_scale, log_ls = theta

    z = state.inducing
    kzz = _se_kernel(z, z, log_scale, log_ls) + _jitter(z.dtype) * _eye(z.shape[0], z)
    w_whiten, w_inv = whiten_matrices(kzz)
    a = w_whiten @ state.whiten_inv                    # A = W_new W_old^{-1}
    a_inv = state.whiten @ w_inv                       # A^{-1} = W_old W_new^{-1}
    new = state._replace(
        log_scale=log_scale, log_lengthscale=log_ls, whiten=w_whiten, whiten_inv=w_inv,
        blr=_reproject(state.blr, a, a_inv))
    return tree_where(all_finite(new), new, state)


def _reproject(blr: regression.BLRState, a: torch.Tensor,
               a_inv: torch.Tensor) -> regression.BLRState:
    """The weight posterior in the basis ``A`` maps to: ``w' = A w``, ``V' =
    A V A^T``, ``P' = A^{-T} P A^{-1}``."""
    w_new = a @ blr.w_mean
    if isinstance(blr, regression.NSVBLR):
        return regression.NSVBLR(w_new, a_inv.T @ blr.precision @ a_inv, a @ blr.cov @ a.T)
    if isinstance(blr, regression.CovarianceBLR):
        return regression.CovarianceBLR(w_new, a @ blr.cov @ a.T)
    p_new = a_inv.T @ blr.precision @ a_inv
    p_new = 0.5 * (p_new + p_new.T)
    chol = safe_cholesky(p_new)
    return regression.PrecisionBLR(w_new, p_new, chol, inv_tril_transpose(chol))


# ---------------------------------------------------------------------------
# The standalone regression class of the reference's test surface
# ---------------------------------------------------------------------------


class SGP:
    """Sparse-GP regression ``y = f(x) + eps`` over inducing points:
    ``SGP(xdim, ydim, udim, covfun, noise_var=..., f_cov="I",
    inducing=<(m, xdim)>)``, features ``k(x, Z) L_zz^{-T}`` with the
    precision-form posterior. Float64 by default; the jitter of ``K_zz``
    follows the dtype the inducing points actually have. The inducing
    points go to the card unless the caller asks for ``device="cpu"``."""

    def __init__(self, xdim: int, ydim: int, udim: int = 0,
                 covfun: Optional[CovarianceFunction] = None, *, noise_var: float = 0.0,
                 f_cov: str = "I", inducing=None, dtype=torch.float64,
                 device=torch.device("cuda")):
        if covfun is None:
            covfun = SquaredExponential()
        if f_cov != "I":
            raise NotImplementedError("only the whitened identity prior (f_cov='I') is "
                                      "supported")
        if inducing is None:
            raise ValueError("inducing points are required")
        self.xdim, self.ydim, self.udim = xdim, ydim, udim
        self.covfun = covfun
        # noise_var = 0 would make the Bayesian update degenerate
        self.noise_var = max(float(noise_var), 1e-6)
        self.inducing = torch.as_tensor(inducing, dtype=dtype, device=device)
        self.dtype = self.inducing.dtype
        self.kzz_chol = None
        self.blr = None
        self.initialize()

    def initialize(self) -> None:
        m = self.inducing.shape[0]
        kzz = self.covfun(self.inducing, self.inducing)
        self.kzz_chol = safe_cholesky(kzz + _jitter(self.dtype) * _eye(m, kzz))
        self.blr = regression.init_precision(m, self.ydim, dtype=self.dtype,
                                             device=self.inducing.device)

    def _as_rows(self, x) -> torch.Tensor:
        return torch.atleast_2d(torch.as_tensor(x, dtype=self.dtype,
                                                device=self.inducing.device))

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return tril_solve(self.kzz_chol, self.covfun(x, self.inducing).T).T

    def predict(self, x) -> Gaussian:
        """Predictive distribution of f(x): the parametric term plus the DTC
        correction ``k(x, x) - q(x, x)``."""
        x = self._as_rows(x)
        feat = self._features(x)
        g = regression.predict_gaussian(self.blr, feat)
        dtc = torch.clamp(self.covfun.diag(x) - torch.sum(feat * feat, dim=-1), min=0.0)
        return Gaussian(g.mean, torch.log(torch.exp(g.logvar) + dtc[..., None] + 1e-30))

    def fit(self, x, y) -> "SGP":
        """One batch Bayesian update; repeated calls accumulate evidence."""
        feat = self._features(self._as_rows(x))
        noise = torch.tensor(self.noise_var, dtype=self.dtype, device=self.inducing.device)
        self.blr = regression.rls(self.blr, feat, self._as_rows(y), noise)
        return self
