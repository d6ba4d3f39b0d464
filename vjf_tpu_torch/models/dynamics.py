"""RBF dynamical system (counterpart of ``vjf_tpu/models/dynamics.py``).

The velocity field is a Bayesian linear regression over RBF features,
``x[t] = (1 - leak) x[t-1] + F(x[t-1], u[t]) w``, with a scalar state noise
learned by a running variance (cap ``state_var_cap``). The weight posterior
is updated in closed form (RLS), never by gradients. Where the JAX package
takes a PRNG key, the port takes a CPU ``torch.Generator``, and the rollout's
draws and the bootstrap's unit draw can be injected.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import VJFConfig
from ..ops.functional import batch_weighted_mean, gaussian_loss, nonecat, running_var, tree_where
from ..types import Gaussian
from . import regression
from .rbf import RBFParams, apply_rbf, init_rbf, reinit_rbf


class DynamicsState(NamedTuple):
    rbf: RBFParams
    blr: regression.BLRState
    logvar: torch.Tensor     # scalar state noise
    n_sample: torch.Tensor   # running-var counter (int32)


def resolve_backend(cfg: VJFConfig, batch_hint: Optional[int] = None) -> str:
    """'auto' backend choice, as in the JAX package: float64 -> precision,
    small per-step batch -> covariance, otherwise nsv."""
    if cfg.rls_backend == "auto" and cfg.dynamics_update == "kalman":
        return "covariance"
    if cfg.rls_backend != "auto":
        if cfg.rls_backend == "covariance" and cfg.chol_jitter:
            raise ValueError(
                "rls_backend='covariance' cannot apply chol_jitter (a "
                "full-rank precision ridge is not a rank-B Woodbury "
                "update); use 'nsv' or 'precision', or set chol_jitter=0"
            )
        return cfg.rls_backend
    if cfg.dtype == "float64":
        return "precision"
    if (
        batch_hint is not None
        and batch_hint * 2 < cfg.feature_dim
        and cfg.chol_jitter == 0.0
    ):
        return "covariance"
    return "nsv"


def init_blr(backend: str, n_feature: int, n_out: int, dtype, device=None):
    """The zero-mean, identity-precision weight posterior of ``backend``
    ('covariance', 'nsv', otherwise 'precision', as the JAX package reads
    it)."""
    if backend == "covariance":
        return regression.init_covariance(n_feature, n_out, dtype=dtype, device=device)
    if backend == "nsv":
        return regression.init_nsv(n_feature, n_out, dtype=dtype, device=device)
    return regression.init_precision(n_feature, n_out, dtype=dtype, device=device)


def init_dynamics(
    generator: torch.Generator, cfg: VJFConfig, backend: Optional[str] = None,
    device=None,
) -> DynamicsState:
    backend = backend or resolve_backend(cfg)
    dtype = cfg.tdtype
    rbf = init_rbf(generator, cfg.xudim, cfg.n_rbf, cfg.centroid_init_range,
                   dtype=dtype, device=device)
    return DynamicsState(
        rbf=rbf,
        blr=init_blr(backend, cfg.n_rbf, cfg.xdim, dtype=dtype, device=device),
        logvar=torch.zeros((), dtype=dtype, device=device),
        n_sample=torch.zeros((), dtype=torch.int32, device=device),
    )


def features(state: DynamicsState, x: torch.Tensor,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The basis at ``concat(x, u)``, shared by the prediction and the update."""
    return apply_rbf(state.rbf, nonecat(x, u))


def predict_from_features(state: DynamicsState, x: torch.Tensor, feat: torch.Tensor,
                          leak: float = 0.0) -> Gaussian:
    dx = regression.predict_gaussian(state.blr, feat)
    return Gaussian((1.0 - leak) * x + dx.mean, dx.logvar)


def transition_gaussian(state: DynamicsState, x: torch.Tensor,
                        u: Optional[torch.Tensor] = None, leak: float = 0.0) -> Gaussian:
    """Predictive ``N((1-leak) x + F w, diag(F V F^T))``."""
    return predict_from_features(state, torch.atleast_2d(x), features(state, x, u), leak)


def transition_sample(state: DynamicsState, x: torch.Tensor, eps_w: torch.Tensor,
                      u: Optional[torch.Tensor] = None, leak: float = 0.0,
                      weight_sqrt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampled step ``(1-leak) x + F (w + S eps_w)``; ``weight_sqrt``
    passes S in, so a rollout factors V once."""
    feat = features(state, x, u)
    s = weight_sqrt if weight_sqrt is not None else regression.weight_sqrt(state.blr)
    return (1.0 - leak) * x + feat @ (state.blr.w_mean + s @ eps_w)


def rollout_draws(generator: torch.Generator, n_step: int, nf: int, nout: int, x_shape,
                  dtype, device, noise: bool = False):
    """A rollout's normals in one draw each from a CPU ``generator``: the
    weight draws (n_step, nf, nout) and, with ``noise``, the state noise
    (n_step, *x_shape)."""
    eps_w = torch.randn((n_step, nf, nout), generator=generator, dtype=dtype)
    eps_n = torch.randn((n_step, *x_shape), generator=generator, dtype=dtype) if noise else None
    return eps_w.to(device), None if eps_n is None else eps_n.to(device)


def sampled_rollout(blr, logvar: torch.Tensor, step_sample: Callable, x0: torch.Tensor,
                    generator: Optional[torch.Generator], n_step: int,
                    u: Optional[torch.Tensor] = None, noise: bool = False,
                    draws: Optional[Tuple] = None) -> torch.Tensor:
    """Autoregressive rollout with a fresh weight sample each step and, with
    ``noise``, additive state noise: (n_step + 1, B, xdim) including ``x0``.
    ``step_sample(x, eps_w, u_t)`` is the family's sampled transition;
    ``u`` (n_step, B, udim) are the controls. The normals come from
    ``generator`` unless ``draws=(eps_w, eps_n)`` injects them."""
    x = torch.atleast_2d(x0)
    nf, nout = blr.w_mean.shape
    if draws is None:
        draws = rollout_draws(generator, n_step, nf, nout, x.shape, x.dtype, x.device, noise)
    eps_w, eps_n = draws
    sqrt_v = torch.exp(0.5 * logvar)
    xs = [x]
    for t in range(n_step):
        ut = u[t] if u is not None and u.shape[-1] > 0 else None
        x = step_sample(x, eps_w[t], ut)
        if noise:
            x = x + eps_n[t] * sqrt_v
        xs.append(x)
    return torch.stack(xs)


def forecast(state: DynamicsState, x0: torch.Tensor, generator: Optional[torch.Generator],
             n_step: int, u: Optional[torch.Tensor] = None, noise: bool = False,
             leak: float = 0.0, draws: Optional[Tuple] = None) -> torch.Tensor:
    """RBF-dynamics rollout (see :func:`sampled_rollout`); V is factored
    once for the whole rollout."""
    w_sqrt = regression.weight_sqrt(state.blr)

    def step(x, eps_w, ut):
        return transition_sample(state, x, eps_w, ut, leak, weight_sqrt=w_sqrt)

    return sampled_rollout(state.blr, state.logvar, step, x0, generator, n_step, u=u,
                           noise=noise, draws=draws)


def update_from_features(cfg: VJFConfig, state: DynamicsState, xt: torch.Tensor,
                         xs: torch.Tensor, feat: torch.Tensor, warm_up: bool = False,
                         weights: Optional[torch.Tensor] = None,
                         warm_gate: Optional[torch.Tensor] = None) -> DynamicsState:
    """Closed-form learning step with precomputed features (see
    :func:`blr_residual_update`)."""
    blr, logvar, n_sample = blr_residual_update(
        cfg, state.blr, state.logvar, state.n_sample, xt, xs, feat, warm_up=warm_up,
        weights=weights, update_rule=cfg.dynamics_update, warm_gate=warm_gate)
    return DynamicsState(state.rbf, blr, logvar, n_sample)


def blr_residual_update(cfg: VJFConfig, blr, logvar: torch.Tensor, n_sample: torch.Tensor,
                        xt: torch.Tensor, xs: torch.Tensor, feat: torch.Tensor,
                        warm_up: bool = False, weights: Optional[torch.Tensor] = None,
                        update_rule: str = "rls", warm_gate: Optional[torch.Tensor] = None):
    """The closed-form weight update on ``dx = xt - xs`` (skipped during
    warm-up): RLS, or with ``update_rule='kalman'`` the weight-diffusion
    Kalman step (``cfg.kalman_diffusion``, ``cfg.joseph_quirk``); then the
    state noise refreshed by a running variance of the post-update residual
    mse (skipped on the device where that variance is not finite). Returns
    ``(blr, logvar, n_sample)``. With the 0/1 trial mask ``weights`` (B,) a
    masked row's feature row is zeroed, so it leaves the weight update, and
    it leaves the residual mse and the sample count.

    ``warm_gate``: the phase of one member of an ensemble epoch whose members
    are in different phases, a scalar (1 = warm-up). Given, it overrides
    ``warm_up``: the weight update is computed and selected away where the
    gate is warm, so what follows sees the state either phase would."""
    if weights is not None:
        feat = feat * weights.to(feat.dtype)[:, None]
    dx = xt - xs
    if not warm_up or warm_gate is not None:
        new = closed_form_update(cfg, blr, feat, dx, torch.exp(logvar), update_rule)
        blr = new if warm_gate is None else tree_where(warm_gate > 0, blr, new)
    residual = dx - regression.predict_gaussian(blr, feat).mean
    if weights is None:
        mse, count = torch.mean(torch.square(residual)), xs.shape[0]
    else:
        mse = batch_weighted_mean(torch.mean(torch.square(residual), dim=-1), weights)
        count = torch.sum(weights.to(feat.dtype))
    return (blr, *state_noise_update(cfg, logvar, n_sample, mse, count))


def closed_form_update(cfg: VJFConfig, blr, feat: torch.Tensor, dx: torch.Tensor,
                       v: torch.Tensor, update_rule: str = "rls"):
    """The weight posterior after one step on ``dx ~ F w + N(0, v)``: RLS,
    or with ``update_rule='kalman'`` the weight-diffusion Kalman step."""
    if update_rule == "kalman":
        return regression.kalman(blr, feat, dx, v, diffusion=cfg.kalman_diffusion,
                                 quirk=cfg.joseph_quirk)
    return regression.rls(blr, feat, dx, v, shrink=cfg.rls_shrink, jitter=cfg.chol_jitter)


def state_noise_update(cfg: VJFConfig, logvar: torch.Tensor, n_sample: torch.Tensor, mse,
                       count):
    """``(logvar, n_sample)`` after the running variance of the residual
    ``mse`` over ``count`` rows; kept where that variance is not finite."""
    var, n_new = running_var(torch.exp(logvar), n_sample, mse, count,
                             size_cap=cfg.state_var_cap)
    new_logvar = torch.clamp(torch.log(var), -cfg.logvar_clamp, cfg.logvar_clamp)
    ok = torch.isfinite(var)
    return torch.where(ok, new_logvar, logvar), torch.where(ok, n_new.to(torch.int32), n_sample)


def dynamics_update(cfg: VJFConfig, state: DynamicsState, xt: torch.Tensor, xs: torch.Tensor,
                    u: Optional[torch.Tensor] = None, warm_up: bool = False,
                    weights: Optional[torch.Tensor] = None) -> DynamicsState:
    """Closed-form learning step from a pair of latent samples; ``weights``
    as in :func:`blr_residual_update`."""
    xs, xt = torch.atleast_2d(xs), torch.atleast_2d(xt)
    return update_from_features(cfg, state, xt, xs, features(state, xs, u), warm_up=warm_up,
                                weights=weights)


def dynamics_initialize(cfg: VJFConfig, generator: torch.Generator, state: DynamicsState,
                        xt: torch.Tensor, xs: torch.Tensor,
                        u: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None) -> DynamicsState:
    """Bootstrap at the end of warm-up from the pooled posterior means:
    centroids re-drawn over ``max ||xu||`` (:func:`reinit_rbf`), one pooled
    RLS on ``dx`` with the naive mse as noise (:func:`regression.one_shot_rls`),
    then the state noise set to the post-fit residual mse. ``weights``: the
    (N,) 0/1 validity of each pooled pair (ragged trials: a pair is valid
    where both ends are observed; a frozen carry's ``dx = 0`` would teach
    ``f = 0``), which weights the features and both mses."""
    xs, xt = torch.atleast_2d(xs), torch.atleast_2d(xt)
    xu = nonecat(xs, u)
    dx = xt - xs
    rbf = reinit_rbf(generator, state.rbf, xu)
    feat = apply_rbf(rbf, xu)
    if weights is not None:
        feat = feat * weights.to(feat.dtype)[:, None]
    blr = regression.one_shot_rls(state.blr, feat, dx, _pair_mse(dx, weights),
                                  shrink=cfg.rls_shrink, jitter=cfg.chol_jitter)
    residual = dx - regression.predict_gaussian(blr, feat).mean
    return DynamicsState(rbf, blr, torch.log(_pair_mse(residual, weights)), state.n_sample)


def _pair_mse(r: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean square of ``r`` (N, d), over the valid rows of ``weights``."""
    if weights is None:
        return torch.mean(torch.square(r))
    return batch_weighted_mean(torch.mean(torch.square(r), dim=-1), weights)


def dynamics_loss(state: DynamicsState, pt: Gaussian, qt: Gaussian,
                  trace_quirk: bool = True, weights: Optional[torch.Tensor] = None,
                  count=None) -> torch.Tensor:
    """``gaussian_loss(pt, qt, state_logvar)`` over the valid trials
    (``count``: this rank's part, as in ``gaussian_loss``)."""
    return gaussian_loss(pt, qt, state.logvar, trace_quirk=trace_quirk, weights=weights,
                         count=count)
