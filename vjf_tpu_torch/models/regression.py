"""Bayesian linear regression state of the dynamics (counterpart of
``vjf_tpu/models/regression.py``): the posterior over the weights of a
linear map from features to velocity, updated in closed form once per step.

Three backends carry the same posterior:

* **precision** (:class:`PrecisionBLR`): ``(w, P, chol(P), inv(chol(P))^T)``;
  one ``n_feature x n_feature`` Cholesky per update (``'auto'`` at float64).
* **covariance** (:class:`CovarianceBLR`): ``(w, V = P^{-1})``, updated by
  the Woodbury/Joseph form; the only factorisation is ``B x B`` (``'auto'``
  at a small batch, and for the weight-diffusion Kalman learner).
* **nsv** (:class:`NSVBLR`): ``(w, P, V ~= P^{-1})`` with V tracked by
  Newton-Schulz, the form the fused kernels carry.

:func:`rls` and :func:`kalman` run their products in full f32 on the card
(no TF32): the ``g -> w -> g`` feedback chain must not lose bits. The
precision and covariance updates repair a failed Cholesky as the JAX
package does (``ops.linalg.safe_cholesky``), deciding on the host: one sync
a step, where JAX takes a ``lax.cond`` on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..ops.fused_step import full_f32_matmul
from ..ops.kalman import joseph_update as _joseph_update
from ..ops.kalman import predict as _kalman_predict
from ..ops.linalg import (
    cho_solve,
    cholesky_f32,
    eigh_floor_inv_pair,
    inv_tril_transpose,
    nan_where_failed,
    safe_cholesky,
    tri_inv_newton,
)
from ..types import Gaussian

NS_TAU_THRESHOLD = 0.25
NS_ITERS = 3


class PrecisionBLR(NamedTuple):
    """Posterior ``w ~ N(w_mean, P^{-1})`` in precision form, with the
    Cholesky factor of P and ``U = inv(L)^T`` (``U U^T = P^{-1}``), so the
    predictive variance is one product ``rowsum((F U)^2)``."""

    w_mean: torch.Tensor            # (n_feature, n_out)
    precision: torch.Tensor         # (n_feature, n_feature)
    prec_chol: torch.Tensor         # lower Cholesky of precision
    prec_chol_inv_t: torch.Tensor   # U = inv(prec_chol)^T


class CovarianceBLR(NamedTuple):
    """Posterior ``w ~ N(w_mean, V)`` in covariance form."""

    w_mean: torch.Tensor      # (n_feature, n_out)
    cov: torch.Tensor         # (n_feature, n_feature)


class NSVBLR(NamedTuple):
    """Posterior carried as ``(w_mean, P, V ~= P^{-1})``; V is maintained by
    warm-started Newton-Schulz refinement."""

    w_mean: torch.Tensor      # (n_feature, n_out)
    precision: torch.Tensor   # (n_feature, n_feature)
    cov: torch.Tensor         # V, maintained ~= P^{-1}


BLRState = Union[PrecisionBLR, CovarianceBLR, NSVBLR]


def _zeros_eyes(n_feature: int, n_out: int, n_eye: int, dtype, device):
    return (torch.zeros(n_feature, n_out, dtype=dtype, device=device),
            *(torch.eye(n_feature, dtype=dtype, device=device) for _ in range(n_eye)))


def init_precision(n_feature: int, n_out: int, dtype=torch.float32,
                   device=None) -> PrecisionBLR:
    """Zero mean, identity precision (and factors)."""
    return PrecisionBLR(*_zeros_eyes(n_feature, n_out, 3, dtype, device))


def init_covariance(n_feature: int, n_out: int, dtype=torch.float32,
                    device=None) -> CovarianceBLR:
    return CovarianceBLR(*_zeros_eyes(n_feature, n_out, 1, dtype, device))


def init_nsv(n_feature: int, n_out: int, dtype=torch.float32, device=None) -> NSVBLR:
    return NSVBLR(*_zeros_eyes(n_feature, n_out, 2, dtype, device))


def weight_sqrt(state: BLRState) -> torch.Tensor:
    """A square root S of the weight covariance, ``S S^T = V``: ``inv(L)^T``
    for the precision form, ``chol(V)`` otherwise."""
    if isinstance(state, PrecisionBLR):
        return state.prec_chol_inv_t
    return safe_cholesky(state.cov)


def predict_gaussian(state: BLRState, feat: torch.Tensor) -> Gaussian:
    """Predictive ``N(F w, diag(F V F^T))``, the log-variance shared across
    the output dimensions."""
    mean = feat @ state.w_mean
    if isinstance(state, PrecisionBLR):
        z = feat @ state.prec_chol_inv_t
        fvf = torch.sum(z * z, dim=-1)
    else:
        fvf = torch.sum((feat @ state.cov) * feat, dim=-1)
    return Gaussian(mean, torch.log(fvf)[..., None].expand(mean.shape))


def predict_sample(state: BLRState, feat: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """``F (w + S eps)`` with an injected (n_feature, n_out) standard normal."""
    return feat @ (state.w_mean + weight_sqrt(state) @ eps)


def rls_products(feat: torch.Tensor, target: torch.Tensor, v: torch.Tensor):
    """``(F^T F / v, F^T target / v)``: the batch's statistics of the update,
    sums over the trials (over several ranks each rank's part, which the
    ranks' sum completes)."""
    s = torch.sqrt(v)
    sf, st = feat / s, target / s
    return sf.T @ sf, sf.T @ st


def _rls_from_products(state, ff, fd, shrink: float, jitter: float):
    """``(g, P_new)`` of the update from :func:`rls_products` and a state
    that carries P."""
    g = (state.precision @ state.w_mean) * shrink + fd
    p_new = state.precision * shrink + ff
    if jitter:
        p_new = p_new + jitter * torch.eye(p_new.shape[0], dtype=p_new.dtype,
                                           device=p_new.device)
    return g, p_new


def _rls_stats(state, feat, target, v, shrink: float, jitter: float):
    """``(g, P_new)`` of the update on ``target ~ F w + N(0, v)`` from a state
    that carries P."""
    return _rls_from_products(state, *rls_products(feat, target, v), shrink, jitter)


def nsv_trace_sum(state: NSVBLR, feat: torch.Tensor, shrink: float) -> torch.Tensor:
    """``sum(F V_old * F)`` with ``V_old = V / shrink``: the nsv trace bound
    times ``v``, a sum over the trials like :func:`rls_products`."""
    return torch.sum((feat @ (state.cov / shrink)) * feat)


@full_f32_matmul()
def rls(state: BLRState, feat: torch.Tensor, target: torch.Tensor, v: torch.Tensor,
        shrink: float = 1.0, jitter: float = 0.0) -> BLRState:
    """One recursive-least-squares update (feat (B, n_feature), target (B,
    n_out), v the scalar noise variance), forgetting factor ``shrink``.

    - precision: ``P' = shrink P + F^T F / v (+ jitter I)``, factored by
      ``safe_cholesky``, ``w' = U U^T g``.
    - nsv: V is refined by ``NS_ITERS`` Newton-Schulz iterations from ``V /
      shrink`` where the trace bound ``tau = tr(dP V_old)`` is below
      ``NS_TAU_THRESHOLD``, else replaced by the exact inverse (Cholesky,
      Newton triangular inverse, one product). JAX picks one branch with
      ``lax.cond``; here both are computed and one is selected with
      ``torch.where``, with no host sync. Where the Cholesky fails the exact
      branch is NaN, as JAX's Cholesky makes it, so the step's finite gate
      drops the update.
    - covariance: the Woodbury gain from one ``B x B`` factorisation of
      ``v I + F V F^T`` and the Joseph-form covariance; it cannot apply
      ``jitter`` (a full-rank precision ridge is not a rank-B update) and
      raises ``ValueError`` for it.
    """
    if isinstance(state, (PrecisionBLR, NSVBLR)):
        ff, fd = rls_products(feat, target, v)
        tau_sum = nsv_trace_sum(state, feat, shrink) if isinstance(state, NSVBLR) else None
        return rls_from_sums(state, ff, fd, tau_sum, v, shrink, jitter)

    if jitter:
        raise ValueError("the covariance RLS backend does not support chol_jitter; "
                         "use the 'nsv' or 'precision' backend")
    v1 = state.cov / shrink
    b = feat.shape[0]
    s_mat = v * torch.eye(b, dtype=feat.dtype, device=feat.device) + feat @ v1 @ feat.T
    k = cho_solve(safe_cholesky(s_mat), feat @ v1).T        # gain, (n_feature, B)
    w_new = state.w_mean + k @ (target - feat @ state.w_mean)
    i_kf = torch.eye(v1.shape[0], dtype=v1.dtype, device=v1.device) - k @ feat
    return CovarianceBLR(w_new, i_kf @ v1 @ i_kf.T + v * (k @ k.T))


@full_f32_matmul()
def rls_from_sums(state: Union[PrecisionBLR, NSVBLR], ff: torch.Tensor, fd: torch.Tensor,
                  tau_sum, v: torch.Tensor, shrink: float = 1.0,
                  jitter: float = 0.0) -> BLRState:
    """:func:`rls` of the precision and nsv forms from the batch's sums
    (:func:`rls_products`; for nsv :func:`nsv_trace_sum`, else None), so
    that over several ranks every rank applies the same update from the
    summed statistics."""
    g, p_new = _rls_from_products(state, ff, fd, shrink, jitter)
    if isinstance(state, PrecisionBLR):
        chol = safe_cholesky(p_new)
        u = inv_tril_transpose(chol)
        return PrecisionBLR(u @ (u.T @ g), p_new, chol, u)
    v_old = state.cov / shrink
    # the trace bound leaves out jitter * tr(V_old), as the JAX package and
    # the kernels do: the escalation bands were tuned on this definition
    tau = tau_sum / v
    eye2 = 2.0 * torch.eye(p_new.shape[0], dtype=p_new.dtype, device=p_new.device)
    x = v_old
    for _ in range(NS_ITERS):
        x = x @ (eye2 - p_new @ x)
    v_ns = 0.5 * (x + x.T)
    chol, info = cholesky_f32(p_new)
    inv_l = tri_inv_newton(chol)
    v_new = torch.where(tau < NS_TAU_THRESHOLD, v_ns, nan_where_failed(inv_l.T @ inv_l, info))
    return NSVBLR(v_new @ g, p_new, v_new)


@full_f32_matmul()
def one_shot_rls(state: BLRState, feat: torch.Tensor, target: torch.Tensor,
                 v: torch.Tensor, shrink: float = 1.0, jitter: float = 0.0) -> BLRState:
    """Pooled RLS of the bootstrap. For nsv, and for the precision form below
    float64, the same statistics as :func:`rls` are solved by one eigh with a
    relative eigenvalue floor (:func:`~vjf_tpu_torch.ops.linalg.eigh_floor_inv_pair`)
    in at least f32, so (P, V, w) stay bounded at any conditioning of the
    pooled Gram; the precision form rebuilds its factor pair from the
    floored P. The covariance form and the float64 precision form take the
    incremental :func:`rls` (the covariance one factors an N x N matrix for
    N pooled rows, as in the JAX package)."""
    lowprec = state.w_mean.dtype != torch.float64
    if not (isinstance(state, NSVBLR) or (isinstance(state, PrecisionBLR) and lowprec)):
        return rls(state, feat, target, v, shrink=shrink, jitter=jitter)
    g, p_new = _rls_stats(state, feat, target, v, shrink, jitter)
    dt = p_new.dtype
    sol_dt = torch.promote_types(dt, torch.float32)
    p_sol, v_sol = eigh_floor_inv_pair(p_new.to(sol_dt))
    w_new = (v_sol @ g.to(sol_dt)).to(dt)
    if isinstance(state, PrecisionBLR):
        chol = safe_cholesky(p_sol)
        return PrecisionBLR(w_new, p_sol.to(dt), chol.to(dt), inv_tril_transpose(chol).to(dt))
    return NSVBLR(w_new, p_sol.to(dt), v_sol.to(dt))


def spectral_repair(
    state: NSVBLR, rel_floor: float = 1e-4, only_if_indefinite: bool = True
) -> NSVBLR:
    """Epoch-boundary re-factorization of the tracked pair: a relative-floored
    eigh makes P PD and V its exact inverse; ``w`` is kept.

    With ``only_if_indefinite`` the repaired pair replaces the old one only
    where a Cholesky of P fails. The JAX package reads that failure as NaN in
    the factor; ``cholesky_ex`` instead returns a finite partial factor and a
    non-zero ``info``, so the probe asks for ``info == 0`` as well. The
    select happens on the device, without a host sync.
    """
    dt = state.precision.dtype
    sol_dt = torch.promote_types(dt, torch.float32)
    p_sym = state.precision.to(sol_dt)
    p_new, v_new = eigh_floor_inv_pair(p_sym, rel_floor=rel_floor)
    if only_if_indefinite:
        chol, info = torch.linalg.cholesky_ex(p_sym)
        ok = (info == 0) & torch.isfinite(chol).all()
        p_new = torch.where(ok, p_sym, p_new)
        v_new = torch.where(ok, state.cov.to(sol_dt), v_new)
    return NSVBLR(state.w_mean, p_new.to(dt), v_new.to(dt))


def _inv(a: torch.Tensor) -> torch.Tensor:
    return nan_where_failed(*torch.linalg.inv_ex(a))


@full_f32_matmul()
def kalman(state: BLRState, feat: torch.Tensor, target: torch.Tensor, v: torch.Tensor,
           diffusion: float = 0.0, quirk: bool = False) -> BLRState:
    """Weight-diffusion Kalman update ``w[t] = w[t-1] + N(0, diffusion I)``,
    ``target = F w[t] + N(0, v)``, in weight space (output dims as the
    batch, H the features).

    The precision and nsv forms convert to covariance form, update, and
    convert back (an ``n_feature`` inverse a step). The covariance form's
    hot path is the direct Joseph update with one ``B x B`` factorisation of
    the innovation, PD by construction, so plain ``cholesky_f32``; where it
    fails the factor is NaN, as JAX's. ``quirk=True`` (``cfg.joseph_quirk``)
    takes the Cholesky-form toolkit with the reference's double-``S^{-1}``
    gain (:func:`~vjf_tpu_torch.ops.kalman.joseph_update`)."""
    if isinstance(state, PrecisionBLR):
        u0 = state.prec_chol_inv_t
        new = kalman(CovarianceBLR(state.w_mean, u0 @ u0.T), feat, target, v, diffusion,
                     quirk)
        prec = _inv(new.cov)
        chol = safe_cholesky(prec)
        return PrecisionBLR(new.w_mean, prec, chol, inv_tril_transpose(chol))

    if isinstance(state, NSVBLR):
        new = kalman(CovarianceBLR(state.w_mean, state.cov), feat, target, v, diffusion,
                     quirk)
        return NSVBLR(new.w_mean, _inv(new.cov), new.cov)

    nf, b = state.cov.shape[0], feat.shape[0]
    eye = torch.eye(nf, dtype=feat.dtype, device=feat.device)
    eye_b = torch.eye(b, dtype=feat.dtype, device=feat.device)
    if quirk:
        yhat, what, chol_vhat = _kalman_predict(state.w_mean, safe_cholesky(state.cov), eye,
                                                diffusion * eye, feat)
        w_new, chol_new = _joseph_update(target, yhat, what, chol_vhat, feat, v * eye_b,
                                         quirk=True)
        return CovarianceBLR(w_new, chol_new @ chol_new.T)

    vhat = state.cov + diffusion * eye
    hv = feat @ vhat                                     # F Vhat, (B, nf)
    s = hv @ feat.T + v * eye_b
    ls = nan_where_failed(*cholesky_f32(0.5 * (s + s.T)))
    k = cho_solve(ls, hv).T                              # Vhat F^T S^{-1}
    w_new = state.w_mean + k @ (target - feat @ state.w_mean)
    i_kf = eye - k @ feat
    cov_new = i_kf @ vhat @ i_kf.T + v * (k @ k.T)
    return CovarianceBLR(w_new, 0.5 * (cov_new + cov_new.T))


class NonBayesLR(NamedTuple):
    """The reference's ``LinearRegression(..., bayes=False)``: ``w_mean`` is a
    gradient-trained parameter and the prediction is the point ``F w``; no
    closed-form update applies."""

    w_mean: torch.Tensor      # (n_feature, n_out)


def init_nonbayes(n_feature: int, n_out: int, dtype=torch.float32,
                  device=None) -> NonBayesLR:
    return NonBayesLR(torch.zeros(n_feature, n_out, dtype=dtype, device=device))


def predict_point(state: NonBayesLR, feat: torch.Tensor) -> torch.Tensor:
    return feat @ state.w_mean


def batch_lstsq_posterior(feat: torch.Tensor, target: torch.Tensor, v: torch.Tensor,
                          dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form batch posterior ``(w, P)`` from an identity prior: what one
    RLS pass from the initial state must reproduce."""
    dtype = dtype or feat.dtype
    p = torch.eye(feat.shape[1], dtype=dtype, device=feat.device) + feat.T @ feat / v
    return torch.linalg.solve(p, feat.T @ target / v), p
