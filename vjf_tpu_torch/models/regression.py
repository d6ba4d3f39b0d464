"""Bayesian linear regression state of the dynamics (counterpart of
``vjf_tpu/models/regression.py``): the Newton-Schulz-tracked form, its
per-step RLS update, the pooled one-shot update of the bootstrap, the
predictive distribution and the epoch-boundary repair. The precision and
covariance forms and ``kalman`` are not ported yet (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg import cholesky_f32, eigh_floor_inv_pair, safe_cholesky, tri_inv_newton
from ..types import Gaussian

NS_TAU_THRESHOLD = 0.25
NS_ITERS = 3
_BACKENDS_TODO = "only the nsv RLS backend is ported: ROADMAP Queue 1 item 3"


class NSVBLR(NamedTuple):
    """Posterior carried as ``(w_mean, P, V ~= P^{-1})``; V is maintained by
    warm-started Newton-Schulz refinement."""

    w_mean: torch.Tensor      # (n_feature, n_out)
    precision: torch.Tensor   # (n_feature, n_feature)
    cov: torch.Tensor         # V, maintained ~= P^{-1}


def init_nsv(n_feature: int, n_out: int, dtype=torch.float32, device=None) -> NSVBLR:
    return NSVBLR(
        w_mean=torch.zeros(n_feature, n_out, dtype=dtype, device=device),
        precision=torch.eye(n_feature, dtype=dtype, device=device),
        cov=torch.eye(n_feature, dtype=dtype, device=device),
    )


def _nsv(state) -> NSVBLR:
    if not isinstance(state, NSVBLR):
        raise NotImplementedError(_BACKENDS_TODO)
    return state


def weight_sqrt(state: NSVBLR) -> torch.Tensor:
    """A square root S of the weight covariance, ``S S^T = V``."""
    return safe_cholesky(_nsv(state).cov)


def predict_gaussian(state: NSVBLR, feat: torch.Tensor) -> Gaussian:
    """Predictive ``N(F w, diag(F V F^T))``, the log-variance shared across
    the output dimensions."""
    state = _nsv(state)
    mean = feat @ state.w_mean
    fvf = torch.sum((feat @ state.cov) * feat, dim=-1)
    return Gaussian(mean, torch.log(fvf)[..., None].expand(mean.shape))


def predict_sample(state: NSVBLR, feat: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """``F (w + S eps)`` with an injected (n_feature, n_out) standard normal."""
    return feat @ (state.w_mean + weight_sqrt(state) @ eps)


def _rls_stats(state: NSVBLR, feat, target, v, shrink: float, jitter: float):
    """``(g, P_new)`` of the update on ``target ~ F w + N(0, v)``."""
    s = torch.sqrt(v)
    sf, st = feat / s, target / s
    g = (state.precision @ state.w_mean) * shrink + sf.T @ st
    p_new = state.precision * shrink + sf.T @ sf
    if jitter:
        p_new = p_new + jitter * torch.eye(p_new.shape[0], dtype=p_new.dtype,
                                           device=p_new.device)
    return g, p_new


def rls(state: NSVBLR, feat: torch.Tensor, target: torch.Tensor, v: torch.Tensor,
        shrink: float = 1.0, jitter: float = 0.0) -> NSVBLR:
    """One recursive-least-squares update (feat (B, n_feature), target (B,
    n_out), v the scalar noise variance).

    V is refined by ``NS_ITERS`` Newton-Schulz iterations from ``V / shrink``
    where the trace bound ``tau = tr(dP V_old)`` is below
    ``NS_TAU_THRESHOLD``, else replaced by the exact inverse (Cholesky, Newton
    triangular inverse, one product). The JAX package picks one branch with
    ``lax.cond``; here both are computed and one is selected with
    ``torch.where``, with no host sync. Where the Cholesky fails (``info !=
    0``) the exact branch is NaN, as JAX's Cholesky makes it, so the step's
    finite gate drops the update.
    """
    state = _nsv(state)
    g, p_new = _rls_stats(state, feat, target, v, shrink, jitter)
    v_old = state.cov / shrink
    # the trace bound leaves out jitter * tr(V_old), as the JAX package and
    # the kernels do: the escalation bands were tuned on this definition
    tau = torch.sum((feat @ v_old) * feat) / v
    eye2 = 2.0 * torch.eye(p_new.shape[0], dtype=p_new.dtype, device=p_new.device)
    x = v_old
    for _ in range(NS_ITERS):
        x = x @ (eye2 - p_new @ x)
    v_ns = 0.5 * (x + x.T)
    chol, info = cholesky_f32(p_new)
    inv_l = tri_inv_newton(chol)
    v_exact = torch.where(info == 0, inv_l.T @ inv_l, torch.full_like(p_new, float("nan")))
    v_new = torch.where(tau < NS_TAU_THRESHOLD, v_ns, v_exact)
    return NSVBLR(v_new @ g, p_new, v_new)


def one_shot_rls(state: NSVBLR, feat: torch.Tensor, target: torch.Tensor, v: torch.Tensor,
                 shrink: float = 1.0, jitter: float = 0.0) -> NSVBLR:
    """Pooled RLS of the bootstrap: the same statistics as :func:`rls`, solved
    by one eigh with a relative eigenvalue floor
    (:func:`~vjf_tpu_torch.ops.linalg.eigh_floor_inv_pair`) in at least f32,
    so (P, V, w) stay bounded at any conditioning of the pooled Gram."""
    state = _nsv(state)
    g, p_new = _rls_stats(state, feat, target, v, shrink, jitter)
    dt = p_new.dtype
    sol_dt = torch.promote_types(dt, torch.float32)
    p_sol, v_sol = eigh_floor_inv_pair(p_new.to(sol_dt))
    return NSVBLR((v_sol @ g.to(sol_dt)).to(dt), p_sol.to(dt), v_sol.to(dt))


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
