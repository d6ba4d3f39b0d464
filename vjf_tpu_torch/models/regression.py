"""Bayesian linear regression state of the dynamics (counterpart of
``vjf_tpu/models/regression.py``): the Newton-Schulz-tracked form and its
epoch-boundary repair. The precision and covariance forms are not ported
yet (ROADMAP Queue 1 item 3)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg import eigh_floor_inv_pair


class NSVBLR(NamedTuple):
    """Posterior carried as ``(w_mean, P, V ~= P^{-1})``; V is maintained by
    warm-started Newton-Schulz refinement inside the fused step."""

    w_mean: torch.Tensor      # (n_feature, n_out)
    precision: torch.Tensor   # (n_feature, n_feature)
    cov: torch.Tensor         # V, maintained ~= P^{-1}


def init_nsv(n_feature: int, n_out: int, dtype=torch.float32, device=None) -> NSVBLR:
    return NSVBLR(
        w_mean=torch.zeros(n_feature, n_out, dtype=dtype, device=device),
        precision=torch.eye(n_feature, dtype=dtype, device=device),
        cov=torch.eye(n_feature, dtype=dtype, device=device),
    )


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
