"""RBF dynamical system state (counterpart of ``vjf_tpu/models/dynamics.py``).

The velocity field is a Bayesian linear regression over RBF features; its
weight posterior is updated by closed-form RLS inside the fused step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import VJFConfig
from . import regression
from .rbf import RBFParams, init_rbf


class DynamicsState(NamedTuple):
    rbf: RBFParams
    blr: regression.NSVBLR
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


def init_dynamics(
    generator: torch.Generator, cfg: VJFConfig, backend: Optional[str] = None,
    device=None,
) -> DynamicsState:
    backend = backend or resolve_backend(cfg)
    if backend != "nsv":
        raise NotImplementedError(
            f"rls_backend={backend!r}: ROADMAP Queue 1 item 3 (only 'nsv' is ported)"
        )
    dtype = cfg.tdtype
    rbf = init_rbf(generator, cfg.xudim, cfg.n_rbf, cfg.centroid_init_range,
                   dtype=dtype, device=device)
    return DynamicsState(
        rbf=rbf,
        blr=regression.init_nsv(cfg.n_rbf, cfg.xdim, dtype=dtype, device=device),
        logvar=torch.zeros((), dtype=dtype, device=device),
        n_sample=torch.zeros((), dtype=torch.int32, device=device),
    )
