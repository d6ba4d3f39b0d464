"""Linear-algebra helpers (counterpart of ``vjf_tpu/ops/linalg.py``): the
parts the fused epoch, the RLS update and the rollout need. Every product
here runs in the input dtype at
full precision (TF32 stays off on the card, see ``fused_step``)."""
from __future__ import annotations

import math

import torch


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """Exact symmetrization (upper triangle mirrored)."""
    return torch.triu(a) + torch.triu(a, 1).transpose(-1, -2)


def eigh_floor_inv_pair(a: torch.Tensor, rel_floor: float = 1e-5):
    """``(A_floored, A_floored^{-1})`` by one eigh with eigenvalues clamped
    up to ``rel_floor * lam_max``: bounded and mutually inverse at any input
    conditioning. Epoch-boundary use only."""
    lam, u = torch.linalg.eigh(symmetrize(a))
    lam_max = torch.clamp(lam[..., -1], min=torch.finfo(a.dtype).tiny)
    lam_f = torch.maximum(lam, rel_floor * lam_max)
    return (u * lam_f) @ u.T, (u / lam_f) @ u.T


def positivize(a: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Eigenvalue-clamped PSD projection: eigenvalues below ``eps`` raised
    to it."""
    w, v = torch.linalg.eigh(a)
    root = v * torch.sqrt(torch.clamp(w, min=eps))[..., None, :]
    return root @ root.transpose(-1, -2)


def safe_cholesky(a: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Lower Cholesky factor, repaired where it fails: where ``info != 0``
    or the factor is not finite, the factor of ``positivize(a, eps)``.

    The branch is taken on the host (one sync), as the JAX package's
    ``lax.cond`` takes it: the callers (the rollout's weight square root)
    run once per rollout, and ``eigh`` raises on a non-finite input, so the
    repair is not computed on every call. A non-finite ``a`` gives NaN, as
    the JAX repair does."""
    chol, info = torch.linalg.cholesky_ex(a)
    if bool(info != 0) or not bool(torch.isfinite(chol).all()):
        if not bool(torch.isfinite(a).all()):
            return torch.full_like(a, float("nan"))
        chol, _ = torch.linalg.cholesky_ex(positivize(a, eps))
    return chol


def cholesky_f32(a: torch.Tensor):
    """Lower Cholesky factor and LAPACK ``info`` without a host sync:
    ``info != 0`` marks a matrix that is not PD (the factor is then a finite
    partial one, where JAX's Cholesky returns NaN)."""
    return torch.linalg.cholesky_ex(a)


def tri_inv_newton(tri: torch.Tensor) -> torch.Tensor:
    """Exact triangular inverse by Newton iteration: seeded with
    ``diag(1/diag)`` the error is strictly triangular, hence nilpotent, so
    ``ceil(log2(n))`` iterations of ``X <- X (2I - T X)`` terminate exactly."""
    n = tri.shape[-1]
    eye = torch.eye(n, dtype=tri.dtype, device=tri.device)
    x = eye * (1.0 / torch.diagonal(tri, dim1=-2, dim2=-1))[..., :, None]
    two_eye = 2.0 * eye
    for _ in range(max(1, math.ceil(math.log2(n)))):
        x = x @ (two_eye - tri @ x)
    return x
