"""Linear-algebra helpers (counterpart of ``vjf_tpu/ops/linalg.py``): the
Cholesky plumbing of the fused epoch, the RLS backends, the Kalman toolkit
and the rollout. Every product here runs in the input dtype at full
precision (TF32 stays off on the card, see ``fused_step``)."""
from __future__ import annotations

import math

import torch


def symmetric(a: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> torch.Tensor:
    """Symmetry check: a boolean tensor, no host sync."""
    return torch.isclose(a, a.transpose(-1, -2), rtol=rtol, atol=atol).all()


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
    or the factor is not finite, the factor of ``positivize(a, eps)`` (NaN
    if that fails too, as JAX's).

    The branch is taken on the host (one sync), as the JAX package's
    ``lax.cond`` takes it on the device: ``eigh`` raises on a non-finite
    input, and computing the repair on every call would cost an eigh each
    time. The precision and covariance RLS updates call it once a step, so
    they pay one sync a step. A non-finite ``a`` gives NaN, as the JAX
    repair does."""
    chol, info = torch.linalg.cholesky_ex(a)
    if bool(info != 0) or not bool(torch.isfinite(chol).all()):
        if not bool(torch.isfinite(a).all()):
            return torch.full_like(a, float("nan"))
        chol = nan_where_failed(*torch.linalg.cholesky_ex(positivize(a, eps)))
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


def tril_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L x = b`` with L lower-triangular."""
    return torch.linalg.solve_triangular(chol, b, upper=False)


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` given the lower Cholesky factor."""
    return torch.cholesky_solve(b, chol, upper=False)


def inv_tril_transpose(chol: torch.Tensor) -> torch.Tensor:
    """``inv(L)^T``: with ``P = L L^T`` the returned ``U`` has ``U U^T =
    P^{-1}``."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return tril_solve(chol, eye).transpose(-1, -2)


def nan_where_failed(out: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """The result of a ``torch.linalg.*_ex`` call (a Cholesky factor, an
    inverse) as JAX gives it: NaN throughout where LAPACK's ``info != 0``
    (``cholesky_ex`` returns a finite partial factor there), selected on the
    device; batched, matrix by matrix."""
    return torch.where((info == 0)[..., None, None], out, torch.full_like(out, float("nan")))
