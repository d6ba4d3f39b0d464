"""RBF featurizer (counterpart of ``vjf_tpu/models/rbf.py``).

Centroids start U[-2, 2), log-widths at 0. They are never SGD-trained; the
end of warm-up re-initialises them from the data (:func:`reinit_rbf`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.functional import rbf as _rbf


class RBFParams(NamedTuple):
    centroid: torch.Tensor   # (n_basis, n_dim)
    logwidth: torch.Tensor   # (n_basis,)


def uniform(generator: torch.Generator, shape, lo: float, hi: float,
            dtype=torch.float32, device=None) -> torch.Tensor:
    """U[lo, hi) drawn from a CPU ``generator``, then moved to ``device``."""
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (lo + (hi - lo) * u).to(device)


def init_rbf(
    generator: torch.Generator,
    n_dim: int,
    n_basis: int,
    init_range: float = 2.0,
    dtype=torch.float32,
    device=None,
) -> RBFParams:
    centroid = uniform(generator, (n_basis, n_dim), -init_range, init_range,
                       dtype=dtype, device=device)
    return RBFParams(centroid=centroid,
                     logwidth=torch.zeros(n_basis, dtype=dtype, device=device))


def apply_rbf(params: RBFParams, x: torch.Tensor) -> torch.Tensor:
    """The basis at ``x`` (..., B, n_dim): (..., B, n_basis)."""
    return _rbf(x, params.centroid, torch.exp(params.logwidth))


def reinit_rbf(generator: torch.Generator, params: RBFParams, x: torch.Tensor,
               unit: Optional[torch.Tensor] = None) -> RBFParams:
    """Data-dependent re-initialisation at the end of warm-up: with ``r =
    max ||x||``, centroids ~ U[-r, r) and log-widths ``log r``. The unit
    draw U[0, 1) of the centroids' shape comes from ``generator`` (a CPU
    one) unless ``unit`` injects it."""
    r = torch.max(torch.linalg.vector_norm(x, dim=-1))
    c = params.centroid
    if unit is None:
        unit = torch.rand(c.shape, generator=generator, dtype=c.dtype)
    centroid = (-1.0 + 2.0 * unit.to(dtype=c.dtype, device=c.device)) * r
    return RBFParams(centroid=centroid,
                     logwidth=torch.log(r) * torch.ones_like(params.logwidth))
