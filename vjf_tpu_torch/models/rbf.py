"""RBF featurizer parameters (counterpart of ``vjf_tpu/models/rbf.py``).

Centroids start U[-2, 2), log-widths at 0. They are never SGD-trained.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
