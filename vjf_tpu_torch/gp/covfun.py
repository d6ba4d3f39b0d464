"""Covariance functions for the sparse-GP dynamics (counterpart of
``vjf_tpu/gp/covfun.py``)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CovarianceFunction:
    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared distances ``|x1|^2 + |x2|^2 - 2 x1 x2^T``, clamped at 0."""
    a = torch.sum(x1 * x1, dim=-1, keepdim=True)
    b = torch.sum(x2 * x2, dim=-1)
    return torch.clamp(a + b - 2.0 * (x1 @ x2.T), min=0.0)


@dataclass(frozen=True)
class SquaredExponential(CovarianceFunction):
    """``k(x, y) = scale^2 exp(-||x - y||^2 / (2 l^2))``."""

    scale: float = 1.0
    lengthscale: float = 1.0

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        d2 = _sqdist(torch.atleast_2d(x1), torch.atleast_2d(x2))
        return self.scale ** 2 * torch.exp(-0.5 * d2 / self.lengthscale ** 2)

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.atleast_2d(x)
        return torch.full(x.shape[:-1], self.scale ** 2, dtype=x.dtype, device=x.device)


@dataclass(frozen=True)
class Matern52(CovarianceFunction):
    """Matern 5/2, a rougher alternative for less smooth velocity fields."""

    scale: float = 1.0
    lengthscale: float = 1.0

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        d = torch.sqrt(_sqdist(torch.atleast_2d(x1), torch.atleast_2d(x2)) + 1e-12)
        r = math.sqrt(5.0) * d / self.lengthscale
        return self.scale ** 2 * (1.0 + r + r * r / 3.0) * torch.exp(-r)

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.atleast_2d(x)
        return torch.full(x.shape[:-1], self.scale ** 2, dtype=x.dtype, device=x.device)
