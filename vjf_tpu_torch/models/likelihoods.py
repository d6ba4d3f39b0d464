"""GLM observation likelihoods (counterpart of
``vjf_tpu/models/likelihoods.py``): parameter containers and init. The
Poisson and Gaussian math runs inside the fused step."""
from __future__ import annotations

from typing import NamedTuple

import torch


class GaussianLikParams(NamedTuple):
    logvar: torch.Tensor   # scalar, SGD-trained AND running-var overwritten


class PoissonLikParams(NamedTuple):
    """No parameters."""

    empty: None = None


def init_gaussian_lik(init_logvar: float, dtype=torch.float32,
                      device=None) -> GaussianLikParams:
    return GaussianLikParams(logvar=torch.tensor(init_logvar, dtype=dtype, device=device))


def init_poisson_lik() -> PoissonLikParams:
    return PoissonLikParams()
