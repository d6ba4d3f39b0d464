"""Non-Bayesian RBF network (counterpart of ``vjf_tpu/models/rbfn.py``): RBF
features at normally drawn centroids with a learnable log-scale, then a
linear layer, trained by gradients (no closed-form update). A standalone
building block, e.g. a gradient-trained velocity-field baseline; VJF does
not use it."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.functional import rbf
from .recognition import init_linear


class RBFNParams(NamedTuple):
    centroid: torch.Tensor   # (n_basis, in_features) ~ N(0, 1)
    logscale: torch.Tensor   # (1, n_basis), broadcast over the batch
    out: nn.Linear           # basis -> output


def init_rbfn(generator: torch.Generator, in_features: int, out_features: int,
              n_basis: int, bias: bool = True, dtype=torch.float32,
              device=None) -> RBFNParams:
    """Centroids N(0, 1) and the output layer (torch's default init) drawn
    from a CPU ``generator``, log-scales 0."""
    centroid = torch.randn((n_basis, in_features), generator=generator, dtype=dtype)
    return RBFNParams(
        centroid=centroid.to(device),
        logscale=torch.zeros((1, n_basis), dtype=dtype, device=device),
        out=init_linear(generator, n_basis, out_features, bias=bias, dtype=dtype,
                        device=device),
    )


def apply_rbfn(params: RBFNParams, x: torch.Tensor) -> torch.Tensor:
    return params.out(rbf(x, params.centroid, torch.exp(params.logscale[0])))
