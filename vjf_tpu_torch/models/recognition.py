"""Amortized recognition (filtering) network
(counterpart of ``vjf_tpu/models/recognition.py``).

An MLP over ``concat(y, u, q_prev.mean, q_prev.logvar)`` with Tanh
activations and two heads: ``mean`` (no bias) and ``logvar`` (bias). The
layers are ``nn.Linear`` in torch's ``(out, in)`` layout, which is also the
JAX package's layout. Parameters carry no autograd: the fused step trains
them with its hand-written backward.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..types import Gaussian
from .rbf import uniform


def linear_from(w: torch.Tensor, b: Optional[torch.Tensor] = None) -> nn.Linear:
    """An ``nn.Linear`` whose weight (and bias) ARE the given tensors."""
    lin = nn.Linear(w.shape[1], w.shape[0], bias=b is not None, device="meta")
    lin.weight = nn.Parameter(w, requires_grad=False)
    if b is not None:
        lin.bias = nn.Parameter(b, requires_grad=False)
    return lin


def init_linear(generator: torch.Generator, n_in: int, n_out: int,
                bias: bool = True, dtype=torch.float32, device=None) -> nn.Linear:
    """torch ``nn.Linear``'s default init: W, b ~ U[-k, k], k = 1/sqrt(fan_in),
    drawn from an explicit generator."""
    k = 1.0 / math.sqrt(n_in)
    w = uniform(generator, (n_out, n_in), -k, k, dtype=dtype, device=device)
    b = uniform(generator, (n_out,), -k, k, dtype=dtype, device=device) if bias else None
    return linear_from(w, b)


class Recognition(nn.Module):
    """q[t] = MLP(y[t], u[t], q[t-1])."""

    def __init__(self, layers: Sequence[nn.Linear], mean: nn.Linear,
                 logvar: nn.Linear):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.mean = mean
        self.logvar = logvar

    def forward(self, y: torch.Tensor, qs: Gaussian,
                u: Optional[torch.Tensor] = None) -> Gaussian:
        parts = [y] + ([u] if u is not None and u.shape[-1] > 0 else [])
        h = torch.cat(parts + [qs.mean, qs.logvar], dim=-1)
        for layer in self.layers:
            h = torch.tanh(layer(h))
        return Gaussian(self.mean(h), self.logvar(h))


def init_recognition(
    generator: torch.Generator,
    ydim: int,
    xdim: int,
    udim: int,
    hidden_sizes: Sequence[int],
    dtype=torch.float32,
    device=None,
) -> Recognition:
    """Input width is ``ydim + udim + 2*xdim``."""
    sizes = [ydim + udim + 2 * xdim, *hidden_sizes]
    layers = [
        init_linear(generator, sizes[i], sizes[i + 1], dtype=dtype, device=device)
        for i in range(len(hidden_sizes))
    ]
    mean = init_linear(generator, sizes[-1], xdim, bias=False, dtype=dtype, device=device)
    logvar = init_linear(generator, sizes[-1], xdim, dtype=dtype, device=device)
    return Recognition(layers, mean, logvar)
