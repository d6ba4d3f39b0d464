"""Amortized recognition (filtering) network
(counterpart of ``vjf_tpu/models/recognition.py``).

An MLP over ``concat(y, u, q_prev.mean, q_prev.logvar)`` with Tanh
activations (the fused kernels' only one) and two heads: ``mean`` (no bias)
and ``logvar`` (bias). The layers are ``nn.Linear`` in torch's ``(out,
in)`` layout, which is also the JAX package's layout. Parameters carry no
autograd: the fused step trains them with its hand-written backward, and
the autograd step (``models.vjf.filter_step``) differentiates a copy made
by :func:`map_linears` and builds new modules from the updated tensors.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.tp import TPSlice, reduce_from
from ..types import Gaussian
from .rbf import uniform


def linear_from(w: torch.Tensor, b: Optional[torch.Tensor] = None,
                requires_grad: bool = False) -> nn.Linear:
    """An ``nn.Linear`` whose weight (and bias) share the given tensors'
    storage; with ``requires_grad`` they are fresh autograd leaves."""
    lin = nn.Linear(w.shape[1], w.shape[0], bias=b is not None, device="meta")
    lin.weight = nn.Parameter(w, requires_grad=requires_grad)
    if b is not None:
        lin.bias = nn.Parameter(b, requires_grad=requires_grad)
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

    def forward(self, y: torch.Tensor, qs: Gaussian, u: Optional[torch.Tensor] = None,
                activation: str = "tanh", tp: Optional[TPSlice] = None) -> Gaussian:
        """With ``tp``, ``y`` holds this rank's channels ``[tp.lo, tp.hi)``:
        the input layer contracts them with its columns of the replicated
        weight and sums the partial products over the ``tp`` ranks
        (:func:`~..ops.tp.reduce_from`); the rest is replicated."""
        act = ACTIVATIONS[activation]
        parts = [y] + ([u] if u is not None and u.shape[-1] > 0 else [])
        if tp is not None:
            return self._forward_tp(parts[1:] + [qs.mean, qs.logvar], y, act, tp)
        h = torch.cat(parts + [qs.mean, qs.logvar], dim=-1)
        for layer in self.layers:
            h = act(layer(h))
        return Gaussian(self.mean(h), self.logvar(h))

    def _forward_tp(self, rest, y, act, tp: TPSlice) -> Gaussian:
        rest = torch.cat(rest, dim=-1)

        def first(lin: nn.Linear) -> torch.Tensor:
            w = lin.weight
            n_y = w.shape[1] - rest.shape[-1]
            out = reduce_from(y @ w[:, tp.lo:tp.hi].T, tp.group) + rest @ w[:, n_y:].T
            return out if lin.bias is None else out + lin.bias

        if not self.layers:
            return Gaussian(first(self.mean), first(self.logvar))
        h = act(first(self.layers[0]))
        for layer in self.layers[1:]:
            h = act(layer(h))
        return Gaussian(self.mean(h), self.logvar(h))


# the JAX package's menu (vjf_tpu/models/recognition.py:ACTIVATIONS); the
# fused kernels run tanh only, the autograd step any of them
ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": torch.nn.functional.softplus,
    "identity": lambda x: x,
}


def map_linears(rec: Recognition, fn: Callable[[nn.Linear], nn.Linear]) -> Recognition:
    """A new ``Recognition`` with ``fn(layer)`` in place of each layer."""
    return Recognition([fn(l) for l in rec.layers], fn(rec.mean), fn(rec.logvar))


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
