"""The two collectives of the ``tp`` (channel) axis inside the autograd
step, as ``torch.autograd.Function``s: the pair that splits a product over
its contracted or its output axis.

* :func:`reduce_from` sums a partial product over the ``tp`` ranks in the
  forward pass (the recognition network's first layer contracts a slice of
  the channels on each rank); its gradient passes as it is.
* :func:`copy_to` passes a replicated input as it is in the forward pass
  (the latent sample a rank decodes into its own channels); its gradient,
  partial on each rank, is summed over the ``tp`` ranks in the backward
  pass.

The JAX package's GSPMD inserts the same two all-reduces from its
shardings."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class TPSlice(NamedTuple):
    """This rank's channels ``[lo, hi)`` of the ``tp`` axis and its group."""

    group: dist.ProcessGroup
    lo: int
    hi: int


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = torch.clone(grad, memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduce_from(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of the ``tp`` ranks' partial ``x``; identity backward."""
    return _Reduce.apply(x, group)


def copy_to(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the ``tp`` ranks."""
    return _Copy.apply(x, group)
