"""Linear decoder (counterpart of ``vjf_tpu/models/decoder.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.tp import TPSlice, copy_to
from .recognition import init_linear


def init_decoder(generator: torch.Generator, xdim: int, ydim: int,
                 dtype=torch.float32, device=None) -> nn.Linear:
    return init_linear(generator, xdim, ydim, dtype=dtype, device=device)


def decode(decoder: nn.Linear, x: torch.Tensor, tp: Optional[TPSlice] = None) -> torch.Tensor:
    """Point decode of a latent sample. With ``tp`` the decoder holds this
    rank's rows, so the result is its channels, and the gradient of the
    replicated ``x`` is summed over the ``tp`` ranks (:func:`~..ops.tp.copy_to`)."""
    return decoder(x if tp is None else copy_to(x, tp.group))
