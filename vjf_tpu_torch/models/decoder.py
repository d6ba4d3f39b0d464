"""Linear decoder (counterpart of ``vjf_tpu/models/decoder.py``): init only.
The decode itself lives in the fused step."""
from __future__ import annotations

import torch
from torch import nn

from .recognition import init_linear


def init_decoder(generator: torch.Generator, xdim: int, ydim: int,
                 dtype=torch.float32, device=None) -> nn.Linear:
    return init_linear(generator, xdim, ydim, dtype=dtype, device=device)
