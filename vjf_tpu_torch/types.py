"""Core container types (counterpart of ``vjf_tpu/types.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Gaussian(NamedTuple):
    """Diagonal Gaussian carried as (mean, log-variance)."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)
