"""The benchmark's own data generators. A traffic file names one by its
``data`` key; :func:`make` draws that cell's observations, (T, B, ydim)
float32 on ``device``, from a seed. The program sees only the result."""
from __future__ import annotations

from . import spikes

GENERATORS = {"spikes": spikes.make}


def make(traffic: dict, ydim: int, seed: int, device):
    return GENERATORS[traffic["data"]](traffic, ydim, seed, device)
