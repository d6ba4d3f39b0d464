"""Spike counts as the flagship benchmark draws them: the sum of Bernoulli
draws at the traffic's ``spike_rates`` (0.07 and 0.05: mean 0.12 a bin,
sparse and neural-data-like), made on the device by a generator seeded from
the run's seed, one large call per rate."""
from __future__ import annotations

import torch


def make(traffic: dict, ydim: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (traffic["steps"], traffic["trials"], ydim)
    ys = torch.zeros(shape, dtype=torch.float32, device=device)
    p = torch.empty(shape, dtype=torch.float32, device=device)
    for rate in traffic["spike_rates"]:
        ys += torch.bernoulli(p.fill_(rate), generator=gen)
    return ys
