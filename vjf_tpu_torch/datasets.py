"""Synthetic benchmark systems: a numpy-only copy of ``vjf_tpu/datasets.py``
(the port imports nothing of ``vjf_tpu``); ``tests/test_torch_functional.py``
pins the two equal.

The named latent systems of ``BASELINE.json`` (Van der Pol, Lorenz, the ring
attractor) and observation helpers, as host-side Euler loops over tiny
state vectors (numpy, seeded). ``chip_smoke.py`` and
``scripts/torch_fit_quality.py`` draw their quality data from here.
"""
from __future__ import annotations

import numpy as np


def van_der_pol(T=1200, dt=0.05, mu=1.0, x0=(1.0, 0.0), noise=0.02, seed=0):
    """Van der Pol oscillator latents, shape (T, 2) — BASELINE config #1."""
    rng = np.random.default_rng(seed)
    x = np.zeros((T, 2))
    x[0] = x0
    for t in range(1, T):
        p, v = x[t - 1]
        dp = v
        dv = mu * (1 - p * p) * v - p
        x[t] = x[t - 1] + dt * np.array([dp, dv]) + noise * rng.normal(size=2)
    return x


def lorenz(T=1500, dt=0.01, seed=0, noise=0.0):
    """Lorenz-63 latents, shape (T, 3) — BASELINE config #2."""
    rng = np.random.default_rng(seed)
    x = np.zeros((T, 3))
    x[0] = (1.0, 1.0, 25.0)
    for t in range(1, T):
        a, b, c = x[t - 1]
        d = np.array([10 * (b - a), a * (28 - c) - b, a * b - 8 / 3 * c])
        x[t] = x[t - 1] + dt * d + noise * rng.normal(size=3)
    return x


def ring_attractor(T=1000, dt=0.1, omega=0.5, radius=1.0, x0=(1.5, 0.0),
                   noise=0.02, seed=6):
    """Ring attractor latents, shape (T, 2) — BASELINE config #3 (SGP):
    radial attraction to ``|x| = radius`` plus constant rotation."""
    rng = np.random.default_rng(seed)
    x = np.zeros((T, 2))
    x[0] = x0
    for t in range(T - 1):
        r = np.linalg.norm(x[t])
        radial = (radius - r) * x[t] / max(r, 1e-6)
        angular = omega * np.array([-x[t, 1], x[t, 0]])
        x[t + 1] = x[t] + dt * (radial + angular) + noise * rng.normal(size=2)
    return x


def linear_gaussian_observations(x, ydim, obs_noise=0.1, intercept=True,
                                 scale=1.0, seed=1):
    """``y = x C + d + eps`` readout of a latent trajectory: returns
    ``(y, C, d)`` with y shape (T, ydim)."""
    rng = np.random.default_rng(seed)
    C = scale * rng.normal(size=(x.shape[-1], ydim))
    d = rng.normal(size=ydim) if intercept else np.zeros(ydim)
    y = x @ C + d + obs_noise * rng.normal(size=(x.shape[0], ydim))
    return y, C, d


def poisson_observations(x, ydim, scale=0.4, bias=0.5, clip=(-4, 3), seed=2):
    """Poisson spike counts ``y ~ Poisson(exp(clip(x C + bias)))``: returns
    ``(y, C)`` with y shape (T, ydim) float32 counts."""
    rng = np.random.default_rng(seed)
    C = scale * rng.normal(size=(x.shape[-1], ydim))
    rate = np.exp(np.clip(x @ C + bias, *clip))
    return rng.poisson(rate).astype(np.float32), C
