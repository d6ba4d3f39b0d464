"""Plain Philox4x32-10 and Box-Muller sampler: the reference for the
device functions ``philox_pair`` and ``box_muller`` in ``csrc/fused_step.cu``.

The JAX kernels draw their step noise from the TPU core's own generator
(``vjf_tpu/ops/pallas/fused_step.py:_box_muller``); the port uses a
counter-based Philox4x32-10 (Random123's constants and round structure)
with this mapping, shared bit for bit by the kernel and this module:

* key = ``(rng_seed, 0)``;
* element ``i`` of the row-major ``(B, 2*xd)`` draw uses counter
  ``(rng_count, i // 2, 0, 0)``, and words ``2*(i % 2)`` and ``2*(i % 2)+1``
  of the output as ``bits1`` and ``bits2``;
* top 24 bits -> ``u1 = i1 * 2^-24 + 2^-25``, ``u2 = i2 * 2^-24``,
  ``eps = sqrt(-2 ln u1) * cos(2 pi u2)``;
* columns ``[:xd]`` are ``eps_s`` and ``[xd:]`` are ``eps_t``;
* a shard of the trials (``row0``: its first row in the whole batch) draws
  rows ``[row0, row0 + B_local)`` of the whole batch's draw, so a sharded
  epoch at any world size uses the same noise as one device.

The 32-bit words live in int64 tensors; the 32x32 -> 64 bit product is
split into 16-bit halves so no intermediate overflows int64.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product ``a * b`` (b < 2^32)."""
    t1 = (a & 0xFFFF) * b              # < 2^48
    t2 = (a >> 16) * b                 # < 2^48
    lo = (((t2 & 0xFFFF) << 16) + t1) & _MASK
    hi = (t2 + (t1 >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words.

    ``ctr``: 4 tensors (broadcastable); ``key``: 2 tensors. Returns 4 words.
    """
    c0, c1, c2, c3 = (c & _MASK for c in ctr)
    k0, k1 = (k & _MASK for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(rng_seed: torch.Tensor, rng_count: torch.Tensor, n_rows: int,
             n_cols: int, dtype=torch.float32, row0: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u1, u2)``, each ``(n_rows, n_cols)``: rows ``row0`` on of one step
    of the stream. ``rng_seed``/``rng_count`` are int tensors of one element
    (any shape), on the device the draws should land on."""
    dev = rng_seed.device
    i = torch.arange(row0 * n_cols, (row0 + n_rows) * n_cols, dtype=torch.int64, device=dev)
    seed = rng_seed.reshape(()).to(torch.int64)
    count = rng_count.reshape(()).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w = philox4x32_10((count, i // 2, zero, zero), (seed, zero))
    odd = (i % 2) == 1
    bits1 = torch.where(odd, w[2], w[0])
    bits2 = torch.where(odd, w[3], w[1])
    u1 = (bits1 >> 8).to(dtype) * (2.0**-24) + (2.0**-25)
    u2 = (bits2 >> 8).to(dtype) * (2.0**-24)
    return u1.reshape(n_rows, n_cols), u2.reshape(n_rows, n_cols)


def normals(rng_seed: torch.Tensor, rng_count: torch.Tensor, n_rows: int,
            n_cols: int, dtype=torch.float32, row0: int = 0) -> torch.Tensor:
    """Box-Muller standard normals, ``(n_rows, n_cols)``, from row ``row0``."""
    u1, u2 = uniforms(rng_seed, rng_count, n_rows, n_cols, dtype, row0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * 3.14159265358979) * u2)


def box_muller_latents(rng_seed: torch.Tensor, rng_count: torch.Tensor, b: int,
                       xd: int, dtype=torch.float32, row0: int = 0):
    """``(eps_s, eps_t)``, each ``(B, xd)``: rows ``[row0, row0 + B)`` of one
    ``(*, 2*xd)`` draw, split by columns."""
    eps = normals(rng_seed, rng_count, b, 2 * xd, dtype, row0)
    return eps[:, :xd], eps[:, xd:]
