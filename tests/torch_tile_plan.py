"""A mirror of the CUDA kernels' shared-memory layout and trial-tile plan, for
the tests: ``carve_smem`` and ``plan_tiles`` of vjf_tpu_torch/csrc/fused_step.cu
in Python, field by field, so that the tile plan and the shared-memory limit
can be tested where the library cannot be built. Nothing in the package
calls it: the launch and ``kernel_limits`` ask the library itself. The card
test ``test_torch_cluster.py::test_tile_plan_mirror_matches_the_library``
holds it against the library's ``vjf_smem_bytes`` and ``vjf_cluster_info``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from vjf_tpu_torch.config import VJFConfig
from vjf_tpu_torch.ops.fused_step import _Args, _dims, _round_up, cluster_size

# What ``carve_smem`` and ``plan_tiles`` need beyond the shapes: the head
# of a block's shared memory (``head_floats``: sizeof(Header) and the 9
# other SGD leaves of 16 bytes, then a Layer of 56 bytes and a width of 4
# for each hidden layer, at least HEAD_MIN_BYTES), the threads of a block,
# the card's shared memory a block, the trial tile's quantum, the rows of a
# staged chunk past 128 padded features and the rows of a staged sub-panel
# on the L2 route.
HEAD_FIXED_BYTES = 1136 + 9 * 16
HEAD_LAYER_BYTES = 56 + 4
HEAD_MIN_BYTES = 1936
NTHREADS = 512
SMEM_LIMIT = 232448
TILE_QUANTUM = 16
STAGE_ROWS = 16
SUB_ROWS = 16


class TilePlan(NamedTuple):
    tile: int         # trials of a block that phase 1 runs at once
    kc: int           # rows of the Newton-Schulz right-hand matrix staged at once
    smem_bytes: int   # dynamic shared memory a block takes at this plan
    sp: int = 0       # rows of a staged sub-panel; 0: the panels and the trials' state resident


def _panel_ksplit(prow: int, nfp: int) -> int:
    tiles = -(-prow // 4) * (nfp // 4)
    return min(max(NTHREADS // max(tiles, 1), 1), 8)


def head_bytes(n_layers: int) -> int:
    """Bytes of the head of a block's shared memory at ``n_layers`` hidden
    layers (``head_floats``): 1936 up to ten layers, as it was with the
    eight-layer arrays, so that those shapes keep their plans."""
    return -(-max(HEAD_FIXED_BYTES + HEAD_LAYER_BYTES * n_layers, HEAD_MIN_BYTES) // 16) * 16


def smem_floats(a: _Args, cluster: int) -> int:
    """Floats of a block's shared memory at the shapes and plan (``tile``,
    ``kc``, ``sp``) of ``a``: ``carve_smem``. With ``sp`` (the L2 route) the
    trials' state and the mask's row are not in shared memory, and phase 2
    keeps one sub-panel of ``sp`` rows."""
    off = 0

    def take(n):
        nonlocal off
        off += -(-n // 4) * 4

    xd, nfp, widths, big = a.xd, a.nfp, a.widths[:a.n_layers], a.sp > 0
    rows, prow, tile = -(-a.B // cluster), -(-nfp // cluster), a.tile
    ldy, ldu, ldf = (a.yd + 3) // 4 * 4 + 4, (a.ud + 3) // 4 * 4 + 4, (nfp + 3) // 4 * 4 + 4
    ldg = (max(widths) + 3) // 4 * 4 + 4
    take(head_bytes(a.n_layers) // 4)
    for n in ([] if big else [rows * 2 * xd] + [rows * xd] * 4) + [8 * NTHREADS // 32, 32, 8]:
        take(n)
    if a.mask and not big:
        take(a.B)
    for n in (([] if big else [rows]) + [nfp * xd] + ([nfp * a.ud] if a.ud else [])
              + [nfp, nfp, a.yd, xd] + widths):
        take(n)
    for _ in range(2 if tile < rows else 1):
        take(tile * ldy)
        if a.ud:
            take(tile * ldu)
        if a.cmask:
            take(tile * ldy)
    mark = off
    for n in ([tile * ldf] + [tile * xd] * 3 + [tile, tile * ldf, tile, tile] + [tile * xd] * 2
              + [tile * ldy] + [tile * xd] * 3 + [tile * ldg] * 2
              + [tile * ((w + 3) // 4 * 4 + 4) for w in widths]):
        take(n)
    end1, off = off, mark
    take(2 * a.kc * nfp if a.kc < nfp else nfp * nfp)
    if big:
        take(a.sp * ldf)
        take(_panel_ksplit(a.sp, nfp) * -(-a.sp // 4) * 4 * nfp)
        for n in (prow * xd, prow * xd):
            take(n)
    else:
        take(prow * ldf)
        take(prow * ldf)
        take(_panel_ksplit(prow, nfp) * -(-prow // 4) * 4 * nfp)
        for n in (prow * nfp, prow * xd, prow * xd, nfp * xd):
            take(n)
    return max(off, end1)


def _fits(p: _Args, cluster: int) -> bool:
    return 4 * smem_floats(p, cluster) <= SMEM_LIMIT


def _tile_search(p: _Args, cluster: int) -> None:
    """``tile_search``: every trial of a block in one tile where it fits,
    else the largest multiple of ``TILE_QUANTUM`` that fits, else (on the L2
    route) half the quantum, then a quarter, else the smallest tile."""
    rows = -(-p.B // cluster)
    p.tile = rows
    r = (rows - 1) // TILE_QUANTUM * TILE_QUANTUM
    while r >= TILE_QUANTUM and not _fits(p, cluster):
        p.tile = r
        r -= TILE_QUANTUM
    r = TILE_QUANTUM // 2
    while p.sp and r >= TILE_QUANTUM // 4 and r < p.tile and not _fits(p, cluster):
        p.tile = r
        r //= 2


def _plan(p: _Args, cluster: int) -> None:
    """``plan_tiles`` on ``p`` in place."""
    p.sp = 0
    p.kc = kc0 = p.nfp if p.nfp <= 128 else STAGE_ROWS
    _tile_search(p, cluster)
    if _fits(p, cluster):
        return
    kc = kc0
    while kc >= 4:
        for sp in (SUB_ROWS, SUB_ROWS // 2, SUB_ROWS // 4):
            p.kc, p.sp = kc, sp
            _tile_search(p, cluster)
            if _fits(p, cluster):
                return
        kc //= 2


def plan_of(a: _Args, cluster: Optional[int] = None) -> TilePlan:
    """The tile plan of ``plan_tiles`` at the shapes of ``a``. With the
    trials' state and phase 2's panels resident: the tile of
    :func:`_tile_search`, the right-hand matrix of a panel product staged
    whole up to 128 padded features, in chunks of ``STAGE_ROWS`` rows past
    that. Where no tile fits so, the L2 route: sub-panels of ``SUB_ROWS``
    rows, halved with the chunk, then the sub-panel, down to 4 until a tile
    fits; else the smallest plan (which the launch refuses)."""
    cluster = cluster_size() if cluster is None else cluster
    p = _Args.from_buffer_copy(a)
    _plan(p, cluster)
    return TilePlan(p.tile, p.kc, 4 * smem_floats(p, cluster), p.sp)


def tile_plan(cfg: VJFConfig, n_batch: int, mask: bool = False, channel_mask: bool = False,
              cluster: Optional[int] = None) -> TilePlan:
    """:func:`plan_of` for ``cfg`` at ``n_batch`` trials, with or without the
    staging of a trial ``mask`` and a ``channel_mask``."""
    return plan_of(_dims(cfg, n_batch, mask=mask, cmask=channel_mask), cluster)


def block_tiles(n: int, tile: int) -> list:
    """The tiles a block of ``n`` trials runs phase 1 over at a plan's
    ``tile``, as ranges of its rows (``tile_of`` and ``n_tiles``): a block without trials runs one empty tile."""
    return [range(r0, min(r0 + tile, n)) for r0 in range(0, max(n, 1), tile)]


class MirrorLib:
    """The library's two shared-memory queries answered by the mirror,
    without a build."""

    def vjf_smem_bytes(self, args):
        return plan_of(args._obj).smem_bytes

    def vjf_smem_limit(self):
        return SMEM_LIMIT


def parent_smem_bytes(cfg, b, mask=False, cmask=False, cluster=8):
    """A block's shared memory before the kernels had trial tiles: every
    trial of the block resident, the whole (nfp, nfp) matrix staged (the
    layout the flagship's 192,368 and 219,504 bytes come from)."""
    off = 0

    def take(n):
        nonlocal off
        off += -(-n // 4) * 4

    xd, yd, ud, nfp = cfg.xdim, cfg.ydim, cfg.udim, _round_up(cfg.feature_dim)
    widths = list(cfg.hidden_sizes)
    rows, prow = -(-b // cluster), -(-nfp // cluster)
    ldy, ldu, ldf = (yd + 3) // 4 * 4 + 4, (ud + 3) // 4 * 4 + 4, (nfp + 3) // 4 * 4 + 4
    ldg = (max(widths) + 3) // 4 * 4 + 4
    take(-(-1440 // 16) * 4)     # sizeof(Header) at 3 layers
    for n in ([rows * ldy] + ([rows * ldu] if ud else []) + [rows * 2 * xd] + [rows * xd] * 4
              + [rows * ldf, rows * xd, rows * xd, 128, 32] + ([rows * ldy] if cmask else [])
              + ([b] if mask else []) + [rows, nfp * xd] + ([nfp * ud] if ud else [])
              + [nfp, nfp, yd, xd] + widths):
        take(n)
    mark = off
    for n in ([rows * xd] * 2 + [rows, rows * ldf, rows, rows] + [rows * xd] * 2 + [rows * ldy]
              + [rows * xd] * 3 + [rows * ldg] * 2 + [rows * ((w + 3) // 4 * 4 + 4)
                                                       for w in widths]):
        take(n)
    end1, off = off, mark
    for n in (nfp * nfp, prow * ldf, prow * ldf,
              _panel_ksplit(prow, nfp) * -(-prow // 4) * 4 * nfp, prow * nfp, prow * xd,
              prow * xd, nfp * xd):
        take(n)
    return 4 * max(off, end1)
