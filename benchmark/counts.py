"""The work a filter-then-learn step needs, and the card's published peaks:
the yardstick of the roofline and MFU metrics.

A copy of the arithmetic of ``chip_smoke.py``'s ``step_ops`` and ``bound``,
with one change: Newton-Schulz is counted at the algorithm's base iteration
count for the step's mode (a prefix step's fixed 3; a segment step's 1 at
64 trials or more, else 2), never the iterations a kernel happens to run,
so the yardstick reads the same work whatever implements the step. Each
input of a launch is counted read once and each output written once; the
carry (weights, P, V, w) is read and written once a launch, so a segment's
launch spreads it over its steps. Elementwise work is not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at the 700 W power limit (data sheet)
PEAK_F32 = 67e12          # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12        # FLOP/s, bf16 inputs, f32 accumulation
PEAK_BYTES = 3.35e12      # bytes/s of HBM3

PREFIX_NS_ITERS = 3
ONE_ITER_MIN_BATCH = 64


def n_padded(nf: int) -> int:
    return ((nf + 127) // 128) * 128


def feature_dim(model: dict) -> int:
    return model["n_inducing"] if model["dynamics"] == "sgp" else model["n_rbf"]


def ns_iters(model: dict, b: int, segment: bool) -> int:
    if not segment:
        return PREFIX_NS_ITERS
    return int(model.get("mega_ns_iters", 0)) or (1 if b >= ONE_ITER_MIN_BATCH else 2)


def step_ops(model: dict, b: int, segment: bool):
    """(full-f32 operations, operations of the bf16-input products) of one
    step, 2 per multiply-add."""
    xd, yd, h = model["xdim"], model["ydim"], list(model["hidden_sizes"])
    nfp = n_padded(feature_dim(model))
    hidden = sum(h[i] * h[i - 1] for i in range(1, len(h)))
    first = h[0] * (yd + 2 * xd)
    mm = b * (nfp * nfp + nfp * xd + first + hidden + 2 * xd * h[-1] + yd * xd)  # forward
    mm += b * (2 * xd * yd + 4 * xd * h[-1] + 2 * hidden + first)               # backward
    mm += b * nfp * (nfp + xd)                                                 # F^T F, F^T dx
    mm += b * nfp * xd                                                         # state-noise residual
    f32 = b * nfp * xd                                                         # RBF cross term
    if model["dynamics"] == "sgp":
        f32 += b * nfp * nfp                                                   # whitening
    f32 += 2 * nfp * nfp * xd + ns_iters(model, b, segment) * 2 * nfp ** 3      # P w, V g, NS
    return 2 * f32, 2 * mm


def carry_bytes(model: dict) -> int:
    """Bytes of the carry a launch reads and writes: the recognition MLP,
    the decoder, the basis and the weight posterior, f32."""
    xd, yd, h = model["xdim"], model["ydim"], list(model["hidden_sizes"])
    nfp = n_padded(feature_dim(model))
    n = h[0] * (yd + 2 * xd) + sum(h[i] * h[i - 1] for i in range(1, len(h))) + sum(h)
    n += 2 * xd * h[-1] + xd + yd * xd + yd                  # mean, logvar heads; decoder
    n += nfp * xd + 2 * nfp + 2 * nfp * nfp + nfp * xd + 8   # basis, P, V, w, scalars
    if model["dynamics"] == "sgp":
        n += nfp * nfp
    return 4 * n


def step_bytes(model: dict, b: int, steps_a_launch: int) -> float:
    """Bytes a step moves: its observations read, its posterior (mean and
    log-variance) and scalar row written, and its share of the carry read
    and written once a launch."""
    per_step = 4 * (b * model["ydim"] + 2 * b * model["xdim"] + 8)
    return per_step + 2 * carry_bytes(model) / steps_a_launch


def least_seconds(model: dict, b: int, segment: bool, steps_a_launch: int):
    """(least seconds a step needs on one card, what sets it)."""
    f32, mm = step_ops(model, b, segment)
    t_ops = f32 / PEAK_F32 + mm / PEAK_BF16
    t_bytes = step_bytes(model, b, steps_a_launch) / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_peak_seconds(model: dict, b: int, segment: bool) -> float:
    """A step's operations at the published peaks: the numerator of MFU."""
    f32, mm = step_ops(model, b, segment)
    return f32 / PEAK_F32 + mm / PEAK_BF16
