"""Drive the PyTorch/CUDA port (``vjf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of ``vjf_tpu_torch/csrc`` with nvcc, holds each against
its plain PyTorch version (and checks that planted faults are rejected by
the same comparison; also that two runs give the same bits, and that a batch
the cluster does not divide is split right), drives the main path (the flagship config of
``bench.py``: one warm-up epoch, then RLS-active epochs at full width,
T = 2048 per epoch) through the kernels, times each kernel beside its plain
version, and profiles one RLS epoch. The ``fallback`` phases hold the
exact fallback's kernel against its plain version and a float64 evaluation
of it on synthetic inputs (tau on each side of the threshold, at it and not
finite; the three gates; 128 to 512 padded features, 1 to 4,096 trials, a
trial mask with controls, SGP; 8 members, each bit for bit against its solo
launch) and time it skipped and taken. The ``sharded`` phases then drive the
exact-sync sharded epoch (``parallel.sharded``) at world size 1 over NCCL
through its phase-1 kernel and hold it against the single-device epoch. The
last phases hold the autograd epoch (``fused_step='off'``, the route a
demoted epoch takes) against the stepwise kernel epoch, and drive the
training entry point ``fit``: blocked at the flagship width with
``bench_all.py``'s forgetting (prefix-free continuation), per epoch with a
forced demotion and re-probe, and ``bench_all.py``'s Van der Pol fit, whose
forecast must beat persistence. The ``sgp`` phases do the same for sparse-GP
dynamics at the flagship widths (``n_inducing`` 100): the three launchers
against their plain versions with the whitening and the DTC correction
(each of the two faults planted must be rejected), a sharded SGP epoch,
the main path (``run_epochs``: warm-up, bootstrap, two RLS epochs) and a
blocked ``fit`` with hyperparameter adaptation. ``route`` drives a
configuration past the kernels' limits (a block past the card's shared
memory at the smallest plan: ydim 2500, 256 padded features, a channel
mask): the autograd epoch under ``fused_step='auto'``, ``ValueError`` under
``'on'``. The ``shapes`` phases close the script: shapes the kernels take
since phase 1 runs over tiles of a block's trials (512 and 1024 trials, 512
with both masks, 256 padded features for RBF and SGP, hidden (64, 64, 64,
64) and (128,)), since the L2 route (512 padded features for RBF and SGP,
256 with both masks, 4096 trials) and since the layer table (hidden (32,) x
9), each with a main path under ``'auto'`` (no
routing warning, the step and mega kernels launched), the three kernels
against their plain versions in both matmul modes with the planted faults,
the tile plan
against the library's, the times beside the autograd epoch's, and 16
sharded steps; the two loosened bf16 limits (``SHAPE_LIMITS``) beside a
float64 plain version; then every hidden-layer count on each of the kernels'
three instantiations (``shapes.depths``) and every tile plan the L2 route
admits (``shapes.plans``). The ``mask`` phases
run ragged trials and missing channels at the flagship widths (trial
lengths in [T/2, T], 10% of y dropped, 8 channels dead over a quarter of the
epoch, NaN at every masked entry): the three launchers with either mask and
both against their plain versions and the planted mask faults, NaN
invariance, the masked main path, a masked sharded epoch and a blocked
``fit`` on the ragged data. The ``ensemble`` phases run 8 members of 32
trials at the flagship widths: the two member-axis launches (one cluster a
member) against their plain versions, on per-member y and on one shared y,
member m of a launch bit for bit against a solo launch of member m, the
planted member faults (a stride one member short, a per-member posterior
read as shared), ``fit_ensemble`` per epoch and blocked beside the same
members' solo fits, that per-epoch fit again with the plain exact
fallback in place of the kernel (its times, how far its members end from
the shipped ones), a phase-mixed epoch
(``warm_gate``) against each member's static-flag epoch, and a forced hot
member re-run alone while the others keep their bits. The ``smooth``
phases drive post-hoc smoothing and co-smoothing evaluation: the
associative-scan smoother in f32 at the flagship widths against the
sequential loops in f64 (a swapped smooth combine must be rejected),
``scripts/flagship_cosmooth.py``'s workload (a 25-epoch ``fit`` through
the kernels, then the 5-fold co-smoothing evaluation with the fold loop and
with fold batches, one fold again in f64, and held-out channels left in the
inference mask, which must be caught), the facade's ``smooth``,
``evaluate`` and ``evaluate_kfold``, and the times of a Laplace pass and of
the small inverse. The ``multi`` phases train over ranks
(``parallel.sharded``): ``multi.fit`` is exact-sync ``fit(mesh=...)`` at
world size 1 over NCCL against the plain ``fit`` (each sharded step one
launch of the phase-1 kernel); ``multi.sync_every`` one relaxed-sync epoch
(four segments of the step and mega kernels, merged at each boundary)
against the same segments chained through ``run_epoch``; ``multi.world2``
two processes on the one card over gloo (``python3 chip_smoke.py
--world2-rank R PORT DIR`` each), which run exact-sync ``fit``, a relaxed
epoch, ``fit_ensemble`` with four members a rank and ``smooth_batch`` over
the two ranks against the one-process runs.
Phases print one line each; any failed check raises and the script exits
non-zero. The last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import json
import logging
import itertools
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from vjf_tpu_torch import VJF, datasets
from vjf_tpu_torch.config import StepFlags, VJFConfig
from vjf_tpu_torch.convert import flatten, state_to_numpy
from vjf_tpu_torch.gp import sgp
from vjf_tpu_torch.models import dynamics as dyn
from vjf_tpu_torch.models import evaluate as EV
from vjf_tpu_torch.models import smoothing
from vjf_tpu_torch.models import regression as R
from vjf_tpu_torch.models import vjf as core
from vjf_tpu_torch.models.recognition import Recognition, linear_from, map_linears
from vjf_tpu_torch.native import StreamingLoader, device_prefetch
from vjf_tpu_torch.ops import _build, linalg, rng
from vjf_tpu_torch.ops import kalman as K
from vjf_tpu_torch.ops import pkalman as PK
from vjf_tpu_torch.ops import fused_step as F
from vjf_tpu_torch.parallel import ensemble as E
from vjf_tpu_torch.parallel import (
    Mesh,
    fit_ensemble,
    init_ensemble,
    make_dp_group,
    make_mesh,
    make_sharded_epoch,
    run_epoch_ensemble,
    run_epoch_fused_sharded,
    run_epoch_sync_every,
    shard_data,
)
from vjf_tpu_torch.parallel.sharded import fused_route, segment_seeds
from vjf_tpu_torch.utils.checkpoint import load_snapshot
from vjf_tpu_torch.utils.evaluation import forecast_rmse, latent_r2

B = 256                 # trials, as in bench.py
T_EPOCH = 2048          # steps per main-path epoch
MEGA_STEPS = 64         # steps of the flagship mega comparison
WARM_STEPS = 256        # warm-up steps before the step and mega comparisons
# Kernel vs plain tolerance on each leaf's normalised error (see compare).
# Both sides are f32 and run the same algorithm; summation orders differ,
# and the exact Cholesky fallback and the Newton-Schulz recursion amplify
# the last bits. In bf16 mode an f32 value that differs in its last bit can
# round to the neighbouring bf16 value, and over 64 steps such flips grow.
# Each limit sits between the largest reading of the sound kernel and the
# smallest reading of a planted fault, the other matmul precision: on an
# H100 these were 1.9e-4 and 4.3e-3 with f32 products, 1.1e-3 and 3.3e-3
# with bf16 products for the one-block kernels, and 1.6e-4 and 4.3e-3,
# 9.4e-4 and 3.3e-3 for the cluster kernels, whose sums run in another
# order (PERF.md).
TOL = {"float32": 1e-3, "bfloat16": 2e-3}
F32_ULP = 2.0 ** -23
SHARD_T = 512           # steps of the sharded epoch (the prefix region)
SHARDS = 4              # trial slices of the shard-sum identity
# Limits of the sharded checks (normalised error, as in compare), each
# between the sound reading and the smallest planted fault on an H100
# (PERF.md, PR 3). The phase-1 kernel against its plain version: sound
# 6.4e-7 (f32 products) and 1.2e-4 (bf16), the other precision 3.9e-3.
# The shard sum differs from one launch by f32 reordering of the trial
# sums: sound 7.0e-7, the slices at their local inv_b about 3. The sharded
# epoch applies each step in plain PyTorch and takes the state-noise
# residual from the summed statistics, where the single-device epoch runs
# the whole step in the kernel. Over SHARD_T steps, by leaf, the sound
# reading and the other mode's sharded epoch (the planted fault) were:
#                 f32 products          bf16 products
#   loss          1.3e-7 / 7.5e-5       6.1e-6 / 7.6e-5
#   q_means       3.9e-7 / 2.7e-3       1.5e-3 / 2.7e-3
#   w_mean        1.8e-5 / 3.6e-4       6.7e-5 / 3.7e-4
#   cov           3.0e-7 / 3.0e-4       5.6e-5 / 3.1e-4
#   state_logvar  1.8e-7 / 9.8e-5       1.9e-5 / 7.9e-5
# Each limit sits near the geometric mean of its pair, but the bf16
# q_means limit: there an f32 difference in the last bit flips a bf16
# rounding, the sound reading lies within 1.8x of the fault's, and the
# limit keeps a margin above the sound reading only; the other leaves
# reject the fault by 2x or more.
SUMS_TOL = {"float32": 5e-5, "bfloat16": 7e-4}
SHARD_TOL = 1e-4
EPOCH_TOL = {
    "float32": {"loss": 3e-6, "q_means": 3e-5, "w_mean": 8e-5, "cov": 1e-5,
                "state_logvar": 4e-6},
    "bfloat16": {"loss": 2e-5, "q_means": 4e-3, "w_mean": 1.5e-4, "cov": 1.3e-4,
                 "state_logvar": 4e-5},
}
XLA_STEPS = 64          # steps of the autograd epoch against the stepwise kernel epoch
# The autograd epoch (fused_step='off') and the stepwise kernel epoch run
# the same math in f32 with sums in other orders; each leaf's normalised
# error (see compare) must stay under the f32 kernel limit. The planted
# faults (SGD off, decoder update off) leave a trained leaf where it was and
# read about 1.
XLA_TOL = TOL["float32"]
FIT_EPOCHS = 8          # fit.flagship: 2 warm-up epochs, then 3 RLS blocks of 2
# Without forgetting, the flagship's RLS diverges in the 4th to 7th RLS
# epoch after fit's bootstrap, with the prefix or without, kernels and plain
# versions alike (scripts/torch_fit_stability.py); fit.flagship takes
# bench_all.py's.
FIT_FORGET = dict(rls_shrink=0.999, chol_jitter=1e-3)
DEMOTE_T = 64           # fit.demote: steps per epoch
VDP_EPOCHS = 60         # fit.vdp: bench_all.py's max_iter for config #1
SGP_TAU0 = 0.5          # the SGP check state's first-step tau (sgp_check_state)
SGP_SHARD_T = 64        # steps of the sharded SGP epoch
SGP_FIT_EPOCHS, SGP_FIT_T = 6, 1024   # fit.sgp: epochs of T steps, blocks of 2
MASK_T = 1024           # steps of the masked data (mask.*, fit.ragged, sharded.mask)
MASK_DROP = 0.10        # the share of y's entries dropped at random
MASK_DEAD = 8           # channels dead over a contiguous quarter of the masked data
MASK_SHARD_T = 64       # sharded.mask: the masked data's steps around MASK_T * 3 / 4
MASK_FIT_EPOCHS = 6     # fit.ragged: 2 warm-up epochs, then 2 RLS blocks of 2
BACKEND_STEPS = 64      # backends.steps: autograd steps on the card and on the CPU
BACKEND_FIT_T = 300     # backends.fit: the first steps of the Van der Pol data
# backends.steps: the card's autograd epoch against the same epoch on the
# CPU in compare()'s normalised error. At float64 the limit is 1e-8. At
# float32 it is 1e-3 or, where larger, BACKEND_F32_MARGIN times the CPU's
# own float32 rounding on that leaf (the CPU float32 epoch against the CPU
# float64 epoch from the same state; two float32 runs can differ by twice
# that): the precision form's explicit triangular inverse at B 1 moves w
# by 8e-3 between float32 and float64 on the CPU, and by 2.3e-2 between the
# card and the CPU (H100, 700 W). The planted faults move the leaves by 0.1
# to 10.
BACKEND_TOL = {"float32": 1e-3, "float64": 1e-8}
BACKEND_F32_MARGIN = 8.0
# name: (config fields over bench_all.py #1 with rls_backend 'auto' and
# chol_jitter 0, the posterior form it must build, the planted fault)
BACKEND_CASES = {
    "precision.f32": (dict(rls_backend="precision"), "PrecisionBLR", dict(rls_shrink=0.99)),
    "precision.f64": (dict(dtype="float64"), "PrecisionBLR", dict(rls_shrink=0.99)),
    "covariance.f32": ({}, "CovarianceBLR", dict(rls_shrink=0.99)),
    "kalman": (dict(dynamics_update="kalman"), "CovarianceBLR", dict(joseph_quirk=True)),
    "kalman.quirk": (dict(dynamics_update="kalman", joseph_quirk=True), "CovarianceBLR",
                     dict(joseph_quirk=False)),
}
STREAM_T, STREAM_B = 20000, 16   # stream: bench_all.py config #4's steps and trials
STREAM_CHUNK, STREAM_K = 2000, 9  # its chunks and chunks_per_dispatch (1 + 9 chunks)
STREAM_SHORT_CHUNK = 500          # stream.tail and stream.resume: the same widths, shorter
STREAM_TAIL = 37                  # stream.tail: the valid steps of the partial last chunk
FIT_RESUME_T = 1024               # fit.resume: the flagship data's first steps
FACADE_EPOCHS = 40                # facade.vdp: epochs (bench_all.py's config #1 runs 60)
# ensemble.*: the JAX package's ensemble measurement (docs/RESULTS.md:346-357),
# members at the flagship widths, 8 members of 32 trials, T 2000
ENS_N, ENS_B, ENS_T = 8, 32, 2000
ENS_FIT_EPOCHS, ENS_BLOCK_EPOCHS = 4, 6   # 1 warm-up + 3 RLS epochs; 6 in blocks of 2
ENS_SHORT_T = 64                          # ensemble.mixed and ensemble.demote
# ensemble.mixed: the gated autograd epoch against each member's static-flag
# autograd epoch (the same f32 code: a constant gate adds exact zeros and
# selects copy bits), as compare()'s normalised error
ENS_MIXED_TOL = 1e-6
SMOOTH_T = 2048         # smooth.pkalman: steps of an LGSSM at the flagship widths
SMOOTH_TOL = 1e-3       # smooth.pkalman: parallel f32 against the sequential f64 loops
COSMOOTH_T, COSMOOTH_B, COSMOOTH_FOLDS = 300, 256, 5   # scripts/flagship_cosmooth.py
COSMOOTH_MODE_TOL = 1e-3    # bits/spike and R² of the fold loop against the fold batches
COSMOOTH_F64_TOL = 2e-3     # fold 0's bits/spike in f32 against f64 (absolute)
# multi.*: training over ranks. multi.fit: exact-sync fit at world size 1,
# fit.flagship's forgetting, 2 warm-up and 2 RLS epochs of MULTI_T steps
MULTI_T, MULTI_EPOCHS = 256, 4
MULTI_LOSS_RTOL, MULTI_R2 = 1e-2, 0.99   # tests/test_sharding.py:510-547's checks
# multi.sync_every: one relaxed-sync epoch of SYNC_T steps in segments of
# SYNC_K against the segments chained through run_epoch; at one rank the
# merge rebuilds P and V = P^-1 by the floored eigh and sets w = V P w, so
# the relaxed w may differ from the chained one by at most SYNC_W_TOL of the
# epoch's own step in w (chosen before the first run)
SYNC_T, SYNC_K = 1024, 256
SYNC_W_TOL = 0.1
# multi.autograd: exact-sync fit(mesh=...) on the autograd route (the
# precision form at float32, no kernel) at multi.fit's cut, and
# MULTI_XLA_STEPS steps of the sharded autograd epoch (fused_step='off')
# from the post-warm-up state against run_epoch on the same seed, at one
# rank and (multi.world2.autograd, multi.world2.tp) over the (2, 1) and
# (1, 2) meshes. MULTI_XLA_TOL is compare()'s normalised limit: float32,
# the same math summed in another order; it must sit between the sound
# readings and the planted faults' (no SGD, no decoder update)
SHAPE_T = 512           # shapes.*: steps of the warm-up and of each RLS epoch of a main path
SHAPE_SHARD_T = 16      # shapes.*.sharded: sharded steps at each shape, world size 1
# Limits by leaf that replace TOL at one shape, kernel and precision. The bf16
# mega segment at hidden (64, 64, 64, 64): a last-bit difference of the two
# sums' orders flips a bf16 rounding now and then, four tanh layers pass it on
# and 64 steps amplify it in the last posterior's log-variance. On an H100 the
# sound kernel read 2.243e-3 there (every run the same bits; every other leaf
# 4.5e-4 or less) and the other matmul precision 2.724e-3 (PERF.md): the limit
# sits between, and every other leaf keeps TOL. The bf16 phase-1 launch at 512
# inducing points: grad_check, the sum of the ~4,300 gradient entries (only its
# finiteness gates SGD), reads about 5.2, so the entries' own bf16 differences
# (at most 5.4e-4 by leaf on an H100, within TOL) read 5.663e-3 there, where
# the other matmul precision reads 5.802e-2 (PERF.md §6). The bf16 step at
# hidden (32,) x 9: the first layers' gradients vanish through nine tanh
# layers, so one step moves their weights little, and a rounding of one
# updated weight that two versions take apart (their bf16 gradients differ in
# the last bits) is a sizeable share of that move (shapes.depths prints the
# move in ulps where it is smallest); the plain version on the card and on the
# CPU, two sound versions, differ by 4.1e-3 in w_in_y and 4.6e-3 in
# w_hidden.1 there, the kernel reads 8.209e-3 in w_in_y and at most 2.62e-3 in
# the other three, and the other matmul precision 7.86e-3 to 8.65e-3 in
# w_in_lv, w_hidden.0 and w_in_y: the limits of those three sit between,
# w_in_y's above both (every other leaf, within TOL, rejects the other
# precision there). The bf16 mega segments at B 1,024 (w_dyn) and at hidden
# (32,) x 9 (q_mean, q_logvar): their start state comes from a prefix epoch
# whose exact fallback steps (346 and 277 of 512) the fallback kernel
# computes, which rounds otherwise than the library's Cholesky. From that
# start the sound kernel reads 2.189e-3 in w_dyn, 2.462e-3 in q_mean and
# 2.168e-3 in q_logvar (every run the same bits; from the library's start
# w_dyn read 3.781e-4, the other two within TOL). Both bf16 versions are then
# about equally far from float64 (w_dyn 2.425e-3 the kernel, 1.833e-3 the
# plain version, and 2.323e-3, 2.234e-3 from the library's start; q_mean
# 3.267e-3 and q_logvar 2.842e-3 both), so the difference is bf16's own
# rounding. The other matmul precision reads 1.807e-3 in w_dyn, under the
# sound kernel (dyn, 7.787e-3, and q_mean, 2.442e-3, reject it), 3.267e-3 in
# q_mean and 2.838e-3 in q_logvar; a planted fault reads at least 4.19e-2 in
# w_dyn at B 1,024, 1.166e-2 in q_mean and 7.548e-3 in q_logvar at (32,) x 9:
# the limits sit between. check_shape gates each leaf of SHAPE_LIMITS against
# a float64 plain version (vs_float64): the kernel is no farther from it than
# SHAPE_F64_RATIO times the plain bf16 version, 1.05 where the entry names
# none. The two mega entries take 2: the sound kernel read 1.323 times the
# plain version in w_dyn above, and a planted fault that moves w_dyn 4.19e-2
# from the plain version is some 20 times the plain version's 1.833e-3
# (PERF.md §6).
SHAPE_LIMITS = {("h64x4", "mega_epoch", "bfloat16"): {"q_logvar": 2.5e-3},
                ("sgp400", "forward_sums", "bfloat16"): {"grad_check": 1e-2},
                ("h32x9", "fused_step", "bfloat16"): {"w_in_y": 1e-2, "w_in_lv": 5e-3,
                                                      "w_hidden.0": 5e-3, "w_hidden.1": 5e-3},
                ("b1024", "mega_epoch", "bfloat16"): {"w_dyn": 3e-3},
                ("h32x9", "mega_epoch", "bfloat16"): {"q_mean": 2.8e-3, "q_logvar": 2.5e-3}}
SHAPE_F64_RATIO = {("b1024", "mega_epoch", "bfloat16"): 2.0,
                   ("h32x9", "mega_epoch", "bfloat16"): 2.0}
DEPTH_WIDTH = 8         # shapes.depths: the width of each hidden layer
DEPTH_LAYERS = tuple(range(1, 13)) + (16,)  # shapes.depths: on the one-pass instantiation
DEPTH_BF16_STEP_LAYERS = 8  # shapes.depths: the bf16 step gated up to this depth (check_depths)
DEPTH_ON_LAYERS = (9, 12, 16)  # shapes.depths.on: layers of 32 under fused_step='on'
DEPTH_WARM = 64         # shapes.depths: warm-up steps before the comparisons
# shapes.depths off the one-pass instantiation: (trials, n_rbf, the launch's
# plan as (tile_rows, stage_rows, sub_rows)) of a shape on each other route,
# held at DEPTH_ROUTE_LAYERS in f32 (the matmul precision is a flag of the
# launch, not of the instantiation): the tiled one, the L2 route, and the L2
# route at a plan of 8 rows (1024 padded features). 3 and 4 layers are where
# ptxas -O2/-O3 built the kernel before the L2 route wrong (ROADMAP Queue 3),
# 9 the first depth past the layer arrays the layer table replaced
DEPTH_ROUTES = {"tiled": (1024, None, (32, 128, 0)), "l2": (4096, 400, (16, 16, 16)),
                "l2.tile8": (256, 1000, (8, 8, 8))}
DEPTH_ROUTE_LAYERS = (3, 4, 9)
# shapes.plans: one shape for each tile plan (tile_rows, stage_rows,
# sub_rows) of the L2 route that no other phase runs, at the flagship's
# other widths in f32 (xdim 10, Poisson, hidden (32,), B 256) as (ydim,
# n_rbf = padded features, masks: "" / "mask" / "cmask" / "both"); the
# plans come from tests/torch_tile_plan.py and each launch's is checked
PLAN_ROWS = {
    (16, 16, 8): (200, 768, ""), (8, 16, 16): (200, 640, "cmask"),
    (8, 16, 8): (200, 768, "cmask"), (8, 16, 4): (200, 896, ""), (8, 8, 4): (200, 1280, ""),
    (8, 4, 4): (200, 1408, "cmask"), (8, 8, 8): (200, 1024, "both"),
    (4, 128, 16): (2500, 128, ""), (4, 16, 16): (2500, 256, ""),
    (4, 16, 16, "mask"): (2500, 256, "mask"), (4, 32, 4): (2500, 128, "cmask"),
    (4, 16, 4): (200, 896, "cmask"), (4, 8, 8): (200, 1152, "cmask"),
    (4, 4, 8): (2500, 896, ""), (4, 8, 4): (200, 1408, ""), (4, 4, 4): (200, 1664, "cmask"),
}
PLAN_WARM = 4           # shapes.plans: warm-up steps through the kernels
PLAN_STEPS = 8          # shapes.plans: steps of the mega segment held against its plain version
PLAN_TAU0 = 0.5         # shapes.plans: the first step's tau (the weight posterior reset)
MULTI_XLA_STEPS = 64
MULTI_XLA_TOL = 1e-3
# fallback.*: the exact fallback's kernel against its plain version on
# synthetic inputs. Taus on each side of NS_TAU_THRESHOLD, at it and not
# finite; shapes (features as n_rbf or n_inducing, trials, SGP, controls,
# a trial mask); the gates planted: P not positive definite, g (so w) not
# finite, the variance not finite (the pre-step log-variance at 1e30)
FB_TAUS = {"below": 0.2499, "at": 0.25, "above": 0.3, "inf": math.inf, "nan": math.nan}
FB_SHAPES = {"n128.b1": (100, 1, False, 0, False), "n128.b256": (100, 256, False, 0, False),
             "n128.b1024": (100, 1024, False, 0, False),
             "n128.b4096": (100, 4096, False, 0, False),
             "n256.b256": (200, 256, False, 0, False), "n512.b256": (400, 256, False, 0, False),
             "n128.b256.mask_u": (100, 256, False, 2, True),
             "sgp200.b256": (200, 256, True, 0, False)}
FB_GATES = ("not_pd", "w_inf", "var_inf")
FB_MEMBER_TAUS = (0.3, 0.1, math.inf, 0.25, math.nan, 0.2, 0.5, 0.26)
FB_COND = 1e4           # condition number of the synthetic P's real block
# a taken leaf's error against the plain version in float64 may be at most
# FB_RATIO times the plain f32 version's, or FB_RATIO times FB_FLOOR where
# the plain version is within a few ulps of float64 (it cannot be halved)
FB_RATIO = 2.0
FB_FLOOR = 8 * F32_ULP
FB_LEAVES = ("v_mat", "w_dyn", "state_logvar", "dyn_n")
# multi.world2: two processes on one card over gloo, one deadline for both
WORLD2_DEADLINE = 240.0
WORLD2_ENS_EPOCHS = 2        # ensemble.fit's workload cut to 1 warm-up + 1 RLS epoch
WORLD2_SMOOTH_TOL = 1e-4     # smooth_batch over 2 ranks against 1 (normalised, f32)
# one card's published peaks (H100 SXM data sheet, dense): HBM bytes/s,
# FP32 outside the tensor cores, bf16 in them
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
SCAL_COLUMNS = ("loss", "recon", "dyn", "ent", "tau")


T0 = time.perf_counter()


def phase(name: str, /, **fields) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": name, **fields, "t": round(time.perf_counter() - T0, 1)}),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def flagship(matmul_dtype: str = "bfloat16") -> VJFConfig:
    """bench.py's configuration."""
    return VJFConfig(ydim=200, xdim=10, udim=0, n_rbf=100, hidden_sizes=(32,),
                     likelihood="poisson", dtype="float32", rls_backend="nsv",
                     fused_step="auto", fused_epoch="mega", matmul_dtype=matmul_dtype)


def other_precision(mm: str) -> str:
    return "float32" if mm == "bfloat16" else "bfloat16"


def spikes(t: int, b: int, ydim: int, dev, seed: int) -> torch.Tensor:
    """On-device Bernoulli spike counts, rate 0.07 + 0.05 (bench.py:74-77)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.empty((t, b, ydim), device=dev)
    ys = torch.bernoulli(p.fill_(0.07), generator=g)
    ys += torch.bernoulli(p.fill_(0.05), generator=g)
    return ys


def clone(c):
    return c._replace(**{
        k: (v.clone() if isinstance(v, torch.Tensor)
            else tuple(x.clone() for x in v) if isinstance(v, tuple) else v)
        for k, v in c._asdict().items()})


def faults(cfg: VJFConfig, flags: StepFlags) -> dict:
    """Planted faults, as (config, flags) of a kernel launch held against
    the sound plain run: the clipped-SGD update skipped, one layer's update
    skipped, and the products at the other matmul precision. ``compare``
    must reject each."""
    return {"no_sgd": (cfg, dataclasses.replace(flags, sgd=False)),
            "no_decoder_update": (cfg, dataclasses.replace(flags, train_decoder=False)),
            "other_precision": (cfg.replace(matmul_dtype=other_precision(cfg.matmul_dtype)),
                                flags)}


def compare_errs(ref: dict, got: dict, start: dict) -> tuple:
    """``(errs, diffs)`` by leaf: the normalised error and the max abs diff
    of :func:`compare`."""
    errs, diffs = {}, {}
    for k, r in ref.items():
        g = got[k]
        if not r.is_floating_point():
            errs[k] = diffs[k] = 0.0 if torch.equal(r, g) else float("inf")
            continue
        fin = torch.isfinite(r)
        if not (torch.equal(fin, torch.isfinite(g)) and torch.equal(r[~fin], g[~fin])):
            errs[k] = diffs[k] = float("inf")
            continue
        r, g = r[fin].double(), g[fin].double()
        if r.numel() == 0:
            errs[k] = diffs[k] = 0.0
            continue
        d = float((g - r).abs().max())
        size = float(r.abs().max())
        moved = size
        if k in start:
            s = start[k][fin].double()
            size = max(size, float(s.abs().max()))
            moved = float((r - s).abs().max())
        scale = moved + 4 * F32_ULP * size
        errs[k] = d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))
        diffs[k] = d
    return errs, diffs


def compare(name: str, ref: dict, got: dict, tol, start: dict,
            reject: bool = False) -> float:
    """Hold ``got`` (kernel) against ``ref`` (plain) leaf by leaf; return
    the largest max abs diff.

    A leaf's normalised error is max|got - ref| over a scale. For a carry
    leaf (a key of ``start``, its value before the run) the scale is how far
    the plain version moved it, max|ref - start|, so that an update the
    kernel skipped or got wrong counts in full however small the step; for
    an output it is max|ref|. Four f32 ulps of the leaf's size are added for
    the rounding of a value that barely moved. Integer leaves and non-finite
    entries (the inf tau of a skipped step) must match exactly. ``tol`` is
    one limit for every leaf or a limit by leaf. Fails when a leaf's error
    exceeds its limit, or, with ``reject=True`` (a planted fault), when none
    does."""
    errs, diffs = compare_errs(ref, got, start)
    limit = tol if isinstance(tol, dict) else dict.fromkeys(errs, tol)
    worst = max(errs, key=lambda k: errs[k] / limit[k])
    phase(name, tol=tol, max_err=errs[worst], worst_leaf=worst,
          max_abs_err=max(diffs.values()), leaves=len(ref),
          err_by_leaf={k: float(f"{v:.3e}") for k, v in errs.items()})
    over = errs[worst] > limit[worst]
    if reject:
        check(over, f"{name}: planted fault passed (worst {worst} error {errs[worst]:.3e})")
    else:
        check(not over, f"{name}: {worst} error {errs[worst]:.3e} > {limit[worst]:.3e}")
    return max(diffs.values())


def outputs(q_pack: torch.Tensor, scal: torch.Tensor) -> dict:
    """The posterior means and log-variances of q_pack, and scal by column."""
    out = {"q_mean": q_pack.select(-3, 0), "q_logvar": q_pack.select(-3, 1)}
    out.update({c: scal[..., i] for i, c in enumerate(SCAL_COLUMNS)})
    return out


def packed(out: F.PackedStepOut) -> dict:
    return dict(flatten(out.carry._asdict()), **outputs(out.q_pack, out.scal),
                g_vec=out.g_vec, xt=out.xt, xs=out.xs)


def segment(carry, q_pack, scal) -> dict:
    """Every leaf of a mega segment's result, by name."""
    return dict(flatten(carry._asdict()), **outputs(q_pack, scal))


def fallback_of(step_fn):
    """The exact fallback that follows ``step_fn``: the plain version after
    the plain step, the kernel after the kernel (on CUDA tensors)."""
    return F.exact_v_fallback_plain if step_fn is F.fused_step_plain else F.exact_v_fallback


def prefix_step(step_fn, cfg, flags, carry, qm, qlv, y, e_s, e_t, lr):
    """One exact-inverse prefix step: a fused step, then the fallback."""
    prev = carry._replace(dyn_n=carry.dyn_n.clone(), state_logvar=carry.state_logvar.clone())
    out = step_fn(cfg, flags, carry, qm, qlv, y, None, e_s, e_t, lr)
    return fallback_of(step_fn)(cfg, out, prev, None)


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_rng(dev) -> None:
    """The kernel's sampler against the plain Philox of ``ops/rng.py``."""
    seed, count = 12345, 7
    ku1, ku2, keps = F.philox_normals_kernel(seed, count, 256, 20, dev)
    s_t = torch.tensor(seed, device=dev)
    c_t = torch.tensor(count, device=dev)
    pu1, pu2 = rng.uniforms(s_t, c_t, 256, 20)
    peps = rng.normals(s_t, c_t, 256, 20)
    check(torch.equal(ku1, pu1) and torch.equal(ku2, pu2), "rng: uniforms differ")
    rng_err = float((keps - peps).abs().max())
    check(rng_err <= 1e-6, f"rng: normals differ by {rng_err}")
    _, _, big = F.philox_normals_kernel(seed, 0, 1000, 1000, dev)
    mean, var = float(big.double().mean()), float(big.double().var())
    check(abs(mean) < 5e-3 and abs(var - 1) < 7e-3, f"rng: moments {mean} {var}")
    phase("rng", shape=[256, 20], uniforms_bit_identical=True, normals_max_abs_err=rng_err,
          tol=1e-6, mean_1e6=mean, var_1e6=var)


def check_step(post_warm, qm, qlv, y, e_s, e_t, lr) -> float:
    """The per-step kernel plus the exact fallback against the plain step,
    from a state whose tau reaches the fallback, in both matmul modes, and
    the planted faults. Returns the largest max abs diff."""
    flags, err = StepFlags(), 0.0
    for mm in ("float32", "bfloat16"):
        cfg = flagship(mm)
        carry = F.pad_carry(cfg, post_warm)
        start = flatten(carry._asdict())
        args = (qm, qlv, y, e_s, e_t, lr)
        ref = prefix_step(F.fused_step_plain, cfg, flags, clone(carry), *args)
        got = prefix_step(F.fused_step_call, cfg, flags, clone(carry), *args)
        tau = float(ref.scal[0, 4])
        check(tau >= F.NS_TAU_THRESHOLD, f"step: tau {tau} does not reach the fallback")
        err = max(err, compare(f"step[{mm}]", packed(ref), packed(got), TOL[mm], start))
        phase(f"step[{mm}].tau", plain=tau, kernel=float(got.scal[0, 4]))
        for fault, (fcfg, fflags) in faults(cfg, flags).items():
            bad = prefix_step(F.fused_step_call, fcfg, fflags, clone(carry), *args)
            compare(f"step[{mm}].fault.{fault}", packed(ref), packed(bad), TOL[mm], start,
                    reject=True)
    return err


def fallback_case(shape: tuple, taus, dev, seed: int, gate=None):
    """Operands of the exact fallback at ``shape`` (a value of FB_SHAPES:
    features, trials, SGP, controls, trial mask): a step's
    output and the pre-step snapshot, with ``len(taus)`` members stacked
    (one: solo). Member m's state is ``init_state(seed + m)``'s; its P is
    symmetric positive definite with eigenvalues log-spaced over
    [1, FB_COND] in a random basis (one of them -1 under ``gate="not_pd"``),
    the identity on the pad; g is P w for a w of scale 0.1, so the exact w
    is of that scale; V is the inverse perturbed by 1e-3 (the step's
    Newton-Schulz iterate); xs and xt are drawn near the RBF centroids'
    scale. Under a trial mask the masked trials' controls are NaN. Returns
    ``(cfg, out, prev, u, mask)``."""
    nf, b, sgp, ud, masked = shape
    cfg = (sgp_flagship if sgp else flagship)("float32").replace(
        udim=ud, **({"n_inducing": nf} if sgp else {"n_rbf": nf}))
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64

    def randn(*shape_):
        return torch.randn(shape_, device=dev, generator=g, dtype=f64)

    carries, rows = [], []
    for m, tau in enumerate(taus):
        c = F.pad_carry(cfg, core.init_state(seed + m, cfg, device=dev))
        nfp, xd = c.p_mat.shape[-1], cfg.xdim
        q, _ = torch.linalg.qr(randn(nf, nf))
        lam = torch.logspace(0, math.log10(FB_COND), nf, device=dev, dtype=f64)
        if gate == "not_pd":
            lam[nf // 2] = -1.0
        p = torch.eye(nfp, device=dev, dtype=f64)
        p[:nf, :nf] = (q * lam) @ q.T
        p = 0.5 * (p + p.T)
        w = torch.zeros((nfp, xd), device=dev, dtype=f64)
        w[:nf] = 0.1 * randn(nf, xd)
        g_vec = p @ w
        if gate == "w_inf":
            g_vec[0, 0] = math.inf
        xs = 0.7 * randn(b, xd)
        scal = torch.zeros((1, 8), device=dev)
        scal[0, 4] = tau
        carries.append(c._replace(
            p_mat=p.float(), v_mat=(torch.linalg.inv(p) * (1 + 1e-3 * randn(nfp, nfp))).float()
            .contiguous(),
            w_dyn=(w + 1e-3 * randn(nfp, xd)).float(),
            state_logvar=torch.full((1, 1), -1.51, device=dev),
            dyn_n=torch.full((1, 1), 5000.0 + b, device=dev)))
        rows.append((torch.zeros((2, b, xd), device=dev), g_vec.float(), (xs + 0.05 * randn(
            b, xd)).float(), xs.float(), scal))
    one = len(taus) == 1
    carry = carries[0] if one else F.stack_carries(carries)
    out = F.PackedStepOut(carry, *(r[0] if one else torch.stack(r) for r in zip(*rows)))
    lead = carry.dyn_n.shape
    prev = carry._replace(dyn_n=torch.full(lead, 5000.0, device=dev), state_logvar=torch.full(
        lead, 1e30 if gate == "var_inf" else -1.5, device=dev))
    u = mask = None
    if masked:
        mask = (torch.rand(b, device=dev, generator=g) > 0.3).float()
    if ud:
        u = torch.randn((b, ud), device=dev, generator=g)
        if mask is not None:
            u[mask == 0] = math.nan
    return cfg, out, prev, u, mask


def fallback_leaves(out) -> dict:
    return {k: getattr(out.carry, k) for k in FB_LEAVES}


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, in float64."""
    scale = float(ref.double().abs().max())
    d = float((got.double() - ref.double()).abs().max())
    return d / scale if scale > 0 else d


def check_fallback_case(name: str, cfg, out, prev, u, mask, taus, gate=None) -> dict:
    """The fallback kernel against its plain version on one case: two
    kernel runs bit for bit; every carry leaf but the four it may write
    untouched; per member, where the branch is skipped or a gate fails, the
    four leaves' bits unchanged (by the plain version too); where it is
    taken, each leaf's error against the plain version in float64 at most
    FB_RATIO times the plain f32 version's (FB_FLOOR at least). Returns the
    errors by leaf, kernel and plain, over the taken members."""
    def run():
        return F.exact_v_fallback(cfg, out._replace(carry=clone(out.carry)), prev, u, mask=mask)

    kern, again = run(), run()
    plain = F.exact_v_fallback_plain(cfg, out, prev, u, mask)
    ref = F.exact_v_fallback_plain(cfg, as_f64(out), as_f64(prev), None if u is None
                                   else u.double(), mask)
    kc, ac = flatten(kern.carry._asdict()), flatten(again.carry._asdict())
    differ = [k for k in kc if not torch.equal(kc[k], ac[k])]
    check(not differ, f"{name}: two runs differ in {differ}")
    sc = flatten(out.carry._asdict())
    touched = [k for k in kc if k not in FB_LEAVES and not torch.equal(kc[k], sc[k])]
    check(not touched, f"{name}: the kernel wrote {touched}")
    start, K, P, R = (fallback_leaves(x) for x in (out, kern, plain, ref))
    errs = {"kernel": dict.fromkeys(FB_LEAVES, 0.0), "plain": dict.fromkeys(FB_LEAVES, 0.0)}
    taken = []
    for m, tau in enumerate(taus):
        pick = (lambda x: x) if len(taus) == 1 else (lambda x: x[m])
        take = not tau < F.NS_TAU_THRESHOLD
        taken.append(take)
        for k in FB_LEAVES:
            s0, kv, pv = pick(start[k]), pick(K[k]), pick(P[k])
            if not take or gate is not None:
                check(torch.equal(kv, s0) and torch.equal(pv, s0),
                      f"{name}: member {m} {k} moved (tau {tau}, gate {gate})")
                continue
            rv = pick(R[k])
            ek, ep = rel_err(kv, rv), rel_err(pv, rv)
            errs["kernel"][k] = max(errs["kernel"][k], ek)
            errs["plain"][k] = max(errs["plain"][k], ep)
            check(ek <= FB_RATIO * max(ep, FB_FLOOR),
                  f"{name}: member {m} {k} {ek:.3e} from float64, the plain version {ep:.3e}")
        if take and gate is None:
            check(not torch.equal(pick(K["v_mat"]), pick(start["v_mat"])),
                  f"{name}: member {m} taken but V unchanged")
    phase(name, taus=[str(t) for t in taus], taken=taken, gate=gate, deterministic=True,
          err_vs_float64={w: {k: float(f"{v:.3e}") for k, v in e.items()}
                          for w, e in errs.items()})
    return errs


def check_fallback_members(cfg, out, prev, u, mask) -> None:
    """Each member of a stacked fallback launch bit for bit against a solo
    launch of that member."""
    both = F.exact_v_fallback(cfg, out._replace(carry=clone(out.carry)), prev, u, mask=mask)
    differ = []
    for m in range(both.carry.v_mat.shape[0]):
        solo = F.PackedStepOut(clone(F.member_carry(out.carry, m)), *(x[m] for x in out[1:]))
        solo = F.exact_v_fallback(cfg, solo, F.member_carry(prev, m), u, mask=mask)
        differ += [f"{m}.{k}" for k, v in fallback_leaves(solo).items()
                   if not torch.equal(v, getattr(both.carry, k)[m])]
    check(not differ, f"fallback.members_vs_solo: leaves differ: {differ}")


def fallback_ops(cfg, nfp: int, b: int) -> tuple:
    """(operations, bytes) that one taken fallback needs, whatever the
    algorithm: the Cholesky factor of P, one triangular inverse and V = X^T X
    (n^3 / 6 multiply-adds each), w = V g (and w_white w for SGP), the
    residual's features and products; P, g, xs, xt, u and the RBF constants
    read once, V and w written once. The kernel's Newton iterations spend
    some 2 ceil(log2 n) triangular products on the inverse where n^3 / 6
    would do; they are not counted."""
    xd, ud = cfg.xdim, cfg.udim
    sgp = cfg.dynamics == "sgp"
    fma = 3 * nfp ** 3 / 6 + nfp * nfp * xd * (1 + sgp) + b * nfp * (2 * xd + ud)
    read = 2 * nfp * nfp * sgp
    byts = 4 * (2 * nfp * nfp + 2 * nfp * xd + b * (2 * xd + ud) + nfp * (xd + ud + 2) + read)
    return 2 * fma, byts


def fallback_device_us(fn, reps: int) -> float:
    """Device microseconds a launch of the fallback kernel, from the
    profiler's kernel records over ``reps`` calls of ``fn`` (the mean over
    the records it kept: a session can miss one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and "vjf_fallback_kernel" in e.key]
    check(len(ev) == 1 and 0 < ev[0].count <= reps, f"fallback: kernel records {ev}")
    return ev[0].self_device_time_total / ev[0].count


def fallback_times(dev, smi) -> dict:
    """Per call at the flagship (B 256, 1024) and at B 1: the kernel's
    device time skipped and taken, its host time, the plain version's time
    (CUDA events), the library's Cholesky (``cholesky_ex``) on the same P,
    and the taken call's bound."""
    out = {}
    for shape in ("n128.b256", "n128.b1024", "n128.b1"):
        row = {}
        for what, tau in (("skipped", 0.1), ("taken", 0.3)):
            cfg, st, prev, u, mask = fallback_case(FB_SHAPES[shape], (tau,), dev, seed=90)
            run = lambda: F.exact_v_fallback(cfg, st, prev, u, mask=mask)  # noqa: E731
            row[f"{what}_us"] = fallback_device_us(run, 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                run()
            row[f"{what}_host_us"] = 1e6 * (time.perf_counter() - t0) / 20
            torch.cuda.synchronize()
        row["plain_us"] = 1e3 * cuda_ms(lambda: F.exact_v_fallback_plain(cfg, st, prev, u,
                                                                         mask), 10)
        row["library_us"] = 1e3 * cuda_ms(lambda: torch.linalg.cholesky_ex(st.carry.p_mat), 20)
        ops, byts = fallback_ops(cfg, st.carry.p_mat.shape[-1], st.xs.shape[0])
        bnd = bound(cfg, byts, (ops, 0))
        row["bound_us"], row["bound_by"] = 1e3 * bnd[0], bnd[1]
        check(row["skipped_us"] <= 10.0, f"fallback.times[{shape}]: skipped {row['skipped_us']}")
        check(row["taken_us"] < 2000.0, f"fallback.times[{shape}]: taken {row['taken_us']}")
        out[shape] = row
    phase("fallback.times", unit="us per call", **out, card=smi)
    return out


def check_fallback(dev, smi) -> dict:
    """The fallback kernel (``csrc/exact_fallback.cu``) against its plain
    version on synthetic inputs (:func:`fallback_case`): each tau of FB_TAUS
    at the flagship shape, each gate planted at a taken tau, every shape of
    FB_SHAPES taken, 8 stacked members with mixed taus (each member bit for
    bit against its solo launch); then the times. Returns the worst errors
    and the times."""
    worst = {"kernel": 0.0, "plain": 0.0}

    def note(errs):
        for w in worst:
            worst[w] = max(worst[w], max(errs[w].values()))

    for i, (tag, tau) in enumerate(FB_TAUS.items()):
        note(check_fallback_case(f"fallback.tau[{tag}]", *fallback_case(
            FB_SHAPES["n128.b256"], (tau,), dev, 100 + i), (tau,)))
    for i, gate in enumerate(FB_GATES):
        note(check_fallback_case(f"fallback.gate[{gate}]", *fallback_case(
            FB_SHAPES["n128.b256"], (0.3,), dev, 110 + i, gate=gate), (0.3,), gate=gate))
    for i, shape in enumerate(FB_SHAPES):
        note(check_fallback_case(f"fallback.shape[{shape}]", *fallback_case(
            FB_SHAPES[shape], (0.3,), dev, 120 + i), (0.3,)))
    case = fallback_case(FB_SHAPES["n128.b256"], FB_MEMBER_TAUS, dev, 140)
    note(check_fallback_case("fallback.members", *case, FB_MEMBER_TAUS))
    check_fallback_members(*case)
    phase("fallback.members_vs_solo", members=len(FB_MEMBER_TAUS), bit_identical=True)
    return {"worst": worst, "times": fallback_times(dev, smi)}


def check_mega(name, cfg, flags, carry, qm, qlv, ys, e_s, e_t, lr, planted=True):
    """``mega_epoch`` against its plain loop from ``carry`` (left as it
    was), and, with ``planted``, the planted faults. Returns the largest max
    abs diff and the plain and kernel results."""
    start = flatten(carry._asdict())
    args = (qm, qlv, ys, None, e_s, e_t, lr)
    ref = F.mega_epoch_plain(cfg, flags, clone(carry), *args)
    got = F.mega_epoch_call(cfg, flags, clone(carry), *args)
    tol = TOL[cfg.matmul_dtype]
    err = compare(name, segment(*ref), segment(*got), tol, start)
    for fault, (fcfg, fflags) in (faults(cfg, flags).items() if planted else ()):
        bad = F.mega_epoch_call(fcfg, fflags, clone(carry), *args)
        compare(f"{name}.fault.{fault}", segment(*ref), segment(*bad), tol, start, reject=True)
    return err, ref, got


def check_escalation(dev) -> None:
    """The forgetting config of tests/test_fused_step.py through
    run_epoch_fused, kernel (CUDA) against plain (CPU); its tau must reach
    an escalation band."""
    esc = VJFConfig(ydim=14, xdim=2, udim=2, n_rbf=16, hidden_sizes=(16, 8),
                    likelihood="gaussian", dtype="float32", rls_backend="nsv",
                    fused_step="on", matmul_dtype="float32", ns_prefix=20,
                    rls_shrink=0.99, chol_jitter=1e-3)
    g = torch.Generator().manual_seed(3)
    e_ys, e_us = torch.randn(60, 8, 14, generator=g), torch.randn(60, 8, 2, generator=g)
    e_eps = torch.randn(2, 60, 8, 2, generator=g)
    e_state = core.init_state(0, esc, device="cpu")
    flags = StepFlags()
    ref = core.run_epoch(esc, flags, e_state, e_ys, e_us, 0, 1e-3, noise=(e_eps[0], e_eps[1]))
    got = core.run_epoch(esc, flags, core.init_state(0, esc, device=dev), e_ys.to(dev),
                         e_us.to(dev), 0, 1e-3, noise=(e_eps[0].to(dev), e_eps[1].to(dev)))
    tau = got.metrics.tau[esc.ns_prefix:].cpu()
    bands = {"lt_0.05": int((tau < 0.05).sum()),
             "0.05_0.25": int(((tau >= 0.05) & (tau < 0.25)).sum()),
             "0.25_0.7": int(((tau >= 0.25) & (tau < 0.7)).sum()),
             "skipped": int((~(tau < 0.7)).sum())}
    check(bands["0.05_0.25"] + bands["0.25_0.7"] > 0, f"escalation never ran: {bands}")

    def state_leaves(st):
        blr = st.dynamics.blr
        return {k: v.detach().cpu() for k, v in (
            ("w_mean", blr.w_mean), ("precision", blr.precision), ("cov", blr.cov),
            ("state_logvar", st.dynamics.logvar), ("lik_logvar", st.params.likelihood.logvar),
            ("w_dec", st.params.decoder.weight))}

    def result(r):
        return {"loss": r.metrics.loss.cpu(), "q_means": r.q_means.cpu(), **state_leaves(r.state)}

    start = state_leaves(e_state)
    compare("mega.escalation", result(ref), result(got), TOL["float32"], start)
    phase("mega.escalation.bands", steps=60 - esc.ns_prefix, **bands)


def check_deterministic(cfg, flags, carry, qm, qlv, ys, lr) -> None:
    """Two mega launches from clones of one carry (in-kernel noise) give the
    same bits on every leaf: the cluster's sums are taken in rank order, with
    no atomics."""
    runs = [segment(*F.mega_epoch_call(cfg, flags, clone(carry), qm, qlv, ys, None, None, None,
                                       lr)) for _ in range(2)]
    differ = [k for k, v in runs[0].items() if not torch.equal(v, runs[1][k])]
    check(not differ, f"mega.deterministic: leaves differ between two runs: {differ}")
    phase("mega.deterministic", steps=ys.shape[0], leaves=len(runs[0]), bit_identical=True)


def check_ragged(dev) -> None:
    """The mega kernel and the phase-1 kernel against their plain versions
    at batch sizes the cluster does not divide (some blocks own fewer
    trials) and below the cluster's size (some own none): small widths,
    controls, two hidden layers, f32 products. The state log-variance and
    its count are set so that tau stays below NS_TAU_MAX on most steps and
    the Newton-Schulz update runs."""
    cfg = VJFConfig(ydim=14, xdim=2, udim=2, n_rbf=16, hidden_sizes=(16, 8),
                    likelihood="gaussian", dtype="float32", rls_backend="nsv",
                    fused_step="on", matmul_dtype="float32")
    flags, steps = StepFlags(), 8
    size = F.cluster_size()
    for b in (250, 5):
        check(b % size != 0, f"mega.ragged: {size} blocks divide {b}")
        g = torch.Generator(device=dev).manual_seed(b)
        ys = torch.randn((steps, b, cfg.ydim), device=dev, generator=g)
        us = torch.randn((steps, b, cfg.udim), device=dev, generator=g)
        eps = torch.randn((2, steps, b, cfg.xdim), device=dev, generator=g)
        q = 0.3 * torch.randn((2, b, cfg.xdim), device=dev, generator=g)
        lr = torch.tensor(1e-2, device=dev)
        carry = F.pad_carry(cfg, core.init_state(0, cfg, device=dev))
        carry = carry._replace(
            state_logvar=torch.full_like(carry.state_logvar, math.log(8.0 * b)),
            dyn_n=torch.full_like(carry.dyn_n, 1e6))
        start = flatten(carry._asdict())
        args = (q[0].contiguous(), q[1].contiguous(), ys, us, eps[0], eps[1], lr)
        ref = F.mega_epoch_plain(cfg, flags, clone(carry), *args)
        got = F.mega_epoch_call(cfg, flags, clone(carry), *args)
        tau = got[2][:, 4]
        check(int((tau < F.NS_TAU_MAX).sum()) >= steps // 2,
              f"mega.ragged[B={b}]: most steps skipped the update (tau {tau.tolist()})")
        compare(f"mega.ragged[B={b}]", segment(*ref), segment(*got), TOL["float32"], start)
        sums_args = (args[0], args[1], ys[0], us[0], eps[0, 0], eps[1, 0], 1.0 / (2 * b), 3)
        compare(f"mega.ragged[B={b}].forward_sums",
                sums_leaves(*F.forward_sums_plain(cfg, flags, carry, *sums_args), carry),
                sums_leaves(*F.forward_sums_call(cfg, flags, carry, *sums_args), carry),
                SUMS_TOL["float32"], {})
        phase(f"mega.ragged[B={b}].split", cluster=size,
              trials_by_block=[len(F.cluster_rows(r, b)) for r in range(size)],
              updated_steps=int((tau < F.NS_TAU_MAX).sum()), steps=steps)


def sums_leaves(flat: torch.Tensor, q_pack: torch.Tensor, carry, has_cm: bool = False) -> dict:
    """Every leaf of a flat FusedSums buffer by name (``cm_sum`` with a
    channel mask), and the q pack."""
    return dict(flatten(F.unpack_sums(flat, carry, has_cm)._asdict()),
                q_mean=q_pack[0], q_logvar=q_pack[1])


def check_forward_sums(post_warm, qm, qlv, y, e_s, e_t) -> float:
    """The phase-1 kernel against its plain version from a post-warm-up
    state with the global inv_b, in both matmul modes, and the planted
    faults (the kernel at the other precision, SGD off in the kernel only).
    Each leaf's error is normalised by its size. Returns the largest max
    abs diff."""
    flags, err = StepFlags(), 0.0
    args = (qm, qlv, y, None, e_s, e_t, 1.0 / y.shape[0])
    for mm in ("float32", "bfloat16"):
        cfg = flagship(mm)
        carry = F.pad_carry(cfg, post_warm)
        before = {k: v.clone() for k, v in flatten(carry._asdict()).items()}
        ref = sums_leaves(*F.forward_sums_plain(cfg, flags, carry, *args), carry)
        got = sums_leaves(*F.forward_sums_call(cfg, flags, carry, *args), carry)
        check(all(torch.equal(v, before[k]) for k, v in flatten(carry._asdict()).items()),
              "forward_sums: the kernel changed the carry")
        err = max(err, compare(f"sharded.forward_sums[{mm}]", ref, got, SUMS_TOL[mm], {}))
        planted = {"other_precision": (cfg.replace(matmul_dtype=other_precision(mm)), flags),
                   "no_sgd": (cfg, dataclasses.replace(flags, sgd=False))}
        for fault, (fcfg, fflags) in planted.items():
            bad = sums_leaves(*F.forward_sums_call(fcfg, fflags, carry, *args), carry)
            compare(f"sharded.forward_sums[{mm}].fault.{fault}", ref, bad, SUMS_TOL[mm], {},
                    reject=True)
    return err


def check_shard_sum(cfg, post_warm, qm, qlv, y) -> None:
    """Linearity the all-reduce relies on: the kernel on SHARDS trial slices
    with the global inv_b and their row offsets (in-kernel Philox noise),
    summed, against one launch on all the trials. The slices' posteriors
    must match the whole batch's bit for bit. Planted fault: each slice at
    its local inv_b."""
    flags, b = StepFlags(), y.shape[0]
    n = b // SHARDS
    carry = F.pad_carry(cfg, post_warm)
    whole, q_whole = F.forward_sums_call(cfg, flags, carry, qm, qlv, y, None, None, None, 1.0 / b)
    ref = sums_leaves(whole, q_whole, carry)

    def summed(inv_b):
        parts = [F.forward_sums_call(cfg, flags, carry, qm[i * n:(i + 1) * n],
                                     qlv[i * n:(i + 1) * n], y[i * n:(i + 1) * n], None, None,
                                     None, inv_b, row0=i * n) for i in range(SHARDS)]
        q_cat = torch.cat([q for _, q in parts], dim=1)
        return sums_leaves(sum(f for f, _ in parts), q_cat, carry)

    got = summed(1.0 / b)
    check(torch.equal(got["q_mean"], ref["q_mean"]) and torch.equal(got["q_logvar"],
                                                                    ref["q_logvar"]),
          "shard_sum: the slices' posteriors differ")
    compare("sharded.shard_sum", ref, got, SHARD_TOL, {})
    compare("sharded.shard_sum.fault.local_inv_b", ref, summed(1.0 / n), SHARD_TOL, {},
            reject=True)


def epoch_leaves(res) -> dict:
    blr = res.state.dynamics.blr
    return {"loss": res.metrics.loss, "q_means": res.q_means, "w_mean": blr.w_mean,
            "cov": blr.cov, "state_logvar": res.state.dynamics.logvar}


def check_sharded_epoch(cfg, post_warm, ys, us, lr, qm, qlv, smi, sgp_args,
                        mask_data) -> tuple:
    """The sharded epoch at world size 1 over NCCL: SHARD_T RLS-active steps
    from the post-warm-up state in both matmul modes, each held against the
    single-device stepwise epoch (same seed, in-kernel noise), and the
    per-step split. The run of ``cfg`` (the flagship's bf16 products) is
    the main path. Planted fault: the other mode's sharded epoch. Returns
    the phase-1 kernel's launches and timesteps in the main path. Then, in
    the same group, SGP_SHARD_T sharded SGP steps from ``sgp_args`` (its
    config and :func:`sgp_check_state`) against the single-device stepwise
    epoch: the phase-1 kernel's launches on the SGP path. Then ``sharded.mask``:
    MASK_SHARD_T steps of the masked data (:func:`masked_data`, both masks,
    NaN padding) around 3/4 of it, where about half the trials have ended,
    sharded against the masked single-device stepwise epoch: the phase-1
    kernel's launches on the masked path."""
    dev = ys.device
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = make_dp_group()
        ys_e, us_e, flags = ys[:SHARD_T], us[:SHARD_T], StepFlags()
        # NCCL sets up its communicator at the first collective: not timed
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
        got, ref = {}, {}
        for mm in (cfg.matmul_dtype, other_precision(cfg.matmul_dtype)):
            c = cfg.replace(matmul_dtype=mm)
            torch.cuda.synchronize()
            F.reset_launches()
            t0 = time.perf_counter()
            got[mm] = run_epoch_fused_sharded(c, flags, post_warm, ys_e, us_e, 21, lr, group)
            torch.cuda.synchronize()
            if mm == cfg.matmul_dtype:
                secs = time.perf_counter() - t0
                launches, timesteps = dict(F.launches), dict(F.steps)
            ref[mm] = core.run_epoch(c.replace(fused_epoch="stepwise"), flags, post_warm, ys_e,
                                     us_e, 21, lr)
        check(launches == {**dict.fromkeys(F.launches, 0), "forward_sums": SHARD_T},
              f"sharded: launches {launches}")
        loss = got[cfg.matmul_dtype].metrics.loss
        q = got[cfg.matmul_dtype].q_means
        check(bool(torch.isfinite(loss).all()) and tuple(q.shape) == (
            SHARD_T, ys.shape[1], cfg.xdim) and bool(torch.isfinite(q).all()),
            "sharded: loss or posterior not finite")
        fired = int((ref[cfg.matmul_dtype].metrics.tau >= F.NS_TAU_THRESHOLD).sum())
        check(fired > 0, "sharded: the exact fallback never fired")
        blr = post_warm.dynamics.blr
        start = {"w_mean": blr.w_mean, "cov": blr.cov, "state_logvar": post_warm.dynamics.logvar}
        errs = {}
        for mm in got:
            r = epoch_leaves(ref[mm])
            errs[mm] = compare(f"sharded.epoch[{mm}]", r, epoch_leaves(got[mm]), EPOCH_TOL[mm],
                               start)
            compare(f"sharded.epoch[{mm}].fault.other_precision", r,
                    epoch_leaves(got[other_precision(mm)]), EPOCH_TOL[mm], start, reject=True)

        # the per-step split, from the post-warm-up state
        b = ys.shape[1]
        carry = F.pad_carry(cfg, post_warm)
        y = ys[-1]

        def k_sums():
            return F.forward_sums_call(cfg, flags, carry, qm, qlv, y, None, None, None, 1.0 / b)

        flat, _ = k_sums()
        sums = F.unpack_sums(flat, carry)
        new, scal, g_vec = F.step_apply(cfg, flags, carry, sums, lr, b)
        split = {
            "forward_sums_kernel": cuda_ms(k_sums, 20),
            "all_reduce": cuda_ms(lambda: dist.all_reduce(flat, group=group), 20),
            "step_apply_plain": cuda_ms(lambda: F.step_apply(cfg, flags, carry, sums, lr, b), 20),
            "exact_v_fallback_sums": cuda_ms(lambda: F.exact_v_fallback_sums(
                cfg, new, carry, sums, g_vec, scal.tau[0, 0], b), 20),
        }
        phase("sharded.epoch", world_size=1, backend="nccl", steps=SHARD_T, seconds=secs,
              steps_per_s=SHARD_T / secs, max_abs_err=errs[cfg.matmul_dtype], fallback_steps=fired,
              loss_first_last=[float(loss[0]), float(loss[-1])], launches=launches,
              split_us_per_step={k: 1e3 * v for k, v in split.items()}, card=smi)

        s_cfg, s_state = sgp_args
        ys_s, us_s = ys[:SGP_SHARD_T], us[:SGP_SHARD_T]
        torch.cuda.synchronize()
        F.reset_launches()
        s_got, s_secs = synced(lambda: run_epoch_fused_sharded(s_cfg, flags, s_state, ys_s, us_s,
                                                               31, lr, group))
        s_launches = dict(F.launches)
        s_ref = core.run_epoch(s_cfg.replace(fused_epoch="stepwise"), flags, s_state, ys_s, us_s,
                               31, lr)
        check(s_launches == {**dict.fromkeys(F.launches, 0), "forward_sums": SGP_SHARD_T},
              f"sgp.sharded: launches {s_launches}")
        blr = s_state.dynamics.blr
        s_err = compare("sgp.sharded.epoch", epoch_leaves(s_ref), epoch_leaves(s_got),
                        EPOCH_TOL[s_cfg.matmul_dtype],
                        {"w_mean": blr.w_mean, "cov": blr.cov,
                         "state_logvar": s_state.dynamics.logvar})
        check(torch.equal(s_got.state.dynamics.whiten, s_state.dynamics.whiten),
              "sgp.sharded: the whitener moved")
        phase("sgp.sharded.times", steps=SGP_SHARD_T, seconds=s_secs,
              steps_per_s=SGP_SHARD_T / s_secs, launches=s_launches, max_abs_err=s_err,
              fallback_steps=int((s_ref.metrics.tau >= F.NS_TAU_THRESHOLD).sum()), card=smi)

        m_ys, _, m_mask, m_cm, _ = mask_data
        mid = 3 * m_ys.shape[0] // 4
        rows = slice(mid - MASK_SHARD_T // 2, mid + MASK_SHARD_T // 2)
        m_args = (m_ys[rows], us[:MASK_SHARD_T], 41, lr)
        m_kw = dict(mask=m_mask[rows], channel_mask=m_cm[rows])
        torch.cuda.synchronize()
        F.reset_launches()
        m_got, m_secs = synced(lambda: run_epoch_fused_sharded(cfg, flags, post_warm, *m_args,
                                                               group, **m_kw))
        m_launches = dict(F.launches)
        m_ref = core.run_epoch(cfg.replace(fused_epoch="stepwise"), flags, post_warm, *m_args,
                               **m_kw)
        check(m_launches == {**dict.fromkeys(F.launches, 0), "forward_sums": MASK_SHARD_T},
              f"sharded.mask: launches {m_launches}")
        blr = post_warm.dynamics.blr
        m_err = compare("sharded.mask", epoch_leaves(m_ref), epoch_leaves(m_got),
                        EPOCH_TOL[cfg.matmul_dtype],
                        {"w_mean": blr.w_mean, "cov": blr.cov,
                         "state_logvar": post_warm.dynamics.logvar})
        phase("sharded.mask.times", steps=MASK_SHARD_T, seconds=m_secs,
              steps_per_s=MASK_SHARD_T / m_secs, launches=m_launches, max_abs_err=m_err,
              valid_share=float(m_mask[rows].mean()),
              fallback_steps=int((m_ref.metrics.tau >= F.NS_TAU_THRESHOLD).sum()), card=smi)
        return (launches["forward_sums"], timesteps["forward_sums"], s_launches["forward_sums"],
                SGP_SHARD_T, m_launches["forward_sums"], MASK_SHARD_T)
    finally:
        dist.destroy_process_group()


def state_leaves(state) -> dict:
    """A state's leaves as CPU copies, by name."""
    return {k: torch.as_tensor(v).clone() for k, v in flatten(state_to_numpy(state)).items()}


def trained_leaves(state) -> dict:
    """The state leaves each update moves: RLS, state noise, first layer,
    decoder."""
    p, d = state.params, state.dynamics
    return {"w_mean": d.blr.w_mean, "cov": d.blr.cov, "state_logvar": d.logvar,
            "w_in": p.recognition.layers[0].weight, "w_dec": p.decoder.weight}


def xla_leaves(res) -> dict:
    """The leaves the autograd-vs-kernel check holds: outputs and
    :func:`trained_leaves`."""
    return {"loss": res.metrics.loss, "q_means": res.q_means, **trained_leaves(res.state)}


def synced(fn):
    """``fn()`` and its seconds on the host clock, the device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_xla(cfg, post_warm, ys, us, lr, smi, steps: int = XLA_STEPS) -> None:
    """The autograd epoch (``fused_step='off'``: ``filter_step`` per step,
    products in full f32) against the stepwise kernel epoch
    (``fused_epoch='stepwise'``: the per-step kernel with NS_ITERS and the
    exact fallback at tau >= 0.25, the same math) from the post-warm-up
    state, injected noise, f32 products; the planted faults (the autograd
    epoch with SGD off, with the decoder update off) must be rejected."""
    dev = ys.device
    g = torch.Generator(device=dev).manual_seed(4)
    eps = torch.randn((2, steps, ys.shape[1], cfg.xdim), device=dev, generator=g)
    ys, us, flags = ys[:steps], us[:steps], StepFlags()

    def epoch(c, fl):
        return synced(lambda: core.run_epoch(c, fl, post_warm, ys, us, 0, lr,
                                             noise=(eps[0], eps[1])))

    kernel, k_s = epoch(cfg.replace(fused_epoch="stepwise"), flags)
    auto = cfg.replace(fused_step="off")
    xla, x_s = epoch(auto, flags)
    check(kernel.metrics.tau is not None and xla.metrics.tau is None,
          "xla.vs_kernel: the routes were not the kernel and the autograd step")
    fired = int((kernel.metrics.tau >= F.NS_TAU_THRESHOLD).sum())
    ref, start = xla_leaves(kernel), trained_leaves(post_warm)
    err = compare("xla.vs_kernel", ref, xla_leaves(xla), XLA_TOL, start)
    for fault, fl in {"no_sgd": dataclasses.replace(flags, sgd=False),
                      "no_decoder_update": dataclasses.replace(flags, train_decoder=False)
                      }.items():
        compare(f"xla.vs_kernel.fault.{fault}", ref, xla_leaves(epoch(auto, fl)[0]), XLA_TOL,
                start, reject=True)
    phase("xla.vs_kernel.times", steps=steps, tol=XLA_TOL, max_abs_err=err,
          fallback_steps=fired, autograd_us_per_step=1e6 * x_s / steps,
          stepwise_kernel_us_per_step=1e6 * k_s / steps, card=smi)


@contextlib.contextmanager
def watched(name: str):
    """``core.<name>`` (``run_epoch`` or ``run_epochs``) wrapped for the
    duration: each call is timed with the device synchronised and logged
    with its route, its prefix, its phase and whether the state it was
    given is bit-identical afterwards. Yields the log."""
    real = getattr(core, name)
    log = []

    def call(cfg, flags, state, *args, **kw):
        before = state_leaves(state)
        res, secs = synced(lambda: real(cfg, flags, state, *args, **kw))
        after = state_leaves(state)
        fused = F.fused_enabled(cfg, state, n_batch=args[0].shape[1])
        entry = {"route": "fused" if fused else "autograd", "fused_step": cfg.fused_step,
                 "ns_prefix": cfg.ns_prefix, "warm_up": flags.warm_up, "seconds": secs,
                 "input_intact": all(torch.equal(before[k], after[k]) for k in before),
                 "input": before}
        if name == "run_epochs":
            entry.update(epochs=len(args[2]), loss=res.epoch_loss.tolist(),
                         max_tau=float(res.max_tau.max()), hot_frac=float(res.hot_frac.max()))
        log.append(entry)
        return res

    setattr(core, name, call)
    try:
        yield log
    finally:
        setattr(core, name, real)


@contextlib.contextmanager
def timed(name: str):
    """``core.<name>`` wrapped for the duration: each call's seconds, the
    device synchronised. Yields the list."""
    real = getattr(core, name)
    secs = []

    def call(*args, **kw):
        out, s = synced(lambda: real(*args, **kw))
        secs.append(s)
        return out

    setattr(core, name, call)
    try:
        yield secs
    finally:
        setattr(core, name, real)


def blocks_summary(log, t_len: int) -> list:
    return [{k: v for k, v in e.items() if k != "input"}
            | {"steps_per_s": e["epochs"] * t_len / e["seconds"]} for e in log]


def check_fit_flagship(cfg, ys, smi, max_iter: int = FIT_EPOCHS) -> dict:
    """``fit`` at the flagship width in blocked mode (2 epochs a dispatch,
    warm-up forced to end after 2 epochs) with ``bench_all.py``'s forgetting
    (``FIT_FORGET``): the blocks' times with and without the exact-inverse
    prefix, where prefix-free continuation engaged, bench.py's asserts, and
    both fused kernels launched. Returns the launches."""
    cfg = cfg.replace(warmup_max=2, **FIT_FORGET)
    state = core.init_state(0, cfg, device=ys.device)
    with watched("run_epochs") as log, timed("_bootstrap_dynamics") as boot:
        F.reset_launches()
        res, secs = synced(lambda: core.fit(cfg, state, ys, seed=7, max_iter=max_iter,
                                            epochs_per_dispatch=2))
        launches = dict(F.launches)
    t_len = ys.shape[0]
    blocks = blocks_summary(log, t_len)
    rls = [b for b in blocks if not b["warm_up"]]
    check(all(b["input_intact"] for b in blocks), "fit.flagship: a block wrote its input state")
    check(math.isfinite(res.loss), f"fit.flagship: loss {res.loss}")
    check(not res.warm_up and rls, "fit.flagship: warm-up never ended")
    max_tau = max(b["max_tau"] for b in rls)
    hot = max(b["hot_frac"] for b in rls)
    check(max_tau < 0.7, f"fit.flagship: Newton-Schulz never contracted (tau={max_tau})")
    check(hot < 0.01, f"fit.flagship: dropped {100 * hot:.1f}% of RLS updates")
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0,
          f"fit.flagship: launches {launches}")
    with_prefix = [b for b in rls if b["ns_prefix"] > 0]
    free = [i for i, b in enumerate(blocks) if not b["warm_up"] and b["ns_prefix"] == 0]
    phase("fit.flagship", config="bench.py flagship, B %d, T %d, 2 epochs a block, "
          "rls_shrink 0.999, chol_jitter 1e-3" % (ys.shape[1], t_len), seconds=secs,
          epochs_run=res.epochs_run,
          warm_up_epochs=sum(b["epochs"] for b in blocks if b["warm_up"]),
          prefix_free_from_block=free[0] if free else None,
          rls_steps_per_s_with_prefix=[b["steps_per_s"] for b in with_prefix],
          rls_steps_per_s_prefix_free=[blocks[i]["steps_per_s"] for i in free],
          bootstrap_s=boot, loss=res.loss, max_tau=max_tau, hot_frac=hot, launches=launches,
          blocks=blocks,
          card=smi)
    return launches


def check_fit_demote(cfg, ys, smi, t_len: int = DEMOTE_T) -> None:
    """A per-epoch ``fit`` (flagship widths, short epochs) whose hot-tau
    threshold lies below 0: the first RLS epoch demotes and re-runs on the
    autograd route from its backup, which must be the intact pre-epoch
    state; ``repromote_after`` epochs later the mega layout is probed again
    (and demotes again)."""
    cfg = cfg.replace(demote_hot_frac=-1.0, ns_prefix=16, warmup_max=2, repromote_after=2)
    state = core.init_state(1, cfg, device=ys.device)
    with watched("run_epoch") as log:
        res, secs = synced(lambda: core.fit(cfg, state, ys[:t_len], seed=8, max_iter=5))
    routes = [("warm-up " if e["warm_up"] else "") + e["route"] for e in log]
    want = ["warm-up fused", "warm-up fused", "fused", "autograd", "autograd", "fused",
            "autograd"]
    check(routes == want, f"fit.demote: routes {routes}, expected {want}")
    check(all(e["input_intact"] for e in log), "fit.demote: an epoch wrote its input state")
    for i in (3, 6):   # each demoted re-run starts from the demoted epoch's input
        a, b = log[i - 1]["input"], log[i]["input"]
        check(all(torch.equal(a[k], b[k]) for k in a), f"fit.demote: backup {i} differs")
    check(math.isfinite(res.loss), f"fit.demote: loss {res.loss}")
    auto = [e["seconds"] for e in log if e["route"] == "autograd"]
    phase("fit.demote", steps_per_epoch=t_len, routes=routes, backup_intact=True, seconds=secs,
          autograd_us_per_step=[1e6 * s / t_len for s in auto],
          fused_epoch_s=[e["seconds"] for e in log if e["route"] == "fused"], card=smi)


def quality_problem(name: str, draw: int = 1):
    """``bench_all.py``'s config #1 (``van_der_pol``), #2 (``lorenz``) or
    #3 (``sgp_ring``: sparse-GP dynamics on the ring attractor, z-scored
    Gaussian observations of observation draw ``draw``; the reference fits
    draws 1 and 7): ``(cfg, y (T, ydim) float32, x_true (T, xdim))``."""
    if name == "sgp_ring":
        x = datasets.ring_attractor(T=1000)
        y, _, _ = datasets.linear_gaussian_observations(x, 20, obs_noise=0.1, seed=draw)
        y = (y - y.mean(0)) / y.std(0)
        cfg = VJFConfig(ydim=20, xdim=2, udim=0, dynamics="sgp", n_inducing=50,
                        sgp_scale=1.0, sgp_lengthscale=1.0, likelihood="gaussian",
                        dtype="float32", lr=1e-3, rtol=2e-3, warmup_max=30,
                        rls_shrink=0.999, chol_jitter=1e-3)
        return cfg, y.astype(np.float32), x
    if name == "van_der_pol":
        x = datasets.van_der_pol(T=1200)
        x = (x - x.mean(0)) / x.std(0)
        r = np.random.default_rng(1)
        c = r.normal(size=(2, 20))
        y = x @ c + r.normal(size=(20,)) + 0.1 * r.normal(size=(1200, 20))
        cfg = VJFConfig(ydim=20, xdim=2, udim=0, n_rbf=100, hidden_sizes=(20,),
                        likelihood="gaussian", dtype="float32", rls_backend="nsv",
                        lr=3e-3, rtol=2e-3, rls_shrink=0.999, chol_jitter=1e-3)
        return cfg, y.astype(np.float32), x
    x = datasets.lorenz(T=1500)
    x = (x - x.mean(0)) / x.std(0)
    r = np.random.default_rng(2)
    c = r.normal(size=(3, 50)) * 0.4
    y = r.poisson(np.exp(np.clip(x @ c + 0.5, -4, 3))).astype(np.float32)
    cfg = VJFConfig(ydim=50, xdim=3, udim=0, n_rbf=100, hidden_sizes=(32,),
                    likelihood="poisson", dtype="float32", rls_backend="nsv",
                    lr=2e-3, rtol=2e-3, rls_shrink=0.999, chol_jitter=1e-3)
    return cfg, y, x


def fit_quality(cfg, y, x_true, dev, max_iter: int, seed: int = 0, horizon: int = 20) -> dict:
    """``bench_all.py:_fit_throughput`` through the port: ``fit`` in blocks
    of 5 epochs, then latent R^2 and the 20-step forecast RMSE beside
    persistence, and each dispatch's route, prefix and time."""
    state = core.init_state(seed, cfg, device=dev)
    with watched("run_epochs") as log:
        res, wall = synced(lambda: core.fit(cfg, state, y, seed=seed, max_iter=max_iter,
                                            epochs_per_dispatch=5))
    mu = res.mu[:, 0, :]
    m_rmse, p_rmse = forecast_rmse(cfg, res.state, mu, y, seed, horizon=horizon)
    blocks = blocks_summary(log, y.shape[0])
    free = [i for i, b in enumerate(blocks) if not b["warm_up"] and b["ns_prefix"] == 0]
    return {"wall_s": wall, "epochs_run": res.epochs_run,
            "steps_per_s": y.shape[0] * res.epochs_run / wall, "final_loss": res.loss,
            "latent_r2": latent_r2(mu, x_true), "forecast_rmse": m_rmse,
            "persistence_rmse": p_rmse,
            "demoted_blocks": sum(b["fused_step"] == "off" for b in blocks),
            "prefix_free_from_block": free[0] if free else None, "blocks": blocks}


def check_fit_vdp(dev, smi, max_iter: int = VDP_EPOCHS) -> None:
    """``bench_all.py``'s Van der Pol fit (B 1, Gaussian) through the port's
    ``fit``: its forecast must beat persistence."""
    cfg, y, x = quality_problem("van_der_pol")
    out = fit_quality(cfg, y, x, dev, max_iter)
    check(out["forecast_rmse"] < out["persistence_rmse"],
          f"fit.vdp: forecast RMSE {out['forecast_rmse']} >= persistence "
          f"{out['persistence_rmse']}")
    phase("fit.vdp", config="bench_all.py #1 van_der_pol_gaussian, T 1200, B 1",
          max_iter=max_iter, **out, card=smi)


def sgp_flagship(matmul_dtype: str = "bfloat16") -> VJFConfig:
    """The flagship widths with sparse-GP dynamics: 100 inducing points
    (padded to 128, as n_rbf) and an SE lengthscale of sqrt(10), the scale
    of the 10-dimensional latents."""
    return flagship(matmul_dtype).replace(dynamics="sgp", n_inducing=100,
                                          sgp_lengthscale=math.sqrt(10.0))


def sgp_check_state(cfg, ys, us, lr):
    """The state the SGP kernels are held against their plain versions
    from: a 256-step warm-up epoch, the bootstrap
    (``gp.sgp.dynamics_initialize``: inducing points over the visited
    latents, re-whitened, the state noise from the pooled residual), then
    the weight posterior replaced by N(0, I / c) with c = B / (SGP_TAU0 sv),
    so that the first step's tau is about SGP_TAU0 and the per-step kernel
    reaches the exact fallback. The bootstrap's own posterior is not used:
    its precision sits at the floor of its eigh (condition number 1e5),
    where 64 steps of w are not determined to f32 (the plain version in f32
    and in f64 differ by about 1 in w's normalised error, as the kernel and
    the plain version do; scripts/torch_sgp_conditioning.py). Returns the
    state and the posterior entering the next step."""
    warm = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device=ys.device),
                          ys[:WARM_STEPS], us[:WARM_STEPS], 5, lr)
    boot = core._bootstrap_dynamics(cfg, warm.state, warm.q_means, us[:WARM_STEPS],
                                    torch.Generator().manual_seed(3))
    d = boot.dynamics
    c = ys.shape[1] / (SGP_TAU0 * float(torch.exp(d.logvar)))
    eye = torch.eye(cfg.n_inducing, device=ys.device)
    blr = d.blr._replace(w_mean=torch.zeros_like(d.blr.w_mean), precision=c * eye,
                         cov=eye / c)
    return (boot._replace(dynamics=d._replace(blr=blr)), warm.q_means[-1].contiguous(),
            warm.q_logvars[-1].contiguous())


def sgp_faults(carry, nf: int) -> dict:
    """The SGP carries of the two planted faults: the whitening skipped
    (``w_white`` the identity on the ``nf`` real features) and the DTC
    correction dropped (``scale2`` 0)."""
    ident = torch.zeros_like(carry.w_white)
    ident[:nf, :nf] = torch.eye(nf, device=ident.device)
    return {"no_whitening": carry._replace(w_white=ident),
            "no_dtc": carry._replace(scale2=torch.zeros_like(carry.scale2))}


def unplant(c, sound):
    """``c`` with the planted leaves given back their sound values, so that
    a fault counts through what the kernel computed, not through its input."""
    return c._replace(w_white=sound.w_white, scale2=sound.scale2)


def check_sgp_kernels(state, qm, qlv, ys, eps, lr, smi) -> dict:
    """The three launchers on the SGP flagship carry against their plain
    versions, in both matmul modes, from :func:`sgp_check_state`: one
    per-step launch with the exact fallback, 64 mega steps, one phase-1
    launch; each planted SGP fault must be rejected. Then each kernel's time
    beside its plain version's (bf16 products, the main path's). Returns
    the largest max abs diff and the times by kernel."""
    flags, errs = StepFlags(), {"fused_step": 0.0, "mega_epoch": 0.0, "forward_sums": 0.0}
    b = ys.shape[1]
    y0, e_s, e_t = ys[-1], eps[0, 0], eps[1, 0]
    lo, hi = WARM_STEPS, WARM_STEPS + MEGA_STEPS
    for mm in ("float32", "bfloat16"):
        cfg = sgp_flagship(mm)
        carry = F.pad_carry(cfg, state)
        start, tol = flatten(carry._asdict()), TOL[mm]
        args = (qm, qlv, y0, e_s, e_t, lr)
        ref = prefix_step(F.fused_step_plain, cfg, flags, clone(carry), *args)
        got = prefix_step(F.fused_step_call, cfg, flags, clone(carry), *args)
        tau = float(ref.scal[0, 4])
        check(tau >= F.NS_TAU_THRESHOLD, f"sgp.step: tau {tau} does not reach the fallback")
        errs["fused_step"] = max(errs["fused_step"], compare(
            f"sgp.step[{mm}]", packed(ref), packed(got), tol, start))
        margs = (qm, qlv, ys[lo:hi], None, eps[0, lo:hi], eps[1, lo:hi], lr)
        m_ref = F.mega_epoch_plain(cfg, flags, clone(carry), *margs)
        m_got = F.mega_epoch_call(cfg, flags, clone(carry), *margs)
        errs["mega_epoch"] = max(errs["mega_epoch"], compare(
            f"sgp.mega[{mm}]", segment(*m_ref), segment(*m_got), tol, start))
        sargs = (qm, qlv, y0, None, e_s, e_t, 1.0 / b)
        s_ref = sums_leaves(*F.forward_sums_plain(cfg, flags, carry, *sargs), carry)
        errs["forward_sums"] = max(errs["forward_sums"], compare(
            f"sgp.forward_sums[{mm}]", s_ref,
            sums_leaves(*F.forward_sums_call(cfg, flags, carry, *sargs), carry), tol, {}))
        for fault, bad in sgp_faults(carry, cfg.n_inducing).items():
            out = prefix_step(F.fused_step_call, cfg, flags, clone(bad), *args)
            compare(f"sgp.step[{mm}].fault.{fault}", packed(ref),
                    packed(out._replace(carry=unplant(out.carry, carry))), tol, start,
                    reject=True)
            m_bad = F.mega_epoch_call(cfg, flags, clone(bad), *margs)
            compare(f"sgp.mega[{mm}].fault.{fault}", segment(*m_ref),
                    segment(unplant(m_bad[0], carry), *m_bad[1:]), tol, start, reject=True)
            compare(f"sgp.forward_sums[{mm}].fault.{fault}", s_ref,
                    sums_leaves(*F.forward_sums_call(cfg, flags, bad, *sargs), carry), tol, {},
                    reject=True)
        mega_tau = m_got[2][:, 4]
        phase(f"sgp.mega[{mm}].tau", first=float(m_ref[2][0, 4]),
              plain_max=float(m_ref[2][:, 4].max()), kernel_max=float(m_got[2][:, 4].max()),
              step_tau=tau)
    cfg = sgp_flagship()
    d = state.dynamics
    phi = sgp.features(d, qm)
    phase("sgp.features", what="|phi|^2 / scale^2 at the check state's posterior means",
          median=float(torch.median(torch.sum(phi * phi, dim=-1)) / torch.exp(2 * d.log_scale)),
          n_inducing=cfg.n_inducing, lengthscale=float(torch.exp(d.log_lengthscale)))
    # times from the check state (bf16 products): the kernels update their
    # carry in place, so each side keeps its own copy
    carry = F.pad_carry(cfg, state)
    c_step, c_mega, c_plain = clone(carry), clone(carry), clone(carry)

    def k_step():
        return F.fused_step_call(cfg, flags, c_step, qm, qlv, y0, None, e_s, e_t, lr)

    def p_step():
        F.fused_step_plain(cfg, flags, c_plain, qm, qlv, y0, None, e_s, e_t, lr)

    def k_mega():
        F.mega_epoch_call(cfg, flags, c_mega, qm, qlv, ys[lo:hi], None, eps[0, lo:hi],
                          eps[1, lo:hi], lr)

    def p_mega():
        F.mega_epoch_plain(cfg, flags, c_plain, qm, qlv, ys[lo:hi], None, eps[0, lo:hi],
                           eps[1, lo:hi], lr)

    def k_sums():
        return F.forward_sums_call(cfg, flags, carry, qm, qlv, y0, None, e_s, e_t, 1.0 / b)

    def p_sums():
        F.forward_sums_plain(cfg, flags, carry, qm, qlv, y0, None, e_s, e_t, 1.0 / b)

    ms = {}
    for name, k, p_ in (("fused_step", k_step, p_step), ("forward_sums", k_sums, p_sums)):
        p1, k1, k2, p2 = cuda_ms(p_, 20), cuda_ms(k, 20), cuda_ms(k, 20), cuda_ms(p_, 20)
        ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    p1, k1, k2, p2 = cuda_ms(p_mega, 1), cuda_ms(k_mega, 3), cuda_ms(k_mega, 3), cuda_ms(p_mega, 1)
    ms["mega_epoch"] = ((k1 + k2) / 2 / MEGA_STEPS, (p1 + p2) / 2 / MEGA_STEPS)
    phase("sgp.times", unit="us per timestep", card=smi,
          **{f"{k}{suffix}": 1e3 * v[i] for k, v in ms.items()
             for i, suffix in ((0, ""), (1, "_plain"))})
    return {"errs": errs, "ms": ms, "stepped": k_step(), "carry": carry, "flat": k_sums(),
            "mega_tau": mega_tau}


def check_sgp_main(ys, us, smi) -> dict:
    """The SGP main path at the flagship widths: ``run_epochs`` for one
    warm-up epoch, the bootstrap, then two RLS epochs (T 2048 each; the
    first ``cfg.ns_prefix`` steps of each through the per-step kernel and
    the exact fallback, the rest in one mega launch). Returns the launches
    and steps by kernel, counted from 0 over this run."""
    cfg, dev, b = sgp_flagship(), ys.device, ys.shape[1]
    state = core.init_state(0, cfg, device=dev)
    lrs = [cfg.lr * cfg.lr_decay ** i for i in range(2)]

    def warm_and_bootstrap():
        wu = core.run_epochs(cfg, StepFlags(warm_up=True), state, ys, us, [20], lrs[:1])
        return core._bootstrap_dynamics(cfg, wu.state, wu.q_means, us,
                                        torch.Generator().manual_seed(21))

    F.reset_launches()
    boot, t_warm = synced(warm_and_bootstrap)
    out, t_rls = synced(lambda: core.run_epochs(cfg, StepFlags(), boot, ys, us, [22, 23], lrs))
    launches, timesteps = dict(F.launches), dict(F.steps)
    check(bool(torch.isfinite(out.epoch_loss).all()), "sgp.main: epoch losses not finite")
    check(tuple(out.q_means.shape) == (ys.shape[0], b, cfg.xdim)
          and bool(torch.isfinite(out.q_means).all()), "sgp.main: posterior not finite")
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0,
          f"sgp.main: launches {launches}")
    phase("sgp.main", config="flagship widths, sgp, n_inducing 100, B %d, T %d/epoch"
          % (b, ys.shape[0]), warmup_and_bootstrap_s=t_warm, rls_epochs_s=t_rls,
          rls_steps_per_s=2 * ys.shape[0] / t_rls, epoch_loss=out.epoch_loss.tolist(),
          max_tau=out.max_tau.tolist(), hot_frac=out.hot_frac.tolist(), launches=launches,
          timesteps=timesteps, card=smi)
    return {"launches": launches, "steps": timesteps}


def check_fit_sgp(ys, smi) -> None:
    """A blocked ``fit`` on the SGP flagship (2 epochs a block, warm-up
    forced to end after 2) with ``bench_all.py``'s forgetting and
    ``sgp_adapt_lr`` 0.05: fails on a non-finite loss or state, or on a
    dispatch that writes its input; reports demotions, prefix-free
    engagement and the adaptation steps."""
    cfg = sgp_flagship().replace(warmup_max=2, sgp_adapt_lr=0.05, **FIT_FORGET)
    ys = ys[:SGP_FIT_T]
    state = core.init_state(0, cfg, device=ys.device)
    with watched("run_epochs") as log, timed("_sgp_adapt_step") as adapts:
        F.reset_launches()
        res, secs = synced(lambda: core.fit(cfg, state, ys, seed=7, max_iter=SGP_FIT_EPOCHS,
                                            epochs_per_dispatch=2))
        launches = dict(F.launches)
    blocks = blocks_summary(log, ys.shape[0])
    check(all(b["input_intact"] for b in blocks), "fit.sgp: a block wrote its input state")
    check(math.isfinite(res.loss), f"fit.sgp: loss {res.loss}")
    leaves = state_leaves(res.state)
    bad = [k for k, v in leaves.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    check(not bad, f"fit.sgp: non-finite state leaves {bad}")
    free = [i for i, b in enumerate(blocks) if not b["warm_up"] and b["ns_prefix"] == 0]
    d = res.state.dynamics
    phase("fit.sgp", config="sgp flagship, B %d, T %d, 2 epochs a block, rls_shrink 0.999, "
          "chol_jitter 1e-3, sgp_adapt_lr 0.05" % (ys.shape[1], ys.shape[0]), seconds=secs,
          epochs_run=res.epochs_run, loss=res.loss, warm_up=res.warm_up,
          demoted_blocks=sum(b["fused_step"] == "off" for b in blocks),
          prefix_free_from_block=free[0] if free else None, adapt_steps=len(adapts),
          adapt_s=adapts, log_scale=float(d.log_scale),
          log_lengthscale=float(d.log_lengthscale), launches=launches, blocks=blocks,
          card=smi)


def check_route(ys, us, lr) -> None:
    """A configuration past the kernels' limits, a block past the card's
    shared memory at the smallest plan (the flagship at ydim 2500 and 256
    padded features with a channel mask: a tile's inputs and their channel
    mask alone): under ``fused_step='auto'`` 8 steps take the autograd epoch,
    with one warning naming the limit and no launch; under ``'on'`` the
    launch raises ValueError."""
    b, dev = ys.shape[1], ys.device
    cfg = flagship().replace(ydim=2500, n_rbf=200)
    ys = spikes(8, b, cfg.ydim, dev, seed=80)
    g = torch.Generator(device=dev).manual_seed(81)
    cmask = (torch.rand(ys.shape, generator=g, device=dev) >= MASK_DROP).float()
    ys, us = holes(ys, None, cmask), us[:8]
    state = core.init_state(0, cfg, device=dev)
    reason = F.kernel_limits(cfg, b, channel_mask=True)
    check(reason is not None, "route: ydim 2500 with a channel mask is within the kernels' limits")
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    F.logger.addHandler(handler)
    F._routed_away.discard(reason)
    try:
        F.reset_launches()
        res, secs = synced(lambda: core.run_epoch(cfg, StepFlags(), state, ys, us, 3, lr,
                                                  channel_mask=cmask))
        res2 = core.run_epoch(cfg, StepFlags(), state, ys, us, 3, lr, channel_mask=cmask)
    finally:
        F.logger.removeHandler(handler)
    check(res.metrics.tau is None and sum(F.launches.values()) == 0,
          f"route: not the autograd epoch (launches {F.launches})")
    check(bool(torch.isfinite(res.metrics.loss).all()) and torch.equal(res.q_means,
                                                                       res2.q_means),
          "route: the autograd epoch is not finite or not repeatable")
    warned = [m for m in seen if reason in m]
    check(len(warned) == 1, f"route: {len(warned)} warnings naming the limit: {seen}")
    try:
        core.run_epoch(cfg.replace(fused_step="on"), StepFlags(), state, ys, us, 3, lr,
                       channel_mask=cmask)
    except ValueError as e:
        raised = str(e)
    else:
        raised = None
    check(raised is not None and reason in raised, f"route: 'on' did not raise ({raised})")
    phase("route", config="flagship at ydim 2500, n_rbf 200, B %d, a channel mask" % b,
          limit=reason, auto="autograd, 8 steps", autograd_us_per_step=1e6 * secs / 8,
          warnings=len(warned), on_raised=raised)


# ---------------------------------------------------------------------------
# Shapes the TPU kernels take that the CUDA kernels took only once phase 1 ran
# over tiles of a block's trials: more trials, 256 padded features, deeper and
# wider recognition networks; and those they took only once the panels and the
# trials' state could live in L2 (the L2 route): 512 padded features, 256 with
# both masks, 4096 trials
# ---------------------------------------------------------------------------


def shape_cases() -> dict:
    """Each shape of the "shapes" phase: (config, trials, both masks, RLS
    epochs of its main path). ``nrbf400`` to ``b4096`` take the L2 route;
    their main path's RLS epoch of SHAPE_T steps lies in the exact-inverse
    prefix. ``h32x9`` has more hidden layers than the kernels' arrays held
    before the layer table."""
    return {
        "b512": (flagship(), 512, False, 1),
        "b1024": (flagship(), 1024, False, 2),
        "b512.mask": (flagship(), 512, True, 1),
        "nrbf200": (flagship().replace(n_rbf=200), 256, False, 2),
        "sgp200": (sgp_flagship().replace(n_inducing=200), 256, False, 1),
        "h64x4": (flagship().replace(hidden_sizes=(64, 64, 64, 64)), 256, False, 1),
        "h128": (flagship().replace(hidden_sizes=(128,)), 256, False, 1),
        "nrbf400": (flagship().replace(n_rbf=400), 256, False, 1),
        "sgp400": (sgp_flagship().replace(n_inducing=400), 256, False, 1),
        "nrbf200.cmask": (flagship().replace(n_rbf=200), 256, True, 1),
        "b4096": (flagship(), 4096, False, 1),
        "h32x9": (flagship().replace(hidden_sizes=(32,) * 9), 256, False, 1),
    }


def shape_times(cfg, carry, qm, qlv, ys, eps, lr, mask=None, cmask=None) -> dict:
    """us per step of the three kernels beside their plain versions at a
    shape, timed in turns (plain, kernel, kernel, plain), from ``carry``
    (left as it was): one step and one phase-1 launch on ``ys[0]``, the mega
    kernel over ``ys``; and one step's and one phase-1 launch's outputs for
    the bounds."""
    flags, n = StepFlags(), ys.shape[0]
    m0 = None if mask is None else mask[0]
    c0 = None if cmask is None else cmask[0]
    inv_b = 1.0 / (float(m0.sum()) if m0 is not None else ys.shape[1])
    carry_s, carry_m, carry_p = clone(carry), clone(carry), clone(carry)
    args = (qm, qlv, ys[0], None, eps[0, 0], eps[1, 0])
    calls = {
        "fused_step": (lambda: F.fused_step_call(cfg, flags, carry_s, *args, lr, mask=m0, cmask=c0),
                       lambda: F.fused_step_plain(cfg, flags, carry_p, *args, lr, mask=m0,
                                                  cmask=c0), 20, 1),
        "forward_sums": (lambda: F.forward_sums_call(cfg, flags, carry, *args, inv_b, mask=m0,
                                                     cmask=c0),
                         lambda: F.forward_sums_plain(cfg, flags, carry, *args, inv_b, mask=m0,
                                                      cmask=c0), 20, 1),
        "mega_epoch": (lambda: F.mega_epoch_call(cfg, flags, carry_m, qm, qlv, ys, None, eps[0],
                                                 eps[1], lr, mask=mask, cmask=cmask),
                       lambda: F.mega_epoch_plain(cfg, flags, carry_p, qm, qlv, ys, None, eps[0],
                                                  eps[1], lr, mask=mask, cmask=cmask), 3, n),
    }
    out = {}
    for name, (k, p, reps, steps) in calls.items():
        p1, k1 = cuda_ms(p, max(reps // 3, 1)), cuda_ms(k, reps)
        k2, p2 = cuda_ms(k, reps), cuda_ms(p, max(reps // 3, 1))
        out[name] = (1e3 * (k1 + k2) / 2 / steps, 1e3 * (p1 + p2) / 2 / steps)
    out["stepped"] = calls["fused_step"][0]()
    out["flat"] = calls["forward_sums"][0]()
    return out


def shape_bounds(cfg, b, carry, qm, qlv, y0, e_s, e_t, lr, stepped, flat, seg_tau,
                 mask=None, cmask=None) -> dict:
    """The bounds of a step launch, a mega step and a phase-1 launch at a
    shape, as the main path's rows count them (each input read once, each
    output written once; the mega segment's carry once per MEGA_STEPS steps
    and its Newton-Schulz iterations as its tau asked for; with masks the
    products of the valid trials, the masks read once more and the
    imputation's decoder product over every trial)."""
    nfp = carry.p_mat.shape[0]
    read, written = carry_bytes(carry), carry_bytes(carry, written=True)
    data = nbytes(y0, qm, qlv, e_s, e_t, lr)
    m_bytes, n_step, n_seg, impute = 0, b, b, 0
    if mask is not None:
        m_bytes = nbytes(mask[0], cmask[0])
        n_step, n_seg = float(mask[0].sum()), float(mask.sum(dim=1).mean())
        impute = 2 * b * cfg.ydim * cfg.xdim

    def ops(n_valid, ns_iters=None):
        f32_ops, mm_ops = step_ops(cfg, max(int(round(n_valid)), 1), nfp, ns_iters)
        return f32_ops, mm_ops + impute

    iters = torch.where(seg_tau < F.NS_TAU_MAX,
                        F.mega_ns_base_iters(cfg, b, masked=mask is not None)
                        + (seg_tau >= F.NS_TAU_ESCALATE).int()
                        + F.NS_EXTRA_ITERS * (seg_tau >= F.NS_TAU_THRESHOLD).int(), 0)
    return {
        "fused_step": bound(cfg, read + written + data + m_bytes + nbytes(
            stepped.q_pack, stepped.g_vec, stepped.xt, stepped.xs, stepped.scal),
            ops(n_step, F.NS_ITERS)),
        "mega_epoch": bound(cfg, (read + written + nbytes(qm, qlv)) / MEGA_STEPS
                            + nbytes(y0, e_s, e_t) + m_bytes + nbytes(stepped.q_pack) + 4 * 8,
                            ops(n_seg, float(iters.float().mean()))),
        "forward_sums": bound(cfg, read - nbytes(carry.p_mat, lr) + data + m_bytes
                              + nbytes(*flat), ops(n_step)),
    }


def as_f64(x):
    """A carry, a tuple of operands or a tensor with every floating-point
    tensor in float64 (a copy)."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x.clone()
    if hasattr(x, "_asdict"):
        return x._replace(**{k: as_f64(v) for k, v in x._asdict().items()})
    if isinstance(x, tuple):
        return tuple(as_f64(v) for v in x)
    return x


def vs_float64(name: str, ref64: dict, kernel: dict, plain: dict, start: dict,
               loosened: dict, ratio: float = 1.05) -> dict:
    """The kernel and the plain version with bf16 products, each held
    against the plain version in float64 from the same start: every leaf's
    normalised error (``compare_errs``) for both, printed ungated. For each
    leaf of ``loosened`` (a SHAPE_LIMITS entry) the kernel must be no farther
    from float64 than ``ratio`` times the plain bf16 version: farther would
    be a fault of the kernel, not bf16 rounding."""
    k_errs, _ = compare_errs(ref64, kernel, start)
    p_errs, _ = compare_errs(ref64, plain, start)
    phase(f"{name}.vs_float64", loosened=loosened, ratio=ratio,
          kernel={k: float(f"{v:.3e}") for k, v in k_errs.items()},
          plain_bf16={k: float(f"{v:.3e}") for k, v in p_errs.items()},
          kernel_worst=max(k_errs.values()), plain_bf16_worst=max(p_errs.values()))
    for leaf in loosened:
        check(k_errs[leaf] <= ratio * p_errs[leaf],
              f"{name}: the kernel's {leaf} is {k_errs[leaf]:.3e} from float64, the plain bf16 "
              f"version's {p_errs[leaf]:.3e}")
    return {"kernel": k_errs, "plain_bf16": p_errs}


def shape_limit(tag: str, kernel: str, mm: str, leaves: dict):
    """``compare``'s limit for a kernel at a shape: TOL, or TOL by leaf with
    the leaves of SHAPE_LIMITS replaced."""
    over = SHAPE_LIMITS.get((tag, kernel, mm))
    return {**dict.fromkeys(leaves, TOL[mm]), **over} if over else TOL[mm]


def depth_runs(n_layers: int, mm: str, dev, mega: bool = True, b: int = B,
               n_rbf=None, plan=None) -> dict:
    """The three kernels and their plain versions at the flagship (at ``b``
    trials, and ``n_rbf`` where given) with ``n_layers`` hidden layers of
    DEPTH_WIDTH, on the same inputs from a state after DEPTH_WARM warm-up
    steps: one step, one phase-1 launch and, with ``mega``, a MEGA_STEPS mega
    segment, as ``{kernel: (plain, kernel, start)}``, the arguments of
    ``compare``. A ``plan`` dict is given the launch's ``cluster_info``."""
    cfg = flagship(mm).replace(hidden_sizes=(DEPTH_WIDTH,) * n_layers)
    if n_rbf is not None:
        cfg = cfg.replace(n_rbf=n_rbf)
    flags, t_len = StepFlags(), DEPTH_WARM + MEGA_STEPS
    ys = spikes(t_len, b, cfg.ydim, dev, seed=90 + n_layers)
    us = torch.zeros((t_len, b, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    eps = torch.randn((2, MEGA_STEPS, b, cfg.xdim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(91))
    warm = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device=dev),
                          ys[:DEPTH_WARM], us[:DEPTH_WARM], 92, lr)
    qm, qlv = warm.q_means[-1].contiguous(), warm.q_logvars[-1].contiguous()
    carry = F.pad_carry(cfg, warm.state)
    start = flatten(carry._asdict())
    y0, e_s, e_t = ys[DEPTH_WARM], eps[0, 0], eps[1, 0]
    if plan is not None:
        plan.update(F.cluster_info(cfg, flags, carry, qm, qlv, ys[DEPTH_WARM:], None, lr))
    step = [packed(prefix_step(fn, cfg, flags, clone(carry), qm, qlv, y0, e_s, e_t, lr))
            for fn in (F.fused_step_plain, F.fused_step_call)]
    sums_args = (qm, qlv, y0, None, e_s, e_t, 1.0 / b)
    sums = [sums_leaves(*fn(cfg, flags, carry, *sums_args), carry)
            for fn in (F.forward_sums_plain, F.forward_sums_call)]
    runs = {"fused_step": (*step, start), "forward_sums": (*sums, {})}
    if mega:
        runs["mega_epoch"] = (*[segment(*fn(cfg, flags, clone(carry), qm, qlv, ys[DEPTH_WARM:],
                                            None, eps[0], eps[1], lr))
                                for fn in (F.mega_epoch_plain, F.mega_epoch_call)], start)
    return runs


def check_depths(dev) -> dict:
    """The hidden-layer counts DEPTH_LAYERS at DEPTH_WIDTH (:func:`depth_runs`)
    on the one-pass instantiation (the launch's plan checked to be one tile
    and the whole operand), each kernel held against its plain version
    within TOL: the step and phase-1 kernels in both matmul precisions, the
    mega kernel in f32. A bf16 mega segment through several
    tanh layers is no test at TOL: rounding flips grow over its 64 steps to
    2.1e-3 to 3.0e-3 in the posterior means of a sound kernel at 3, 5, 7
    and 8 layers of 8 on an H100 (PERF.md); its code is the step kernel's,
    held here in bf16 up to DEPTH_BF16_STEP_LAYERS layers, and the mega
    loop's own code is held in f32. Past DEPTH_BF16_STEP_LAYERS layers the bf16 step is printed,
    ungated, with how far the plain version moved w_in_y in f32 ulps of its
    largest entry: the first layers' gradients vanish with depth, so one
    step moves them a few ulps and a single rounding of the updated weight
    that the two versions take apart (their bf16 gradients differ in the
    last bits) reads up to 1/(moved + 4) (2.837e-2 in w_in_y at 12 layers of
    8 on an H100, where the phase-1 kernel's gradients read 1.4e-6 in bf16:
    PERF.md §6); the phase-1 kernel holds those gradients in bf16 at
    every depth, and the step's own code is held in f32. Then the three
    kernels in f32 at DEPTH_ROUTE_LAYERS on each route of DEPTH_ROUTES, the
    launch's plan checked to be that route's. Also 8 steps of ``run_epoch``
    under ``fused_step='on'`` at DEPTH_ON_LAYERS layers of 32: the step
    kernel launches. Returns the largest max abs diff of each kernel, and of
    each by route."""
    errs = dict.fromkeys(("fused_step", "forward_sums", "mega_epoch"), 0.0)
    by_route = {}
    one_pass = (-(-B // F.cluster_size()), 128, 0)
    for n in DEPTH_LAYERS:
        for mm in ("float32", "bfloat16"):
            plan = {}
            runs = depth_runs(n, mm, dev, mega=mm == "float32", b=B, plan=plan)
            got_plan = tuple(plan[k] for k in ("tile_rows", "stage_rows", "sub_rows"))
            check(got_plan == one_pass, f"shapes.depths.h{DEPTH_WIDTH}x{n}: the launch's plan "
                  f"{got_plan}, not {one_pass}")
            for kernel, (ref, got, start) in runs.items():
                name = f"shapes.depths.h{DEPTH_WIDTH}x{n}.{kernel}[{mm}]"
                if kernel == "fused_step" and mm == "bfloat16" and n > DEPTH_BF16_STEP_LAYERS:
                    found, _ = compare_errs(ref, got, start)
                    worst = max(found, key=found.get)
                    w0 = start["w_in_y"].double()
                    moved = float((ref["w_in_y"].double() - w0).abs().max())
                    phase(name, gated=False, max_err=found[worst], worst_leaf=worst,
                          w_in_y_moved_ulps=moved / (F32_ULP * float(w0.abs().max())))
                    continue
                errs[kernel] = max(errs[kernel], compare(name, ref, got, TOL[mm], start))
    # under fused_step='on' at the flagship's width of 32: 8 steps launch
    for n in DEPTH_ON_LAYERS:
        cfg = flagship().replace(hidden_sizes=(32,) * n, fused_step="on")
        ys = spikes(8, B, cfg.ydim, dev, seed=95)
        F.reset_launches()
        res = core.run_epoch(cfg, StepFlags(), core.init_state(0, cfg, device=dev), ys,
                             torch.zeros((8, B, 0), device=dev), 96,
                             torch.tensor(cfg.lr, device=dev))
        launched = dict(F.launches)
        check(launched["fused_step"] == 8 and bool(torch.isfinite(res.metrics.loss).all()),
              f"shapes.depths.on.h32x{n}: launches {launched}")
        phase(f"shapes.depths.on.h32x{n}", fused_step="on", steps=8, launches=launched)
    for route, (b, n_rbf, want) in DEPTH_ROUTES.items():
        r_errs = by_route[route] = dict.fromkeys(errs, 0.0)
        for n in DEPTH_ROUTE_LAYERS:
            plan = {}
            runs = depth_runs(n, "float32", dev, b=b, n_rbf=n_rbf, plan=plan)
            got_plan = tuple(plan[k] for k in ("tile_rows", "stage_rows", "sub_rows"))
            check(got_plan == want, f"shapes.depths.{route}.h{DEPTH_WIDTH}x{n}: the launch's "
                  f"plan {got_plan}, not {want}")
            for kernel, (ref, got, start) in runs.items():
                r_errs[kernel] = max(r_errs[kernel], compare(
                    f"shapes.depths.{route}.h{DEPTH_WIDTH}x{n}.{kernel}[float32]", ref, got,
                    TOL["float32"], start))
    return {**errs, "by_route": by_route}


def check_plans(dev) -> dict:
    """Each tile plan of the L2 route in PLAN_ROWS at its shape: the launch's
    plan (tile_rows, stage_rows, sub_rows) from ``cluster_info`` checked
    against the row and against the tests' mirror
    (``tests/torch_tile_plan.py:tile_plan``); then, from a state after
    PLAN_WARM warm-up steps through the kernels with its weight posterior
    reset so that the first step's tau is PLAN_TAU0 (the Newton-Schulz
    iterations run in every launch, as the main path's do past its first
    epoch), one step with the exact fallback, one phase-1 launch and a mega
    segment of PLAN_STEPS steps through the kernels against their plain
    versions at TOL (f32), each with its planted faults rejected. Returns
    the largest max abs diff of each kernel by plan."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_tile_plan as TP

    flags, t_len, tol = StepFlags(), PLAN_WARM + PLAN_STEPS, TOL["float32"]
    lo, seg = PLAN_WARM, slice(PLAN_WARM, PLAN_WARM + PLAN_STEPS)
    out = {}
    for key, (ydim, n_rbf, masks) in PLAN_ROWS.items():
        # 16x16x8, or 4x16x16.mask for a key with a fourth entry
        tag, want = "x".join(map(str, key[:3])) + "".join(f".{k}" for k in key[3:]), key[:3]
        t0 = time.perf_counter()
        cfg = flagship("float32").replace(ydim=ydim, n_rbf=n_rbf)
        ys = spikes(t_len, B, ydim, dev, seed=100)
        us = torch.zeros((t_len, B, 0), device=dev)
        lr = torch.tensor(cfg.lr, device=dev)
        eps = torch.randn((2, PLAN_STEPS, B, cfg.xdim), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(101))
        mask = cmask = None
        if masks:
            _, _, m, cm, _ = masked_data(ys, seed=102)
            mask = m if masks in ("mask", "both") else None
            cmask = cm if masks in ("cmask", "both") else None
            ys = holes(ys, mask, cmask)

        def mk(rows):
            return {k: v[rows] for k, v in (("mask", mask), ("channel_mask", cmask))
                    if v is not None}

        warm = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device=dev),
                              ys[:lo], us[:lo], 103, lr, **mk(slice(0, lo)))
        qm, qlv = warm.q_means[-1].contiguous(), warm.q_logvars[-1].contiguous()
        m0 = None if mask is None else mask[lo]
        c0 = None if cmask is None else cmask[lo]
        m_seg = None if mask is None else mask[seg]
        c_seg = None if cmask is None else cmask[seg]
        s_args = (qm, qlv, ys[lo], eps[0, 0], eps[1, 0], lr)

        def reset(c):
            d = warm.state.dynamics
            eye = torch.eye(d.blr.precision.shape[0], device=dev)
            blr = d.blr._replace(w_mean=torch.zeros_like(d.blr.w_mean), precision=c * eye,
                                 cov=eye / c)
            return F.pad_carry(cfg, warm.state._replace(dynamics=d._replace(blr=blr)))

        # tau falls as 1 / c: one plain step at a first guess sets c
        c = B / (PLAN_TAU0 * float(torch.exp(warm.state.dynamics.logvar)))
        probe = F.fused_step_plain(cfg, flags, reset(c), qm, qlv, ys[lo], None, *s_args[3:],
                                   mask=m0, cmask=c0)
        carry = reset(c * float(probe.scal[0, 4]) / PLAN_TAU0)
        start = flatten(carry._asdict())
        info = F.cluster_info(cfg, flags, carry, qm, qlv, ys[seg], None, lr, mask=m_seg,
                              cmask=c_seg)
        got_plan = tuple(info[k] for k in ("tile_rows", "stage_rows", "sub_rows"))
        mirror = TP.tile_plan(cfg, B, mask is not None, cmask is not None)
        check(got_plan == want == (mirror.tile, mirror.kc, mirror.sp),
              f"shapes.plans.{tag}: the launch's plan {got_plan}, the mirror's {mirror}")
        errs = out[tag] = {}
        ref = masked_prefix_step(F.fused_step_plain, cfg, flags, clone(carry), *s_args, mask=m0,
                                 cmask=c0)
        got = masked_prefix_step(F.fused_step_call, cfg, flags, clone(carry), *s_args, mask=m0,
                                 cmask=c0)
        errs["fused_step"] = compare(f"shapes.plans.{tag}.step", packed(ref), packed(got), tol,
                                     start)
        for fault, (fcfg, fflags) in faults(cfg, flags).items():
            bad = masked_prefix_step(F.fused_step_call, fcfg, fflags, clone(carry), *s_args,
                                     mask=m0, cmask=c0)
            compare(f"shapes.plans.{tag}.step.fault.{fault}", packed(ref), packed(bad), tol,
                    start, reject=True)
        inv_b = 1.0 / (float(m0.sum()) if m0 is not None else B)
        sums_args = (qm, qlv, ys[lo], None, *s_args[3:5], inv_b)
        s_ref = sums_leaves(*F.forward_sums_plain(cfg, flags, carry, *sums_args, mask=m0,
                                                  cmask=c0), carry, c0 is not None)
        s_got = sums_leaves(*F.forward_sums_call(cfg, flags, carry, *sums_args, mask=m0,
                                                 cmask=c0), carry, c0 is not None)
        errs["forward_sums"] = compare(f"shapes.plans.{tag}.forward_sums", s_ref, s_got, tol, {})
        for fault, (fcfg, fflags) in (("other_precision", (cfg.replace(
                matmul_dtype="bfloat16"), flags)),
                ("no_sgd", (cfg, dataclasses.replace(flags, sgd=False)))):
            bad = sums_leaves(*F.forward_sums_call(fcfg, fflags, carry, *sums_args, mask=m0,
                                                   cmask=c0), carry, c0 is not None)
            compare(f"shapes.plans.{tag}.forward_sums.fault.{fault}", s_ref, bad, tol, {},
                    reject=True)
        m_args = (qm, qlv, ys[seg], None, eps[0], eps[1], lr)
        m_ref = F.mega_epoch_plain(cfg, flags, clone(carry), *m_args, mask=m_seg, cmask=c_seg)
        m_got = F.mega_epoch_call(cfg, flags, clone(carry), *m_args, mask=m_seg, cmask=c_seg)
        errs["mega_epoch"] = compare(f"shapes.plans.{tag}.mega", segment(*m_ref),
                                     segment(*m_got), tol, start)
        for fault, (fcfg, fflags) in faults(cfg, flags).items():
            bad = F.mega_epoch_call(fcfg, fflags, clone(carry), *m_args, mask=m_seg, cmask=c_seg)
            compare(f"shapes.plans.{tag}.mega.fault.{fault}", segment(*m_ref), segment(*bad),
                    tol, start, reject=True)
        torch.cuda.synchronize()
        phase(f"shapes.plans.{tag}", plan=list(got_plan), ydim=ydim, padded_features=n_rbf,
              masks=masks or "none", trials=B, smem_bytes=info["smem_bytes"],
              registers=info["registers"], local_bytes=info["local_bytes"],
              step_tau=float(got.scal[0, 4]), mega_tau=[float(m_got[2][:, 4].min()),
                                                       float(m_got[2][:, 4].max())],
              max_abs_err=errs, seconds=time.perf_counter() - t0)
    return out


def check_shape(tag, cfg, b, masked, rls_epochs, dev, group, smi) -> dict:
    """One shape the kernels take since phase 1 runs in trial tiles. The main
    path through ``run_epochs`` under ``fused_step='auto'`` (a warm-up epoch
    of SHAPE_T steps, for SGP the bootstrap, then ``rls_epochs`` RLS epochs):
    finite, the step and mega kernels launched, no routing warning. The three
    kernels against their plain versions in both matmul modes (``compare``
    at TOL, the planted faults rejected), from the flagship checks' states:
    one step with the exact fallback and one phase-1 launch after a warm-up
    epoch of WARM_STEPS, MEGA_STEPS mega steps after ``ns_prefix`` more
    steps through the kernels (whose tau lies between the escalation bands,
    as the flagship's does); SGP from :func:`sgp_check_state`. The tile plan
    against the library's, the times beside the plain versions' and the
    autograd epoch's, the bounds, and SHAPE_SHARD_T sharded steps at world
    size 1 (the phase-1 kernel's launches on that path)."""
    flags, t_len = StepFlags(), SHAPE_T
    # the masked data as the flagship's (MASK_T steps, trial lengths in
    # [MASK_T / 2, MASK_T]): about half the trials have ended in the mega segment
    t_data = max(t_len, WARM_STEPS + cfg.ns_prefix + MEGA_STEPS, MASK_T if masked else 0)
    ys = spikes(t_data, b, cfg.ydim, dev, seed=60)
    us = torch.zeros((t_data, b, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    eps = torch.randn((2, MEGA_STEPS, b, cfg.xdim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(61))
    mask = cmask = None
    if masked:
        ys, _, mask, cmask, _ = masked_data(ys, seed=62)
    masks = {} if mask is None else dict(mask=mask[:t_len], channel_mask=cmask[:t_len])
    sgp_cfg = cfg.dynamics == "sgp"

    # ---- the main path under 'auto': no routing warning
    seen = []
    handler = logging.Handler()
    handler.emit = lambda rec: seen.append(rec.getMessage())
    F.logger.addHandler(handler)
    try:
        state = core.init_state(0, cfg, device=dev)
        lrs = [cfg.lr * cfg.lr_decay ** i for i in range(rls_epochs)]
        F.reset_launches()
        wu, t_warm = synced(lambda: core.run_epochs(cfg, StepFlags(warm_up=True), state,
                                                    ys[:t_len], us[:t_len], [70], lrs[:1],
                                                    **masks))
        boot = (core._bootstrap_dynamics(cfg, wu.state, wu.q_means, us[:t_len],
                                         torch.Generator().manual_seed(71))
                if sgp_cfg else wu.state)
        out, t_rls = synced(lambda: core.run_epochs(cfg, flags, boot, ys[:t_len], us[:t_len],
                                                    list(range(72, 72 + rls_epochs)), lrs,
                                                    **masks))
        launches, timesteps = dict(F.launches), dict(F.steps)
    finally:
        F.logger.removeHandler(handler)
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0,
          f"shapes.{tag}.main: launches {launches}")
    check(not seen, f"shapes.{tag}.main: routing warnings {seen}")
    check(bool(torch.isfinite(out.epoch_loss).all()) and bool(torch.isfinite(out.q_means).all()),
          f"shapes.{tag}.main: loss or posterior not finite")
    phase(f"shapes.{tag}.main", config=f"{tag}: B {b}, T {t_len}, "
          f"{'both masks, ' if masked else ''}1 warm-up + {rls_epochs} RLS epochs",
          warmup_epoch_s=t_warm, rls_epochs_s=t_rls, epoch_loss=out.epoch_loss.tolist(),
          max_tau=out.max_tau.tolist(), launches=launches, timesteps=timesteps,
          warnings=len(seen), card=smi)

    # ---- the three kernels against their plain versions
    def mk(rows):
        return {} if mask is None else dict(mask=mask[rows], channel_mask=cmask[rows])

    if sgp_cfg:
        check_state, qm_w, qlv_w = sgp_check_state(cfg, ys, us, lr)
        post, qm_p, qlv_p = check_state, qm_w, qlv_w
        lo = WARM_STEPS
    else:
        warm_rows, lo = slice(0, WARM_STEPS), WARM_STEPS + cfg.ns_prefix
        warm = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device=dev),
                              ys[warm_rows], us[warm_rows], 5, lr, **mk(warm_rows))
        check_state, qm_w, qlv_w = (warm.state, warm.q_means[-1].contiguous(),
                                    warm.q_logvars[-1].contiguous())
        pre = slice(WARM_STEPS, lo)
        prefix = core.run_epoch(cfg, flags, check_state, ys[pre], us[pre], 6, lr,
                                q0=core.Gaussian(qm_w, qlv_w), **mk(pre))
        post, qm_p, qlv_p = (prefix.state, prefix.q_means[-1].contiguous(),
                             prefix.q_logvars[-1].contiguous())
    y0, e_s, e_t = ys[lo], eps[0, 0], eps[1, 0]
    seg = slice(lo, lo + MEGA_STEPS)
    m0, c0 = (None, None) if mask is None else (mask[lo], cmask[lo])
    m_seg, c_seg = (None, None) if mask is None else (mask[seg], cmask[seg])
    inv_b = 1.0 / (float(m0.sum()) if m0 is not None else b)
    errs = dict.fromkeys(("fused_step", "mega_epoch", "forward_sums"), 0.0)
    for mm in ("float32", "bfloat16"):
        c = cfg.replace(matmul_dtype=mm)
        carry = F.pad_carry(c, check_state)
        start = flatten(carry._asdict())
        s_args = (qm_w, qlv_w, y0, e_s, e_t, lr)
        ref = masked_prefix_step(F.fused_step_plain, c, flags, clone(carry), *s_args, mask=m0,
                                 cmask=c0)
        got = masked_prefix_step(F.fused_step_call, c, flags, clone(carry), *s_args, mask=m0,
                                 cmask=c0)
        phase(f"shapes.{tag}.step[{mm}].tau", plain=float(ref.scal[0, 4]),
              kernel=float(got.scal[0, 4]))
        st_tol = shape_limit(tag, "fused_step", mm, packed(ref))
        errs["fused_step"] = max(errs["fused_step"], compare(
            f"shapes.{tag}.step[{mm}]", packed(ref), packed(got), st_tol, start))
        if (tag, "fused_step", mm) in SHAPE_LIMITS:
            f64 = c.replace(dtype="float64", matmul_dtype="float32")
            st_64 = masked_prefix_step(F.fused_step_plain, f64, flags, as_f64(carry),
                                       *as_f64(s_args), mask=m0, cmask=c0)
            vs_float64(f"shapes.{tag}.step[{mm}]", packed(st_64), packed(got), packed(ref),
                       start, SHAPE_LIMITS[(tag, "fused_step", mm)])
        for fault, (fcfg, fflags) in faults(c, flags).items():
            bad = masked_prefix_step(F.fused_step_call, fcfg, fflags, clone(carry), *s_args,
                                     mask=m0, cmask=c0)
            compare(f"shapes.{tag}.step[{mm}].fault.{fault}", packed(ref), packed(bad), st_tol,
                    start, reject=True)
        sums_args = (qm_w, qlv_w, y0, None, e_s, e_t, inv_b)
        s_ref = sums_leaves(*F.forward_sums_plain(c, flags, carry, *sums_args, mask=m0,
                                                  cmask=c0), carry, c0 is not None)
        s_got = sums_leaves(*F.forward_sums_call(c, flags, carry, *sums_args, mask=m0, cmask=c0),
                            carry, c0 is not None)
        s_tol = shape_limit(tag, "forward_sums", mm, s_ref)
        errs["forward_sums"] = max(errs["forward_sums"], compare(
            f"shapes.{tag}.forward_sums[{mm}]", s_ref, s_got, s_tol, {}))
        if (tag, "forward_sums", mm) in SHAPE_LIMITS:
            f64 = c.replace(dtype="float64", matmul_dtype="float32")
            s_64 = sums_leaves(*F.forward_sums_plain(f64, flags, as_f64(carry), *as_f64(sums_args),
                                                     mask=m0, cmask=c0), carry, c0 is not None)
            vs_float64(f"shapes.{tag}.forward_sums[{mm}]", s_64, s_got, s_ref, {},
                       SHAPE_LIMITS[(tag, "forward_sums", mm)])
        for fault, (fcfg, fflags) in (("other_precision", (c.replace(
                matmul_dtype=other_precision(mm)), flags)),
                ("no_sgd", (c, dataclasses.replace(flags, sgd=False)))):
            bad = sums_leaves(*F.forward_sums_call(fcfg, fflags, carry, *sums_args, mask=m0,
                                                   cmask=c0), carry, c0 is not None)
            compare(f"shapes.{tag}.forward_sums[{mm}].fault.{fault}", s_ref, bad, s_tol, {},
                    reject=True)
        carry = F.pad_carry(c, post)
        start = flatten(carry._asdict())
        m_args = (qm_p, qlv_p, ys[seg], None, eps[0], eps[1], lr)
        m_ref = F.mega_epoch_plain(c, flags, clone(carry), *m_args, mask=m_seg, cmask=c_seg)
        m_got = F.mega_epoch_call(c, flags, clone(carry), *m_args, mask=m_seg, cmask=c_seg)
        phase(f"shapes.{tag}.mega[{mm}].tau", plain_min=float(m_ref[2][:, 4].min()),
              plain_max=float(m_ref[2][:, 4].max()), kernel_max=float(m_got[2][:, 4].max()),
              base_iters=F.mega_ns_base_iters(c, b, masked=mask is not None))
        m_tol = shape_limit(tag, "mega_epoch", mm, segment(*m_ref))
        errs["mega_epoch"] = max(errs["mega_epoch"], compare(
            f"shapes.{tag}.mega[{mm}]", segment(*m_ref), segment(*m_got), m_tol, start))
        if (tag, "mega_epoch", mm) in SHAPE_LIMITS:
            f64 = c.replace(dtype="float64", matmul_dtype="float32")
            m_64 = F.mega_epoch_plain(f64, flags, as_f64(carry), *as_f64(m_args), mask=m_seg,
                                      cmask=c_seg)
            vs_float64(f"shapes.{tag}.mega[{mm}]", segment(*m_64), segment(*m_got),
                       segment(*m_ref), start, SHAPE_LIMITS[(tag, "mega_epoch", mm)],
                       SHAPE_F64_RATIO.get((tag, "mega_epoch", mm), 1.05))
        for fault, (fcfg, fflags) in faults(c, flags).items():
            bad = F.mega_epoch_call(fcfg, fflags, clone(carry), *m_args, mask=m_seg, cmask=c_seg)
            compare(f"shapes.{tag}.mega[{mm}].fault.{fault}", segment(*m_ref), segment(*bad),
                    m_tol, start, reject=True)
        if mm == cfg.matmul_dtype:
            seg_tau = m_got[2][:, 4]

    # ---- the tile plan, the times and the bounds (the main path's products)
    carry = F.pad_carry(cfg, post)
    info = F.cluster_info(cfg, flags, carry, qm_p, qlv_p, ys[seg], None, lr, mask=m_seg,
                          cmask=c_seg)
    need = F._library().vjf_smem_bytes(ctypes.byref(F._dims(cfg, b, mask=masked, cmask=masked)))
    check(need == info["smem_bytes"], f"shapes.{tag}: vjf_smem_bytes {need}, the launch {info}")
    times = shape_times(cfg, carry, qm_p, qlv_p, ys[seg], eps, lr, m_seg, c_seg)
    auto_masks = {} if mask is None else dict(mask=mask[:8], channel_mask=cmask[:8])
    _, auto_s = synced(lambda: core.run_epoch(cfg.replace(fused_step="off"), flags, post,
                                              ys[:8], us[:8], 3, lr, **auto_masks))
    bounds = shape_bounds(cfg, b, carry, qm_p, qlv_p, y0, e_s, e_t, lr, times["stepped"],
                          times["flat"], seg_tau, m_seg, c_seg)
    phase(f"shapes.{tag}.times", unit="us per timestep", card=smi,
          tile_rows=info["tile_rows"], stage_rows=info["stage_rows"],
          sub_rows=info["sub_rows"], smem_bytes=info["smem_bytes"],
          tiles_by_block=[max(-(-len(F.cluster_rows(r, b)) // info["tile_rows"]), 1)
                          for r in range(F.cluster_size())],
          registers=info["registers"], local_bytes=info["local_bytes"],
          autograd_us_per_step=1e6 * auto_s / 8,
          **{f"{k}{suffix}": times[k][i] for k in bounds
             for i, suffix in ((0, ""), (1, "_plain"))},
          **{f"{k}_bound": bounds[k][0] * 1e3 for k in bounds})

    # ---- the phase-1 kernel on the sharded path, world size 1
    sh_masks = {} if mask is None else dict(mask=mask[:SHAPE_SHARD_T],
                                            channel_mask=cmask[:SHAPE_SHARD_T])
    F.reset_launches()
    sh = run_epoch_fused_sharded(cfg, flags, post, ys[:SHAPE_SHARD_T], us[:SHAPE_SHARD_T], 73,
                                 lr, group, **sh_masks)
    sh_launches, sh_steps = dict(F.launches), dict(F.steps)
    check(sh_launches == {**dict.fromkeys(F.launches, 0), "forward_sums": SHAPE_SHARD_T},
          f"shapes.{tag}.sharded: launches {sh_launches}")
    check(bool(torch.isfinite(sh.metrics.loss).all()), f"shapes.{tag}.sharded: loss not finite")
    phase(f"shapes.{tag}.sharded", world_size=1, backend="nccl", steps=SHAPE_SHARD_T,
          launches=sh_launches["forward_sums"])
    launches["forward_sums"], timesteps["forward_sums"] = (sh_launches["forward_sums"],
                                                           sh_steps["forward_sums"])
    return {"launches": launches, "steps": timesteps, "errs": errs, "us": times,
            "bounds": bounds}


def check_shapes(dev, smi) -> dict:
    """Every shape of :func:`shape_cases` (:func:`check_shape`), inside one
    world-size-1 NCCL group for their sharded steps. Returns each shape's
    launches, errors, times and bounds by tag."""
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = make_dp_group()
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
        return {tag: check_shape(tag, *case, dev, group, smi)
                for tag, case in shape_cases().items()}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Ragged trials and missing channels: the masks through the three kernels
# ---------------------------------------------------------------------------


def masked_data(ys: torch.Tensor, seed: int):
    """The flagship data made ragged: trial lengths drawn from [T/2, T],
    NaN after each trial's end; MASK_DROP of y's entries dropped at random
    and MASK_DEAD channels dead over a contiguous quarter of the epoch, NaN
    there too. Returns ``(ys with NaN, ys with 0 at the same entries, mask
    (T, B), channel mask (T, B, ydim), ys)``."""
    t, b, yd = ys.shape
    dev = ys.device
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(t, device=dev)[:, None] < lengths[None, :]).float()
    cmask = (torch.rand((t, b, yd), generator=g, device=dev) >= MASK_DROP).float()
    dead = torch.randperm(yd, generator=g, device=dev)[:MASK_DEAD]
    start = int(torch.randint(0, t - t // 4 + 1, (1,), generator=g, device=dev))
    cmask[start:start + t // 4, :, dead] = 0.0
    return (holes(ys, mask, cmask), holes(ys, mask, cmask, 0.0), mask, cmask, ys)


def holes(ys, mask=None, cmask=None, fill=float("nan")):
    """``ys`` with ``fill`` at every entry the given masks hide."""
    hole = torch.zeros_like(ys, dtype=torch.bool)
    if cmask is not None:
        hole |= cmask == 0
    if mask is not None:
        hole |= (mask == 0)[..., None]
    return torch.where(hole, torch.full_like(ys, fill), ys)


MASK_VARIANTS = ("mask", "cmask", "both")


def variant(name, mask, cmask) -> dict:
    """The keyword arguments of a launcher for one mask variant."""
    return {"mask": mask if name in ("mask", "both") else None,
            "cmask": cmask if name in ("cmask", "both") else None}


def masked_prefix_step(step_fn, cfg, flags, carry, qm, qlv, y, e_s, e_t, lr, mask=None,
                       cmask=None):
    """One exact-inverse prefix step with masks: a fused step, then the
    fallback over the valid rows."""
    prev = carry._replace(dyn_n=carry.dyn_n.clone(), state_logvar=carry.state_logvar.clone())
    out = step_fn(cfg, flags, carry, qm, qlv, y, None, e_s, e_t, lr, mask=mask, cmask=cmask)
    return fallback_of(step_fn)(cfg, out, prev, None, mask=mask)


def check_mask_kernels(post_warm, qm, qlv, post_prefix, data, eps, lr, smi) -> dict:
    """The three launchers with the trial mask alone, the channel mask alone
    and both, in both matmul modes, against their plain versions (``compare``
    at TOL): one per-step launch and the exact fallback at a step where
    about half the trials have ended (from the post-warm-up state, where the
    fallback fires), 64 mega steps from the post-prefix state with one step
    of no valid trial, and one phase-1 launch with the global 1/count. The
    frozen rows are their input bit for bit; the empty step reports loss and
    tau 0 and leaves P, V and w. Planted faults, each of which must be
    rejected: the kernel given an all-ones trial mask, or an all-ones
    channel mask, against the plain version given the real one, and the
    kernel given the empty step made valid against the plain version that
    freezes it (finite padding there, so that the difference is numeric).
    Then NaN invariance (NaN padding against 0 padding: the same bits, here
    and with controls at ``check_ragged``'s widths) and two masked mega runs
    bit for bit. Returns the largest max abs diff by kernel."""
    _, _, mask, cmask, ys = data
    flags = StepFlags()
    errs = dict.fromkeys(("fused_step", "mega_epoch", "forward_sums"), 0.0)
    carry_p, qm_p, qlv_p = post_prefix
    lo = flagship().ns_prefix
    hi = lo + MEGA_STEPS
    empty = 5                                  # the segment's step with no valid trial
    seg_mask = mask[lo:hi].clone()
    seg_mask[empty] = 0.0
    e_s, e_t = eps[0, 0], eps[1, 0]
    t1 = 3 * ys.shape[0] // 4                  # about half the trials have ended
    frozen = mask[t1] == 0
    check(bool(frozen.any()) and bool((~frozen).any()), "mask: no ragged step to check")
    taus = {}
    for mm in ("float32", "bfloat16"):
        cfg = flagship(mm)
        tol = TOL[mm]
        carry = F.pad_carry(cfg, post_warm)
        start = flatten(carry._asdict())
        m_start = flatten(carry_p._asdict())
        for name in MASK_VARIANTS:
            kw = variant(name, mask[t1], cmask[t1])
            # NaN where this variant's masks hide an entry, 0 for the faults
            ys_nan = holes(ys, **variant(name, mask, cmask))
            ys_zero = holes(ys, **variant(name, mask, cmask), fill=0.0)
            args = (qm, qlv, ys_nan[t1], e_s, e_t, lr)
            ref = masked_prefix_step(F.fused_step_plain, cfg, flags, clone(carry), *args, **kw)
            got = masked_prefix_step(F.fused_step_call, cfg, flags, clone(carry), *args, **kw)
            taus[f"{name}[{mm}]"] = [float(ref.scal[0, 4]), float(got.scal[0, 4])]
            errs["fused_step"] = max(errs["fused_step"], compare(
                f"mask.step[{name}][{mm}]", packed(ref), packed(got), tol, start))
            if kw["mask"] is not None:
                check(torch.equal(got.q_pack[0][frozen], qm[frozen])
                      and torch.equal(got.q_pack[1][frozen], qlv[frozen]),
                      f"mask.step[{name}][{mm}]: a frozen row moved")
            mkw = variant(name, seg_mask, cmask[lo:hi])
            margs = (qm_p, qlv_p, ys_nan[lo:hi], None, eps[0, lo:hi], eps[1, lo:hi], lr)
            m_ref = F.mega_epoch_plain(cfg, flags, clone(carry_p), *margs, **mkw)
            m_got = F.mega_epoch_call(cfg, flags, clone(carry_p), *margs, **mkw)
            errs["mega_epoch"] = max(errs["mega_epoch"], compare(
                f"mask.mega[{name}][{mm}]", segment(*m_ref), segment(*m_got), tol, m_start))
            if mkw["mask"] is not None:
                ks = m_got[2]
                check(float(ks[empty, 0]) == 0.0 and float(ks[empty, 4]) == 0.0,
                      f"mask.mega[{name}][{mm}]: the empty step reports loss "
                      f"{float(ks[empty, 0])}, tau {float(ks[empty, 4])}")
            skw = variant(name, mask[t1], cmask[t1])
            n_valid = float(mask[t1].sum()) if skw["mask"] is not None else ys.shape[1]
            sargs = (qm, qlv, ys_nan[t1], None, e_s, e_t, 1.0 / max(n_valid, 1.0))
            s_ref = sums_leaves(*F.forward_sums_plain(cfg, flags, carry, *sargs, **skw), carry,
                                skw["cmask"] is not None)
            s_got = sums_leaves(*F.forward_sums_call(cfg, flags, carry, *sargs, **skw), carry,
                                skw["cmask"] is not None)
            errs["forward_sums"] = max(errs["forward_sums"], compare(
                f"mask.forward_sums[{name}][{mm}]", s_ref, s_got, tol, {}))

            # planted faults, on the finite padding
            zargs = (qm, qlv, ys_zero[t1], e_s, e_t, lr)
            zm = (qm_p, qlv_p, ys_zero[lo:hi], None, eps[0, lo:hi], eps[1, lo:hi], lr)
            for fault, key in (("all_ones_mask", "mask"), ("all_ones_cmask", "cmask")):
                if kw[key] is None:
                    continue
                bad = dict(kw, **{key: torch.ones_like(kw[key])})
                out = masked_prefix_step(F.fused_step_call, cfg, flags, clone(carry), *zargs,
                                         **bad)
                compare(f"mask.step[{name}][{mm}].fault.{fault}", packed(ref), packed(out),
                        tol, start, reject=True)
                bad_m = dict(mkw, **{key: torch.ones_like(mkw[key])})
                m_bad = F.mega_epoch_call(cfg, flags, clone(carry_p), *zm, **bad_m)
                compare(f"mask.mega[{name}][{mm}].fault.{fault}", segment(*m_ref),
                        segment(*m_bad), tol, m_start, reject=True)
                bad_s = dict(skw, **{key: torch.ones_like(skw[key])})
                s_bad = sums_leaves(*F.forward_sums_call(cfg, flags, carry, qm, qlv,
                                                         ys_zero[t1], None, e_s, e_t,
                                                         sargs[-1], **bad_s),
                                    carry, skw["cmask"] is not None)
                compare(f"mask.forward_sums[{name}][{mm}].fault.{fault}", s_ref, s_bad, tol,
                        {}, reject=True)
            if mkw["mask"] is not None:
                woke = seg_mask.clone()
                woke[empty] = 1.0
                m_bad = F.mega_epoch_call(cfg, flags, clone(carry_p), *zm,
                                          **dict(mkw, mask=woke))
                compare(f"mask.mega[{name}][{mm}].fault.empty_step_made_valid",
                        segment(*m_ref), segment(*m_bad), tol, m_start, reject=True)

    check(any(v[0] >= F.NS_TAU_THRESHOLD for v in taus.values()),
          f"mask.step: no variant reaches the exact fallback (tau {taus})")
    phase("mask.step.tau", plain_kernel=taus, threshold=F.NS_TAU_THRESHOLD)

    # a step with no valid trial through the per-step kernel
    ys_nan, ys_zero = data[0], data[1]
    cfg = flagship()
    carry = F.pad_carry(cfg, post_warm)
    none = torch.zeros_like(mask[t1])
    got = masked_prefix_step(F.fused_step_call, cfg, flags, clone(carry), qm, qlv, ys_nan[t1],
                             e_s, e_t, lr, mask=none, cmask=cmask[t1])
    # the counters keep their count, clamped at their caps as in every step
    moved = [k for k in ("p_mat", "v_mat", "w_dyn", "w_in_y", "w_dec")
             if not torch.equal(getattr(got.carry, k), getattr(carry, k))]
    unchanged = moved + [k for k, cap in (("dyn_n", cfg.state_var_cap), ("lik_n", cfg.obs_var_cap))
                         if not torch.equal(getattr(got.carry, k),
                                            torch.clamp(getattr(carry, k), max=float(cap)))]
    check(not unchanged and torch.equal(got.q_pack[0], qm) and torch.equal(got.q_pack[1], qlv)
          and float(got.scal[0, 0]) == 0.0 and float(got.scal[0, 4]) == 0.0,
          f"mask.step.empty: moved {unchanged}, loss {float(got.scal[0, 0])}")

    # NaN invariance: the same bits from NaN and from 0 at the masked entries
    mkw = variant("both", seg_mask, cmask[lo:hi])
    runs = [segment(*F.mega_epoch_call(cfg, flags, clone(carry_p), qm_p, qlv_p, y[lo:hi], None,
                                       eps[0, lo:hi], eps[1, lo:hi], lr, **mkw))
            for y in (ys_nan, ys_zero)]
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    check(not differ, f"mask.nan_invariance: leaves differ {differ}")
    finite = all(bool(torch.isfinite(v).all()) for k, v in runs[0].items()
                 if v.is_floating_point() and k != "tau")
    check(finite, "mask.nan_invariance: a NaN reached the state")
    check_mask_controls(ys_nan.device)
    phase("mask.nan_invariance", steps=MEGA_STEPS, leaves=len(runs[0]), bit_identical=True,
          with_controls="mask.controls")

    # two masked mega runs, in-kernel noise: the same bits
    runs = [segment(*F.mega_epoch_call(cfg, flags, clone(carry_p), qm_p, qlv_p, ys_nan[lo:hi],
                                       None, None, None, lr, **mkw)) for _ in range(2)]
    differ = [k for k, v in runs[0].items() if not torch.equal(v, runs[1][k])]
    check(not differ, f"mask.deterministic: leaves differ {differ}")
    phase("mask.deterministic", steps=MEGA_STEPS, leaves=len(runs[0]), bit_identical=True)
    return errs


def check_mask_controls(dev) -> None:
    """NaN invariance with controls: ``check_ragged``'s widths (udim 2, B
    250), both masks with NaN or 0 at every masked entry of y and u, through
    the per-step kernel and the mega kernel: the same bits."""
    cfg = VJFConfig(ydim=14, xdim=2, udim=2, n_rbf=16, hidden_sizes=(16, 8),
                    likelihood="gaussian", dtype="float32", rls_backend="nsv",
                    fused_step="on", matmul_dtype="float32")
    steps, b = 8, 250
    g = torch.Generator(device=dev).manual_seed(41)
    ys = torch.randn((steps, b, cfg.ydim), device=dev, generator=g)
    us = torch.randn((steps, b, cfg.udim), device=dev, generator=g)
    eps = torch.randn((2, steps, b, cfg.xdim), device=dev, generator=g)
    q = 0.3 * torch.randn((2, b, cfg.xdim), device=dev, generator=g)
    mask = (torch.rand((steps, b), device=dev, generator=g) > 0.3).float()
    cmask = (torch.rand((steps, b, cfg.ydim), device=dev, generator=g) > 0.2).float()
    carry = F.pad_carry(cfg, core.init_state(0, cfg, device=dev))
    lr = torch.tensor(1e-2, device=dev)

    def fill(v):
        y = torch.where((cmask == 0) | (mask == 0)[:, :, None], torch.full_like(ys, v), ys)
        return y, torch.where((mask == 0)[:, :, None], torch.full_like(us, v), us)

    outs = []
    for v in (float("nan"), 0.0):
        y, u = fill(v)
        c = clone(carry)
        st = F.fused_step_call(cfg, StepFlags(), c, q[0], q[1], y[0], u[0], eps[0, 0], eps[1, 0],
                               lr, mask=mask[0], cmask=cmask[0])
        st = F.exact_v_fallback(cfg, st, carry, u[0], mask=mask[0])
        res = F.mega_epoch_call(cfg, StepFlags(), clone(carry), q[0], q[1], y, u, eps[0], eps[1],
                                lr, mask=mask, cmask=cmask)
        outs.append(dict(packed(st), **{f"mega.{k}": v for k, v in segment(*res).items()}))
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    check(not differ, f"mask.controls: leaves differ {differ}")
    phase("mask.controls", batch=b, udim=cfg.udim, steps=steps, bit_identical=True)


def mask_times(post_prefix, data, eps, lr, smi) -> dict:
    """Microseconds per step of each masked launcher beside the unmasked one
    and the plain version, in one run (bf16 products, from the post-prefix
    state, the masks of the mega check): the mega kernel with the trial
    mask, the channel mask and both; the other two with both. Returns
    ``{kernel: (ms, plain_ms)}`` with both masks, and the times by variant."""
    _, _, mask, cmask, ys = data
    cfg, flags = flagship(), StepFlags()
    carry_p, qm, qlv = post_prefix
    lo = cfg.ns_prefix
    hi = lo + MEGA_STEPS
    t1 = 3 * ys.shape[0] // 4
    e_s, e_t = eps[0, 0], eps[1, 0]
    b = ys.shape[1]
    inv_b = 1.0 / max(float(mask[t1].sum()), 1.0)
    seg = {n: variant(n, mask[lo:hi], cmask[lo:hi]) for n in MASK_VARIANTS}
    seg["none"] = variant("none", None, None)
    one = {n: variant(n, mask[t1], cmask[t1]) for n in ("both", "none")}
    pc = clone(carry_p)

    # each variant's data holds NaN where its own masks hide an entry
    def mega(fn, kw, c):
        y = holes(ys[lo:hi], **kw)
        return lambda: fn(cfg, flags, c, qm, qlv, y, None, eps[0, lo:hi], eps[1, lo:hi], lr,
                          **kw)

    def step(fn, kw, c):
        y = holes(ys[t1], **kw)
        return lambda: fn(cfg, flags, c, qm, qlv, y, None, e_s, e_t, lr, **kw)

    def sums(fn, kw):
        y = holes(ys[t1], **kw)
        return lambda: fn(cfg, flags, carry_p, qm, qlv, y, None, e_s, e_t,
                          inv_b if kw["mask"] is not None else 1.0 / b, **kw)

    us = {}
    for n, kw in seg.items():
        kc = clone(carry_p)             # each variant from the same carry
        k1, k2 = cuda_ms(mega(F.mega_epoch_call, kw, kc), 3), cuda_ms(mega(F.mega_epoch_call, kw,
                                                                           kc), 3)
        us[f"mega_epoch.{n}"] = 1e3 * (k1 + k2) / 2 / MEGA_STEPS
    p1, p2 = cuda_ms(mega(F.mega_epoch_plain, seg["both"], pc), 1), cuda_ms(
        mega(F.mega_epoch_plain, seg["both"], pc), 1)
    us["mega_epoch.both_plain"] = 1e3 * (p1 + p2) / 2 / MEGA_STEPS
    for n, kw in one.items():
        kc = clone(carry_p)
        us[f"fused_step.{n}"] = 1e3 * (cuda_ms(step(F.fused_step_call, kw, kc), 20)
                                       + cuda_ms(step(F.fused_step_call, kw, kc), 20)) / 2
        us[f"forward_sums.{n}"] = 1e3 * (cuda_ms(sums(F.forward_sums_call, kw), 20)
                                         + cuda_ms(sums(F.forward_sums_call, kw), 20)) / 2
    us["fused_step.both_plain"] = 1e3 * cuda_ms(step(F.fused_step_plain, one["both"], pc), 20)
    us["forward_sums.both_plain"] = 1e3 * cuda_ms(sums(F.forward_sums_plain, one["both"]), 20)
    lib = F._library()
    smem = {n: lib.vjf_smem_bytes(ctypes.byref(F._dims(cfg, b, mask=m, cmask=cm)))
            for n, m, cm in (("none", False, False), ("mask", True, False),
                             ("cmask", False, True), ("both", True, True))}
    phase("mask.times", unit="us per timestep", card=smi, smem_bytes_a_block=smem, **us)
    return {k: (us[f"{k}.both"] / 1e3, us[f"{k}.both_plain"] / 1e3)
            for k in ("fused_step", "mega_epoch", "forward_sums")}


def check_mask_main(data, smi) -> dict:
    """The masked main path through ``run_epochs``: one warm-up epoch, then
    two RLS epochs (T = MASK_T, B 256, both masks, NaN padding) through the
    kernels. Fails on a non-finite loss or state leaf, and unless a trial
    that has ended keeps its last valid posterior bit for bit. Returns the
    launches and steps by kernel, counted from 0 over this run."""
    ys_nan, _, mask, cmask, _ = data
    cfg, dev, b = flagship(), ys_nan.device, ys_nan.shape[1]
    us = torch.zeros((ys_nan.shape[0], b, 0), device=dev)
    state = core.init_state(0, cfg, device=dev)
    lrs = [cfg.lr * cfg.lr_decay ** i for i in range(2)]
    masks = dict(mask=mask, channel_mask=cmask)
    F.reset_launches()
    wu, t_warm = synced(lambda: core.run_epochs(cfg, StepFlags(warm_up=True), state, ys_nan, us,
                                                [50], lrs[:1], **masks))
    out, t_rls = synced(lambda: core.run_epochs(cfg, StepFlags(), wu.state, ys_nan, us, [51, 52],
                                                lrs, **masks))
    launches, timesteps = dict(F.launches), dict(F.steps)
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0,
          f"mask.main: launches {launches}")
    check(bool(torch.isfinite(out.epoch_loss).all()), "mask.main: epoch losses not finite")
    leaves = state_leaves(out.state)
    bad = [k for k, v in leaves.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    check(not bad, f"mask.main: non-finite state leaves {bad}")
    check(bool(torch.isfinite(out.q_means).all()), "mask.main: posterior not finite")
    lengths = mask.sum(dim=0).long()
    short = int(torch.argmin(lengths))
    n = int(lengths[short])
    last = out.q_means[n - 1, short]
    check(torch.equal(out.q_means[n:, short], last.expand(ys_nan.shape[0] - n, -1)),
          "mask.main: an ended trial's posterior moved")
    phase("mask.main", config="bench.py flagship, B %d, T %d/epoch, both masks" % (
              b, ys_nan.shape[0]), warmup_epoch_s=t_warm, rls_epochs_s=t_rls,
          rls_steps_per_s=2 * ys_nan.shape[0] / t_rls, epoch_loss=out.epoch_loss.tolist(),
          max_tau=out.max_tau.tolist(), hot_frac=out.hot_frac.tolist(), launches=launches,
          timesteps=timesteps, valid_share=float(mask.mean()),
          observed_share=float((cmask * mask[:, :, None]).mean()), frozen_trial=short,
          frozen_after_step=n - 1, card=smi)
    return {"launches": launches, "steps": timesteps}


def check_fit_ragged(data, smi) -> None:
    """A blocked ``fit`` on the masked flagship data (2 epochs a block,
    warm-up forced to end after 2, ``bench_all.py``'s forgetting), 6 epochs:
    seconds per block with and without the prefix, a finite bootstrap and a
    finite result, no dispatch writing its input, the kernels launched."""
    ys_nan, _, mask, cmask, _ = data
    cfg = flagship().replace(warmup_max=2, **FIT_FORGET)
    state = core.init_state(0, cfg, device=ys_nan.device)
    with watched("run_epochs") as log, timed("_bootstrap_dynamics") as boot:
        F.reset_launches()
        res, secs = synced(lambda: core.fit(cfg, state, ys_nan, seed=9,
                                            max_iter=MASK_FIT_EPOCHS, epochs_per_dispatch=2,
                                            mask=mask, channel_mask=cmask))
        launches = dict(F.launches)
    blocks = blocks_summary(log, ys_nan.shape[0])
    check(all(b["input_intact"] for b in blocks), "fit.ragged: a block wrote its input state")
    check(math.isfinite(res.loss), f"fit.ragged: loss {res.loss}")
    # the bootstrap's state is the input of the first RLS block
    first_rls = [e["input"] for e in log if not e["warm_up"]]
    check(len(boot) == 1 and len(first_rls) > 0, f"fit.ragged: {len(boot)} bootstraps")
    for name, leaves in (("bootstrap", first_rls[0]), ("final", state_leaves(res.state))):
        bad = [k for k, v in leaves.items()
               if v.is_floating_point() and not torch.isfinite(v).all()]
        check(not bad, f"fit.ragged: non-finite {name} state leaves {bad}")
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0,
          f"fit.ragged: launches {launches}")
    rls = [b for b in blocks if not b["warm_up"]]
    free = [i for i, b in enumerate(blocks) if not b["warm_up"] and b["ns_prefix"] == 0]
    phase("fit.ragged", config="flagship, B %d, T %d, both masks, 2 epochs a block, "
          "rls_shrink 0.999, chol_jitter 1e-3" % (ys_nan.shape[1], ys_nan.shape[0]),
          seconds=secs, epochs_run=res.epochs_run, loss=res.loss, warm_up=res.warm_up,
          bootstrap_s=boot[0], bootstrap_finite=True,
          block_s_with_prefix=[b["seconds"] for b in rls if b["ns_prefix"] > 0],
          block_s_prefix_free=[blocks[i]["seconds"] for i in free],
          prefix_free_from_block=free[0] if free else None,
          demoted_blocks=sum(b["fused_step"] == "off" for b in blocks), launches=launches,
          blocks=blocks, card=smi)


def backend_leaves(state, res=None) -> dict:
    """The leaves ``backends.steps`` holds, on the CPU: the state noise, the
    first layer, the decoder and every field of the weight posterior of
    ``state``, and with an epoch's ``res`` its loss and posterior means."""
    d, p = state.dynamics, state.params
    out = {"state_logvar": d.logvar, "w_in": p.recognition.layers[0].weight,
           "w_dec": p.decoder.weight}
    out.update({f"blr.{k}": v for k, v in d.blr._asdict().items()})
    if res is not None:
        out.update(loss=res.metrics.loss, q_means=res.q_means)
    return {k: v.detach().cpu() for k, v in out.items()}


def nosync_cholesky(a, eps: float = 1e-3):
    """``safe_cholesky`` without its repair, so without its host sync: the
    factor, NaN where it failed. Only for timing the sync."""
    del eps
    return linalg.nan_where_failed(*linalg.cholesky_f32(a))


@contextlib.contextmanager
def cholesky_timed(safe: bool):
    """For the duration, every ``safe_cholesky`` of the RLS update and the
    Kalman toolkit (or, with ``safe=False``, :func:`nosync_cholesky` in its
    place) timed on the host clock; yields the seconds of each call. The
    steps are host-bound, so the sync's wait is what separates the two."""
    fn = linalg.safe_cholesky if safe else nosync_cholesky
    secs = []

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs.append(time.perf_counter() - t0)
        return out

    saved = R.safe_cholesky, K.safe_cholesky
    R.safe_cholesky = K.safe_cholesky = call
    try:
        yield secs
    finally:
        R.safe_cholesky, K.safe_cholesky = saved


def cast_state(state, dtype, device):
    """A copy of ``state`` with every float leaf in ``dtype`` on ``device``."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype if x.is_floating_point() else x.dtype)
        if isinstance(x, torch.nn.Linear):
            return linear_from(leaf(x.weight), None if x.bias is None else leaf(x.bias))
        if isinstance(x, Recognition):
            return map_linears(x, leaf)
        return type(x)(*(leaf(v) for v in x)) if isinstance(x, tuple) else x

    return leaf(state)


def check_backends_steps(dev, smi) -> dict:
    """The precision, covariance and Kalman backends on the card
    (``bench_all.py`` config #1's widths, B 1): ``BACKEND_STEPS`` steps of the
    autograd epoch (the only route these states take) from the same state
    with the same injected draws on the card and on the CPU, held by
    ``compare`` within the limits of ``BACKEND_TOL``; each planted fault
    (``rls_shrink`` changed, the Joseph quirk flipped) must be rejected.
    Each backend's µs per step on the card, and again with
    ``safe_cholesky`` replaced by a factorisation without repair (no host
    sync): the two must give the same bits; the host time inside those
    calls is what the sync costs. nsv on the autograd route is timed beside
    them. Returns µs per step."""
    base, y, _ = quality_problem("van_der_pol")
    base = base.replace(rls_backend="auto", chol_jitter=0.0)
    steps, cpu = BACKEND_STEPS, torch.device("cpu")
    g = torch.Generator().manual_seed(60)
    eps = torch.randn((2, steps, 1, base.xdim), generator=g, dtype=torch.float64)

    def epoch(cf, state):
        dt, device = cf.tdtype, state.dynamics.logvar.device
        ys = torch.as_tensor(y[:steps, None, :], dtype=dt, device=device)
        us = torch.zeros((steps, 1, 0), dtype=dt, device=device)
        noise = (eps[0].to(device, dt), eps[1].to(device, dt))
        return synced(lambda: core.run_epoch(cf, StepFlags(), state, ys, us, 0, cf.lr,
                                             noise=noise))

    def leaves(res):
        return backend_leaves(res.state, res)

    times = {}
    for name, (kw, kind, fault) in BACKEND_CASES.items():
        c = base.replace(**kw)
        built = core.init_state(0, c, device=dev, batch_hint=1)
        check(type(built.dynamics.blr).__name__ == kind,
              f"backends.steps[{name}]: built {type(built.dynamics.blr).__name__}, not {kind}")
        check(not F.fused_enabled(c, built, n_batch=1),
              f"backends.steps[{name}]: routed to the kernels")
        # one state for every run: drawn at float64, cast to the run's dtype
        backend = dyn.resolve_backend(c, batch_hint=1)
        s64 = core.init_state(0, c.replace(dtype="float64"), device=cpu, backend=backend)
        on_cpu = cast_state(s64, c.tdtype, cpu)
        on_card = cast_state(s64, c.tdtype, dev)
        ref, _ = epoch(c, on_cpu)
        start = backend_leaves(on_cpu)
        tol = BACKEND_TOL[c.dtype]
        if c.dtype == "float32":
            exact, _ = epoch(c.replace(dtype="float64"), s64)
            own, _ = compare_errs(leaves(exact), leaves(ref), backend_leaves(s64))
            tol = {k: max(tol, BACKEND_F32_MARGIN * e) for k, e in own.items()}
        # the fault's run goes first: it warms the card up for the timed runs
        faulty, _ = epoch(c.replace(**fault), on_card)
        with cholesky_timed(safe=True) as in_sync:
            got, secs = epoch(c, on_card)
        with cholesky_timed(safe=False) as in_bare:
            bare, bare_s = epoch(c, on_card)
        check(got.metrics.tau is None, f"backends.steps[{name}]: not the autograd route")
        err = compare(f"backends.steps[{name}]", leaves(ref), leaves(got), tol, start)
        fault_name = ",".join(f"{k}={v}" for k, v in fault.items())
        compare(f"backends.steps[{name}].fault.{fault_name}", leaves(ref), leaves(faulty), tol,
                start, reject=True)
        a, b = leaves(got), leaves(bare)
        check(all(torch.equal(a[k], b[k]) for k in a),
              f"backends.steps[{name}]: the repair of safe_cholesky fired")
        times[name] = {"us_per_step": 1e6 * secs / steps,
                       "no_sync_us_per_step": 1e6 * bare_s / steps,
                       "safe_cholesky_calls_per_step": len(in_sync) / steps,
                       "in_safe_cholesky_us_per_step": 1e6 * sum(in_sync) / steps,
                       "in_no_sync_cholesky_us_per_step": 1e6 * sum(in_bare) / steps,
                       "max_abs_err": err}
    nsv = base.replace(rls_backend="nsv", fused_step="off")
    nsv_state = core.init_state(0, nsv, device=dev)
    epoch(nsv, nsv_state)
    _, nsv_s = epoch(nsv, nsv_state)
    times["nsv.f32"] = {"us_per_step": 1e6 * nsv_s / steps}
    phase("backends.times", config="bench_all.py #1 widths (ydim 20, xdim 2, n_rbf 100, "
          "hidden (20,)), B 1, autograd epoch, %d steps" % steps, unit="us per step",
          card=smi, **times)
    return times


def check_backends_fit(dev, smi) -> None:
    """A short per-epoch ``fit`` at B 1 on the Van der Pol data (its first
    ``BACKEND_FIT_T`` steps) with ``rls_backend='auto'`` and ``chol_jitter``
    0, which resolves to the covariance form, then the same with
    ``dynamics_update='kalman'``: every epoch on the autograd route, a
    finite result, the covariance form kept, the forecast beside
    persistence (reported, not gated: three epochs)."""
    cfg, y, x = quality_problem("van_der_pol")
    y, x = y[:BACKEND_FIT_T], x[:BACKEND_FIT_T]
    base = cfg.replace(rls_backend="auto", chol_jitter=0.0, warmup_max=2)
    for name, kw in (("auto", {}), ("kalman", dict(dynamics_update="kalman"))):
        c = base.replace(**kw)
        state = core.init_state(0, c, device=dev, batch_hint=1)
        with watched("run_epoch") as log:
            res, secs = synced(lambda: core.fit(c, state, y, seed=0, max_iter=3))
        blr = res.state.dynamics.blr
        check(isinstance(blr, R.CovarianceBLR), f"backends.fit.{name}: {type(blr).__name__}")
        check(math.isfinite(res.loss) and not res.warm_up,
              f"backends.fit.{name}: loss {res.loss}, warm_up {res.warm_up}")
        check(all(bool(torch.isfinite(v).all()) for v in blr), f"backends.fit.{name}: blr")
        check(all(e["route"] == "autograd" for e in log), f"backends.fit.{name}: a fused epoch")
        check(all(e["input_intact"] for e in log), f"backends.fit.{name}: input written")
        m_rmse, p_rmse = forecast_rmse(c, res.state, res.mu[:, 0, :], y, 0)
        phase(f"backends.fit.{name}", config="bench_all.py #1 van_der_pol_gaussian, T %d, B 1, "
              "rls_backend auto, chol_jitter 0" % BACKEND_FIT_T, dynamics_update=c.dynamics_update,
              blr=type(blr).__name__, seconds=secs, epochs_run=res.epochs_run, loss=res.loss,
              us_per_step=[1e6 * e["seconds"] / BACKEND_FIT_T for e in log],
              latent_r2=latent_r2(res.mu[:, 0, :], x), forecast_rmse=m_rmse,
              persistence_rmse=p_rmse, card=smi)


def stream_cfg() -> VJFConfig:
    """``bench_all.py``'s config #4 (neural population streaming)."""
    return VJFConfig(ydim=200, xdim=10, udim=0, n_rbf=100, hidden_sizes=(32,),
                     likelihood="poisson", dtype="float32", rls_backend="nsv")


def stream_counts() -> np.ndarray:
    """``bench_all.py:bench_streaming``'s recording: (T, B, ydim) counts
    drawn as Poisson(0.12) with numpy seed 0, clipped to 255, as uint8."""
    rng = np.random.default_rng(0)
    return np.minimum(rng.poisson(0.12, size=(STREAM_T, STREAM_B, 200)), 255).astype(np.uint8)


def stream(model, chunks, k: int, **kw):
    """Every result of ``model.filter_stream`` and its seconds, the device
    synchronised."""
    return synced(lambda: list(model.filter_stream(chunks, chunks_per_dispatch=k, **kw)))


def same_results(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x.q_means, y.q_means) and torch.equal(x.q_logvars, y.q_logvars)
        and torch.equal(x.metrics.loss, y.metrics.loss) for x, y in zip(a, b))


def same_state(a, b) -> bool:
    a, b = state_leaves(a), state_leaves(b)
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def stream_hot(cfg, results) -> tuple:
    """(hot fraction over the stream's post-prefix steps, demoted): the
    first chunk's prefix steps are left out, and a result without a tau
    stream took the autograd route."""
    taus = [r.metrics.tau[cfg.ns_prefix if i == 0 else 0:]
            for i, r in enumerate(results) if r.metrics.tau is not None]
    tau = torch.cat(taus)
    hot = float(((tau >= F.NS_TAU_MAX) | ~torch.isfinite(tau)).float().mean())
    return hot, len(taus) < len(results)


def step_mega_bounds(cfg, b, carry, qm, qlv, y0, e_s, e_t, lr, stepped, seg_tau) -> tuple:
    """The bounds of one step kernel launch and of a mega step at ``b``
    trials: each input read once and each output written once; the mega
    segment's carry once per MEGA_STEPS steps, its Newton-Schulz
    iterations as the timed segment's tau asked for (base, +1 at 0.05, +2
    at 0.25, none when skipped at 0.7)."""
    nfp = carry.p_mat.shape[0]
    read, written = carry_bytes(carry), carry_bytes(carry, written=True)
    step_b = bound(cfg, read + written + nbytes(y0, qm, qlv, e_s, e_t, lr) + nbytes(
        stepped.q_pack, stepped.g_vec, stepped.xt, stepped.xs, stepped.scal),
        step_ops(cfg, b, nfp, F.NS_ITERS))
    iters = torch.where(seg_tau < F.NS_TAU_MAX, F.mega_ns_base_iters(cfg, b)
                        + (seg_tau >= F.NS_TAU_ESCALATE).int()
                        + F.NS_EXTRA_ITERS * (seg_tau >= F.NS_TAU_THRESHOLD).int(), 0)
    mega_b = bound(cfg, (read + written + nbytes(qm, qlv)) / MEGA_STEPS + nbytes(y0, e_s, e_t)
                   + nbytes(stepped.q_pack) + 4 * 8,
                   step_ops(cfg, b, nfp, float(iters.float().mean())))
    return step_b, mega_b


def kernel_times(cfg, carry, qm, qlv, ys, eps, lr) -> dict:
    """us per step of the step kernel and of the mega kernel (over
    ``ys``'s MEGA_STEPS steps) beside their plain versions, timed in turns
    (plain, kernel, kernel, plain), and one step's output for the bounds."""
    flags = StepFlags()
    carry_s, carry_m = clone(carry), clone(carry)
    args = (ys[0], None, eps[0, 0], eps[1, 0], lr)

    def k_step():
        return F.fused_step_call(cfg, flags, carry_s, qm, qlv, *args)

    def p_step():
        F.fused_step_plain(cfg, flags, carry, qm, qlv, *args)

    def k_mega():
        F.mega_epoch_call(cfg, flags, carry_m, qm, qlv, ys, None, eps[0], eps[1], lr)

    def p_mega():
        F.mega_epoch_plain(cfg, flags, carry, qm, qlv, ys, None, eps[0], eps[1], lr)

    p1, k1, k2, p2 = cuda_ms(p_step, 20), cuda_ms(k_step, 20), cuda_ms(k_step, 20), cuda_ms(p_step, 20)
    out = {"fused_step": (1e3 * (k1 + k2) / 2, 1e3 * (p1 + p2) / 2)}
    p1, k1, k2, p2 = cuda_ms(p_mega, 1), cuda_ms(k_mega, 3), cuda_ms(k_mega, 3), cuda_ms(p_mega, 1)
    n = ys.shape[0]
    out["mega_epoch"] = (1e3 * (k1 + k2) / 2 / n, 1e3 * (p1 + p2) / 2 / n)
    out["stepped"] = k_step()
    return out


def check_stream(dev, smi) -> dict:
    """``bench_all.py``'s config #4 at its own size through the facade: the
    uint8 recording in a file, read by the native ``StreamingLoader``,
    staged on the card by ``device_prefetch`` and filtered by
    ``VJF.filter_stream`` in blocks of K chunks; the same stream replayed
    from chunks already on the card, and as float32, must give the same
    bits. Then, at B 16, each kernel against its plain version (one prefix
    step from the stream's first state, MEGA_STEPS mega steps from its state
    after the first chunk) with the planted faults, and their times. Returns
    the launches, errors, times and bounds for the ``kernels`` line."""
    cfg = stream_cfg()
    data = stream_counts()
    k = STREAM_K
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.bin")
        data.tofile(path)
        # the warm-up runs the first chunk's path and one block on another
        # model, before the timed loader starts reading
        probe = StreamingLoader(path, ydim=cfg.ydim, batch=STREAM_B, chunk=STREAM_CHUNK,
                                dtype=np.uint8)
        first = next(probe)
        probe.close()
        _, warm_s = stream(VJF(cfg, seed=1), iter([first] * 3), 2)
        model = VJF(cfg, seed=0)
        loader = StreamingLoader(path, ydim=cfg.ydim, batch=STREAM_B, chunk=STREAM_CHUNK,
                                 dtype=np.uint8)
        native = loader.is_native
        check(native, "stream: the native loader did not build")
        F.reset_launches()
        e2e, wall = stream(model, device_prefetch(loader, depth=k + 1,
                                                  valid_fn=lambda: loader.last_valid), k)
        launches, timesteps = dict(F.launches), dict(F.steps)
    n = sum(r.q_means.shape[0] for r in e2e)
    hot, demoted = stream_hot(cfg, e2e)
    check(n == STREAM_T, f"stream: {n} steps, expected {STREAM_T}")
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0, f"stream: launches {launches}")
    check(all(bool(torch.isfinite(r.metrics.loss).all()) for r in e2e), "stream: a loss not finite")
    check(all(bool(torch.isfinite(r.q_means).all()) for r in e2e), "stream: a posterior not finite")
    chunks = [torch.from_numpy(data[i:i + STREAM_CHUNK]).to(dev)
              for i in range(0, STREAM_T, STREAM_CHUNK)]
    replay_model = VJF(cfg, seed=0)
    replay, pipe_wall = stream(replay_model, iter(chunks), k)
    f32_model = VJF(cfg, seed=0)
    f32, _ = stream(f32_model, iter([c.float() for c in chunks]), k)
    check(same_results(e2e, replay) and same_state(model.state, replay_model.state),
          "stream: the loader and prefetch changed the bits of the device-resident replay")
    check(same_results(replay, f32) and same_state(replay_model.state, f32_model.state),
          "stream: the uint8 stream differs from the float32 stream")
    phase("stream", config="bench_all.py #4 neural_population_streaming: T %d, B %d, ydim 200, "
          "xdim 10, n_rbf 100, hidden (32,), Poisson, float32, nsv" % (STREAM_T, STREAM_B),
          chunk=STREAM_CHUNK, chunks_per_dispatch=k, native_loader=native, steps=n,
          wall_s=wall, steps_per_s=n / wall, pipeline_steps_per_s=n / pipe_wall,
          warm_up_s=warm_s, launches=launches, timesteps=timesteps, hot_frac=hot,
          demoted=demoted, losses_finite=True, uint8_bits_equal_float32=True,
          e2e_bits_equal_replay=True, card=smi)

    # the kernels at B 16: the stream's first step, and MEGA_STEPS steps of
    # its second chunk from its state after the first
    flags = StepFlags()
    lr = torch.tensor(cfg.lr, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    eps = torch.randn((2, MEGA_STEPS, STREAM_B, cfg.xdim), device=dev, generator=g)
    ys0, ys1 = chunks[0].float(), chunks[1].float()
    state0 = VJF(cfg, seed=0).state
    q0 = core.prior(state0.params, STREAM_B)
    carry0 = F.pad_carry(cfg, state0)
    start = flatten(carry0._asdict())
    args = (q0.mean.contiguous(), q0.logvar.contiguous(), ys0[0], eps[0, 0], eps[1, 0], lr)
    ref = prefix_step(F.fused_step_plain, cfg, flags, clone(carry0), *args)
    got = prefix_step(F.fused_step_call, cfg, flags, clone(carry0), *args)
    tol = TOL[cfg.matmul_dtype]
    errs = {"fused_step": compare("stream.step[b16]", packed(ref), packed(got), tol, start)}
    for fault, (fcfg, fflags) in faults(cfg, flags).items():
        bad = prefix_step(F.fused_step_call, fcfg, fflags, clone(carry0), *args)
        compare(f"stream.step[b16].fault.{fault}", packed(ref), packed(bad), tol, start,
                reject=True)
    # the mega kernel over MEGA_STEPS steps of the second chunk, from the kind
    # of state the flagship's check starts from, at B 16: a warm-up epoch of
    # WARM_STEPS steps, then an RLS epoch of ns_prefix steps (the per-step
    # kernel and the exact fallback)
    pre_ys = torch.from_numpy(data[:WARM_STEPS + cfg.ns_prefix]).to(dev).float()
    us = torch.zeros((cfg.ns_prefix, STREAM_B, 0), device=dev)
    warm = core.run_epoch(cfg, StepFlags(warm_up=True), state0, pre_ys[:WARM_STEPS],
                          us[:WARM_STEPS], 5, lr)
    pre = core.run_epoch(cfg, flags, warm.state, pre_ys[WARM_STEPS:], us, 8, lr,
                         q0=core.Gaussian(warm.q_means[-1], warm.q_logvars[-1]))
    carry1 = F.pad_carry(cfg, pre.state)
    qm1, qlv1 = pre.q_means[-1].contiguous(), pre.q_logvars[-1].contiguous()
    errs["mega_epoch"], _, (_, _, ks) = check_mega(
        "stream.mega[b16]", cfg, flags, carry1, qm1, qlv1, ys1[:MEGA_STEPS], eps[0], eps[1], lr)
    # the same from the stream's own state after its first chunk (no warm-up),
    # reported, not gated, beside the plain version against itself from a V
    # one float32 ulp away (V * (1 + 2^-23)) and the segment's tau range:
    # where that moves a leaf as much as the kernel does, the leaf is not
    # determined in float32 there
    after = VJF(cfg, seed=0)
    first = list(after.filter_stream(iter(chunks[:1])))[0]
    carry2 = F.pad_carry(cfg, after.state)
    qm2, qlv2 = first.q_means[-1].contiguous(), first.q_logvars[-1].contiguous()
    seg = (ys1[:MEGA_STEPS], None, eps[0], eps[1], lr)
    ref2 = segment(*F.mega_epoch_plain(cfg, flags, clone(carry2), qm2, qlv2, *seg))
    start2 = flatten(carry2._asdict())
    k_errs, _ = compare_errs(ref2, segment(*F.mega_epoch_call(cfg, flags, clone(carry2), qm2,
                                                              qlv2, *seg)), start2)
    nudged = clone(carry2)._replace(v_mat=carry2.v_mat * (1 + F32_ULP))
    u_errs, _ = compare_errs(ref2, segment(*F.mega_epoch_plain(cfg, flags, nudged, qm2, qlv2,
                                                               *seg)), start2)
    phase("stream.mega[b16].after_first_chunk", steps=MEGA_STEPS, gated=False,
          tau_min=float(ref2["tau"].min()), tau_max=float(ref2["tau"].max()),
          kernel_err_by_leaf={k: float(f"{v:.3e}") for k, v in k_errs.items() if v > 0},
          plain_v_one_ulp_err_by_leaf={k: float(f"{v:.3e}") for k, v in u_errs.items()
                                       if v > 0})
    times = kernel_times(cfg, carry1, qm1, qlv1, ys1[:MEGA_STEPS], eps, lr)
    bounds = step_mega_bounds(cfg, STREAM_B, carry1, qm1, qlv1, ys1[0], eps[0, 0], eps[1, 0], lr,
                              times["stepped"], ks[:, 4])
    phase("stream.times", unit="us per timestep", batch=STREAM_B,
          mega_base_ns_iters=F.mega_ns_base_iters(cfg, STREAM_B),
          fused_step=times["fused_step"][0], fused_step_plain=times["fused_step"][1],
          mega_epoch=times["mega_epoch"][0], mega_epoch_plain=times["mega_epoch"][1], card=smi)
    return {"launches": launches, "steps": timesteps, "errs": errs,
            "ms": {kk: (v[0] / 1e3, v[1] / 1e3) for kk, v in times.items() if kk != "stepped"},
            "bounds": {"fused_step": bounds[0], "mega_epoch": bounds[1]}, "data": data}


def check_stream_tail(cfg, data, smi) -> None:
    """A stream whose last chunk is partial, read by the loader and staged
    by ``device_prefetch`` as ``(chunk, n_valid)`` pairs: the first chunk
    alone, a block of two, then the tail's valid steps, one ``filter`` step
    each; exactly the valid steps come out."""
    t_len = 3 * STREAM_SHORT_CHUNK + STREAM_TAIL
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tail.bin")
        data[:t_len].tofile(path)
        loader = StreamingLoader(path, ydim=cfg.ydim, batch=STREAM_B, chunk=STREAM_SHORT_CHUNK,
                                 dtype=np.uint8)
        out, secs = stream(VJF(cfg, seed=2), device_prefetch(
            loader, depth=3, valid_fn=lambda: loader.last_valid), 2)
    lens = [r.q_means.shape[0] for r in out]
    check(lens == [STREAM_SHORT_CHUNK] * 3 + [STREAM_TAIL], f"stream.tail: chunk lengths {lens}")
    check(all(bool(torch.isfinite(r.q_means).all() and torch.isfinite(r.metrics.loss).all())
              for r in out), "stream.tail: not finite")
    check(out[-1].metrics.tau is None, "stream.tail: the tail did not take the filter step")
    phase("stream.tail", steps=sum(lens), chunk_lengths=lens, seconds=secs,
          tail="per-step VJF.filter (autograd step)", card=smi)


def check_stream_resume(cfg, data, dev, smi) -> None:
    """A K-block stream (K 2, chunks of STREAM_SHORT_CHUNK) with a snapshot
    every K chunks, stopped after its second block and resumed on a model of
    another seed: the rest of the stream, the final state, the posterior,
    the learning rate and the generator are the uninterrupted stream's."""
    k, n_chunks = 2, 7
    chunks = [torch.from_numpy(data[i:i + STREAM_SHORT_CHUNK]).to(dev)
              for i in range(0, n_chunks * STREAM_SHORT_CHUNK, STREAM_SHORT_CHUNK)]
    ref = VJF(cfg, seed=3)
    ref_out, ref_s = stream(ref, iter(chunks), k)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.ckpt")
        part = VJF(cfg, seed=3)
        gen = part.filter_stream(iter(chunks), chunks_per_dispatch=k, checkpoint_path=path,
                                 checkpoint_every=k)
        list(itertools.islice(gen, 1 + 2 * k))
        gen.close()
        done = load_snapshot(path, dev).chunks_done
        check(done == 1 + 2 * k, f"stream.resume: snapshot at chunk {done}")
        res = VJF(cfg, seed=4)
        out, secs = stream(res, iter(chunks[done:]), k, resume_from=path)
    check(same_results(out, ref_out[done:]), "stream.resume: the resumed results differ")
    check(same_state(res.state, ref.state), "stream.resume: the final state differs")
    check(res._lr == ref._lr and torch.equal(res.generator.get_state(), ref.generator.get_state()),
          "stream.resume: the learning rate or the generator differs")
    phase("stream.resume", chunks=n_chunks, chunk=STREAM_SHORT_CHUNK, chunks_per_dispatch=k,
          resumed_at_chunk=done, bit_identical=True, uninterrupted_s=ref_s, resumed_s=secs,
          card=smi)


def check_fit_resume(cfg, ys, smi) -> None:
    """The blocked flagship ``fit`` (2 epochs a block, warm-up forced to end
    after 2, ``bench_all.py``'s forgetting) with a snapshot every 2 epochs,
    stopped after 4 and resumed from another state and seed to 6: the
    result is the uninterrupted fit's, bit for bit."""
    cfg = cfg.replace(warmup_max=2, **FIT_FORGET)
    ys = ys[:FIT_RESUME_T]
    dev = ys.device
    state = core.init_state(0, cfg, device=dev)
    ref, ref_s = synced(lambda: core.fit(cfg, state, ys, seed=7, max_iter=6,
                                         epochs_per_dispatch=2))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.ckpt")
        synced(lambda: core.fit(cfg, state, ys, seed=7, max_iter=4, epochs_per_dispatch=2,
                                checkpoint_path=path, checkpoint_every=2))
        snap = load_snapshot(path, dev)
        check(snap.epoch == 4 and not snap.warm_up, f"fit.resume: snapshot at {snap.epoch}")
        got, secs = synced(lambda: core.fit(cfg, core.init_state(1, cfg, device=dev), ys,
                                            seed=9, max_iter=6, epochs_per_dispatch=2,
                                            resume_from=path))
    check(torch.equal(got.mu, ref.mu) and torch.equal(got.logvar, ref.logvar),
          "fit.resume: the posteriors differ")
    check((got.loss, got.lr, got.epochs_run, got.warm_up) == (ref.loss, ref.lr, ref.epochs_run,
                                                              ref.warm_up),
          f"fit.resume: {(got.loss, got.lr, got.epochs_run)} != {(ref.loss, ref.lr, ref.epochs_run)}")
    check(same_state(got.state, ref.state), "fit.resume: the state differs")
    phase("fit.resume", config="bench.py flagship, B %d, T %d, 2 epochs a block, rls_shrink "
          "0.999, chol_jitter 1e-3" % (ys.shape[1], ys.shape[0]), epochs=6, resumed_at_epoch=4,
          prefix_free_at_snapshot=snap.prefix_free, bit_identical=True, uninterrupted_s=ref_s,
          resumed_s=secs, loss=got.loss, card=smi)


def check_facade_vdp(dev, smi) -> None:
    """``bench_all.py``'s config #1 through the facade with the knobs of
    ``examples/limit_cycle.py``: the default backend at B 1 and float32 is
    nsv and the fit takes the kernels; quality is reported, not gated; the
    kernels' us per step at B 1; then ``save`` and ``load``: one filter step
    and one fit epoch of the loaded model give the bits of the one never
    saved."""
    _, y, x = quality_problem("van_der_pol")
    model = VJF.make_model(ydim=20, xdim=2, n_rbf=100, hidden_sizes=[20], likelihood="gaussian",
                           lr=1e-3, rtol=0.0, warmup_max=15, rls_shrink=0.999, chol_jitter=1e-3)
    cfg = model.cfg
    blr = type(model.state.dynamics.blr).__name__
    check(blr == "NSVBLR", f"facade.vdp: the default backend built {blr}")
    check(F.fused_enabled(cfg, model.state, n_batch=1), "facade.vdp: B 1 does not take the kernels")
    F.reset_launches()
    (mu, logvar, loss), secs = synced(lambda: model.fit(y, max_iter=FACADE_EPOCHS,
                                                        epochs_per_dispatch=5))
    launches, timesteps = dict(F.launches), dict(F.steps)
    epochs_run = model.epochs_run
    check(launches["mega_epoch"] > 0, f"facade.vdp: launches {launches}")
    check(math.isfinite(loss) and bool(torch.isfinite(mu).all()), f"facade.vdp: loss {loss}")
    m = mu[:, 0, :]
    m_rmse, p_rmse = forecast_rmse(cfg, model.state, m, y, 0)
    # the kernels at B 1 from the fitted state
    g = torch.Generator(device=dev).manual_seed(7)
    eps = torch.randn((2, MEGA_STEPS, 1, cfg.xdim), device=dev, generator=g)
    ys = torch.as_tensor(y[:MEGA_STEPS], device=dev)[:, None, :]
    times = kernel_times(cfg, F.pad_carry(cfg, model.state), mu[-1].contiguous(),
                         logvar[-1].contiguous(), ys, eps, torch.tensor(model._lr, device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vdp.pt")
        model.save(path)
        loaded = VJF.load(path)
    check(same_state(model.state, loaded.state) and loaded._lr == model._lr
          and loaded._decoder_frozen == model._decoder_frozen
          and torch.equal(loaded.generator.get_state(), model.generator.get_state()),
          "facade.vdp: load did not restore the model")
    (q1, l1), (q2, l2) = model.filter(y[0]), loaded.filter(y[0])
    check(torch.equal(q1.mean, q2.mean) and torch.equal(q1.logvar, q2.logvar)
          and torch.equal(l1, l2), "facade.vdp: a filter step of the loaded model differs")
    f1, f2 = model.fit(y, max_iter=1), loaded.fit(y, max_iter=1)
    check(torch.equal(f1[0], f2[0]) and f1[2] == f2[2] and same_state(model.state, loaded.state),
          "facade.vdp: a fit epoch of the loaded model differs")
    phase("facade.vdp", config="bench_all.py #1 van_der_pol_gaussian, T 1200, B 1, "
          "VJF.make_model with examples/limit_cycle.py's knobs", backend=blr,
          epochs_run=epochs_run, seconds=secs, steps_per_s=y.shape[0] * epochs_run / secs, loss=loss, launches=launches,
          timesteps=timesteps, latent_r2=latent_r2(m, x), forecast_rmse=m_rmse,
          persistence_rmse=p_rmse, b1_us_per_step={
              "fused_step": times["fused_step"][0], "fused_step_plain": times["fused_step"][1],
              "mega_epoch": times["mega_epoch"][0], "mega_epoch_plain": times["mega_epoch"][1]},
          save_load_bit_identical=True, card=smi)


def ensemble_check_state(cfg, ys, lr):
    """ENS_N distinct members at ENS_B trials (per-member data ``ys``, (N,
    T, B, ydim)): fresh states of seeds 0..N-1 after a warm-up epoch of
    WARM_STEPS and a ``cfg.ns_prefix``-step RLS prefix, both through the
    ensemble launches, as the flagship's checks start from a warm-up and a
    prefix. Returns the stacked carry (Philox keys 300 + m) and the
    posterior entering the next step."""
    n = ys.shape[0]
    states = [core.init_state(m, cfg, device=ys.device) for m in range(n)]
    warm = F.run_epoch_fused(cfg, StepFlags(warm_up=True), states, ys[:, :WARM_STEPS], None,
                             [100 + m for m in range(n)], lr)
    q0 = core.Gaussian(warm.q_means[:, -1].contiguous(), warm.q_logvars[:, -1].contiguous())
    hi = WARM_STEPS + cfg.ns_prefix
    pre = F.run_epoch_fused(cfg, StepFlags(), warm.state, ys[:, WARM_STEPS:hi], None,
                            [200 + m for m in range(n)], lr, q0=q0)
    carry = F.stack_carries([F.pad_carry(cfg, st)._replace(
        rng_seed=torch.full((1, 1), 300 + m, dtype=torch.int32, device=ys.device))
        for m, st in enumerate(pre.state)])
    return carry, pre.q_means[:, -1].contiguous(), pre.q_logvars[:, -1].contiguous()


def member_faults(ys, qm, qlv) -> dict:
    """Planted faults of an ensemble launch, as (y, q mean, q log-variance)
    that the comparison against the sound plain run must reject: each
    member but the first reading the y of the member before it (a stride
    one member short), and the per-member posterior read as one copy for
    all members (member 0's, stacked)."""
    return {"y_stride": (torch.cat([ys[:1], ys[:-1]]), qm, qlv),
            "qs_shared": (ys, qm[:1].expand_as(qm).contiguous(),
                          qlv[:1].expand_as(qlv).contiguous())}


def check_ensemble_kernels(cfg, ys, lr, smi) -> dict:
    """The two ensemble launches (N members, one cluster each) against their
    plain versions (the solo plain versions over the members) from
    :func:`ensemble_check_state`, with ``compare``'s limits, on per-member
    y and on one y shared by all (stride 0, the form ``fit_ensemble`` on
    shared data launches); the planted member faults; member m of each
    N-member launch against a solo launch of member m, bit for bit; their
    times beside the plain versions; the cluster waves. Returns the
    errors, times and one step's output."""
    n, b = ys.shape[0], ys.shape[2]
    flags = StepFlags()
    carry, qm, qlv = ensemble_check_state(cfg, ys, lr)
    start = flatten(carry._asdict())
    lo = WARM_STEPS + cfg.ns_prefix
    y0, seg = ys[:, lo].contiguous(), ys[:, lo:lo + MEGA_STEPS].contiguous()
    tol = TOL[cfg.matmul_dtype]

    def step(fn, c, y, m, lv):
        prev = c._replace(dyn_n=c.dyn_n.clone(), state_logvar=c.state_logvar.clone())
        return fallback_of(fn)(cfg, fn(cfg, flags, c, m, lv, y, None, None, None, lr), prev,
                               None)

    ref = step(F.fused_step_plain, clone(carry), y0, qm, qlv)
    got = step(F.fused_step_call, clone(carry), y0, qm, qlv)
    errs = {"fused_step": compare("ensemble.step", packed(ref), packed(got), tol, start)}
    for fault, (fy, fm, flv) in member_faults(y0, qm, qlv).items():
        bad = step(F.fused_step_call, clone(carry), fy, fm, flv)
        compare(f"ensemble.step.fault.{fault}", packed(ref), packed(bad), tol, start,
                reject=True)
    seg_args = (qm, qlv, seg, None, None, None, lr)
    ref = F.mega_epoch_plain(cfg, flags, clone(carry), *seg_args)
    got = F.mega_epoch_call(cfg, flags, clone(carry), *seg_args)
    errs["mega_epoch"] = compare("ensemble.mega", segment(*ref), segment(*got), tol, start)
    for fault, (fy, fm, flv) in member_faults(seg, qm, qlv).items():
        bad = F.mega_epoch_call(cfg, flags, clone(carry), fm, flv, fy, None, None, None, lr)
        compare(f"ensemble.mega.fault.{fault}", segment(*ref), segment(*bad), tol, start,
                reject=True)
    # one y for all members, read at stride 0
    y_one, seg_one = y0[0], seg[0]
    ref = step(F.fused_step_plain, clone(carry), y_one, qm, qlv)
    shared = step(F.fused_step_call, clone(carry), y_one, qm, qlv)
    errs["fused_step"] = max(errs["fused_step"], compare(
        "ensemble.step.shared_y", packed(ref), packed(shared), tol, start))
    one_args = (qm, qlv, seg_one, None, None, None, lr)
    ref = F.mega_epoch_plain(cfg, flags, clone(carry), *one_args)
    shared = F.mega_epoch_call(cfg, flags, clone(carry), *one_args)
    errs["mega_epoch"] = max(errs["mega_epoch"], compare(
        "ensemble.mega.shared_y", segment(*ref), segment(*shared), tol, start))

    # member m of the N-member launch against a solo launch of member m
    stepped = F.fused_step_call(cfg, flags, clone(carry), qm, qlv, y0, None, None, None, lr)
    differ = []
    for m in range(n):
        solo = F.fused_step_call(cfg, flags, clone(F.member_carry(carry, m)), qm[m], qlv[m],
                                 y0[m], None, None, None, lr)
        one = F.PackedStepOut(F.member_carry(stepped.carry, m), *(x[m] for x in stepped[1:]))
        a, z = packed(solo), packed(one)
        differ += [f"step.{m}.{k}" for k in a if not torch.equal(a[k], z[k])]
        solo = F.mega_epoch_call(cfg, flags, clone(F.member_carry(carry, m)), qm[m], qlv[m],
                                 seg[m], None, None, None, lr)
        a, z = segment(*solo), segment(F.member_carry(got[0], m), got[1][m], got[2][m])
        differ += [f"mega.{m}.{k}" for k in a if not torch.equal(a[k], z[k])]
    check(not differ, f"ensemble.members_vs_solo: leaves differ: {differ[:8]}")
    phase("ensemble.members_vs_solo", members=n, launches=["fused_step", "mega_epoch"],
          steps=[1, MEGA_STEPS], bit_identical=True)

    # times: the whole ensemble's step and mega step, in turns
    c_s, c_m = clone(carry), clone(carry)
    k_step = lambda: F.fused_step_call(cfg, flags, c_s, qm, qlv, y0, None, None, None, lr)
    p_step = lambda: F.fused_step_plain(cfg, flags, carry, qm, qlv, y0, None, None, None, lr)
    k_mega = lambda: F.mega_epoch_call(cfg, flags, c_m, *seg_args)
    p_mega = lambda: F.mega_epoch_plain(cfg, flags, carry, *seg_args)
    p1, k1, k2, p2 = cuda_ms(p_step, 3), cuda_ms(k_step, 20), cuda_ms(k_step, 20), cuda_ms(
        p_step, 3)
    ms = {"fused_step": ((k1 + k2) / 2, (p1 + p2) / 2)}
    p1, k1, k2, p2 = (cuda_ms(p_mega, 1), cuda_ms(k_mega, 3), cuda_ms(k_mega, 3),
                      cuda_ms(p_mega, 1))
    ms["mega_epoch"] = ((k1 + k2) / 2 / MEGA_STEPS, (p1 + p2) / 2 / MEGA_STEPS)
    info = F.cluster_info(cfg, flags, carry, qm, qlv, seg, None, lr)
    phase("ensemble.kernels", members=n, batch=b, unit="us per step of all members",
          fused_step=1e3 * ms["fused_step"][0], fused_step_plain=1e3 * ms["fused_step"][1],
          mega_epoch=1e3 * ms["mega_epoch"][0], mega_epoch_plain=1e3 * ms["mega_epoch"][1],
          mega_us_per_member_step=1e3 * ms["mega_epoch"][0] / n, cluster=info, card=smi)
    return {"errs": errs, "ms": ms, "carry": carry, "qm": qm, "qlv": qlv, "stepped": stepped,
            "mega_tau": got[2][..., 4], "y0": y0}


@contextlib.contextmanager
def ensemble_dispatches():
    """``parallel.ensemble._ensemble_epoch`` wrapped for the duration: each
    dispatch timed with the device synchronised and logged with its route
    (the member kernels, or the autograd epoch: a gated phase-mixed epoch or
    a re-run), its prefix and how many members it ran. Yields the log."""
    real = E._ensemble_epoch
    log = []

    def call(cfg, flags, states, *args, **kw):
        warms = args[5] if len(args) > 5 else kw.get("warms")
        fused = warms is None and F.fused_enabled(cfg, states[0], n_batch=args[0].shape[-2])
        res, secs = synced(lambda: real(cfg, flags, states, *args, **kw))
        log.append({"route": "kernels" if fused else "autograd", "ns_prefix": cfg.ns_prefix,
                    "warm_up": flags.warm_up, "gated": warms is not None,
                    "members": len(states), "seconds": secs})
        return res

    E._ensemble_epoch = call
    try:
        yield log
    finally:
        E._ensemble_epoch = real


def ensemble_cfg(cfg) -> VJFConfig:
    """The ensemble fits' knobs: bench_all.py's forgetting, without which
    the flagship diverges after the bootstrap, and uniform phases (rtol 0,
    warm-up forced after one epoch)."""
    return cfg.replace(rtol=0.0, warmup_max=1, **FIT_FORGET)


def check_ensemble_fit(cfg, dev, smi) -> dict:
    """``fit_ensemble`` on shared data at the ensemble shape (ENS_N
    members x ENS_B trials, T ENS_T): 1 warm-up + 3 RLS epochs per epoch,
    then ENS_BLOCK_EPOCHS epochs in blocks of 2 (prefix-free continuation);
    wall seconds, member-steps/s, launches by kernel; the same members as
    sequential solo fits, whose finals must agree with the ensemble's
    within compare()'s limits. The per-epoch ensemble drops the prefix once
    every member has contracted and the solo per-epoch ``fit`` never does
    (in both packages), so that pair runs with ``ns_prefix_free='off'``, the
    same steps on both sides. Returns the per-epoch fit's launches (the
    ensemble's main path), result, seeds and times."""
    blocked_cfg = ensemble_cfg(cfg)
    cfg = blocked_cfg.replace(ns_prefix_free="off")
    y = spikes(ENS_T, ENS_B, cfg.ydim, dev, seed=60)
    states = init_ensemble(0, cfg, ENS_N, device=dev)
    seeds = [20 + m for m in range(ENS_N)]
    with ensemble_dispatches() as log:
        F.reset_launches()
        res, secs = synced(lambda: fit_ensemble(cfg, states, y, seeds=seeds,
                                                max_iter=ENS_FIT_EPOCHS))
        launches, steps_ = dict(F.launches), dict(F.steps)
    check(launches["fused_step.ensemble"] > 0 and launches["mega_epoch.ensemble"] > 0,
          f"ensemble.fit: launches {launches}")
    check(launches["fused_step"] == 0 and launches["mega_epoch"] == 0,
          f"ensemble.fit: solo launches on the ensemble path {launches}")
    check(bool(np.isfinite(res.loss).all()) and not res.warm_up.any(),
          f"ensemble.fit: loss {res.loss}, warm_up {res.warm_up}")
    check(bool(torch.isfinite(res.mu).all()), "ensemble.fit: posterior not finite")
    member_steps = int(res.epochs_run.sum()) * ENS_T
    rls = [e for e in log if not e["warm_up"]]

    # the same members fitted one after the other
    solo_s, solo_err = 0.0, 0.0
    for m in range(ENS_N):
        solo, s_ = synced(lambda: core.fit(cfg, states[m], y, seed=seeds[m],
                                           max_iter=ENS_FIT_EPOCHS))
        solo_s += s_
        ref = dict(state_leaves(solo.state), mu=solo.mu.cpu())
        got = dict(state_leaves(res.states[m]), mu=res.mu[m].cpu())
        solo_err = max(solo_err, compare(f"ensemble.fit.member{m}_vs_solo", ref, got,
                                         TOL[cfg.matmul_dtype], state_leaves(states[m])))

    with ensemble_dispatches() as blog:
        bres, b_secs = synced(lambda: fit_ensemble(blocked_cfg, states, y, seeds=seeds,
                                                   max_iter=ENS_BLOCK_EPOCHS,
                                                   epochs_per_dispatch=2))
    check(bool(np.isfinite(bres.loss).all()), f"ensemble.fit.blocked: loss {bres.loss}")
    # one entry a dispatched epoch, in order (no demotion here)
    epochs = [dict(e, member_steps_per_s=ENS_N * ENS_T / e["seconds"]) for e in blog]
    free = [i for i, e in enumerate(blog) if not e["warm_up"] and e["ns_prefix"] == 0]
    phase("ensemble.fit", config="bench.py flagship member widths, %d members x B %d, T %d, "
          "shared data, rls_shrink 0.999, chol_jitter 1e-3, rtol 0, warmup_max 1"
          % (ENS_N, ENS_B, ENS_T), ns_prefix_free="off, then auto in the blocked fit",
          seconds=secs, member_steps=member_steps,
          member_steps_per_s=member_steps / secs, epochs_run=res.epochs_run.tolist(),
          loss=res.loss.tolist(), launches=launches, member_steps_by_kernel=steps_,
          rls_epoch_s=[e["seconds"] for e in rls],
          solo_fits_s=solo_s, solo_over_ensemble=solo_s / secs, solo_max_abs_err=solo_err,
          blocked_seconds=b_secs, blocked_epochs=ENS_BLOCK_EPOCHS,
          blocked_member_steps_per_s=int(bres.epochs_run.sum()) * ENS_T / b_secs,
          prefix_free_epoch=free[0] if free else None,
          member_steps_per_s_with_prefix=[e["member_steps_per_s"] for e in epochs
                                          if not e["warm_up"] and e["ns_prefix"] > 0],
          member_steps_per_s_prefix_free=[epochs[i]["member_steps_per_s"] for i in free],
          blocked_epochs_log=epochs, card=smi)
    return {"launches": launches, "steps": steps_, "result": res, "seeds": seeds,
            "seconds": secs, "rls_epoch_s": [e["seconds"] for e in rls]}


def check_ensemble_fallback(cfg, dev, smi, shipped: dict) -> None:
    """What the exact fallback costs in an ensemble fit: "ensemble.fit"'s
    per-epoch fit again with the plain fallback (``exact_v_fallback_plain``:
    the branch computed on every prefix step and selected, each member's P
    factored alone by the library's Cholesky) in place of the shipped kernel
    (one launch for all members, the branch taken on the device): its RLS
    epochs' seconds beside the shipped fit's, and how far its members'
    finals end from the shipped ones (``compare``'s normalised errors, not
    gated: the fit is not determined in float32 once the bootstrap has
    run)."""
    cfg = ensemble_cfg(cfg).replace(ns_prefix_free="off")
    y = spikes(ENS_T, ENS_B, cfg.ydim, dev, seed=60)
    states = init_ensemble(0, cfg, ENS_N, device=dev)
    own = F.exact_v_fallback
    F.exact_v_fallback = F.exact_v_fallback_plain
    try:
        with ensemble_dispatches() as log:
            res, secs = synced(lambda: fit_ensemble(cfg, states, y, seeds=shipped["seeds"],
                                                    max_iter=ENS_FIT_EPOCHS))
    finally:
        F.exact_v_fallback = own
    ref = shipped["result"]
    errs = [compare_errs(state_leaves(ref.states[m]), state_leaves(res.states[m]),
                         state_leaves(states[m]))[0] for m in range(ENS_N)]
    phase("ensemble.fallback", members=ENS_N, batch=ENS_B, steps=ENS_T,
          prefix=cfg.ns_prefix, rls_epoch_s_kernel=shipped["rls_epoch_s"],
          rls_epoch_s_plain=[e["seconds"] for e in log if not e["warm_up"]],
          fit_s_kernel=shipped["seconds"], fit_s_plain=secs,
          finite=bool(np.isfinite(res.loss).all()),
          w_mean_err_vs_shipped=[e["dynamics.blr.w_mean"] for e in errs],
          max_err_vs_shipped=[max(e.values()) for e in errs], card=smi)


def check_ensemble_mixed(cfg, dev, smi) -> None:
    """A phase-mixed epoch: member 0 warm, member 1 past warm-up, one
    ``run_epoch_ensemble`` with their gates (the autograd route) against
    each member's static-flag autograd epoch, within ENS_MIXED_TOL."""
    cfg = ensemble_cfg(cfg).replace(fused_step="off")
    y = spikes(ENS_SHORT_T, ENS_B, cfg.ydim, dev, seed=61)
    us = torch.zeros((ENS_SHORT_T, ENS_B, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    states = init_ensemble(1, cfg, 2, device=dev)
    gated, secs = synced(lambda: run_epoch_ensemble(
        cfg, StepFlags(warm_up=False, train_decoder=False), states, y, us, [31, 32], lr,
        warm_gate=[1.0, 0.0]))
    identical = []
    for m, warm in enumerate((True, False)):
        ref = core.run_epoch(cfg, StepFlags(warm_up=warm, train_decoder=warm), states[m], y,
                             us, [31, 32][m], lr)
        a = dict(state_leaves(ref.state), loss=ref.metrics.loss.cpu(), mu=ref.q_means.cpu())
        b = dict(state_leaves(gated.state[m]), loss=gated.metrics.loss[m].cpu(),
                 mu=gated.q_means[m].cpu())
        compare(f"ensemble.mixed.member{m}", a, b, ENS_MIXED_TOL, state_leaves(states[m]))
        identical.append(all(torch.equal(a[k], b[k]) for k in a))
    phase("ensemble.mixed", members=2, phases=["warm-up", "rls"], steps=ENS_SHORT_T,
          batch=ENS_B, tol=ENS_MIXED_TOL, bit_identical=identical, seconds=secs,
          autograd_us_per_member_step=1e6 * secs / (2 * ENS_SHORT_T), card=smi)


def check_ensemble_demote(cfg, dev, smi) -> None:
    """4 members, member 1 forced hot on every watched epoch: it alone
    re-runs on the autograd route, and members 0, 2 and 3 end with the bits
    of the same fit without the forcing."""
    cfg = ensemble_cfg(cfg).replace(ns_prefix=16)
    y = spikes(ENS_SHORT_T, ENS_B, cfg.ydim, dev, seed=62)
    states = init_ensemble(2, cfg, 4, device=dev)
    kw = dict(seeds=[41, 42, 43, 44], max_iter=3)
    clean = fit_ensemble(cfg, states, y, **kw)
    real = E._member_tau_stats

    def forced(c, tau, t_len, n, dtype, device):
        max_tau, hot = real(c, tau, t_len, n, dtype, device)
        return max_tau, torch.where(torch.arange(n, device=hot.device) == 1,
                                    torch.ones_like(hot), hot)

    E._member_tau_stats = forced
    try:
        with ensemble_dispatches() as log:
            hot, secs = synced(lambda: fit_ensemble(cfg, states, y, **kw))
    finally:
        E._member_tau_stats = real
    reruns = [e for e in log if e["route"] == "autograd"]
    check(reruns and all(e["members"] == 1 for e in reruns),
          f"ensemble.demote: re-runs {reruns}")
    for m in (0, 2, 3):
        a, b = state_leaves(clean.states[m]), state_leaves(hot.states[m])
        check(all(torch.equal(a[k], b[k]) for k in a) and torch.equal(clean.mu[m], hot.mu[m]),
              f"ensemble.demote: healthy member {m} differs from the run without the demotion")
    check(not torch.equal(clean.mu[1], hot.mu[1]), "ensemble.demote: member 1 never re-ran")
    phase("ensemble.demote", members=4, hot_member=1, steps_per_epoch=ENS_SHORT_T,
          dispatches=[{k: e[k] for k in ("route", "members", "ns_prefix", "seconds")}
                      for e in log], healthy_bit_identical=True, seconds=secs, card=smi)


def lgssm_case(name: str, dev):
    """(a, q, h, r, m0, p0, ys, b, diag_r) of an LGSSM at the flagship widths
    (xdim 10, ydim 200, T SMOOTH_T) in f64 on ``dev``, simulated from
    numpy's seed 0: a stable rotation A perturbed per step with an offset b
    (the observations come from that system in every case), a random
    decoder, per-channel variances. ``dense`` and ``diag_inf`` smooth under
    the unperturbed A, ``diag_inf`` with 10% of the entries dropped
    (variance inf, y NaN); ``time_varying`` under the per-step A and b."""
    rng = np.random.default_rng(0)
    xd, yd, t_len = 10, 200, SMOOTH_T
    a = 0.97 * np.linalg.qr(rng.normal(size=(xd, xd)))[0]
    q, h = 0.05 * np.eye(xd), 0.3 * rng.normal(size=(yd, xd))
    r_var = rng.uniform(0.5, 1.5, size=yd)
    a_seq = a + 0.02 * rng.normal(size=(t_len, xd, xd))
    b = 0.1 * rng.normal(size=(t_len, xd))
    x, xs = np.zeros(xd), []
    for t in range(t_len):
        x = a_seq[t] @ x + b[t] + rng.normal(size=xd) * np.sqrt(0.05)
        xs.append(x)
    ys = np.stack(xs) @ h.T + rng.normal(size=(t_len, yd)) * np.sqrt(r_var)
    r, diag = np.diag(r_var), False
    if name == "diag_inf":
        r = np.broadcast_to(r_var, (t_len, yd)).copy()
        miss = rng.random((t_len, yd)) < 0.1
        r[miss], ys[miss], diag = np.inf, np.nan, True
    if name != "time_varying":
        a_seq, b = a, None
    t = (lambda v: None if v is None else torch.tensor(v, dtype=torch.float64, device=dev))
    return (*(t(v) for v in (a_seq, q, h, r, np.zeros(xd), np.eye(xd), ys, b)), diag)


def normalised(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def check_smooth_pkalman(dev, smi) -> None:
    """``parallel_smooth`` in f32 on the card against ``sequential_filter``
    and ``sequential_smooth`` in f64 on the card, SMOOTH_T steps at the
    flagship widths, for a dense R, a diagonal R with missing entries (the
    loops take them as a dense per-step R with the variance at 1e12 and y
    0, which leaves a gain below 1e-12) and time-varying A and b. Each
    filtered and smoothed mean and covariance within SMOOTH_TOL (normalised
    by the largest entry of the f64 result). The smooth combine with its
    arguments swapped must be rejected."""
    out = {}
    for name in ("dense", "diag_inf", "time_varying"):
        a, q, h, r, m0, p0, ys, b, diag = lgssm_case(name, dev)
        f32 = [None if v is None else v.float() for v in (a, q, h, r, m0, p0, ys, b)]
        (filt, sm), par_s = synced(lambda: PK.parallel_smooth(*f32, diag_r=diag))
        r_seq, y_seq = r, ys
        if diag:
            missing = torch.isinf(r)
            r_seq = torch.diag_embed(torch.where(missing, 1e12, r))
            y_seq = torch.where(missing, 0.0, ys)

        def loops():
            f = PK.sequential_filter(a, q, h, r_seq, m0, p0, y_seq, b)
            return f, PK.sequential_smooth(a, q, f, b)

        (seq_f, seq_s), seq_secs = synced(loops)
        errs = {"filtered_means": normalised(filt.means, seq_f.means),
                "filtered_covs": normalised(filt.covs, seq_f.covs),
                "smoothed_means": normalised(sm.means, seq_s.means),
                "smoothed_covs": normalised(sm.covs, seq_s.covs)}
        check(all(v <= SMOOTH_TOL for v in errs.values()),
              f"smooth.pkalman[{name}]: {errs} over {SMOOTH_TOL}")
        out[name] = dict(errs, parallel_f32_s=par_s, sequential_f64_s=seq_secs)
        if name == "dense":
            elems = PK._smooth_elements(f32[0], f32[1], filt, f32[7])
            _, g_bad, _ = PK.associative_scan(lambda ej, ei: PK._smooth_combine(ei, ej),
                                              elems, reverse=True)
            bad = normalised(g_bad, seq_s.means)
            check(bad > SMOOTH_TOL, f"smooth.pkalman: swapped combine accepted ({bad})")
            out["fault.swapped_smooth_combine"] = {"smoothed_means": bad, "rejected": True}
    phase("smooth.pkalman", steps=SMOOTH_T, xdim=10, ydim=200, tol=SMOOTH_TOL,
          cases=out, card=smi)


def cosmooth_data(dev):
    """scripts/flagship_cosmooth.py's data: a 10-D population of 5
    oscillator planes, 200 Poisson channels, B 256 trials of T 300, uint8
    counts from numpy's seed 0, put on the card as they are."""
    t_len, b, ydim, xdim = COSMOOTH_T, COSMOOTH_B, 200, 10
    rng = np.random.default_rng(0)
    ts = np.arange(t_len)[:, None]
    freqs = 2 * np.pi * np.linspace(0.01, 0.05, 5)
    ph = rng.uniform(0, 2 * np.pi, size=(b, 5))
    x = np.stack([np.sin(freqs * ts[:, None] + ph), np.cos(freqs * ts[:, None] + ph)],
                 axis=-1).reshape(t_len, b, xdim)
    c = rng.normal(size=(xdim, ydim)) * 0.5
    rate = np.exp(np.clip(x @ c - 0.8, -6, 2.5))
    return torch.from_numpy(rng.poisson(rate).astype(np.uint8)).to(dev)


def cosmooth_cfg() -> VJFConfig:
    """scripts/flagship_cosmooth.py's configuration."""
    return VJFConfig(ydim=200, xdim=10, udim=0, n_rbf=100, hidden_sizes=(32,),
                     likelihood="poisson", dtype="float32", rls_backend="nsv", lr=1e-3,
                     warmup_max=25, rtol=2e-3)


def check_cosmooth(dev, smi) -> dict:
    """The flagship co-smoothing workload: ``fit`` (25 epochs, both kernels),
    then ``kfold_channel_eval`` with 5 folds, with the fold loop and with
    ``vmap_folds=True, fold_chunk=2``, two runs each (cold, warm). The
    pooled bits/spike must be finite and above 0 (the model beats the
    constant-rate null) and the two modes agree within COSMOOTH_MODE_TOL;
    fold 0 recomputed in f64 agrees within COSMOOTH_F64_TOL; held-out
    values must not move a prediction, and the held-out channels left in
    the inference mask (a planted fault) must move it. Returns the fit's
    state and the data."""
    cfg, y = cosmooth_cfg(), cosmooth_data(dev)
    state = core.init_state(0, cfg, device=dev)
    F.reset_launches()
    res, fit_s = synced(lambda: core.fit(cfg, state, y, seed=0, max_iter=25))
    fit_launches = dict(F.launches)
    check(fit_launches["fused_step"] > 0 and fit_launches["mega_epoch"] > 0,
          f"smooth.flagship: fit launches {fit_launches}")
    runs = {}
    for mode, kw in (("fold_loop", {}), ("fold_batched", dict(vmap_folds=True, fold_chunk=2))):
        secs = []
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for _ in range(2):
            kf, sec = synced(lambda: EV.kfold_channel_eval(cfg, res.state, y,
                                                           n_folds=COSMOOTH_FOLDS, **kw))
            secs.append(sec)
        # the evaluation's own peak, above what earlier phases still hold
        runs[mode] = dict(kf=kf, cold_s=secs[0], warm_s=secs[1],
                          peak_bytes=torch.cuda.max_memory_allocated() - held)
    loop, batched = runs["fold_loop"]["kf"], runs["fold_batched"]["kf"]
    bits = loop.bits_per_spike
    check(math.isfinite(bits) and bits > 0, f"smooth.flagship: bits/spike {bits}")
    mode_diff = max(abs(bits - batched.bits_per_spike) / abs(bits),
                    float(np.abs(loop.r2 - batched.r2).max()))
    check(mode_diff <= COSMOOTH_MODE_TOL,
          f"smooth.flagship: fold loop and fold batches {mode_diff} apart")

    # fold 0 again in f64 on the card
    fold = loop.folds[0]
    cfg64 = cfg.replace(dtype="float64")
    ev64 = EV.heldout_eval(cfg64, cast_state(res.state, torch.float64, dev), y, fold.heldout)
    f64_diff = abs(float(fold.bits_per_spike) - float(ev64.bits_per_spike))
    f64_means = normalised(fold.smoothed_means, ev64.smoothed_means)
    check(f64_diff <= COSMOOTH_F64_TOL, f"smooth.flagship: f32 bits {f64_diff} off f64")

    # held-out values reach no prediction; with the held-out channels left
    # in the inference mask (the planted fault) they do
    idx = fold.heldout
    corrupt = y.clone()
    corrupt[..., idx] = y[..., idx].flip(0)
    sound = EV.heldout_eval(cfg, res.state, corrupt, idx)
    check(torch.equal(sound.pred, fold.pred), "smooth.flagship: held-out values moved pred")

    def leaky(ys):
        _, sm = smoothing.smooth_batch(cfg, res.state, ys)
        w = torch.ones(ys.shape[:-1] + (len(idx),), device=dev)
        return EV._score_heldout(cfg, res.state, ys.float(), idx, w, sm).pred

    leak = float((leaky(corrupt) - leaky(y)).abs().max())
    check(leak > 0, "smooth.flagship: the leaky evaluation was not caught")
    phase("smooth.flagship", config="scripts/flagship_cosmooth.py: T %d, B %d, ydim 200, "
          "xdim 10, poisson, n_rbf 100, hidden (32,), f32, nsv, lr 1e-3, warmup_max 25, "
          "rtol 2e-3, max_iter 25, %d folds" % (COSMOOTH_T, COSMOOTH_B, COSMOOTH_FOLDS),
          fit_s=fit_s, epochs_run=res.epochs_run, fit_loss=res.loss, warm_up=res.warm_up,
          fit_launches=fit_launches,
          bits_per_spike=bits, bits_per_spike_batched=batched.bits_per_spike,
          fold_r2=loop.r2.tolist(), mode_tol=COSMOOTH_MODE_TOL, mode_diff=mode_diff,
          **{f"{m}_{k}": runs[m][k] for m in runs for k in ("cold_s", "warm_s", "peak_bytes")},
          fold0_f64_bits=float(ev64.bits_per_spike), fold0_f64_bits_diff=f64_diff,
          fold0_f64_means_err=f64_means, f64_tol=COSMOOTH_F64_TOL,
          heldout_corrupted_pred_bit_identical=True, fault_leaked_heldout_pred_moved=leak,
          card=smi)
    return {"cfg": cfg, "state": res.state, "y": y}


def check_smooth_facade(dev, smi) -> None:
    """``VJF.smooth``/``evaluate``/``evaluate_kfold`` on a small model on the
    card (ydim 20, xdim 2, 2 fit epochs on counts of a rotating latent, T
    200, B 4): finite results; NaN at the entries a channel mask drops gives
    the bits of a zero fill, bit for bit; a ``mesh=`` that is not a dp
    process group raises ``ValueError`` naming it."""
    rng = np.random.default_rng(5)
    t_len, b, ydim = 200, 4, 20
    th = 0.1 * np.arange(t_len)[:, None] + rng.uniform(0, 6.3, size=b)
    x = np.stack([np.sin(th), np.cos(th)], axis=-1)
    y = rng.poisson(np.exp(x @ rng.normal(size=(2, ydim)) * 0.7 - 0.5)).astype(np.float32)
    model = VJF.make_model(ydim, 2, n_rbf=20, hidden_sizes=(8,), likelihood="poisson", seed=0)
    (_, _, fit_loss), fit_s = synced(lambda: model.fit(y, max_iter=2))
    _, one = model.smooth(y[:, 0])
    _, batch = model.smooth(y)
    check(tuple(batch.covs.shape) == (t_len, b, 2, 2) and bool(torch.isfinite(batch.covs).all())
          and bool(torch.isfinite(one.means).all()), "smooth.facade: smooth not finite")
    ev = model.evaluate(y, [1, 5, 9])
    kf = model.evaluate_kfold(y, n_folds=4)
    check(math.isfinite(kf.bits_per_spike) and bool(torch.isfinite(ev.bits_per_spike)),
          "smooth.facade: evaluation not finite")
    cm = (rng.random((t_len, b, ydim)) > 0.2).astype(np.float32)
    bits = [model.evaluate(np.where(cm > 0, y, fill), [1, 5, 9], channel_mask=cm).bits_per_spike
            for fill in (np.nan, 0.0)]
    check(torch.equal(bits[0], bits[1]), f"smooth.facade: NaN fill {bits[0]} != zero {bits[1]}")
    refused = []
    for method, args in (("smooth", (y,)), ("evaluate", (y, [1])), ("evaluate_kfold", (y,))):
        try:
            getattr(model, method)(*args, mesh=object())
        except ValueError as e:
            refused.append("dp process group" in str(e))
    check(refused == [True] * 3, f"smooth.facade: mesh refusals {refused}")
    phase("smooth.facade", config="ydim 20, xdim 2, n_rbf 20, poisson, T %d, B %d" % (t_len, b),
          fit_epochs=model.epochs_run, fit_loss=fit_loss, fit_s=fit_s,
          bits_per_spike=float(ev.bits_per_spike),
          kfold_bits_per_spike=kf.bits_per_spike, nan_fill_bits=float(bits[0]),
          zero_fill_bits=float(bits[1]), mesh_refused=refused, card=smi)


def check_smooth_times(flag: dict, smi) -> None:
    """One Laplace pass at the flagship co-smoothing shape (B 256, T 300:
    the linearization and one pass of the smoother), its seconds and the
    CUDA kernels it launches (torch.profiler), and ``_gj_inverse`` on
    (76,800, 10, 10) beside ``torch.linalg.inv`` (CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, state, y = flag["cfg"], flag["state"], flag["y"]

    def one_pass():
        return smoothing.smooth_batch(cfg, state, y, n_iter=1)

    one_pass()
    secs = [synced(one_pass)[1] for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    check(launches > 0 and device_s > 0, "smooth.times: no device time recorded")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    g = torch.Generator(device=y.device).manual_seed(3)
    m = torch.eye(10, device=y.device) + 0.1 * torch.randn(
        (COSMOOTH_T * COSMOOTH_B, 10, 10), device=y.device, generator=g)
    gj_err = normalised(PK._gj_inverse(m), torch.linalg.inv(m.double()))
    gj = [cuda_ms(lambda: PK._gj_inverse(m), 10), cuda_ms(lambda: torch.linalg.inv(m), 10)]
    gj += [cuda_ms(lambda: torch.linalg.inv(m), 10), cuda_ms(lambda: PK._gj_inverse(m), 10)]
    phase("smooth.times", what="one Laplace pass, B %d, T %d, xdim 10, ydim 200" % (
          COSMOOTH_B, COSMOOTH_T), pass_s=secs, kernel_launches=launches,
          device_s_profiled=device_s, device_busy_share=device_s / min(secs),
          top_kernels=[{"name": e.key[:60], "calls": e.count,
                        "share": e.self_device_time_total / 1e6 / device_s} for e in top],
          gj_inverse_batch=list(m.shape), gj_inverse_ms=[gj[0], gj[3]],
          linalg_inv_ms=[gj[1], gj[2]], gj_inverse_err_vs_f64=gj_err, card=smi)


def multi_cfg(cfg) -> VJFConfig:
    """The multi phases' fit knobs: fit.flagship's forgetting, warm-up
    forced to end after 2 epochs, no plateau (rtol 1e-12, as JAX's test)."""
    return cfg.replace(warmup_max=2, rtol=1e-12, **FIT_FORGET)


def fit_checks(name: str, got, ref, xdim: int) -> float:
    """tests/test_sharding.py:510-547's checks of a fit over ranks against
    another: the same epochs_run and warm_up, the loss within
    MULTI_LOSS_RTOL, the affine-aligned latent R² above MULTI_R2 (returned)."""
    check(got.epochs_run == ref.epochs_run and got.warm_up == ref.warm_up,
          f"{name}: epochs_run/warm_up {got.epochs_run}/{got.warm_up} against "
          f"{ref.epochs_run}/{ref.warm_up}")
    check(math.isfinite(got.loss) and abs(got.loss - ref.loss) <= MULTI_LOSS_RTOL * abs(ref.loss),
          f"{name}: loss {got.loss} against {ref.loss}")
    r2 = latent_r2(got.mu.reshape(-1, xdim), ref.mu.reshape(-1, xdim).cpu().double().numpy())
    check(r2 > MULTI_R2, f"{name}: latent R2 {r2} against the other fit")
    return r2


def check_multi_fit(cfg, ys, group, smi) -> dict:
    """Exact-sync ``fit(mesh=group)`` at world size 1 (NCCL) against the
    plain ``fit`` on the same seed and data (:func:`fit_checks`); the phase-1
    kernel launched once per sharded step and no other kernel; seconds per
    step of both. Returns the launches and both results."""
    cfg = multi_cfg(cfg)
    y = ys[:MULTI_T]
    state = core.init_state(3, cfg, device=ys.device)
    plain, p_s = synced(lambda: core.fit(cfg, state, y, seed=9, max_iter=MULTI_EPOCHS))
    F.reset_launches()
    multi, m_s = synced(lambda: core.fit(cfg, state, y, seed=9, max_iter=MULTI_EPOCHS,
                                         mesh=group))
    launches, steps_ = dict(F.launches), dict(F.steps)
    n_steps = multi.epochs_run * MULTI_T
    check(launches == {**dict.fromkeys(F.launches, 0), "forward_sums": n_steps},
          f"multi.fit: launches {launches}, {n_steps} sharded steps")
    r2 = fit_checks("multi.fit", multi, plain, cfg.xdim)
    phase("multi.fit", world_size=1, backend="nccl",
          config="bench.py flagship, B %d, T %d, rls_shrink 0.999, chol_jitter 1e-3, "
          "warmup_max 2" % (ys.shape[1], MULTI_T), epochs_run=multi.epochs_run,
          warm_up=multi.warm_up, loss=multi.loss, plain_loss=plain.loss, latent_r2=r2,
          seconds=m_s, s_per_step=m_s / n_steps, plain_seconds=p_s,
          plain_s_per_step=p_s / n_steps, launches=launches, card=smi)
    return {"launches": launches, "steps": steps_, "result": multi, "plain": plain,
            "state": state, "cfg": cfg}


def check_multi_sync_every(cfg, state, ys, us, lr, group, smi) -> dict:
    """One relaxed-sync epoch (``run_epoch_sync_every``, world size 1, NCCL,
    segments of SYNC_K over SYNC_T steps) from the post-warm-up flagship
    state against the same segments chained through ``run_epoch`` on the
    same seeds (``segment_seeds``): its w within SYNC_W_TOL of the epoch's
    own step in w (the merge at one rank rebuilds V = P^-1 exactly where
    the chain tracks it by Newton-Schulz), everything finite; the step and
    mega launches (the first segment lies inside the prefix, each later one
    is one mega launch); its seconds beside the chain's and one exact-sync
    epoch's over the same steps. Returns the launches."""
    y, u, flags = ys[:SYNC_T], us[:SYNC_T], StepFlags()
    n_seg = SYNC_T // SYNC_K
    F.reset_launches()
    res, secs = synced(lambda: run_epoch_sync_every(cfg, flags, state, y, u, 31, lr, group,
                                                    SYNC_K))
    launches, steps_ = dict(F.launches), dict(F.steps)
    check(launches["fused_step"] == min(cfg.ns_prefix, SYNC_K)
          and launches["mega_epoch"] == n_seg - 1 and launches["forward_sums"] == 0,
          f"multi.sync_every: launches {launches}")
    check(bool(torch.isfinite(res.q_means).all() and torch.isfinite(res.metrics.loss).all()
               and torch.isfinite(res.state.dynamics.blr.w_mean).all()),
          "multi.sync_every: not finite")
    st, q, chain_s = state, None, 0.0
    for i, seed in enumerate(segment_seeds(31, n_seg, 0)):
        rows = slice(i * SYNC_K, (i + 1) * SYNC_K)
        c = cfg if i == 0 else cfg.replace(ns_prefix=0)
        r, s_ = synced(lambda: core.run_epoch(c, flags, st, y[rows], u[rows], seed, lr, q0=q))
        st, q, chain_s = r.state, core.Gaussian(r.q_means[-1], r.q_logvars[-1]), chain_s + s_
    w0, wc = state.dynamics.blr.w_mean, st.dynamics.blr.w_mean
    w_err = float(torch.linalg.vector_norm(res.state.dynamics.blr.w_mean - wc)
                  / torch.linalg.vector_norm(wc - w0))
    check(w_err <= SYNC_W_TOL, f"multi.sync_every: w {w_err} of the epoch's step from the chain")
    _, exact_s = synced(lambda: run_epoch_fused_sharded(cfg, flags, state, y, u, 31, lr, group))
    phase("multi.sync_every", world_size=1, backend="nccl", steps=SYNC_T, sync_every=SYNC_K,
          segments=n_seg, seconds=secs, chained_seconds=chain_s, exact_sync_seconds=exact_s,
          exact_over_relaxed=exact_s / secs, w_err_of_step=w_err, tol=SYNC_W_TOL,
          loss_first_last=[float(res.metrics.loss[0]), float(res.metrics.loss[-1])],
          launches=launches, timesteps=steps_, card=smi)
    return {"launches": launches, "steps": steps_}


def autograd_leaves(res, rows=slice(None)) -> dict:
    """:func:`xla_leaves` with the posterior rows ``rows``, on the CPU."""
    out = dict(xla_leaves(res), q_means=res.q_means[:, rows])
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def check_multi_autograd(cfg, post_warm, ys, us, lr, group, smi) -> dict:
    """The exact-sync epoch's autograd route at world size 1 (NCCL): no
    kernel launched. ``fit(mesh=group)`` with the precision form at float32
    (a state the kernels refuse) against the plain ``fit``
    (:func:`fit_checks`); then MULTI_XLA_STEPS steps of
    ``make_sharded_epoch`` with ``fused_step='off'`` from the post-warm-up
    state against ``run_epoch`` on the same seed (:func:`compare`, the
    planted faults rejected). Returns the one-process epoch and its faults
    for "multi.world2"."""
    pcfg = multi_cfg(cfg).replace(rls_backend="precision")
    y = ys[:MULTI_T]
    state = core.init_state(3, pcfg, device=ys.device)
    check(isinstance(state.dynamics.blr, R.PrecisionBLR), "multi.autograd: not the precision form")
    plain, p_s = synced(lambda: core.fit(pcfg, state, y, seed=9, max_iter=MULTI_EPOCHS))
    F.reset_launches()
    multi, m_s = synced(lambda: core.fit(pcfg, state, y, seed=9, max_iter=MULTI_EPOCHS,
                                         mesh=group))
    fit_launches = dict(F.launches)
    check(sum(fit_launches.values()) == 0, f"multi.autograd: fit launches {fit_launches}")
    r2 = fit_checks("multi.autograd.fit", multi, plain, cfg.xdim)
    n_fit = multi.epochs_run * MULTI_T

    off, flags = flagship("float32").replace(fused_step="off"), StepFlags()
    y64, u64 = ys[:MULTI_XLA_STEPS], us[:MULTI_XLA_STEPS]
    one, o_s = synced(lambda: core.run_epoch(off, flags, post_warm, y64, u64, 41, lr))
    F.reset_launches()
    got, g_s = synced(lambda: make_sharded_epoch(off, flags, group)(post_warm, y64, u64, 41, lr))
    check(sum(F.launches.values()) == 0, f"multi.autograd: epoch launches {dict(F.launches)}")
    start = {k: v.cpu() for k, v in trained_leaves(post_warm).items()}
    ref = autograd_leaves(one)
    err = compare("multi.autograd.epoch", ref, autograd_leaves(got), MULTI_XLA_TOL, start)
    faults_ = {}
    for fault, fl in {"no_sgd": dataclasses.replace(flags, sgd=False),
                      "no_decoder_update": dataclasses.replace(flags, train_decoder=False)
                      }.items():
        faults_[fault] = autograd_leaves(core.run_epoch(off, fl, post_warm, y64, u64, 41, lr))
        compare(f"multi.autograd.epoch.fault.{fault}", faults_[fault], autograd_leaves(got),
                MULTI_XLA_TOL, start, reject=True)
    phase("multi.autograd", world_size=1, backend="nccl",
          fit=dict(config="bench.py flagship widths, B %d, T %d, rls_backend precision, "
                   "float32, rls_shrink 0.999, chol_jitter 1e-3, warmup_max 2"
                   % (ys.shape[1], MULTI_T), epochs_run=multi.epochs_run, loss=multi.loss,
                   plain_loss=plain.loss, latent_r2=r2, ms_per_step=1e3 * m_s / n_fit,
                   plain_ms_per_step=1e3 * p_s / n_fit, launches=fit_launches),
          epoch=dict(steps=MULTI_XLA_STEPS, config="flagship, float32, fused_step off",
                     tol=MULTI_XLA_TOL, max_abs_err=err,
                     ms_per_step=1e3 * g_s / MULTI_XLA_STEPS,
                     plain_ms_per_step=1e3 * o_s / MULTI_XLA_STEPS),
          card=smi)
    return {"cfg": off, "state": post_warm, "ys": y64, "us": u64, "lr": lr, "ref": ref,
            "faults": faults_, "start": start}


@contextlib.contextmanager
def counted_all_reduces(mesh: Mesh):
    """``dist.all_reduce`` counted for the duration: yields a list of
    (axis, floats) a call, the axis ``tp`` on the mesh's ``tp`` group and
    ``mesh`` elsewhere."""
    real, seen = dist.all_reduce, []

    def counting(t, *args, group=None, **kw):
        seen.append(("tp" if mesh.tp is not None and group is mesh.tp else "mesh", t.numel()))
        return real(t, *args, group=group, **kw)

    dist.all_reduce = counting
    try:
        yield seen
    finally:
        dist.all_reduce = real


def world2_worker(rank: int, port: str, path: str) -> int:
    """One rank of "multi.world2": gloo over ``localhost:port`` on cuda:0,
    the jobs of ``path/job.pt``, the results (and each job's launches and
    seconds) to ``path/out<rank>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.load_library()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    try:
        group = make_dp_group()
        job = torch.load(os.path.join(path, "job.pt"), map_location="cuda:0",
                         weights_only=False)
        out = {}

        def run(name, fn):
            torch.cuda.synchronize()
            F.reset_launches()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out[name] = {"seconds": time.perf_counter() - t0, "launches": dict(F.launches)}
            return res

        f = job["fit"]
        res = run("fit", lambda: core.fit(f["cfg"], f["state"], f["y"], seed=f["seed"],
                                          max_iter=f["max_iter"], mesh=group))
        out["fit"].update(loss=res.loss, epochs_run=res.epochs_run, warm_up=res.warm_up,
                          mu=res.mu.cpu(), state=state_leaves(res.state))
        # the exact-sync step's flat sums at this rank's batch, all-reduced alone
        y_l = shard_data(f["y"], f["y"][..., :0], group)[0]
        q0 = core.prior(f["state"].params, y_l.shape[1])
        flat, _ = F.forward_sums_call(f["cfg"], StepFlags(), F.pad_carry(f["cfg"], f["state"]),
                                      q0.mean.contiguous(), q0.logvar.contiguous(), y_l[0],
                                      None, None, None, 1.0 / f["y"].shape[1])
        out["gloo_all_reduce_ms"] = cuda_ms(lambda: dist.all_reduce(flat, group=group), 20)
        out["gloo_floats"] = flat.numel()
        s = job["sync"]
        ys_l, us_l = shard_data(s["ys"], s["us"], group)
        res = run("sync", lambda: run_epoch_sync_every(s["cfg"], StepFlags(), s["state"], ys_l,
                                                       us_l, 31, s["lr"], group, SYNC_K))
        out["sync"].update(state=state_leaves(res.state),
                           finite=bool(torch.isfinite(res.q_means).all()
                                       and torch.isfinite(res.metrics.loss).all()))
        e = job["ens"]
        res = run("ens", lambda: fit_ensemble(e["cfg"], e["states"], e["y"], seeds=e["seeds"],
                                              max_iter=WORLD2_ENS_EPOCHS, mesh=group))
        out["ens"].update(states=[state_leaves(st) for st in res.states], mu=res.mu.cpu(),
                          loss=res.loss)
        m = job["smooth"]
        filt, sm = run("smooth", lambda: smoothing.smooth_batch(m["cfg"], m["state"], m["y"],
                                                                mesh=group))
        out["smooth"].update(means=sm.means.cpu(), covs=sm.covs.cpu(),
                             filtered=filt.means.cpu())
        world2_autograd_jobs(job, group, run, out)
        torch.save(out, os.path.join(path, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def world2_autograd_jobs(job, group, run, out) -> None:
    """The world-2 jobs of the exact-sync autograd route and of the route
    decision (:func:`check_world2_autograd`, "multi.world2.route"): ``run(name,
    fn)`` times ``fn`` into ``out[name]`` with its launches."""
    a = job["autograd"]
    for name, shape in (("autograd", (2, 1)), ("tp", (1, 2))):
        mesh = make_mesh(shape=shape)
        epoch = make_sharded_epoch(a["cfg"], StepFlags(), mesh)
        with counted_all_reduces(mesh) as seen:
            res = run(name, lambda: epoch(a["state"], a["ys"], a["us"], 41, a["lr"]))
        groups = {"tp": mesh.tp, "mesh": mesh.everyone}
        dev = a["ys"].device
        out[name].update(leaves=autograd_leaves(res), state=state_leaves(res.state),
                         coords=mesh.coords, collectives=seen,
                         all_reduce_us={f"{ax}:{n}": 1e3 * cuda_ms(
                             lambda: dist.all_reduce(torch.zeros(n, device=dev),
                                                     group=groups[ax]), 10)
                             for ax, n in sorted(set(seen))})
    r = job["route"]
    res = run("route", lambda: make_sharded_epoch(r["cfg"], StepFlags(), group)(
        r["state"], r["ys"], r["us"], 43, r["lr"]))
    out["route"].update(tau_stream=res.metrics.tau is not None,
                        finite=bool(torch.isfinite(res.metrics.loss).all()))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def normalised_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def check_multi_world2(cfg, sync_state, ys, us, lr, multi, cosmooth, autograd, smi) -> dict:
    """Two processes on cuda:0 (:func:`world2_worker`) over gloo: NCCL
    refuses two ranks on one device. One deadline of WORLD2_DEADLINE s for
    both; whatever happens both are killed and reaped; any failure fails
    the run. Jobs: exact-sync ``fit(mesh=...)`` against "multi.fit"'s
    world-1 run (:func:`fit_checks`), every rank's state bit-equal to rank
    0's; one relaxed-sync epoch (SYNC_T, SYNC_K, B 128 a rank), finite and
    bit-equal across the ranks; ``fit_ensemble(mesh=...)`` on "ensemble.fit"'s
    workload (ENS_N members x ENS_B trials, T ENS_T, 1 warm-up + 1 RLS
    epoch), four members a rank, each member bit-identical to the one-process
    ``fit_ensemble``; ``smooth_batch(mesh=...)`` on "smooth.flagship"'s
    trained state and data (B 256, T 300) within WORLD2_SMOOTH_TOL
    (normalised) of the one-process call; the sharded autograd epoch
    ("multi.autograd"'s MULTI_XLA_STEPS steps) over the (2, 1) mesh (128
    trials a rank) and the (1, 2) mesh (100 channels a rank) against the
    one-process epoch within MULTI_XLA_TOL, its planted faults rejected,
    every rank's state bit-equal, the all-reduces per step by axis and
    their gloo times; SGP at B 8 over the two ranks on the fused route (the
    route decided on the whole batch). Times are two processes sharing one
    card, not scaling numbers."""
    dev = ys.device
    e_cfg = ensemble_cfg(cfg).replace(ns_prefix_free="off")
    e_states = init_ensemble(0, e_cfg, ENS_N, device=dev)
    e_y = spikes(ENS_T, ENS_B, cfg.ydim, dev, seed=60)
    e_seeds = [20 + m for m in range(ENS_N)]
    ens_ref, ens_s = synced(lambda: fit_ensemble(e_cfg, e_states, e_y, seeds=e_seeds,
                                                 max_iter=WORLD2_ENS_EPOCHS))
    c = cosmooth
    (_, sm_ref), sm_s = synced(lambda: smoothing.smooth_batch(c["cfg"], c["state"], c["y"]))
    f = multi
    job = {"fit": dict(cfg=f["cfg"], state=f["state"], y=ys[:MULTI_T], seed=9,
                       max_iter=MULTI_EPOCHS),
           "sync": dict(cfg=cfg, state=sync_state, ys=ys[:SYNC_T], us=us[:SYNC_T], lr=lr),
           "ens": dict(cfg=e_cfg, states=e_states, y=e_y, seeds=e_seeds),
           "smooth": dict(cfg=c["cfg"], state=c["state"], y=c["y"]),
           "autograd": {k: autograd[k] for k in ("cfg", "state", "ys", "us", "lr")},
           "route": route_job(ys, us, lr)}
    tmp = tempfile.mkdtemp(prefix="vjf_world2_")
    torch.save(job, os.path.join(tmp, "job.pt"))
    port = str(free_port())
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, "--world2-rank", str(r), port, tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + WORLD2_DEADLINE
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    wall = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          "multi.world2: a rank failed:\n" + "\n".join(l[-4000:] for l in logs))
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(2)]

    def same(a, b):
        return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    fit_got = types.SimpleNamespace(**{k: outs[0]["fit"][k] for k in
                                       ("loss", "epochs_run", "warm_up", "mu")})
    r2 = fit_checks("multi.world2.fit", fit_got, f["result"], cfg.xdim)
    check(same(outs[0]["fit"]["state"], outs[1]["fit"]["state"]),
          "multi.world2.fit: rank 1's state differs from rank 0's")
    n_steps = fit_got.epochs_run * MULTI_T
    for o in outs:
        check(o["fit"]["launches"]["forward_sums"] == n_steps,
              f"multi.world2.fit: launches {o['fit']['launches']}")
    check(all(o["sync"]["finite"] for o in outs), "multi.world2.sync: not finite")
    check(same(outs[0]["sync"]["state"], outs[1]["sync"]["state"]),
          "multi.world2.sync: rank 1's state differs from rank 0's")
    for r, o in enumerate(outs):
        check(torch.equal(o["ens"]["mu"], ens_ref.mu.cpu()),
              f"multi.world2.ens: rank {r}'s posteriors differ from the one-process fit")
        check(np.array_equal(o["ens"]["loss"], ens_ref.loss),
              f"multi.world2.ens: rank {r}'s losses differ")
        for m, st in enumerate(ens_ref.states):
            check(same(state_leaves(st), o["ens"]["states"][m]),
                  f"multi.world2.ens: member {m} on rank {r} differs from the one-process fit")
        launched = o["ens"]["launches"]
        check(launched["fused_step.ensemble"] > 0 and launched["mega_epoch.ensemble"] > 0,
              f"multi.world2.ens: launches {launched}")
    sm_err = max(normalised_err(o["smooth"][k], getattr(sm_ref, k).cpu())
                 for o in outs for k in ("means", "covs"))
    check(sm_err <= WORLD2_SMOOTH_TOL, f"multi.world2.smooth: {sm_err} from the one-process call")
    check_world2_autograd(outs, autograd, smi)
    route = job["route"]
    for o in outs:
        check(o["route"]["launches"]["forward_sums"] == route["ys"].shape[0]
              and o["route"]["tau_stream"] and o["route"]["finite"],
              f"multi.world2.route: SGP at B 8 over two ranks, {o['route']}")
    phase("multi.world2.route", config="sgp flagship widths, B %d over 2 ranks, T %d"
          % tuple(route["ys"].shape[1::-1]), route="fused sharded", launches=[
              o["route"]["launches"] for o in outs], rank_batch_gate_refused=True,
          seconds=[o["route"]["seconds"] for o in outs], card=smi)
    phase("multi.world2", world_size=2, backend="gloo", device="cuda:0 shared by both ranks",
          note="two processes sharing one card: not a scaling number", wall_seconds=wall,
          deadline=WORLD2_DEADLINE,
          fit=dict(seconds=outs[0]["fit"]["seconds"], s_per_step=outs[0]["fit"]["seconds"]
                   / n_steps, loss=fit_got.loss, world1_loss=f["result"].loss,
                   latent_r2=r2, ranks_bit_equal=True, launches=outs[0]["fit"]["launches"]),
          gloo_all_reduce_us=[1e3 * o["gloo_all_reduce_ms"] for o in outs],
          gloo_floats=outs[0]["gloo_floats"],
          sync=dict(seconds=[o["sync"]["seconds"] for o in outs], ranks_bit_equal=True,
                    launches=outs[0]["sync"]["launches"]),
          ens=dict(members=ENS_N, per_rank=ENS_N // 2, epochs=WORLD2_ENS_EPOCHS,
                   seconds=[o["ens"]["seconds"] for o in outs], one_process_seconds=ens_s,
                   members_bit_identical=True, launches=outs[0]["ens"]["launches"]),
          smooth=dict(seconds=[o["smooth"]["seconds"] for o in outs],
                      one_process_seconds=sm_s, max_err=sm_err, tol=WORLD2_SMOOTH_TOL),
          card=smi)
    return {"launches": [o["fit"]["launches"] for o in outs]}


def route_job(ys, us, lr) -> dict:
    """SGP at the flagship widths, B 8, T 8: over two ranks the whole
    batch's 8 trials pass SGP's small-batch gate, so the exact-sync epoch
    takes the fused route (the rank's 4 trials would not); checked here on
    the gate, then driven by "multi.world2"."""
    cfg = sgp_flagship()
    state = core.init_state(0, cfg, device=ys.device)
    check(fused_route(cfg, state, 8, Mesh(None, None, None, (0, 0), (2, 1)))
          and not F.fused_enabled(cfg, state, n_batch=4),
          "route: SGP at B 8 over two ranks is not the fused route")
    return dict(cfg=cfg, state=state, ys=ys[:8, :8].contiguous(),
                us=us[:8, :8].contiguous(), lr=lr)


def check_world2_autograd(outs: list, autograd: dict, smi) -> None:
    """"multi.world2.autograd" (the (2, 1) mesh) and "multi.world2.tp" (the
    (1, 2) mesh): each rank's epoch against the one-process epoch (its
    posterior rows), the planted faults rejected, the ranks' states bit for
    bit; the all-reduces a step on each axis and their gloo times."""
    ref, start, steps = autograd["ref"], autograd["start"], MULTI_XLA_STEPS
    b = ref["q_means"].shape[1]
    for name, shape in (("autograd", (2, 1)), ("tp", (1, 2))):
        per, errs = b // shape[0], []
        for r, o in enumerate(outs):
            got = o[name]
            d = got["coords"][0]
            want = dict(ref, q_means=ref["q_means"][:, d * per:(d + 1) * per])
            errs.append(compare(f"multi.world2.{name}[rank {r}]", want, got["leaves"],
                                MULTI_XLA_TOL, start))
            check(sum(got["launches"].values()) == 0,
                  f"multi.world2.{name}: launches {got['launches']}")
        for fault, bad in autograd["faults"].items():
            compare(f"multi.world2.{name}.fault.{fault}",
                    dict(bad, q_means=bad["q_means"][:, :per]), outs[0][name]["leaves"],
                    MULTI_XLA_TOL, start, reject=True)
        a, c = outs[0][name]["state"], outs[1][name]["state"]
        check(all(torch.equal(a[k], c[k]) for k in a),
              f"multi.world2.{name}: rank 1's state differs from rank 0's")
        calls = outs[0][name]["collectives"]
        phase(f"multi.world2.{name}", mesh=list(shape), world_size=2, backend="gloo",
              device="cuda:0 shared by both ranks",
              config="flagship, float32, fused_step off, %d steps, %d trials and %d channels "
              "a rank" % (steps, per, autograd["cfg"].ydim // shape[1]), tol=MULTI_XLA_TOL,
              max_abs_err=max(errs), ranks_bit_equal=True,
              us_per_step=[1e6 * o[name]["seconds"] / steps for o in outs],
              all_reduces_per_step={ax: sum(1 for x, _ in calls if x == ax) / steps
                                    for ax in ("mesh", "tp")},
              all_reduce_floats=sorted(set(calls)),
              gloo_all_reduce_us={k: [o[name]["all_reduce_us"][k] for o in outs]
                                  for k in outs[0][name]["all_reduce_us"]},
              card=smi)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def carry_bytes(carry, written: bool = False) -> int:
    """Bytes of the carry's leaves; ``written``: only those a step updates."""
    fixed = (("cent_x", "cent_u", "c2", "inv_w2", "w_white", "scale2", "rng_seed") if written
             else ())
    return nbytes(*(v for k, v in flatten(carry._asdict()).items()
                    if k.split(".")[0] not in fixed))


def step_ops(cfg, b: int, nfp: int, ns_iters=None):
    """Operations (2 per multiply-add) of the products of one step at the
    main path's flags (SGD, decoder trained, RLS on): (full-f32 products,
    products of ``_mm_fn``, bf16 inputs when matmul_dtype='bfloat16'). With
    SGP dynamics the whitening product counts as f32. ``ns_iters=None``:
    phase 1 alone. Elementwise work is not counted."""
    xd, yd, ud, h = cfg.xdim, cfg.ydim, cfg.udim, list(cfg.hidden_sizes)
    hidden = sum(h[i] * h[i - 1] for i in range(1, len(h)))
    first = h[0] * (yd + ud + 2 * xd)
    mm = b * (nfp * nfp + nfp * xd + first + hidden + 2 * xd * h[-1] + yd * xd)  # forward
    mm += b * (2 * xd * yd + 4 * xd * h[-1] + 2 * hidden + first)               # backward
    mm += b * nfp * (nfp + xd)                                                 # F^T F, F^T dx
    f32 = b * nfp * (xd + ud)                                                  # RBF cross term
    if cfg.dynamics == "sgp":
        f32 += b * nfp * nfp                                                   # whitening
    if ns_iters is not None:
        f32 += 2 * nfp * nfp * xd + ns_iters * 2 * nfp ** 3   # P w, V g, Newton-Schulz
        mm += b * nfp * xd                                    # state-noise residual
    return 2 * f32, 2 * mm


def bound(cfg, nbytes_: float, ops) -> tuple:
    """(least ms on one card, what sets it): bytes over the memory rate or
    the operations over the peak rate of their type, the larger."""
    f32_ops, mm_ops = ops
    t_ops = f32_ops / PEAK_F32 + mm_ops / (PEAK_BF16 if cfg.matmul_dtype == "bfloat16"
                                           else PEAK_F32)
    t_bytes = nbytes_ / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (this script runs on the card)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    phase("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # ---------------- build ----------------
    info = _build.build()
    _build.load_library(info.path)
    F._library()
    ptxas = [ln.strip().replace("ptxas info    : ", "") for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln
             or "Function properties" in ln]
    phase("build", seconds=round(info.seconds, 2), library=str(info.path), ptxas=ptxas)

    check_rng(dev)

    # ---------------- a post-warm-up flagship state ----------------
    cfg = flagship()
    b = B
    state = core.init_state(0, cfg, device=dev)
    ys = spikes(T_EPOCH, b, cfg.ydim, dev, seed=1)
    us = torch.zeros((T_EPOCH, b, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    # a short warm-up epoch, whose last posterior starts the step phase:
    # after a full one that posterior lies where the RBF features are nearly
    # 0, the next step's tau falls far below NS_TAU_THRESHOLD, and the step
    # phase would not reach the exact fallback
    warm = core.run_epoch(cfg, StepFlags(warm_up=True), state, ys[:WARM_STEPS],
                          us[:WARM_STEPS], 5, lr)
    post_warm = warm.state
    qm0, qlv0 = warm.q_means[-1].contiguous(), warm.q_logvars[-1].contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    eps = torch.randn((2, 1024, b, cfg.xdim), device=dev, generator=gen)
    flags = StepFlags()
    mask_data = masked_data(ys[:MASK_T], seed=40)

    step_err = check_step(post_warm, qm0, qlv0, ys[-1], eps[0, 0], eps[1, 0], lr)
    fallback = check_fallback(dev, smi)
    sums_err = check_forward_sums(post_warm, qm0, qlv0, ys[-1], eps[0, 0], eps[1, 0])
    check_shard_sum(cfg, post_warm, qm0, qlv0, ys[-1])

    # ---------------- mega: flagship after a 512-step plain prefix ----------------
    carry = F.pad_carry(cfg, post_warm)
    qm, qlv = qm0, qlv0
    t0 = time.perf_counter()
    for t in range(cfg.ns_prefix):
        out = prefix_step(F.fused_step_plain, cfg, flags, carry, qm, qlv, ys[t],
                          eps[0, t], eps[1, t], lr)
        carry, qm, qlv = out.carry, out.q_pack[0], out.q_pack[1]
    torch.cuda.synchronize()
    phase("mega.prefix", steps=cfg.ns_prefix, seconds=round(time.perf_counter() - t0, 3),
          last_tau=float(out.scal[0, 4]))
    post_prefix = (clone(carry), qm, qlv)
    lo, hi = cfg.ns_prefix, cfg.ns_prefix + MEGA_STEPS
    mega_err, mega_tau = 0.0, None
    for mm in ("float32", "bfloat16"):
        c = flagship(mm)
        err, (_, _, rs), (_, _, ks) = check_mega(
            f"mega[{mm}]", c, flags, carry, qm, qlv, ys[lo:hi], eps[0, lo:hi], eps[1, lo:hi], lr)
        mega_err = max(mega_err, err)
        if mm == cfg.matmul_dtype:
            mega_tau = ks[:, 4]
        phase(f"mega[{mm}].tau", base_iters=F.mega_ns_base_iters(c, b),
              plain_max=float(rs[:, 4].max()), kernel_max=float(ks[:, 4].max()))
    # the in-kernel Philox noise against the plain Philox, same seed and count
    seeded = carry._replace(rng_seed=torch.full((1, 1), 777, dtype=torch.int32, device=dev),
                            rng_count=torch.full((1, 1), 5000, dtype=torch.int32, device=dev))
    _, (rc, _, _), (kc, _, _) = check_mega("mega[philox]", cfg, flags, seeded, qm, qlv,
                                           ys[lo:hi], None, None, lr, planted=False)
    check(int(kc.rng_count) == int(rc.rng_count) == 5000 + MEGA_STEPS, "mega: rng_count")
    check_deterministic(cfg, flags, seeded, qm, qlv, ys[lo:hi], lr)
    # how the fused kernel launches at the flagship shape
    info = F.cluster_info(cfg, flags, carry, qm, qlv, ys[lo:hi], None, lr)
    check(info["cluster"] > 1 and info["active_clusters"] >= 1, f"cluster: {info}")
    phase("cluster", **info, trials_by_block=[len(F.cluster_rows(r, b))
                                              for r in range(info["cluster"])],
          spills=[ln for ln in ptxas if "spill" in ln])

    check_escalation(dev)
    check_ragged(dev)

    # skip: straight after warm-up tau >= NS_TAU_MAX, so every step skips
    carry = F.pad_carry(cfg, post_warm)
    p0, v0 = carry.p_mat.clone(), carry.v_mat.clone()
    rc, _, rs = F.mega_epoch_plain(cfg, flags, clone(carry), qm0, qlv0, ys[:4], None,
                                   eps[0, :4], eps[1, :4], lr)
    kc, _, ks = F.mega_epoch_call(cfg, flags, clone(carry), qm0, qlv0, ys[:4], None,
                                  eps[0, :4], eps[1, :4], lr)
    check(bool(torch.isinf(ks[:, 4]).all() and torch.isinf(rs[:, 4]).all()), "skip: tau not inf")
    check(torch.equal(kc.p_mat, p0) and torch.equal(kc.v_mat, v0), "skip: kernel moved P/V")
    check(torch.equal(rc.p_mat, p0) and torch.equal(rc.v_mat, v0), "skip: plain moved P/V")
    phase("mega.skip", steps=4, tau_kernel=ks[:, 4].tolist(), p_v_unchanged=True)

    # warm-up flags, as the main path's first epoch runs them: from a fresh
    # state and the prior, no RLS update
    fresh = core.init_state(0, cfg, device=dev)
    q0 = core.prior(fresh.params, b)
    check_mega("mega[warm-up]", cfg, StepFlags(warm_up=True), F.pad_carry(cfg, fresh),
               q0.mean.contiguous(), q0.logvar.contiguous(), ys[:MEGA_STEPS],
               eps[0, :MEGA_STEPS], eps[1, :MEGA_STEPS], lr)

    # ---------------- main path ----------------
    state = core.init_state(0, cfg, device=dev)
    lrs = cfg.lr * cfg.lr_decay ** torch.arange(2, dtype=torch.float32, device=dev)
    F.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wu = core.run_epochs(cfg, StepFlags(warm_up=True), state, ys, us, [10], lrs[:1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = core.run_epochs(cfg, StepFlags(), wu.state, ys, us, [11, 12], lrs)
    loss = float(out.epoch_loss[-1])
    t2 = time.perf_counter()
    launches, steps_by_kernel = dict(F.launches), dict(F.steps)
    max_tau = float(out.max_tau.max())
    hot = float(out.hot_frac.max())
    check(loss == loss and abs(loss) != float("inf") and loss != 0.0, f"degenerate loss {loss}")
    check(max_tau < 0.7, f"Newton-Schulz never contracted (tau={max_tau})")
    check(hot < 0.01, f"dropped {100 * hot:.1f}% of RLS updates")
    check(launches["fused_step"] > 0 and launches["mega_epoch"] > 0, f"launches {launches}")
    check(launches["exact_fallback"] == launches["fused_step"],
          f"main: a prefix step without its fallback launch: {launches}")
    check(tuple(out.q_means.shape) == (T_EPOCH, b, cfg.xdim)
          and bool(torch.isfinite(out.q_means).all()), "main: posterior not finite")
    check(bool(torch.isfinite(out.epoch_loss).all()), "main: epoch losses not finite")
    steps = 2 * T_EPOCH
    phase("main", config="bench.py flagship, B 256, T %d/epoch" % T_EPOCH,
          warmup_epoch_s=round(t1 - t0, 3), rls_epochs_s=round(t2 - t1, 3),
          rls_steps_per_s=round(steps / (t2 - t1), 1), epoch_loss=out.epoch_loss.tolist(),
          max_tau=out.max_tau.tolist(), hot_frac=out.hot_frac.tolist(), launches=launches,
          timesteps=steps_by_kernel, card=smi)

    # ---------------- times: kernel vs plain at the flagship shape ----------------
    # from the post-prefix state, where the mega segment runs its base
    # Newton-Schulz iteration (a state with tau >= 0.7 would skip it); the
    # kernels update their carry in place, so each side gets its own copy
    carry_t, qm_t, qlv_t = post_prefix
    y0, e_s, e_t = ys[lo], eps[0, lo], eps[1, lo]
    times = kernel_times(cfg, carry_t, qm_t, qlv_t, ys[lo:hi], eps[:, lo:hi], lr)
    step_ms, step_plain_ms = (us / 1e3 for us in times["fused_step"])
    mega_ms, mega_plain_ms = (us / 1e3 for us in times["mega_epoch"])
    stepped = times["stepped"]
    fallback_ms = cuda_ms(lambda: F.exact_v_fallback(cfg, stepped, carry_t, None), 20)

    sums_args = (qm_t, qlv_t, y0, None, e_s, e_t, 1.0 / b)

    def k_sums():
        return F.forward_sums_call(cfg, flags, carry_t, *sums_args)

    def p_sums():
        F.forward_sums_plain(cfg, flags, carry_t, *sums_args)

    p1, k1, k2, p2 = (cuda_ms(p_sums, 20), cuda_ms(k_sums, 20), cuda_ms(k_sums, 20),
                      cuda_ms(p_sums, 20))
    sums_ms, sums_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    phase("times", unit="us per timestep", card=smi, fused_step=1e3 * step_ms,
          fused_step_plain=1e3 * step_plain_ms, mega_epoch=1e3 * mega_ms,
          mega_epoch_plain=1e3 * mega_plain_ms, exact_v_fallback=1e3 * fallback_ms,
          forward_sums=1e3 * sums_ms, forward_sums_plain=1e3 * sums_plain_ms)

    profile_epoch(cfg, wu.state, ys, us, lrs[0], smi)

    # ---------------- sgp: the SGP kernels against their plain versions ----------------
    sgp_cfg = sgp_flagship()
    sgp_state, sgp_qm, sgp_qlv = sgp_check_state(sgp_cfg, ys, us, lr)
    sgp_k = check_sgp_kernels(sgp_state, sgp_qm, sgp_qlv, ys, eps, lr, smi)

    # ---------------- sharded: the exact-sync epoch at world size 1 ----------------
    (sums_launches, sums_steps, sgp_sums_launches, sgp_sums_steps, mask_sums_launches,
     mask_sums_steps) = check_sharded_epoch(cfg, post_warm, ys, us, lr, qm0, qlv0, smi,
                                            (sgp_cfg, sgp_state), mask_data)

    # ---------------- the autograd epoch and the fit loop ----------------
    check_xla(flagship("float32"), post_warm, ys, us, lr, smi)
    check_fit_flagship(cfg, ys, smi)
    check_fit_demote(cfg, ys, smi)
    check_fit_vdp(dev, smi)

    # ---------------- sgp: the main path, fit, and the routing of refused shapes ------------
    sgp_main = check_sgp_main(ys, us, smi)
    check_fit_sgp(ys, smi)
    check_route(ys, us, lr)

    # ---------------- masks: ragged trials and missing channels ----------------
    mask_errs = check_mask_kernels(post_warm, qm0, qlv0, post_prefix, mask_data, eps, lr, smi)
    mask_ms = mask_times(post_prefix, mask_data, eps, lr, smi)
    mask_main = check_mask_main(mask_data, smi)
    check_fit_ragged(mask_data, smi)

    # ---------------- backends: precision, covariance, the Kalman learner ----------------
    check_backends_steps(dev, smi)
    check_backends_fit(dev, smi)

    # ---------------- the facade: streaming, snapshots, save and load ----------------
    stream_k = check_stream(dev, smi)
    check_stream_tail(stream_cfg(), stream_k["data"], smi)
    check_stream_resume(stream_cfg(), stream_k["data"], dev, smi)
    check_fit_resume(cfg, ys, smi)
    check_facade_vdp(dev, smi)

    # ---------------- ensembles: N members a launch ----------------
    ens_ys = torch.stack([spikes(WARM_STEPS + cfg.ns_prefix + MEGA_STEPS, ENS_B, cfg.ydim, dev,
                                 seed=50 + m) for m in range(ENS_N)])
    ens_k = check_ensemble_kernels(cfg, ens_ys, lr, smi)
    ens_main = check_ensemble_fit(cfg, dev, smi)
    check_ensemble_fallback(cfg, dev, smi, ens_main)
    check_ensemble_mixed(cfg, dev, smi)
    check_ensemble_demote(cfg, dev, smi)

    # ---------------- smoothing and co-smoothing evaluation ----------------
    check_smooth_pkalman(dev, smi)
    cosmooth = check_cosmooth(dev, smi)
    check_smooth_facade(dev, smi)
    check_smooth_times(cosmooth, smi)

    # ---------------- multi: training over ranks ----------------
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        group = make_dp_group()
        # NCCL sets up its communicator at the first collective: not timed
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
        multi = check_multi_fit(cfg, ys, group, smi)
        sync = check_multi_sync_every(cfg, wu.state, ys, us, lr, group, smi)
        autograd = check_multi_autograd(cfg, post_warm, ys, us, lr, group, smi)
    finally:
        dist.destroy_process_group()
    check_multi_world2(cfg, wu.state, ys, us, lr, multi, cosmooth, autograd, smi)

    # ---------------- shapes: trial tiles, 256 and 512 padded features, deeper and wider
    # layers, 4096 trials -----
    shapes = check_shapes(dev, smi)
    t_depths = time.perf_counter()
    depths = check_depths(dev)
    phase("shapes.depths", layers=list(DEPTH_LAYERS), width=DEPTH_WIDTH,
          routes={r: {"trials": b, "n_rbf": n or flagship().n_rbf, "plan": plan,
                      "layers": DEPTH_ROUTE_LAYERS} for r, (b, n, plan) in DEPTH_ROUTES.items()},
          max_abs_err=depths, seconds=time.perf_counter() - t_depths)
    t_plans = time.perf_counter()
    plans = check_plans(dev)
    phase("shapes.plans", plans=list(plans), trials=B, warm_up_steps=PLAN_WARM,
          mega_steps=PLAN_STEPS, max_abs_err={k: max(v.values()) for k, v in plans.items()},
          seconds=time.perf_counter() - t_plans)

    # ---------------- bounds: the least time one card could take ----------------
    # each input read once and each output written once (step_mega_bounds)
    nfp = carry_t.p_mat.shape[0]
    data = nbytes(y0, qm_t, qlv_t, e_s, e_t, lr)
    read, written = carry_bytes(carry_t), carry_bytes(carry_t, written=True)
    step_bound, mega_bound = step_mega_bounds(cfg, b, carry_t, qm_t, qlv_t, y0, e_s, e_t, lr,
                                              stepped, mega_tau)
    flat, q_pack = k_sums()   # phase 1 reads neither P nor the learning rate
    sums_bound = bound(cfg, read - nbytes(carry_t.p_mat, lr) + data + nbytes(flat, q_pack),
                       step_ops(cfg, b, nfp))

    # the SGP carry: the same reads and writes plus w_white and scale2, the
    # whitening product among the f32 operations
    s_carry = sgp_k["carry"]
    s_read = carry_bytes(s_carry)
    sgp_step_bound, sgp_mega_bound = step_mega_bounds(sgp_cfg, b, s_carry, qm_t, qlv_t, y0,
                                                      e_s, e_t, lr, sgp_k["stepped"],
                                                      sgp_k["mega_tau"])
    s_flat, s_q = sgp_k["flat"]
    sgp_sums_bound = bound(sgp_cfg, s_read - nbytes(s_carry.p_mat, lr) + data
                           + nbytes(s_flat, s_q), step_ops(sgp_cfg, b, nfp))

    # masked: the timed step's masks read once more; the products of the
    # valid trials, and the imputation's decoder product over every trial
    _, _, m_mask, m_cm, _ = mask_data
    t1, m_lo = 3 * m_mask.shape[0] // 4, cfg.ns_prefix
    m_valid = float(m_mask[t1].sum())
    seg_valid = float(m_mask[m_lo:m_lo + MEGA_STEPS].sum(dim=1).mean())
    impute = 2 * b * cfg.ydim * cfg.xdim

    def masked_ops(n_valid, ns_iters=None):
        f32_ops, mm_ops = step_ops(cfg, max(int(round(n_valid)), 1), nfp, ns_iters)
        return f32_ops, mm_ops + impute

    m_bytes = nbytes(m_mask[t1], m_cm[t1])
    mask_step_bound = bound(cfg, read + written + data + m_bytes + nbytes(
        stepped.q_pack, stepped.g_vec, stepped.xt, stepped.xs, stepped.scal),
        masked_ops(m_valid, F.NS_ITERS))
    mask_mega_bound = bound(cfg, (read + written + nbytes(qm_t, qlv_t)) / MEGA_STEPS + nbytes(
        y0, e_s, e_t) + m_bytes + nbytes(stepped.q_pack) + 4 * 8,
        masked_ops(seg_valid, F.mega_ns_base_iters(cfg, b, masked=True)))
    mask_sums_bound = bound(cfg, read - nbytes(carry_t.p_mat, lr) + data + m_bytes
                            + nbytes(flat, q_pack) + 4, masked_ops(m_valid))

    # ensembles: N members' work, member 0's bounds times N
    st0 = ens_k["stepped"]
    st0 = F.PackedStepOut(F.member_carry(st0.carry, 0), *(x[0] for x in st0[1:]))
    e_step, e_mega = step_mega_bounds(cfg, ENS_B, F.member_carry(ens_k["carry"], 0),
                                      ens_k["qm"][0], ens_k["qlv"][0], ens_k["y0"][0], None,
                                      None, lr, st0, ens_k["mega_tau"][0])
    ens_step_bound, ens_mega_bound = ((ENS_N * b_[0], b_[1]) for b_ in (e_step, e_mega))

    # library_ms: no single PyTorch call computes a VJF step or its phase 1
    src = "vjf_tpu_torch/csrc/fused_step.cu"
    fb_t = fallback["times"]["n128.b256"]

    def row(name, replaces, launches_, steps_, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"vjf_tpu/ops/pallas/fused_step.py:{replaces}",
                "launches": launches_, "steps": steps_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        row("fused_step", 1104, launches["fused_step"], steps_by_kernel["fused_step"],
            step_err, step_ms, step_plain_ms, step_bound),
        row("mega_epoch", 1767, launches["mega_epoch"], steps_by_kernel["mega_epoch"],
            mega_err, mega_ms, mega_plain_ms, mega_bound),
        row("forward_sums", 1437, sums_launches, sums_steps, sums_err, sums_ms, sums_plain_ms,
            sums_bound),
        row("fused_step.sgp", 1104, sgp_main["launches"]["fused_step"],
            sgp_main["steps"]["fused_step"], sgp_k["errs"]["fused_step"],
            *sgp_k["ms"]["fused_step"], sgp_step_bound),
        row("mega_epoch.sgp", 1767, sgp_main["launches"]["mega_epoch"],
            sgp_main["steps"]["mega_epoch"], sgp_k["errs"]["mega_epoch"],
            *sgp_k["ms"]["mega_epoch"], sgp_mega_bound),
        row("forward_sums.sgp", 1437, sgp_sums_launches, sgp_sums_steps,
            sgp_k["errs"]["forward_sums"], *sgp_k["ms"]["forward_sums"], sgp_sums_bound),
        row("fused_step.mask", 1104, mask_main["launches"]["fused_step"],
            mask_main["steps"]["fused_step"], mask_errs["fused_step"],
            *mask_ms["fused_step"], mask_step_bound),
        row("mega_epoch.mask", 1767, mask_main["launches"]["mega_epoch"],
            mask_main["steps"]["mega_epoch"], mask_errs["mega_epoch"],
            *mask_ms["mega_epoch"], mask_mega_bound),
        row("forward_sums.mask", 1437, mask_sums_launches, mask_sums_steps,
            mask_errs["forward_sums"], *mask_ms["forward_sums"], mask_sums_bound),
        row("fused_step.stream", 1104, stream_k["launches"]["fused_step"],
            stream_k["steps"]["fused_step"], stream_k["errs"]["fused_step"],
            *stream_k["ms"]["fused_step"], stream_k["bounds"]["fused_step"]),
        row("mega_epoch.stream", 1767, stream_k["launches"]["mega_epoch"],
            stream_k["steps"]["mega_epoch"], stream_k["errs"]["mega_epoch"],
            *stream_k["ms"]["mega_epoch"], stream_k["bounds"]["mega_epoch"]),
        row("fused_step.ensemble", 1104, ens_main["launches"]["fused_step.ensemble"],
            ens_main["steps"]["fused_step.ensemble"], ens_k["errs"]["fused_step"],
            *ens_k["ms"]["fused_step"], ens_step_bound),
        row("mega_epoch.ensemble", 1767, ens_main["launches"]["mega_epoch.ensemble"],
            ens_main["steps"]["mega_epoch.ensemble"], ens_k["errs"]["mega_epoch"],
            *ens_k["ms"]["mega_epoch"], ens_mega_bound),
        # the multi paths run the flagship shapes of rows 1-3 (B 256 a rank)
        row("forward_sums.multi", 1437, multi["launches"]["forward_sums"],
            multi["steps"]["forward_sums"], sums_err, sums_ms, sums_plain_ms, sums_bound),
        row("fused_step.sync_every", 1104, sync["launches"]["fused_step"],
            sync["steps"]["fused_step"], step_err, step_ms, step_plain_ms, step_bound),
        row("mega_epoch.sync_every", 1767, sync["launches"]["mega_epoch"],
            sync["steps"]["mega_epoch"], mega_err, mega_ms, mega_plain_ms, mega_bound),
        # the fallback taken at the flagship shape; the library's Cholesky beside it
        dict(row("exact_fallback", 1357, launches["exact_fallback"],
                 steps_by_kernel["exact_fallback"], fallback["worst"]["kernel"],
                 fb_t["taken_us"] / 1e3, fb_t["plain_us"] / 1e3,
                 (fb_t["bound_us"] / 1e3, fb_t["bound_by"])),
             source="vjf_tpu_torch/csrc/exact_fallback.cu", library_ms=fb_t["library_us"] / 1e3,
             skipped_ms=fb_t["skipped_us"] / 1e3),
    ] + [
        # the shapes: the step and mega launches from each shape's main path, the
        # phase-1 launches from its sharded steps
        row(f"{k}.{tag}", replaces, sh["launches"][k], sh["steps"][k], sh["errs"][k],
            sh["us"][k][0] / 1e3, sh["us"][k][1] / 1e3, sh["bounds"][k])
        for tag, sh in shapes.items()
        for k, replaces in (("fused_step", 1104), ("mega_epoch", 1767), ("forward_sums", 1437))
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_epoch(cfg, state, ys, us, lr, smi) -> None:
    """One RLS epoch of the main path from ``state``: host time and the
    prefix steps whose tau reaches the exact fallback, then device time by
    kernel under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def epoch():
        res = core.run_epoch(cfg, StepFlags(), state, ys, us, 13, lr)
        torch.cuda.synchronize()
        return res

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tau = epoch().metrics.tau[:cfg.ns_prefix]
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    check(device_us > 0, "profile: no device time recorded")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    phase("profile", what="one RLS epoch, T %d" % ys.shape[0], host_s_unprofiled=host_s,
          prefix_first_tau=float(tau[0]),
          prefix_steps_with_fallback=int((tau >= F.NS_TAU_THRESHOLD).sum()),
          device_s=device_us / 1e6, device_busy_share=device_us / 1e6 / host_s,
          top_kernels=[{"name": e.key[:60], "calls": e.count,
                        "share": e.self_device_time_total / device_us} for e in top],
          card=smi)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--world2-rank":
        sys.exit(world2_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
