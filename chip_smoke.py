"""Drive the PyTorch/CUDA port (``vjf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of ``vjf_tpu_torch/csrc`` with nvcc, holds each against
its plain PyTorch version (and checks that planted faults are rejected by
the same comparison; also that two runs give the same bits, and that a batch
the cluster does not divide is split right), drives the main path (the flagship config of
``bench.py``: one warm-up epoch, then RLS-active epochs at full width,
T = 2048 per epoch) through the kernels, times each kernel beside its plain
version, and profiles one RLS epoch. The ``sharded`` phases then drive the
exact-sync sharded epoch (``parallel.sharded``) at world size 1 over NCCL
through its phase-1 kernel and hold it against the single-device epoch. The
last phases hold the autograd epoch (``fused_step='off'``, the route a
demoted epoch takes) against the stepwise kernel epoch, and drive the
training entry point ``fit``: blocked at the flagship width with
``bench_all.py``'s forgetting (prefix-free continuation), per epoch with a
forced demotion and re-probe, and ``bench_all.py``'s Van der Pol fit, whose
forecast must beat persistence.
Phases print one line each; any failed check raises and the script exits
non-zero. The last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from vjf_tpu_torch import datasets
from vjf_tpu_torch.config import StepFlags, VJFConfig
from vjf_tpu_torch.convert import flatten, state_to_numpy
from vjf_tpu_torch.models import vjf as core
from vjf_tpu_torch.ops import _build, rng
from vjf_tpu_torch.ops import fused_step as F
from vjf_tpu_torch.parallel import make_dp_group, run_epoch_fused_sharded
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
    out.update({c: scal[:, i] for i, c in enumerate(SCAL_COLUMNS)})
    return out


def packed(out: F.PackedStepOut) -> dict:
    return dict(flatten(out.carry._asdict()), **outputs(out.q_pack, out.scal),
                g_vec=out.g_vec, xt=out.xt, xs=out.xs)


def segment(carry, q_pack, scal) -> dict:
    """Every leaf of a mega segment's result, by name."""
    return dict(flatten(carry._asdict()), **outputs(q_pack, scal))


def prefix_step(step_fn, cfg, flags, carry, qm, qlv, y, e_s, e_t, lr):
    """One exact-inverse prefix step: a fused step, then the fallback."""
    prev = carry._replace(dyn_n=carry.dyn_n.clone(), state_logvar=carry.state_logvar.clone())
    out = step_fn(cfg, flags, carry, qm, qlv, y, None, e_s, e_t, lr)
    return F.exact_v_fallback(cfg, out, prev, None)


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


def sums_leaves(flat: torch.Tensor, q_pack: torch.Tensor, carry) -> dict:
    """Every leaf of a flat FusedSums buffer by name, and the q pack."""
    return dict(flatten(F.unpack_sums(flat, carry)._asdict()),
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


def check_sharded_epoch(cfg, post_warm, ys, us, lr, qm, qlv, smi) -> int:
    """The sharded epoch at world size 1 over NCCL: SHARD_T RLS-active steps
    from the post-warm-up state in both matmul modes, each held against the
    single-device stepwise epoch (same seed, in-kernel noise), and the
    per-step split. The run of ``cfg`` (the flagship's bf16 products) is
    the main path. Planted fault: the other mode's sharded epoch. Returns
    the phase-1 kernel's launches and timesteps in the main path."""
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
        check(launches == {"fused_step": 0, "mega_epoch": 0, "forward_sums": SHARD_T},
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
        return launches["forward_sums"], timesteps["forward_sums"]
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
        entry = {"route": "fused" if fused else "autograd",
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


def quality_problem(name: str):
    """``bench_all.py``'s config #1 (``van_der_pol``) or #2 (``lorenz``):
    ``(cfg, y (T, ydim) float32, x_true (T, xdim))``."""
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
            "demoted_blocks": sum(b["route"] == "autograd" for b in blocks),
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def carry_bytes(carry, written: bool = False) -> int:
    """Bytes of the carry's leaves; ``written``: only those a step updates."""
    fixed = ("cent_x", "cent_u", "c2", "inv_w2", "rng_seed") if written else ()
    return nbytes(*(v for k, v in flatten(carry._asdict()).items()
                    if k.split(".")[0] not in fixed))


def step_ops(cfg, b: int, nfp: int, ns_iters=None):
    """Operations (2 per multiply-add) of the products of one step at the
    main path's flags (SGD, decoder trained, RLS on): (full-f32 products,
    products of ``_mm_fn``, bf16 inputs when matmul_dtype='bfloat16').
    ``ns_iters=None``: phase 1 alone. Elementwise work is not counted."""
    xd, yd, ud, h = cfg.xdim, cfg.ydim, cfg.udim, list(cfg.hidden_sizes)
    hidden = sum(h[i] * h[i - 1] for i in range(1, len(h)))
    first = h[0] * (yd + ud + 2 * xd)
    mm = b * (nfp * nfp + nfp * xd + first + hidden + 2 * xd * h[-1] + yd * xd)  # forward
    mm += b * (2 * xd * yd + 4 * xd * h[-1] + 2 * hidden + first)               # backward
    mm += b * nfp * (nfp + xd)                                                 # F^T F, F^T dx
    f32 = b * nfp * (xd + ud)                                                  # RBF cross term
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

    step_err = check_step(post_warm, qm0, qlv0, ys[-1], eps[0, 0], eps[1, 0], lr)
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
    carry_s, carry_m = clone(carry_t), clone(carry_t)
    y0, e_s, e_t = ys[-2], eps[0, 0], eps[1, 0]

    def k_step():
        return F.fused_step_call(cfg, flags, carry_s, qm_t, qlv_t, y0, None, e_s, e_t, lr)

    def p_step():
        F.fused_step_plain(cfg, flags, carry_t, qm_t, qlv_t, y0, None, e_s, e_t, lr)

    def k_mega():
        F.mega_epoch_call(cfg, flags, carry_m, qm_t, qlv_t, ys[lo:hi], None,
                          eps[0, lo:hi], eps[1, lo:hi], lr)

    def p_mega():
        F.mega_epoch_plain(cfg, flags, carry_t, qm_t, qlv_t, ys[lo:hi], None,
                           eps[0, lo:hi], eps[1, lo:hi], lr)

    p1, k1, k2, p2 = cuda_ms(p_step, 20), cuda_ms(k_step, 20), cuda_ms(k_step, 20), cuda_ms(p_step, 20)
    step_ms, step_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    p1, k1, k2, p2 = (cuda_ms(p_mega, 1), cuda_ms(k_mega, 3), cuda_ms(k_mega, 3),
                      cuda_ms(p_mega, 1))
    mega_ms, mega_plain_ms = (k1 + k2) / 2 / MEGA_STEPS, (p1 + p2) / 2 / MEGA_STEPS
    stepped = k_step()
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

    # ---------------- sharded: the exact-sync epoch at world size 1 ----------------
    sums_launches, sums_steps = check_sharded_epoch(cfg, post_warm, ys, us, lr, qm0, qlv0, smi)

    # ---------------- the autograd epoch and the fit loop ----------------
    check_xla(flagship("float32"), post_warm, ys, us, lr, smi)
    check_fit_flagship(cfg, ys, smi)
    check_fit_demote(cfg, ys, smi)
    check_fit_vdp(dev, smi)

    # ---------------- bounds: the least time one card could take ----------------
    # each input read once and each output written once; the mega segment's
    # carry once per MEGA_STEPS steps, its Newton-Schulz iterations as the
    # timed segment's tau asked for (base, +1 at 0.05, +2 at 0.25, none when
    # skipped at 0.7)
    nfp = carry_t.p_mat.shape[0]
    data = nbytes(y0, qm_t, qlv_t, e_s, e_t, lr)
    read, written = carry_bytes(carry_t), carry_bytes(carry_t, written=True)
    step_bound = bound(cfg, read + written + data + nbytes(
        stepped.q_pack, stepped.g_vec, stepped.xt, stepped.xs, stepped.scal),
        step_ops(cfg, b, nfp, F.NS_ITERS))
    iters = torch.where(mega_tau < F.NS_TAU_MAX, F.mega_ns_base_iters(cfg, b)
                        + (mega_tau >= F.NS_TAU_ESCALATE).int()
                        + F.NS_EXTRA_ITERS * (mega_tau >= F.NS_TAU_THRESHOLD).int(), 0)
    mega_bound = bound(cfg, (read + written + nbytes(qm_t, qlv_t)) / MEGA_STEPS + nbytes(
        y0, e_s, e_t) + nbytes(stepped.q_pack) + 4 * 8, step_ops(cfg, b, nfp, float(
            iters.float().mean())))
    flat, q_pack = k_sums()   # phase 1 reads neither P nor the learning rate
    sums_bound = bound(cfg, read - nbytes(carry_t.p_mat, lr) + data + nbytes(flat, q_pack),
                       step_ops(cfg, b, nfp))

    # library_ms: no single PyTorch call computes a VJF step or its phase 1
    src = "vjf_tpu_torch/csrc/fused_step.cu"

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
    sys.exit(main())
