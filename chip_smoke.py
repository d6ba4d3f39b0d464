"""Drive the PyTorch/CUDA port (``vjf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of ``vjf_tpu_torch/csrc`` with nvcc, holds each against
its plain PyTorch version (and checks that planted faults are rejected by
the same comparison), drives the main path (the flagship config of
``bench.py``: one warm-up epoch, then RLS-active epochs at full width,
T = 2048 per epoch) through the kernels, times each kernel beside its plain
version, and profiles one RLS epoch. Phases print one line each; any failed
check raises and the script exits non-zero. The last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from vjf_tpu_torch.config import StepFlags, VJFConfig
from vjf_tpu_torch.convert import flatten
from vjf_tpu_torch.models import vjf as core
from vjf_tpu_torch.ops import _build, rng
from vjf_tpu_torch.ops import fused_step as F

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
# with bf16 products (PERF.md).
TOL = {"float32": 1e-3, "bfloat16": 2e-3}
F32_ULP = 2.0 ** -23
SCAL_COLUMNS = ("loss", "recon", "dyn", "ent", "tau")


def phase(name: str, /, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


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


def compare(name: str, ref: dict, got: dict, tol: float, start: dict,
            reject: bool = False) -> float:
    """Hold ``got`` (kernel) against ``ref`` (plain) leaf by leaf; return
    the largest max abs diff.

    A leaf's normalised error is max|got - ref| over a scale. For a carry
    leaf (a key of ``start``, its value before the run) the scale is how far
    the plain version moved it, max|ref - start|, so that an update the
    kernel skipped or got wrong counts in full however small the step; for
    an output it is max|ref|. Four f32 ulps of the leaf's size are added for
    the rounding of a value that barely moved. Integer leaves and non-finite
    entries (the inf tau of a skipped step) must match exactly. Fails when
    the largest error exceeds ``tol``, or, with ``reject=True`` (a planted
    fault), when it does not."""
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
    worst = max(errs, key=errs.get)
    phase(name, tol=tol, max_err=errs[worst], worst_leaf=worst,
          max_abs_err=max(diffs.values()), leaves=len(ref),
          err_by_leaf={k: float(f"{v:.3e}") for k, v in errs.items()})
    if reject:
        check(errs[worst] > tol, f"{name}: planted fault passed (max error {errs[worst]:.3e})")
    else:
        check(errs[worst] <= tol, f"{name}: {worst} error {errs[worst]:.3e} > {tol:.3e}")
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
    e_state = core.init_state(0, esc)
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
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
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
    mega_err = 0.0
    for mm in ("float32", "bfloat16"):
        c = flagship(mm)
        err, (_, _, rs), (_, _, ks) = check_mega(
            f"mega[{mm}]", c, flags, carry, qm, qlv, ys[lo:hi], eps[0, lo:hi], eps[1, lo:hi], lr)
        mega_err = max(mega_err, err)
        phase(f"mega[{mm}].tau", base_iters=F.mega_ns_base_iters(c, b),
              plain_max=float(rs[:, 4].max()), kernel_max=float(ks[:, 4].max()))
    # the in-kernel Philox noise against the plain Philox, same seed and count
    seeded = carry._replace(rng_seed=torch.full((1, 1), 777, dtype=torch.int32, device=dev),
                            rng_count=torch.full((1, 1), 5000, dtype=torch.int32, device=dev))
    _, (rc, _, _), (kc, _, _) = check_mega("mega[philox]", cfg, flags, seeded, qm, qlv,
                                           ys[lo:hi], None, None, lr, planted=False)
    check(int(kc.rng_count) == int(rc.rng_count) == 5000 + MEGA_STEPS, "mega: rng_count")

    check_escalation(dev)

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
    launches = dict(F.launches)
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
          card=smi)

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
    phase("times", unit="us per timestep", card=smi, fused_step=1e3 * step_ms,
          fused_step_plain=1e3 * step_plain_ms, mega_epoch=1e3 * mega_ms,
          mega_epoch_plain=1e3 * mega_plain_ms, exact_v_fallback=1e3 * fallback_ms)

    profile_epoch(cfg, wu.state, ys, us, lrs[0], smi)

    src = "vjf_tpu_torch/csrc/fused_step.cu"
    print(json.dumps({"kernels": [
        {"name": "fused_step", "route": "cuda", "source": src,
         "replaces": "vjf_tpu/ops/pallas/fused_step.py:1104", "launches": launches["fused_step"],
         "max_abs_err": step_err, "ms": step_ms, "plain_ms": step_plain_ms},
        {"name": "mega_epoch", "route": "cuda", "source": src,
         "replaces": "vjf_tpu/ops/pallas/fused_step.py:1767", "launches": launches["mega_epoch"],
         "max_abs_err": mega_err, "ms": mega_ms, "plain_ms": mega_plain_ms},
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
