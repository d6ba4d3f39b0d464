"""Where a fused step's time goes inside the kernel: SM clocks per phase.

    python3 scripts/torch_kernel_marks.py

Copies ``vjf_tpu_torch`` and ``chip_smoke.py`` into the git-ignored
``build/marks/``, patches ``csrc/fused_step.cu`` there with ``clock64()``
marks (a ``__syncthreads()`` and, in thread 0 of block 0, the clocks since
the last mark added to a ``__device__`` array), builds that copy, brings the
flagship state of ``chip_smoke.py`` past a 256-step warm-up and the 512-step
exact prefix, and runs a 64-step mega segment and single per-step launches
through the marked kernels. Prints clocks, share and microseconds per phase
and timestep. The first mark of a launch also holds the idle time since the
last launch, so for single launches it is the launch gap. The marks hang on
lines of the source; the script stops if one is no longer there. Other
blocks' waiting shows only as barrier time. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "marks"

MARK_MACRO = '''#include "vjf_hopper.cuh"
__device__ long long vjf_prof[64];
__device__ long long vjf_prof_last;
#define MARK(i) do { __syncthreads(); if (threadIdx.x == 0 && cluster_rank() == 0) { \\
    long long now = clock64(); vjf_prof[i] += now - vjf_prof_last; \\
    vjf_prof_last = now; } } while (0)
'''
READERS = '''extern "C" {
int vjf_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, vjf_prof, sizeof(long long) * 64);
}
int vjf_prof_reset(void) {
  long long z[64] = {0};
  return (int)cudaMemcpyToSymbol(vjf_prof, z, sizeof(z));
}
'''

# (index, name, "before" or "after", the source text the mark hangs on)
MARKS = [
    (0, "between steps / begin", "before",
     "// ---------------- forward ----------------"),
    (1, "xs, x2, features", "before",
     "const Mat feat = rowmaj(s.feat, s.ldf);"),
    (2, "F V, F w, first layer", "before",
     "for (int b = tid >> 5; b < nb; b += NWARPS) {  // a warp per trial"),
    (3, "fvf, tanh", "before",
     "for (int l = 1; l < L; ++l) {\n    const int hi = a.widths[l], hp = a.widths[l - 1];\n"
     "    mm(nb, hi, hp, rowmaj(ly[l - 1].hs"),
    (4, "hidden layers, heads", "before",
     "{\n    float* qp = a.q_pack"),
    (5, "posterior elementwise, q_pack", "before",
     "mm(nb, yd, xd, rowmaj(s.xt, xd), trans(a.w_dec, xd), s.py"),
    (6, "decoder product", "before",
     "// ---------------- ELBO batch sums"),
    (7, "ELBO loop + block_sum", "before",
     "// ---------------- manual backward"),
    (8, "g_xt, g_w_dec, g_b_dec", "before",
     "for (int i = tid; i < nb * xd; i += NTHREADS) {\n      const int b = i / xd, kk = i % xd;\n"
     "      const float lv = qt_lv[i];"),
    (9, "g_q elementwise", "before",
     "mm(xd, hl, nb, trans(s.g_qm, xd), h_last, slab + c.so.wm"),
    (10, "g_wm, g_wlv, g_h, g_blv", "before",
     "for (int l = L - 1; l >= 1; --l) {  // layers n..1"),
    (11, "hidden backward, g_a", "before",
     "const Mat g_at = trans(s.g_a, s.ldg);"),
    (12, "g_b_hidden0, g_w_in_*", "before",
     "// the RLS raw statistics F^T F and F^T dx are taken in phase 2"),
    (13, "stat_rows (F^T F, F^T dx rows)", "before",
     "for (int idx = tid; idx < frn * nfp; idx += NTHREADS) {\n"
     "        const int il = idx / nfp, col = idx % nfp, r = fr0 + il;"),
    (14, "grad_check, scalars", "before",
     "if (t + 1 < a.T) fetch_inputs<TILED, BIG>(a, c, t + 1);\n  cluster_sync();"),
    (15, "prefetch + cluster barrier 1", "after",
     "if (t + 1 < a.T) fetch_inputs<TILED, BIG>(a, c, t + 1);\n  cluster_sync();"),
    (16, "reduce scalars", "after",
     "const StepSums p = reduce_scalars(a, c, cs, inv_b, valid);"),
    (17, "ELBO consts, SGD slices", "before",
     "// ---------------- RLS with Newton-Schulz tracking of V"),
    (18, "P_new rows, iterate rows, fxd rows", "before",
     "// g = lam P w + F^T dx / sv, full f32\n      mm(frn"),
    (19, "P w, g_vec", "before",
     "cluster_sync();  // g_vec and the scaled iterate are whole"),
    (20, "cluster barrier 2", "after",
     "cluster_sync();  // g_vec and the scaled iterate are whole"),
    (21, "Newton-Schulz iterations (with barriers)", "before",
     "// this block's rows of V_new = (X + X^T) / 2"),
    (22, "symmetrise, V g, finite sum", "before",
     "cluster_sync();\n        ns_ok = isfinite(rank_sum"),
    (23, "cluster barrier 3", "after",
     "cluster_sync();\n        ns_ok = isfinite(rank_sum(c, c.so.ftf + SC_FINITE));"),
    (24, "commit rows of P, V, w", "before",
     "cluster_sync();  // the new w is whole"),
    (25, "cluster barrier 4", "after",
     "cluster_sync();  // the new w is whole"),
    (26, "residual product + sum", "before",
     "if (tid == 0) c.slab[c.so.ftf + SC_RESID] = ms[0];\n    cluster_sync();"),
    (27, "cluster barrier 5", "after",
     "if (tid == 0) c.slab[c.so.ftf + SC_RESID] = ms[0];\n    cluster_sync();"),
]


def make_copy() -> None:
    """The package and chip_smoke.py under COPY, the kernel source marked."""
    shutil.rmtree(COPY, ignore_errors=True)
    COPY.mkdir(parents=True)
    shutil.copytree(ROOT / "vjf_tpu_torch", COPY / "vjf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", COPY / "chip_smoke.py")
    path = COPY / "vjf_tpu_torch" / "csrc" / "fused_step.cu"
    src = path.read_text()

    def once(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"mark anchor found {src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)

    once('#include "vjf_hopper.cuh"\n', MARK_MACRO)
    for idx, _, kind, anchor in MARKS:
        once(anchor, f"MARK({idx});\n  {anchor}" if kind == "before"
             else f"{anchor}\n  MARK({idx});")
    once('extern "C" {\n', READERS)
    path.write_text(src)


def main() -> int:
    make_copy()
    sys.path.insert(0, str(COPY))
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch.config import StepFlags
    from vjf_tpu_torch.models import vjf as core
    from vjf_tpu_torch.ops import _build
    from vjf_tpu_torch.ops import fused_step as F

    _build.build()
    lib = F._library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg, flags, b = cs.flagship(), StepFlags(), cs.B
    steps = cs.WARM_STEPS + cfg.ns_prefix + cs.MEGA_STEPS
    ys = cs.spikes(steps, b, cfg.ydim, dev, seed=1)
    us = torch.zeros((steps, b, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    warm = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device=dev),
                          ys[:cs.WARM_STEPS], us[:cs.WARM_STEPS], 5, lr)
    carry = F.pad_carry(cfg, warm.state)
    qm, qlv = warm.q_means[-1].contiguous(), warm.q_logvars[-1].contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    eps = torch.randn((2, steps, b, cfg.xdim), device=dev, generator=gen)
    for t in range(cs.WARM_STEPS, cs.WARM_STEPS + cfg.ns_prefix):
        out = cs.prefix_step(F.fused_step_call, cfg, flags, carry, qm, qlv, ys[t], eps[0, t],
                             eps[1, t], lr)
        carry, qm, qlv = out.carry, out.q_pack[0], out.q_pack[1]
    lo = cs.WARM_STEPS + cfg.ns_prefix
    names = {idx: name for idx, name, _, _ in MARKS}

    def report(label, fn, nsteps):
        fn()
        torch.cuda.synchronize()
        lib.vjf_prof_reset()
        us_step = 1e3 * cs.cuda_ms(fn, 3) / nsteps   # cuda_ms runs fn once more before timing
        buf = (ctypes.c_longlong * 64)()
        lib.vjf_prof_read(buf)
        total, n = sum(buf), 4 * nsteps
        print(f"== {label}: {us_step:.1f} us per timestep with the marks, "
              f"{total / n:.0f} clocks per timestep, {cs.smi_line()}")
        for i, clocks in enumerate(buf):
            if clocks:
                print(f"  {i:2d} {names.get(i, '?'):42s} {clocks / n:9.0f} clocks "
                      f"{100 * clocks / total:5.1f}%  {us_step * clocks / total:7.2f} us")

    carry_m, carry_s = cs.clone(carry), cs.clone(carry)
    report("mega, 64 steps a launch",
           lambda: F.mega_epoch_call(cfg, flags, carry_m, qm, qlv, ys[lo:], None, eps[0, lo:],
                                     eps[1, lo:], lr), cs.MEGA_STEPS)
    report("per-step launches",
           lambda: F.fused_step_call(cfg, flags, carry_s, qm, qlv, ys[lo], None, eps[0, lo],
                                     eps[1, lo], lr), 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
