"""Runs the CUDA kernels of ``vjf_tpu_torch/csrc/fused_step.cu`` and
``exact_fallback.cu`` on the CPU, where there is no card: an emulation for
checking a change to a kernel before it reaches the card.

    python3 scripts/kernel_emu/emu.py [--threads 512] [--cluster 8] [--smem BYTES]
        [--asan] [--opt -O2] [CASE ...]

The kernel file is cut before its "Kernels and the C interface" section and
built with g++ (``emu.cpp`` beside this file: a pthread a CUDA thread, a
``std::barrier`` each ``__syncthreads`` and ``cluster_sync``; the CUDA and
Hopper calls from this directory's ``cuda_runtime.h`` and ``vjf_hopper.cuh``)
into ``build/kernel_emu/`` (git-ignored). The port's own binding loads that
library in place of the card's, with ``_on_cuda`` and the pointer check
patched to take CPU tensors, so each launcher runs its emulated kernel. A
case warms a small flagship-like configuration up through the kernels, then
prints its tile plan and each kernel's worst normalised error
(``chip_smoke.compare_errs``) against its plain version: one step with the
exact fallback, one phase-1 launch, an 8-step mega segment. ``--smem`` sets
``MAX_SMEM_BYTES`` (a smaller limit forces tiles, chunks and the L2 route at
small shapes); ``--asan`` builds with AddressSanitizer at -O1 (run with
``LD_PRELOAD`` of g++'s ``libasan.so`` and ``ASAN_OPTIONS=detect_leaks=0``).
512 threads and a cluster of 8 (the card's geometry) take seconds a launch;
``--threads 128 --cluster 4`` is quicker. The emulated tensor-core product
sums in f32 in k order, so bits differ from the card's. The ``fb.*`` cases
run the fallback kernel (``emu_fallback.cpp``, built into the same library)
through ``chip_smoke.check_fallback_case`` on synthetic inputs, and an
ensemble case's members bit for bit against their solo launches.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

# name: (hidden sizes, trials, matmul precision, n_rbf, ydim, masks: "", "cmask", "both")
CASES = {
    "h8x1": ((8,), 16, "float32", 30, 20, ""),
    "h8x9": ((8,) * 9, 16, "float32", 30, 20, ""),
    "h8x9.bf16": ((8,) * 9, 16, "bfloat16", 30, 20, ""),
    "h8x9.both": ((8,) * 9, 16, "float32", 30, 20, "both"),
    "h5x12": ((5, 7, 6, 8, 5, 4, 8, 6, 5, 7, 8, 6), 16, "float32", 30, 20, ""),
    "h32.bf16": ((32,), 32, "bfloat16", 30, 20, ""),
    "n200.h8x9": ((8,) * 9, 64, "float32", 200, 20, ""),
    "n200.h8x9.both": ((8,) * 9, 64, "float32", 200, 20, "both"),
    "b64.h6x16.both": ((6,) * 16, 64, "float32", 30, 20, "both"),
}


# the fallback kernel: name: (features, trials, SGP, controls, trial mask), the
# members' taus, a planted gate; through chip_smoke's fallback checks
INF, NAN = float("inf"), float("nan")
FALLBACK = {
    "fb.taus": ((100, 16, False, 0, False), (0.2499, 0.25, 0.3, INF, NAN, 0.1), None),
    "fb.b1": ((30, 1, False, 0, False), (0.3,), None),
    "fb.mask_u": ((30, 16, False, 2, True), (0.3,), None),
    "fb.sgp": ((30, 16, True, 0, False), (0.3,), None),
    "fb.n256": ((200, 8, False, 0, False), (0.3,), None),
    "fb.not_pd": ((30, 16, False, 0, False), (0.3,), "not_pd"),
    "fb.w_inf": ((30, 16, False, 0, False), (0.3,), "w_inf"),
    "fb.var_inf": ((30, 16, False, 0, False), (0.3,), "var_inf"),
}


def build(args) -> Path:
    """The emulated library of this tree's kernel files at the given geometry."""
    out = ROOT / "build" / "kernel_emu" / f"t{args.threads}_c{args.cluster}_s{args.smem}" \
        f"{'_asan' if args.asan else ''}"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("fused_step", "exact_fallback"):
        src = (ROOT / "vjf_tpu_torch" / "csrc" / f"{name}.cu").read_text().splitlines(True)
        cut = next(i for i, ln in enumerate(src) if "Kernels and the C interface" in ln)
        (out / f"{name}_cut.cu").write_text("".join(src[:cut - 1]))
    lib = out / "libvjf_emu.so"
    flags = [f"-DNTHREADS={args.threads}", f"-DVJF_CLUSTER={args.cluster}",
             f"-DMAX_SMEM_BYTES={args.smem}"]
    flags += ["-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer"] if args.asan \
        else [args.opt]
    subprocess.run(["g++", "-std=c++20", "-shared", "-fPIC", f"-I{out}", f"-I{HERE}",
                    f"-I{ROOT / 'vjf_tpu_torch' / 'csrc'}", *flags,
                    str(HERE / "emu.cpp"), str(HERE / "emu_fallback.cpp"), "-o", str(lib),
                    "-lpthread"], check=True)
    return lib


def load(lib: Path, cluster: int):
    """The port's binding on the emulated library: every launcher runs it
    on CPU tensors."""
    os.environ["VJF_CLUSTER"] = str(cluster)
    sys.path.insert(0, str(ROOT))
    import torch

    from vjf_tpu_torch.ops import _build
    from vjf_tpu_torch.ops import fused_step as F

    _build.load_library(lib)
    F._library()
    F._on_cuda = lambda t: True

    def ptr(t, name, shape=None, dtype=torch.float32, device=None):
        if t is None:
            return None
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        return t.data_ptr()

    F._ptr = ptr
    torch.cuda.device = lambda d: contextlib.nullcontext()
    torch.cuda.current_stream = lambda d=None: types.SimpleNamespace(cuda_stream=0)
    return F


def run(name, hidden, b, mm, n_rbf, ydim, masks, warm=24, seg=8) -> float:
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch.config import StepFlags
    from vjf_tpu_torch.models import vjf as core
    from vjf_tpu_torch.ops import fused_step as F

    cfg = cs.flagship(mm).replace(ydim=ydim, xdim=3, n_rbf=n_rbf, hidden_sizes=hidden)
    flags, g = StepFlags(), torch.Generator().manual_seed(5)
    ys = torch.bernoulli(torch.full((warm + seg, b, ydim), 0.3), generator=g)
    us = torch.zeros((warm + seg, b, 0))
    lr = torch.tensor(cfg.lr)
    eps = torch.randn((2, seg, b, cfg.xdim), generator=g)
    w = core.run_epoch(cfg, StepFlags(warm_up=True), core.init_state(0, cfg, device="cpu"),
                       ys[:warm], us[:warm], 92, lr)
    qm, qlv = w.q_means[-1].contiguous(), w.q_logvars[-1].contiguous()
    carry = F.pad_carry(cfg, w.state)
    mask = cmask = None
    if masks:
        cmask = (torch.rand((seg, b, ydim), generator=g) > 0.2).float()
        mask = (torch.rand((seg, b), generator=g) > 0.3).float() if masks == "both" else None
    m0 = None if mask is None else mask[0]
    c0 = None if cmask is None else cmask[0]
    y0, e_s, e_t = ys[warm], eps[0, 0], eps[1, 0]
    info = F.cluster_info(cfg, flags, carry, qm, qlv, ys[warm:], None, lr, mask=mask,
                          cmask=cmask)
    step = [cs.packed(cs.masked_prefix_step(fn, cfg, flags, cs.clone(carry), qm, qlv, y0, e_s,
                                            e_t, lr, mask=m0, cmask=c0))
            for fn in (F.fused_step_plain, F.fused_step_call)]
    inv_b = 1.0 / (float(m0.sum()) if m0 is not None else b)
    sums = [cs.sums_leaves(*fn(cfg, flags, carry, qm, qlv, y0, None, e_s, e_t, inv_b, mask=m0,
                               cmask=c0), carry, c0 is not None)
            for fn in (F.forward_sums_plain, F.forward_sums_call)]
    mega = [cs.segment(*fn(cfg, flags, cs.clone(carry), qm, qlv, ys[warm:], None, eps[0],
                           eps[1], lr, mask=mask, cmask=cmask))
            for fn in (F.mega_epoch_plain, F.mega_epoch_call)]
    start = cs.flatten(carry._asdict())
    worst = {}
    for k, (ref, got), st in (("step", step, start), ("sums", sums, {}), ("mega", mega, start)):
        errs, _ = cs.compare_errs(ref, got, st)
        leaf = max(errs, key=errs.get)
        worst[k] = (leaf, errs[leaf])
    plan = (info["tile_rows"], info["stage_rows"], info["sub_rows"])
    print(name, "plan", plan, {k: f"{leaf} {e:.2e}" for k, (leaf, e) in worst.items()},
          flush=True)
    return max(e for _, e in worst.values())


def run_fallback(name, shape, taus, gate) -> float:
    """The fallback kernel against its plain version (chip_smoke's
    ``check_fallback_case``), and each member bit for bit against its solo
    launch."""
    import chip_smoke as cs

    cs.phase = lambda n, **kw: print(n, kw, flush=True)
    case = cs.fallback_case(shape, taus, "cpu", 7, gate=gate)
    errs = cs.check_fallback_case(name, *case, taus, gate=gate)
    if len(taus) > 1:
        cs.check_fallback_members(*case)
    return max(errs["kernel"].values())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="*", default=list(CASES) + list(FALLBACK))
    ap.add_argument("--threads", type=int, default=128)
    ap.add_argument("--cluster", type=int, default=4)
    ap.add_argument("--smem", type=int, default=232448)
    ap.add_argument("--opt", default="-O2")
    ap.add_argument("--asan", action="store_true")
    args = ap.parse_args()
    load(build(args), args.cluster)
    worst = max(run_fallback(c, *FALLBACK[c]) if c in FALLBACK else run(c, *CASES[c])
                for c in args.cases)
    print("worst", worst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
