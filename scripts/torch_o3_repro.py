"""Reproduces the fault ptxas -O2/-O3 built into csrc/fused_step.cu at 3 and 4 hidden layers.

    python3 scripts/torch_o3_repro.py --tree DIR [--variants OPT[+cond|+branch],...]

DIR is a source tree whose kernel holds the hidden layers in arrays of eight
(``MAX_LAYERS``; the tree before the layer table, 76821d2, or earlier). Each
variant is a copy of the tree's ``vjf_tpu_torch`` and ``chip_smoke.py``, one
directory a tree and variant under the
git-ignored ``build/o3repro/``, built with ptxas at the level OPT (all builds at
once, one nvcc each), with one audit added to the kernel: thread 0 of each
block of member 0 saves the block's shared-memory header (the arguments and
the layouts, ``Header``) to global memory once ``make_header`` has written
it and compares it word by word at the end of the launch, and block 0 of
each kernel kind keeps the flat buffer's offsets (``SumsOff``) as the header
holds them. ``cond`` writes ``sums_offsets``'s two loops over the layers as
conditional expressions (the form of the kernel before the L2 route),
``branch`` the other way round.

One worker process a variant runs ``chip_smoke.depth_runs`` at 1 to 8 hidden
layers of 8 in f32 and prints, for each depth, every kernel's worst
normalised error against its plain version (and every leaf over 1e-3),
whether each block's header changed by the end of the launch (-1: it did
not, else 99000 and the count of words that differ) and the device's offsets
wherever they differ from the host's ``sums_offsets`` of the same arguments.

To reproduce the fault, give it the source before the L2 route
(``git archive 9ee7efc vjf_tpu_torch chip_smoke.py | tar -x -C DIR``):
``--tree DIR --variants 3,1,3+branch``. Reading on an H100 80GB HBM3 at 700
W, nvcc 12.9, is in ROADMAP.md (Queue 3). Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPIES = ROOT / "build" / "o3repro"
KINDS = ("forward_sums", "fused_step", "mega_epoch")

DEBUG = r"""
// ---- o3 audit ----
__device__ unsigned dbg_ref[3][VJF_CLUSTER][512];
__device__ int dbg_first[3][VJF_CLUSTER];
__device__ unsigned dbg_diff[3][VJF_CLUSTER][48];
__device__ int dbg_kind[VJF_CLUSTER];
__device__ unsigned long long dbg_so[3][sizeof(SumsOff) / 8];
__device__ int dbg_lv[3][1 + 2 * MAX_LEAVES];
extern __shared__ float4 vjf_smem[];

__device__ __noinline__ void dbg_save() {
  if (threadIdx.x || blockIdx.y) return;
  const int r = blockIdx.x % VJF_CLUSTER, k = dbg_kind[r];
  const volatile unsigned* w = reinterpret_cast<const volatile unsigned*>(vjf_smem);
  for (int i = 0; i < (int)HEADER_FLOATS; ++i) dbg_ref[k][r][i] = w[i];
  if (r == 0) {
    const Header* h = reinterpret_cast<const Header*>(vjf_smem);
    const unsigned long long* so = reinterpret_cast<const unsigned long long*>(&h->c.so);
    for (int i = 0; i < (int)(sizeof(SumsOff) / 8); ++i) dbg_so[k][i] = so[i];
    dbg_lv[k][0] = h->c.lv.n;
    for (int i = 0; i < MAX_LEAVES; ++i) {
      dbg_lv[k][1 + i] = h->c.lv.off[i];
      dbg_lv[k][1 + MAX_LEAVES + i] = h->c.lv.len[i];
    }
  }
}

__device__ __noinline__ void dbg_check(int id) {
  if (threadIdx.x || blockIdx.y) return;
  const int r = blockIdx.x % VJF_CLUSTER, k = dbg_kind[r];
  if (dbg_first[k][r] >= 0) return;
  const volatile unsigned* w = reinterpret_cast<const volatile unsigned*>(vjf_smem);
  int nd = 0;
  for (int i = 0; i < (int)HEADER_FLOATS; ++i) {
    const unsigned v = w[i], ref = dbg_ref[k][r][i];
    if (v != ref) {
      if (nd < 16) {
        dbg_diff[k][r][3 * nd] = i;
        dbg_diff[k][r][3 * nd + 1] = ref;
        dbg_diff[k][r][3 * nd + 2] = v;
      }
      ++nd;
    }
  }
  if (nd) dbg_first[k][r] = id * 1000 + (nd < 999 ? nd : 999);
}

__device__ __forceinline__ void dbg_kind_set(int k) {
  if (threadIdx.x == 0 && blockIdx.y == 0) dbg_kind[blockIdx.x % VJF_CLUSTER] = k;
}

// ---- end of the o3 audit ----
"""

HOST = r"""
#include <cstring>
extern "C" int vjf_dbg_reset(void) {
  static int first[3 * VJF_CLUSTER];
  for (int i = 0; i < 3 * VJF_CLUSTER; ++i) first[i] = -1;
  cudaError_t e = cudaMemcpyToSymbol(dbg_first, first, sizeof(first));
  return (int)e;
}

extern "C" int vjf_dbg_offsets(unsigned long long* so, int* lv) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(so, dbg_so, sizeof(dbg_so));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(lv, dbg_lv, sizeof(dbg_lv));
  return (int)e;
}

extern "C" int vjf_dbg_so_words(void) { return (int)(sizeof(SumsOff) / 8); }

extern "C" size_t vjf_host_sums_off(const VJFArgs* a, unsigned long long* so) {
  const SumsOff o = sums_offsets(*a);
  std::memcpy(so, &o, sizeof(o));
  return sizeof(o) / 8;
}

extern "C" int vjf_dbg_read(int* first, unsigned* diff) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(first, dbg_first, sizeof(int) * 3 * VJF_CLUSTER);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(diff, dbg_diff, sizeof(dbg_diff));
  return (int)e;
}
"""


def sub(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced by ``new``; in a source whose kernels have
    one template parameter (before the L2 route), the anchors' ``<TILED, BIG>``
    read ``<TILED>``."""
    if src.count(old) != 1:
        old, new = (x.replace("<TILED, BIG>", "<TILED>") for x in (old, new))
    if src.count(old) != 1:
        raise SystemExit(f"anchor not found once: {old[:60]!r}")
    return src.replace(old, new)


def patch(src: str, variant: str) -> str:
    """The source with the patches of ``variant`` ('+' joins several)."""
    for part in variant.split("+"):
        src = patch_one(src, part)
    return src


BRANCH = """  for (int i = 0; i < MAX_LAYERS - 1; ++i) {
    o.w_hidden[i] = off;
    if (i + 1 < a.n_layers) off += (size_t)a.h[i + 1] * a.h[i];
  }
  for (int i = 0; i < MAX_LAYERS; ++i) {
    o.b_hidden[i] = off;
    if (i < a.n_layers) off += a.h[i];
  }
"""
CONDITIONAL = """  for (int i = 0; i < MAX_LAYERS - 1; ++i)
    o.w_hidden[i] = off, off += i + 1 < a.n_layers ? (size_t)a.h[i + 1] * a.h[i] : 0;
  for (int i = 0; i < MAX_LAYERS; ++i) o.b_hidden[i] = off, off += i < a.n_layers ? a.h[i] : 0;
"""


def patch_one(src: str, variant: str) -> str:
    if variant == "cond":
        return sub(src, BRANCH, CONDITIONAL)
    if variant == "branch":
        return sub(src, CONDITIONAL, BRANCH)
    if variant != "end":
        raise SystemExit(f"unknown variant {variant}")
    src = sub(src, "#define HEADER_FLOATS ((sizeof(Header) + 15) / 16 * 4)\n",
              "#define HEADER_FLOATS ((sizeof(Header) + 15) / 16 * 4)\n" + DEBUG)
    src = sub(src, "      lv.add(a.b_dec, c.so.b_dec, a.yd);\n    }\n  }\n",
              "      lv.add(a.b_dec, c.so.b_dec, a.yd);\n    }\n    dbg_save();\n  }\n")
    src = sub(src, "  vjf_steps<TILED, BIG>(a, reinterpret_cast<float*>(vjf_smem));",
              "  dbg_kind_set(a.mega ? 2 : 1);\n"
              "  vjf_steps<TILED, BIG>(a, reinterpret_cast<float*>(vjf_smem));\n"
              "  __syncthreads();\n  dbg_check(99);")
    src = sub(src, "  vjf_sums<TILED, BIG>(a, reinterpret_cast<float*>(vjf_smem));",
              "  dbg_kind_set(0);\n  vjf_sums<TILED, BIG>(a, reinterpret_cast<float*>(vjf_smem));\n"
              "  __syncthreads();\n  dbg_check(99);")
    src = src + HOST
    return src


def prepare(tree: Path, name: str, variant: str, opt: int) -> Path:
    dest = COPIES / name
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(tree / "vjf_tpu_torch", dest / "vjf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copy(tree / "chip_smoke.py", dest / "chip_smoke.py")
    cu = dest / "vjf_tpu_torch" / "csrc" / "fused_step.cu"
    cu.write_text(patch(cu.read_text(), variant))
    path = dest / "vjf_tpu_torch" / "ops" / "_build.py"
    src = path.read_text()
    if re.search(r'"-Xptxas", "-O\d"', src):
        src = re.sub(r'"-Xptxas", "-O\d"', f'"-Xptxas", "-O{opt}"', src)
    else:
        src = src.replace('"-O3",', f'"-O3", "-Xptxas", "-O{opt}",', 1)
    path.write_text(src)
    return dest


def worker(dest: Path) -> None:
    sys.path.insert(0, str(dest))
    import torch
    import chip_smoke as cs
    from vjf_tpu_torch.ops import _build

    F = cs.F
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    lib = _build.load_library(_build.build().path)
    F._library()
    n, words, mm = F.cluster_size(), lib.vjf_dbg_so_words(), "float32"
    for depth in range(1, F._MAX_LAYERS + 1):
        lib.vjf_dbg_reset()
        row = {"variant": dest.name, "layers": depth, "mm": mm}
        for kernel, (ref, got, start) in cs.depth_runs(depth, mm, dev).items():
            errs, _ = cs.compare_errs(ref, got, start)
            worst = max(errs, key=errs.get)
            row[kernel] = [float(f"{errs[worst]:.3e}"), worst]
            if errs[worst] > 1e-3:
                row[f"{kernel}.over"] = {k: float(f"{v:.3e}") for k, v in errs.items()
                                         if v > 1e-3}
        first = (ctypes.c_int * (3 * n))()
        diff = (ctypes.c_uint * (3 * n * 48))()
        row["audit_rc"] = lib.vjf_dbg_read(first, diff)
        for k, kind in enumerate(KINDS):
            firsts = list(first[k * n:(k + 1) * n])
            row[f"{kind}.header_changed"] = firsts
            for r in range(n):
                if firsts[r] >= 0:
                    base = (k * n + r) * 48
                    row[f"{kind}.diff.block{r}"] = [list(diff[base + 3 * i:base + 3 * i + 3])
                                                    for i in range(min(firsts[r] % 1000, 16))]
                    break
        so = (ctypes.c_ulonglong * (3 * words))()
        lv = (ctypes.c_int * (3 * (1 + 2 * (9 + 2 * F._MAX_LAYERS))))()
        lib.vjf_dbg_offsets(so, lv)
        cfg = cs.flagship(mm).replace(hidden_sizes=(cs.DEPTH_WIDTH,) * depth)
        host = (ctypes.c_ulonglong * words)()
        lib.vjf_host_sums_off(ctypes.byref(F._dims(cfg, cs.B)), host)
        row["sums_offsets.host"] = list(host)
        for k, kind in enumerate(KINDS):
            if list(so[k * words:(k + 1) * words]) != list(host):
                row[f"{kind}.sums_offsets.device"] = list(so[k * words:(k + 1) * words])
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="3,1")
    ap.add_argument("--tree", required=True)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker))
        return 0
    specs = []
    for i, spec in enumerate(args.variants.split(",")):
        opt, *extra = spec.split("+")
        name = f"{Path(args.tree).resolve().name}_{i}_O{opt}{''.join('_' + e for e in extra)}"
        specs.append((name, prepare(Path(args.tree).resolve(), name, "+".join(["end", *extra]),
                                    int(opt))))
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", "from vjf_tpu_torch.ops import _build; "
                                "_build.build()"], cwd=d, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True) for _, d in specs]
    failed = set()
    for (name, _), p in zip(specs, builds):
        log = p.communicate()[0]
        if p.returncode:
            failed.add(name)
            print(json.dumps({"build_failed": name, "log": log[-1500:]}), flush=True)
    specs = [s for s in specs if s[0] not in failed]
    print(json.dumps({"built": [s[0] for s in specs],
                      "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    rc = 1 if failed else 0
    for name, d in specs:
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(d)],
                              cwd=d, capture_output=True, text=True, timeout=900)
        print(done.stdout, end="", flush=True)
        if done.returncode:
            print(name, done.stderr[-3000:], file=sys.stderr)
            rc = 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return rc


if __name__ == "__main__":
    sys.exit(main())
