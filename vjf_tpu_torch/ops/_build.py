"""Build and load the port's CUDA kernels.

``load_library()`` compiles ``vjf_tpu_torch/csrc/*.cu`` with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), caches it under ``build/vjf_tpu_torch/<hash>/`` beside the
package (the directory is git-ignored), and loads it with ``ctypes``. The
hash covers the sources and the compiler flags, so an edited source builds
anew. Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vjf_tpu_torch"
# Blocks in the kernels' thread-block cluster, a compile-time constant of
# csrc/fused_step.cu. 8 is the largest portable size; the environment
# variable VJF_CLUSTER builds another (4 or 16) to compare.
CLUSTER = int(os.environ.get("VJF_CLUSTER", "8"))
# ptxas at -O1: at -O2 and -O3 (the default) ptxas built the kernels of the
# source before the L2 route wrong at 3 and 4 hidden layers (the flat buffer's
# offsets, computed on the device from the launch's arguments, one hidden
# layer's product past the host's), with the same PTX right at -O1; no smaller
# kernel shows it and this source does not, so the cause is not pinned down
# (scripts/torch_o3_repro.py, ROADMAP Queue 3). chip_smoke.py's "shapes.depths"
# holds every depth on each of the kernels' three instantiations
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-Xptxas", "-O1",
              f"-DVJF_CLUSTER={CLUSTER}"]


class BuildInfo(NamedTuple):
    path: Path
    seconds: float        # 0.0 when the library was already built
    log: str              # nvcc's output (ptxas registers and spills)


_loaded: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    return srcs, headers


def build() -> BuildInfo:
    """Compile the sources unless the hashed library already exists."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libvjf_kernels.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, (out_dir / "nvcc.log").read_text()
                         if (out_dir / "nvcc.log").exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build to a temporary name and rename: a concurrent loader never sees a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    (out_dir / "nvcc.log").write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, time.perf_counter() - t0, log)


def load_library(path: Optional[Path] = None) -> ctypes.CDLL:
    """The kernels' library, built at first use (or loaded from ``path``)."""
    global _loaded
    if _loaded is None:
        _loaded = ctypes.CDLL(str(path or build().path))
    return _loaded
