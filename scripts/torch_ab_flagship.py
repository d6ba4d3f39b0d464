"""Times the flagship mega step of two or more source trees in turns, on one card.

    python3 scripts/torch_ab_flagship.py NAME=TREE[:OPT] NAME=TREE[:OPT] ... \\
        [--rounds 1] [--depths NAME,NAME]

Each TREE is a checkout of this repository (its ``vjf_tpu_torch`` and
``chip_smoke.py`` are used). The script copies both into the git-ignored
``build/ab/NAME/``; OPT, where given, replaces the ``-Xptxas -O`` level of the
copy's ``ops/_build.py``. It builds every copy's kernels at once (one nvcc
each), then runs one worker process per tree and turn, in the order
A B ... B A, ``--rounds`` times. A worker brings ``chip_smoke.py``'s flagship
state past its warm-up and its 512-step exact prefix, times the mega kernel
over the next MEGA_STEPS steps with CUDA events as ``chip_smoke.py``'s
"times" phase does (a warm call, 3 calls, 3 more, their mean), five times
from the same state, and prints one JSON line: the microseconds per step,
the kernel's registers and spills, and a digest of the outputs of one step,
one phase-1 launch and one mega segment, so that the trees' bits can be
compared. For the trees named by ``--depths`` the worker also holds the
three kernels against their plain versions at 1 to 8 hidden layers
(``chip_smoke.depth_runs``) and prints the readings without a limit: a
diagnosis, not a check. The last lines are the card and a summary by tree.
Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPIES = ROOT / "build" / "ab"
REPEATS = 5


def prepare(name: str, tree: Path, opt) -> Path:
    dest = COPIES / name
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(tree / "vjf_tpu_torch", dest / "vjf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copy(tree / "chip_smoke.py", dest / "chip_smoke.py")
    if opt is not None:
        path = dest / "vjf_tpu_torch" / "ops" / "_build.py"
        src = path.read_text()
        if re.search(r'"-Xptxas", "-O\d"', src):
            src = re.sub(r'"-Xptxas", "-O\d"', f'"-Xptxas", "-O{opt}"', src)
        else:
            src = src.replace('"-O3",', f'"-O3", "-Xptxas", "-O{opt}",', 1)
        path.write_text(src)
    return dest


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(dest: Path, depths: bool) -> None:
    sys.path.insert(0, str(dest))
    import torch
    import chip_smoke as cs
    from vjf_tpu_torch.ops import _build

    F, core = cs.F, cs.core
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    info = _build.build()
    _build.load_library(info.path)
    F._library()
    cfg, b = cs.flagship(), cs.B
    ys = cs.spikes(cs.T_EPOCH, b, cfg.ydim, dev, seed=1)
    us = torch.zeros((cs.T_EPOCH, b, 0), device=dev)
    lr = torch.tensor(cfg.lr, device=dev)
    warm = core.run_epoch(cfg, cs.StepFlags(warm_up=True), core.init_state(0, cfg, device=dev),
                          ys[:cs.WARM_STEPS], us[:cs.WARM_STEPS], 5, lr)
    qm, qlv = warm.q_means[-1].contiguous(), warm.q_logvars[-1].contiguous()
    eps = torch.randn((2, 1024, b, cfg.xdim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    flags = cs.StepFlags()
    carry = F.pad_carry(cfg, warm.state)
    for t in range(cfg.ns_prefix):
        out = cs.prefix_step(F.fused_step_plain, cfg, flags, carry, qm, qlv, ys[t], eps[0, t],
                             eps[1, t], lr)
        carry, qm, qlv = out.carry, out.q_pack[0], out.q_pack[1]
    lo, hi = cfg.ns_prefix, cfg.ns_prefix + cs.MEGA_STEPS
    seg = (ys[lo:hi], None, eps[0, lo:hi], eps[1, lo:hi], lr)
    bits = {
        "fused_step": digest(cs.packed(F.fused_step_call(
            cfg, flags, cs.clone(carry), qm, qlv, ys[lo], None, eps[0, lo], eps[1, lo], lr))),
        "forward_sums": digest(dict(zip(("flat", "q_pack"), F.forward_sums_call(
            cfg, flags, carry, qm, qlv, ys[lo], None, eps[0, lo], eps[1, lo], 1.0 / b)))),
        "mega_epoch": digest(cs.segment(*F.mega_epoch_call(cfg, flags, cs.clone(carry), qm,
                                                           qlv, *seg))),
    }
    mega_us = []
    for _ in range(REPEATS):
        moving = cs.clone(carry)

        def k_mega():
            F.mega_epoch_call(cfg, flags, moving, qm, qlv, *seg)

        k1, k2 = cs.cuda_ms(k_mega, 3), cs.cuda_ms(k_mega, 3)
        mega_us.append(1e3 * (k1 + k2) / 2 / cs.MEGA_STEPS)
    launch = F.cluster_info(cfg, flags, carry, qm, qlv, ys[lo:hi], None, lr)
    row = {"tree": dest.name, "mega_us": mega_us, "bits": bits,
           "registers": launch["registers"], "local_bytes": launch["local_bytes"],
           "build_s": round(info.seconds, 1),
           "ptxas": [ln.strip() for ln in info.log.splitlines()
                     if "vjf_" in ln and "Compiling" in ln or "spill" in ln]}
    if depths and hasattr(cs, "depth_runs"):
        found = {}
        for n in range(1, 9):   # the depths every tree since the trial tiles takes
            for mm in ("float32", "bfloat16"):
                for kernel, (ref, got, start) in cs.depth_runs(n, mm, dev).items():
                    errs, _ = cs.compare_errs(ref, got, start)
                    worst = max(errs, key=errs.get)
                    found[f"h{cs.DEPTH_WIDTH}x{n}.{kernel}[{mm}]"] = [errs[worst], worst]
        row["depths"] = found
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", help="NAME=TREE[:OPT]")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--depths", default="", help="trees whose depth readings to print")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--with-depths", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker), args.with_depths)
        return 0
    dests = []
    for spec in args.trees:
        name, _, rest = spec.partition("=")
        tree, _, opt = rest.partition(":")
        dests.append(prepare(name, (ROOT / tree).resolve(), int(opt) if opt else None))
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", "from vjf_tpu_torch.ops import _build; "
                                "_build.build()"], cwd=d) for d in dests]
    if any(p.wait() for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    print(json.dumps({"built": [d.name for d in dests],
                      "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    want_depths = set(filter(None, args.depths.split(",")))
    rows = {d.name: [] for d in dests}
    order = (dests + dests[::-1]) * args.rounds
    for i, d in enumerate(order):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(d)]
        if d.name in want_depths and not any("depths" in r for r in rows[d.name]):
            cmd.append("--with-depths")
        done = subprocess.run(cmd, cwd=d, capture_output=True, text=True, timeout=900)
        if done.returncode:
            print(done.stdout[-2000:], done.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(done.stdout.strip().splitlines()[-1])
        row["turn"] = i
        rows[d.name].append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    summary = {}
    for name, rs in rows.items():
        us = [u for r in rs for u in r["mega_us"]]
        summary[name] = {"mega_us_median": statistics.median(us), "mega_us_min": min(us),
                         "mega_us_max": max(us), "bits": rs[0]["bits"],
                         "local_bytes": rs[0]["local_bytes"], "registers": rs[0]["registers"]}
    print(json.dumps({"summary": summary, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
