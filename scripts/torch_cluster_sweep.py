"""Time the port's fused kernels at several thread-block cluster sizes.

    python3 scripts/torch_cluster_sweep.py [4 8 16]

The cluster size is a compile-time constant of
``vjf_tpu_torch/csrc/fused_step.cu`` (``VJF_CLUSTER``, set through the
environment variable of the same name), so each size is its own build and
its own process: the builds run side by side, then the timings one after
the other on the one card. Each process brings the flagship state of
``chip_smoke.py`` past a 256-step warm-up and the 512-step exact prefix
(through the kernels), then times the per-step kernel, a 64-step mega
segment and the phase-1 kernel with CUDA events, as ``chip_smoke.py`` does.
A size whose blocks need more shared memory than the card gives one block is
reported as refused. Prints one JSON line per size, the card's name and power limit in each.
Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def one() -> None:
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch.config import StepFlags
    from vjf_tpu_torch.models import vjf as core
    from vjf_tpu_torch.ops import _build
    from vjf_tpu_torch.ops import fused_step as F

    info = _build.build()
    if "--build-only" in sys.argv:
        return
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
    carry_s, carry_m = cs.clone(carry), cs.clone(carry)

    def k_step():
        F.fused_step_call(cfg, flags, carry_s, qm, qlv, ys[lo], None, eps[0, lo], eps[1, lo], lr)

    def k_mega():
        return F.mega_epoch_call(cfg, flags, carry_m, qm, qlv, ys[lo:], None, eps[0, lo:],
                                 eps[1, lo:], lr)

    def k_sums():
        F.forward_sums_call(cfg, flags, carry, qm, qlv, ys[lo], None, eps[0, lo], eps[1, lo],
                            1.0 / b)

    step_us = 1e3 * (cs.cuda_ms(k_step, 20) + cs.cuda_ms(k_step, 20)) / 2
    mega_us = 1e3 * (cs.cuda_ms(k_mega, 3) + cs.cuda_ms(k_mega, 3)) / 2 / cs.MEGA_STEPS
    sums_us = 1e3 * (cs.cuda_ms(k_sums, 20) + cs.cuda_ms(k_sums, 20)) / 2
    _, _, scal = F.mega_epoch_call(cfg, flags, cs.clone(carry), qm, qlv, ys[lo:], None,
                                   eps[0, lo:], eps[1, lo:], lr)
    launch = F.cluster_info(cfg, flags, carry, qm, qlv, ys[lo:], None, lr)
    print(json.dumps({"cluster": launch, "build_s": round(info.seconds, 1),
                      "us_per_timestep": {"fused_step": step_us, "mega_epoch": mega_us,
                                          "forward_sums": sums_us},
                      "mega_mean_loss": float(scal[:, 0].mean()),
                      "mega_max_tau": float(scal[:, 4].max()), "card": cs.smi_line()}),
          flush=True)


def main() -> int:
    if os.environ.get("VJF_CLUSTER_SWEEP_CHILD"):
        try:
            one()
        except ValueError as e:   # a size whose blocks do not fit the card's shared memory
            print(json.dumps({"cluster": int(os.environ["VJF_CLUSTER"]), "refused": str(e)}),
                  flush=True)
        return 0
    sizes = [int(a) for a in sys.argv[1:]] or [4, 8, 16]

    def child(size, *args):
        env = dict(os.environ, VJF_CLUSTER=str(size), VJF_CLUSTER_SWEEP_CHILD="1")
        return subprocess.Popen([sys.executable, __file__, *args], env=env, cwd=ROOT)

    builds = [child(s, "--build-only") for s in sizes]
    if any(p.wait() != 0 for p in builds):
        return 1
    return max(child(s).wait() for s in sizes)


if __name__ == "__main__":
    sys.exit(main())
