"""Host time against device time of single launches of the port's kernels.

    python3 scripts/torch_launch_probe.py

At the flagship shape of ``chip_smoke.py`` (B 256, a fresh state, given
noise), for the per-step kernel, the phase-1 kernel, a mega launch of one
step and one of 64: the host's time to enqueue a call (the wrapper checks
its operands, fills the argument struct, allocates outputs and workspace),
the wall time per call with the queue drained at the end, and the kernel's
own time on the device under ``torch.profiler``. Where the host time is the
larger, CUDA-event times of that launch measure the host. Prints one JSON
line per case, the card's name and power limit in each. Needs one CUDA
device and nvcc.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from vjf_tpu_torch.config import StepFlags
    from vjf_tpu_torch.models import vjf as core
    from vjf_tpu_torch.ops import fused_step as F

    dev = torch.device("cuda:0")
    cfg, flags, b = cs.flagship(), StepFlags(), cs.B
    ys = cs.spikes(cs.MEGA_STEPS, b, cfg.ydim, dev, seed=1)
    lr = torch.tensor(cfg.lr, device=dev)
    state = core.init_state(0, cfg, device=dev)
    carry = F.pad_carry(cfg, state)
    q0 = core.prior(state.params, b)
    qm, qlv = q0.mean.contiguous(), q0.logvar.contiguous()
    eps = torch.randn((2, cs.MEGA_STEPS, b, cfg.xdim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    cases = {
        "fused_step": (100, 1, lambda: F.fused_step_call(
            cfg, flags, carry, qm, qlv, ys[0], None, eps[0, 0], eps[1, 0], lr)),
        "forward_sums": (100, 1, lambda: F.forward_sums_call(
            cfg, flags, carry, qm, qlv, ys[0], None, eps[0, 0], eps[1, 0], 1.0 / b)),
        "mega_epoch, 1 step": (100, 1, lambda: F.mega_epoch_call(
            cfg, flags, carry, qm, qlv, ys[:1], None, eps[0, :1], eps[1, :1], lr)),
        "mega_epoch, 64 steps": (5, cs.MEGA_STEPS, lambda: F.mega_epoch_call(
            cfg, flags, carry, qm, qlv, ys, None, eps[0], eps[1], lr)),
    }
    smi = cs.smi_line()
    for name, (calls, steps, fn) in cases.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and "vjf_" in e.key)
        print(json.dumps({"launch": name, "calls": calls, "steps_per_call": steps,
                          "host_enqueue_us_per_call": 1e6 * (t1 - t0) / calls,
                          "wall_us_per_call": 1e6 * (t2 - t0) / calls,
                          "kernel_us_per_call": device_us / calls,
                          "kernel_us_per_step": device_us / calls / steps, "card": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
