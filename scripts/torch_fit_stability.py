"""Stability of ``fit`` at the flagship width after the dynamics bootstrap.

    python3 scripts/torch_fit_stability.py [--max-iter N] [variant ...]

Runs the port's blocked ``fit`` (2 epochs a dispatch, warm-up forced to end
after 2 epochs) on ``chip_smoke.py``'s flagship data (B 256, T 2048, ydim
200, Bernoulli spikes) under each variant, with demotion switched off
(``demote_hot_frac=2``) so that every epoch runs on the fused kernels
whatever its tau statistics. Prints one JSON line per variant: each epoch's
prefix, mean loss, hot fraction (post-prefix steps whose update was
skipped), first hot step, max finite tau, the state noise log-variance and
the largest dynamics weight after it, and its seconds (host clock, device
synchronised), with the card's name and power limit. Needs one CUDA device
and nvcc.

The variants: the flagship as ``bench.py`` configures it (bf16 products,
no forgetting), the same without prefix-free continuation, with f32
products, with another data seed, and with ``bench_all.py``'s forgetting
(``rls_shrink`` 0.999, ``chol_jitter`` 1e-3).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORGET = dict(rls_shrink=0.999, chol_jitter=1e-3)
VARIANTS = {
    "bf16": dict(mm="bfloat16"),
    "bf16_prefix_free_off": dict(mm="bfloat16", ns_prefix_free="off"),
    "f32": dict(mm="float32"),
    "bf16_forgetting": dict(mm="bfloat16", **FORGET),
    "bf16_data_seed2": dict(mm="bfloat16", data_seed=2),
    "f32_data_seed2": dict(mm="float32", data_seed=2),
    "f32_forgetting": dict(mm="float32", **FORGET),
}


def epoch_stats(cfg, flags, res, secs: float) -> dict:
    import torch

    tau = None if res.metrics.tau is None else res.metrics.tau[cfg.ns_prefix:]
    finite = None if tau is None else torch.isfinite(tau)
    return {"warm_up": flags.warm_up, "ns_prefix": cfg.ns_prefix,
            "loss": float(res.metrics.loss.mean()),
            "hot_frac": None if tau is None else float((~finite).float().mean()),
            "first_hot": (None if tau is None or bool(finite.all())
                          else int(torch.nonzero(~finite)[0])),
            "max_tau": None if tau is None or not bool(finite.any()) else float(tau[finite].max()),
            "state_logvar": float(res.state.dynamics.logvar),
            "w_abs_max": float(res.state.dynamics.blr.w_mean.abs().max()), "seconds": secs}


def run_variant(name: str, max_iter: int, smi: str) -> dict:
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch.models import vjf as core

    v = dict(VARIANTS[name])
    mm, data_seed = v.pop("mm"), v.pop("data_seed", 1)
    cfg = cs.flagship(mm).replace(warmup_max=2, demote_hot_frac=2.0, **v)
    dev = torch.device("cuda:0")
    ys = cs.spikes(cs.T_EPOCH, cs.B, cfg.ydim, dev, seed=data_seed)
    log = []
    real = core.run_epoch

    def run_epoch(c, flags, state, *args, **kw):
        res, secs = cs.synced(lambda: real(c, flags, state, *args, **kw))
        log.append(epoch_stats(c, flags, res, secs))
        return res

    core.run_epoch = run_epoch
    try:
        res, wall = cs.synced(lambda: core.fit(cfg, core.init_state(0, cfg, device=dev), ys,
                                               seed=7, max_iter=max_iter, epochs_per_dispatch=2))
    finally:
        core.run_epoch = real
    return {"variant": name, "loss": res.loss, "epochs_run": res.epochs_run, "wall_s": wall,
            "epochs": log, "card": smi}


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_fit_stability: no CUDA device", file=sys.stderr)
        return 1
    max_iter = 12
    if "--max-iter" in argv:
        i = argv.index("--max-iter")
        max_iter = int(argv[i + 1])
        del argv[i:i + 2]
    _build.load_library()
    smi = cs.smi_line()
    for name in argv or list(VARIANTS):
        print(json.dumps(run_variant(name, max_iter, smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
