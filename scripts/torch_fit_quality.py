"""Fit quality of the port on the card: ``bench_all.py``'s Van der Pol and
Lorenz configurations (its ``bench_vdp`` and ``bench_lorenz``) through
``vjf_tpu_torch``'s ``fit``.

    python3 scripts/torch_fit_quality.py [van_der_pol lorenz] [--max-iter N]

Each system is fitted as ``bench_all.py:_fit_throughput`` does it (blocks of
5 epochs, at most 60), then scored: latent R^2 against the generating
latents, and the 20-step forecast RMSE from 50 starts beside the
persistence baseline. Prints one JSON line per system with ``wall_s``,
``epochs_run``, ``steps_per_s``, ``final_loss``, ``latent_r2``,
``forecast_rmse``, ``persistence_rmse``, the dispatches (route, prefix,
seconds) and the card's name and power limit. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_fit_quality: no CUDA device", file=sys.stderr)
        return 1
    max_iter = 60
    if "--max-iter" in argv:
        max_iter = int(argv[argv.index("--max-iter") + 1])
        del argv[argv.index("--max-iter"):argv.index("--max-iter") + 2]
    names = argv or ["van_der_pol", "lorenz"]
    _build.load_library()
    smi = cs.smi_line()
    for name in names:
        cfg, y, x = cs.quality_problem(name)
        out = cs.fit_quality(cfg, y, x, torch.device("cuda:0"), max_iter)
        print(json.dumps({"config": name, "max_iter": max_iter, **out, "card": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
