"""Fit quality of the port on the card: ``bench_all.py``'s Van der Pol,
Lorenz and sparse-GP ring-attractor configurations (its ``bench_vdp``,
``bench_lorenz`` and ``bench_sgp_ring``) through ``vjf_tpu_torch``'s ``fit``.

    python3 scripts/torch_fit_quality.py [van_der_pol lorenz sgp_ring] [--max-iter N]
        [--backend nsv|precision|covariance] [--dtype float32|float64]

``sgp_ring`` fits both of the reference's observation draws (1 and 7); at
B 1 its epochs take the autograd route (below ``sgp_fused_min_batch``), as
in the reference. ``--backend`` replaces the configurations' RLS backend
(``bench_all.py`` uses nsv with ``chol_jitter`` 1e-3); ``covariance`` also
sets ``chol_jitter`` to 0, which that backend cannot apply, and keeps
``rls_shrink`` 0.999. The precision and covariance backends train on the
autograd route. ``--dtype`` replaces the configurations' float32
(``scripts/jax_fit_backends.py`` runs the JAX package's side on the CPU).
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
    over = {}
    for flag, field in (("--backend", "rls_backend"), ("--dtype", "dtype")):
        if flag in argv:
            over[field] = argv[argv.index(flag) + 1]
            del argv[argv.index(flag):argv.index(flag) + 2]
    if over.get("rls_backend") == "covariance":
        over["chol_jitter"] = 0.0
    names = argv or ["van_der_pol", "lorenz", "sgp_ring"]
    _build.load_library()
    smi = cs.smi_line()
    for name in names:
        for draw in ((1, 7) if name == "sgp_ring" else (1,)):
            cfg, y, x = cs.quality_problem(name, draw)
            cfg = cfg.replace(**over)
            out = cs.fit_quality(cfg, y, x, torch.device("cuda:0"), max_iter)
            tag = {"obs_draw": draw} if name == "sgp_ring" else {}
            tag.update(rls_backend=cfg.rls_backend, dtype=cfg.dtype,
                       chol_jitter=cfg.chol_jitter, rls_shrink=cfg.rls_shrink)
            print(json.dumps({"config": name, **tag, "max_iter": max_iter, **out, "card": smi}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
