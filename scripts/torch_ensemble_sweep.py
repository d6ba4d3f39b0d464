"""The seed-ensemble workload of ``examples/ensemble_sweep.py`` through the
port on the card: 4 members on shared data (a noisy limit cycle, T about
955, 8 trials, ydim 20, xdim 2), ``n_rbf`` 50, hidden (20,), Gaussian,
float32, the example's knobs (lr 3e-3, rtol 2e-3, ``warmup_max`` 30,
``rls_shrink`` 0.999, ``chol_jitter`` 1e-3), at most 60 epochs, through
``VJF.fit_ensemble``.

    python3 scripts/torch_ensemble_sweep.py [--members 4] [--max-iter 60]

The data are drawn with numpy (seed 0) the way the example draws its own
with JAX, so the numbers are this port's, not the example's. Prints one
JSON line per epoch as it ends (its seconds, the members' losses, the
dispatch's route: the member kernels on phase-uniform epochs, the gated
autograd epoch on phase-mixed ones), so that a run cut short still says
where its time went, then one result line: wall seconds, member-steps/s,
epochs by member, the time by route, each member's latent R^2 against the
limit cycle and its 20-step forecast RMSE beside persistence, and the
card's name and power limit. Fails if a member's forecast is not finite.
Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def limit_cycle(seed: int = 0, t_end: float = 60.0, dt: float = 2e-2 * math.pi, ydim: int = 20,
                obs_noise: float = 0.1, n_trials: int = 8):
    """The example's data: a noisy unit circle, an affine Gaussian readout
    to ``ydim`` channels, the same latents in every trial."""
    rng = np.random.default_rng(seed)
    t = np.arange(0, t_end, dt)
    x = np.stack([np.sin(t), np.cos(t)], axis=-1)
    x = x + obs_noise * rng.normal(size=x.shape)
    c, d = rng.normal(size=(2, ydim)), rng.normal(size=ydim)
    y = (x @ c + d)[:, None, :] + obs_noise * rng.normal(size=(t.shape[0], n_trials, ydim))
    return x, y.astype(np.float32)


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from vjf_tpu_torch import VJF
    from vjf_tpu_torch.ops import _build
    from vjf_tpu_torch.utils.evaluation import forecast_rmse, latent_r2

    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--max-iter", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ensemble_sweep: no CUDA device", file=sys.stderr)
        return 1
    _build.load_library(_build.build().path)
    x_true, y = limit_cycle()
    template = VJF.make_model(ydim=y.shape[-1], xdim=2, n_rbf=50, hidden_sizes=[20],
                              likelihood="gaussian", dtype="float32", lr=3e-3, rtol=2e-3,
                              warmup_max=30, rls_shrink=0.999, chol_jitter=1e-3)

    def progress(epoch, losses, res):
        e = log[-1]
        print(json.dumps({"epoch": epoch, "t": time.perf_counter() - t0,
                          "seconds": e["seconds"], "route": e["route"], "gated": e["gated"],
                          "losses": [float(v) for v in losses]}), flush=True)

    with cs.ensemble_dispatches() as log:
        t0 = time.perf_counter()
        result, members = template.fit_ensemble(y, n_models=args.members,
                                                max_iter=args.max_iter, seed=7,
                                                callback=progress)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = int(np.sum(result.epochs_run)) * y.shape[0]
    r2, skill = [], []
    for i, m in enumerate(members):
        r2.append(latent_r2(result.mu[i, :, 0, :], x_true))
        skill.append(forecast_rmse(m.cfg, m.state, result.mu[i, :, 0, :], y[:, 0], 100 + i,
                                   horizon=20))
    mrs = np.array([s[0] for s in skill])
    by_route = {}
    for e in log:
        r = by_route.setdefault(e["route"], {"dispatches": 0, "seconds": 0.0})
        r["dispatches"] += 1
        r["seconds"] += e["seconds"]
    print(json.dumps({
        "workload": "examples/ensemble_sweep.py: %d members, T %d, B %d, ydim %d, xdim 2, "
                    "n_rbf 50, hidden (20,), gaussian, float32" % (
                        args.members, y.shape[0], y.shape[1], y.shape[2]),
        "wall_s": wall, "member_steps_per_s": steps / wall,
        "epochs_run": result.epochs_run.tolist(), "warm_up": result.warm_up.tolist(),
        "routes": by_route, "gated_dispatches": sum(e["gated"] for e in log),
        "latent_r2": r2, "forecast_rmse": mrs.tolist(),
        "persistence_rmse": [s[1] for s in skill],
        "beat_persistence": int(np.sum(mrs < np.array([s[1] for s in skill]))),
        "card": cs.smi_line()}), flush=True)
    return 0 if np.all(np.isfinite(mrs)) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
