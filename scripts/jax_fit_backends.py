"""``bench_all.py``'s Van der Pol fit (config #1) through the JAX package on
the CPU, with the regression backend, the dtype and the forgetting factor
chosen: the reference side of the port's
``scripts/torch_fit_quality.py van_der_pol --backend ...``.

    JAX_PLATFORMS=cpu python3 scripts/jax_fit_backends.py [--backend covariance]
        [--dtype float32|float64] [--rls-shrink 0.999] [--chol-jitter 0]
        [--lr 3e-3] [--rtol 2e-3] [--warmup-max 0] [--max-iter 60]

``--backend nsv --chol-jitter 1e-3 --lr 1e-3 --rtol 0 --warmup-max 15``
are ``examples/limit_cycle.py``'s knobs, which ``chip_smoke.py``'s
"facade.vdp" phase gives the port's ``VJF.make_model``.

Prints one JSON line: the fit's epochs, latent R^2 and the 20-step forecast
RMSE beside persistence (``bench_all.py:_fit_throughput``), and the final
weight posterior's largest |w|, the extreme eigenvalues of its covariance
(of P^-1 for the precision and nsv forms) and the state noise's log
variance. Takes seconds at float32 on a few cores.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="covariance")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--rls-shrink", type=float, default=0.999)
    ap.add_argument("--chol-jitter", type=float, default=0.0)
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rtol", type=float, default=2e-3)
    ap.add_argument("--warmup-max", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from bench_all import _fit_throughput
    from vjf_tpu.config import VJFConfig
    from vjf_tpu.datasets import van_der_pol
    from vjf_tpu.models import vjf as core

    # bench_all.py:bench_vdp's data and configuration
    x = van_der_pol(T=1200)
    x = (x - x.mean(0)) / x.std(0)
    rng = np.random.default_rng(1)
    y = x @ rng.normal(size=(2, 20)) + rng.normal(size=(20,)) + 0.1 * rng.normal(size=(1200, 20))
    cfg = VJFConfig(ydim=20, xdim=2, udim=0, n_rbf=100, hidden_sizes=(20,),
                    likelihood="gaussian", dtype=args.dtype, rls_backend=args.backend,
                    lr=args.lr, rtol=args.rtol, warmup_max=args.warmup_max,
                    rls_shrink=args.rls_shrink, chol_jitter=args.chol_jitter)
    key = jax.random.PRNGKey(0)
    out = _fit_throughput(cfg, y.astype(args.dtype), key, args.max_iter, core, jnp, x_true=x)
    # the final posterior: _fit_throughput's fit once more (the same key, bit for bit)
    res = core.fit(cfg, core.init_state(key, cfg), y.astype(args.dtype), key=key,
                   max_iter=args.max_iter, epochs_per_dispatch=5)
    blr = jax.tree.map(lambda a: np.asarray(a, np.float64), res.state.dynamics.blr)
    if hasattr(blr, "cov"):
        cov = blr.cov
    else:
        cov = blr.prec_chol_inv_t @ blr.prec_chol_inv_t.T
    ev = np.linalg.eigvalsh(0.5 * (cov + cov.T))
    print(json.dumps({"config": "van_der_pol_gaussian", "package": "vjf_tpu (CPU)",
                      "rls_backend": args.backend, "dtype": args.dtype,
                      "rls_shrink": args.rls_shrink, "chol_jitter": args.chol_jitter,
                      "lr": args.lr, "rtol": args.rtol, "warmup_max": args.warmup_max, **out,
                      "max_abs_w": float(np.abs(blr.w_mean).max()),
                      "cov_eig_min": float(ev[0]), "cov_eig_max": float(ev[-1]),
                      "state_logvar": float(res.state.dynamics.logvar)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
