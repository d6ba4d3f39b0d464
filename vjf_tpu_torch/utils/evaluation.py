"""Quality metrics of a fit (counterpart of ``vjf_tpu/utils/evaluation.py``).

* :func:`latent_r2`: affine-aligned R^2 of inferred latents against the
  synthetic truth (latents are identified only up to an affine map).
* :func:`forecast_rmse`: k-step forecast error in observation space from
  evenly spaced starts along the posterior, with a fresh weight sample per
  step and no state noise, beside the persistence baseline
  ``y[t+k] := y[t]``. Poisson models compare on the count scale.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def latent_r2(mu, x_true) -> float:
    """Affine-aligned R^2 between inferred latents (T, xdim) and the truth."""
    m = np.asarray(torch.as_tensor(mu).detach().cpu(), dtype=np.float64)
    x_true = np.asarray(x_true, dtype=np.float64)
    big_x = np.concatenate([m, np.ones((m.shape[0], 1))], axis=1)
    a, *_ = np.linalg.lstsq(big_x, x_true, rcond=None)
    pred = big_x @ a
    return float(1.0 - np.sum((pred - x_true) ** 2) / np.sum((x_true - x_true.mean(0)) ** 2))


def forecast_rmse(cfg, state, mu, y, seed: Union[int, torch.Generator], horizon: int = 20,
                  n_starts: int = 50, u=None) -> Tuple[float, float]:
    """k-step forecast RMSE against the persistence baseline, averaged over
    ``n_starts`` evenly spaced starts and the whole ``horizon``.

    :param mu: (T, xdim) posterior means of the fit (the starts)
    :param y: (T, ydim) observations
    :param u: optional (T, udim) controls; ``u[t]`` drives the step into x[t]
    :return: (model RMSE, persistence RMSE)
    """
    from ..models import vjf as core

    dev = state.dynamics.blr.w_mean.device
    mu = torch.as_tensor(mu).to(device=dev, dtype=cfg.tdtype)
    y = np.asarray(torch.as_tensor(y).detach().cpu())
    t_len = y.shape[0]
    if t_len < horizon + 2:
        raise ValueError(f"forecast_rmse needs T >= horizon + 2 (got T={t_len}, "
                         f"horizon={horizon}); shorten the horizon or supply more data")
    starts = np.linspace(0, t_len - horizon - 2, n_starts).astype(int)
    x0 = mu[torch.as_tensor(starts, device=dev)]
    uw: Optional[torch.Tensor] = None
    if u is not None:
        u = np.asarray(torch.as_tensor(u).detach().cpu())
        uw = torch.as_tensor(np.stack([u[s + 1:s + 1 + horizon] for s in starts], axis=1),
                             dtype=cfg.tdtype, device=dev)
    _, yf = core.forecast(cfg, state, x0, seed, n_step=horizon, u=uw, noise=False)
    yf = yf[1:].detach().cpu().numpy()
    if cfg.likelihood == "poisson":
        yf = np.exp(np.minimum(yf, cfg.poisson_clamp))
    err_model = err_pers = 0.0
    for j, s in enumerate(starts):
        future = y[s + 1:s + 1 + horizon]
        err_model += np.mean((yf[:, j, :] - future) ** 2)
        err_pers += np.mean((y[s][None, :] - future) ** 2)
    return (float(np.sqrt(err_model / len(starts))),
            float(np.sqrt(err_pers / len(starts))))
