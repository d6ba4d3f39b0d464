"""Cholesky-form Kalman toolkit (counterpart of ``vjf_tpu/ops/kalman.py``):
the time update, the standard measurement update and the Joseph-form one.

The framework applies it in weight space (``models.regression.kalman``'s
parity route): the "state" is the regression weight matrix, H the feature
matrix. Covariances are carried as lower Cholesky factors; the Joseph form
assumes a diagonal R. Each ``safe_cholesky`` decides its repair on the host
(one sync a call).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .linalg import cho_solve, safe_cholesky, tril_solve


def predict(x: torch.Tensor, chol_v: torch.Tensor, a: torch.Tensor, q: torch.Tensor,
            h: torch.Tensor, cholesky: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time update ``x' = A x``, ``V' = A V A^T + Q``: ``(yhat, xhat,
    chol_vhat)``. ``chol_v`` is the lower factor of V, or V itself with
    ``cholesky=False`` (and then ``V'`` itself is returned)."""
    xhat = a @ x
    chol = chol_v if cholesky else safe_cholesky(chol_v)
    al = a @ chol
    vhat = al @ al.T + q
    yhat = h @ xhat
    return yhat, xhat, safe_cholesky(vhat) if cholesky else vhat


def update(y: torch.Tensor, yhat: torch.Tensor, xhat: torch.Tensor, chol_vhat: torch.Tensor,
           h: torch.Tensor, r: torch.Tensor, cholesky: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard innovation update ``V = Vhat - G G^T``; the subtraction can
    lose definiteness, prefer :func:`joseph_update`."""
    e = y - yhat
    lhat = chol_vhat if cholesky else safe_cholesky(chol_vhat)
    vhat = lhat @ lhat.T
    hl = h @ lhat
    ls = safe_cholesky(hl @ hl.T + r)
    g = tril_solve(ls, h @ vhat).T           # G G^T = K S K^T
    x = xhat + g @ tril_solve(ls, e)
    v = vhat - g @ g.T
    return x, safe_cholesky(v) if cholesky else v


def joseph_update(y: torch.Tensor, yhat: torch.Tensor, xhat: torch.Tensor,
                  chol_vhat: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                  cholesky: bool = True, quirk: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joseph-form update ``V = (I - K H) Vhat (I - K H)^T + K R K^T`` with
    ``K = Vhat H^T S^{-1}`` from one Cholesky solve (``sqrt(R)`` elementwise:
    R diagonal). ``quirk=True`` is the reference's double-``S^{-1}`` gain:
    ``K S^{-1}`` applied to the innovation, to H in the sandwich and to
    ``sqrt(R)``."""
    e = y - yhat
    lhat = chol_vhat if cholesky else safe_cholesky(chol_vhat)
    vhat = lhat @ lhat.T
    hl = h @ lhat
    ls = safe_cholesky(hl @ hl.T + r)
    g = cho_solve(ls, h @ vhat).T            # K = Vhat H^T S^{-1}
    eye = torch.eye(vhat.shape[0], dtype=vhat.dtype, device=vhat.device)
    if quirk:
        x = xhat + g @ cho_solve(ls, e)
        i_kh = eye - g @ cho_solve(ls, h)
        kr = g @ cho_solve(ls, torch.sqrt(r))
    else:
        x = xhat + g @ e
        i_kh = eye - g @ h
        kr = g @ torch.sqrt(r)
    i_kh_l = i_kh @ lhat
    v = i_kh_l @ i_kh_l.T + kr @ kr.T
    return x, safe_cholesky(v) if cholesky else v
