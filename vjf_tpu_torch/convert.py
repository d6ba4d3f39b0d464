"""Carry weights and state across from the JAX package and back.

:func:`state_from_numpy` takes the JAX ``TrainState`` after
``jax.tree.map(np.asarray, state)`` and reads it by attribute, so this module
imports neither ``jax`` nor ``vjf_tpu``. :func:`state_to_numpy` returns the
port's state as nested dicts under the JAX package's field names;
:func:`flatten` turns either side into ``{"a.b.0.c": array}`` for a
leaf-by-leaf comparison. Both directions carry the RBF dynamics and the
sparse-GP dynamics (``cfg.dynamics='sgp'``), with the weight posterior of
any of the three RLS backends.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import VJFConfig
from .gp.sgp import SGPDynamicsState
from .models.dynamics import DynamicsState
from .models.likelihoods import GaussianLikParams, PoissonLikParams
from .models.rbf import RBFParams
from .models.recognition import Recognition, linear_from
from .models.regression import CovarianceBLR, NSVBLR, PrecisionBLR
from .models.vjf import Params, PriorParams, TrainState


def _t(a, device, dtype=None) -> torch.Tensor:
    # copy: a tensor sharing memory with the caller's array would let the
    # port's updates write through into it
    return torch.tensor(np.array(a, copy=True), dtype=dtype, device=device)


def _blr_type(blr):
    """The port's posterior type of a JAX one, told apart by its fields."""
    if hasattr(blr, "prec_chol_inv_t"):
        return PrecisionBLR
    return NSVBLR if hasattr(blr, "precision") else CovarianceBLR


def state_from_numpy(cfg: VJFConfig, tree, device=torch.device("cuda")) -> TrainState:
    """The port's ``TrainState`` on ``device`` (the card unless the caller
    asks for ``device="cpu"``) from a numpy-leaved JAX one."""
    p = tree.params
    rec = p.recognition
    recognition = Recognition(
        [linear_from(_t(l.w, device), _t(l.b, device)) for l in rec.layers],
        mean=linear_from(_t(rec.mean.w, device)),
        logvar=linear_from(_t(rec.logvar.w, device), _t(rec.logvar.b, device)),
    )
    if cfg.likelihood == "gaussian":
        lik = GaussianLikParams(logvar=_t(p.likelihood.logvar, device))
    else:
        lik = PoissonLikParams()
    d = tree.dynamics
    kind = _blr_type(d.blr)
    blr = kind(*(_t(getattr(d.blr, f), device) for f in kind._fields))
    noise = dict(logvar=_t(d.logvar, device), n_sample=_t(d.n_sample, device, torch.int32))
    if cfg.dynamics == "sgp":
        dynamics = SGPDynamicsState(
            inducing=_t(d.inducing, device), whiten=_t(d.whiten, device),
            whiten_inv=_t(d.whiten_inv, device), log_scale=_t(d.log_scale, device),
            log_lengthscale=_t(d.log_lengthscale, device), blr=blr, **noise)
    else:
        dynamics = DynamicsState(
            rbf=RBFParams(_t(d.rbf.centroid, device), _t(d.rbf.logwidth, device)),
            blr=blr, **noise)
    return TrainState(
        params=Params(
            recognition=recognition,
            decoder=linear_from(_t(p.decoder.w, device), _t(p.decoder.b, device)),
            likelihood=lik,
            prior=PriorParams(_t(p.prior.mean, device), _t(p.prior.logvar, device)),
        ),
        dynamics=dynamics,
        lik_n_sample=_t(tree.lik_n_sample, device),
    )


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _linear(lin) -> Dict[str, Any]:
    return {"w": _np(lin.weight), "b": None if lin.bias is None else _np(lin.bias)}


def _dynamics(d) -> Dict[str, Any]:
    """The dynamics state under the JAX field names, in the JAX field order."""
    blr = {k: _np(v) for k, v in d.blr._asdict().items()}
    if isinstance(d, SGPDynamicsState):
        head = {k: _np(getattr(d, k)) for k in ("inducing", "whiten", "whiten_inv",
                                                 "log_scale", "log_lengthscale")}
    else:
        head = {"rbf": {"centroid": _np(d.rbf.centroid), "logwidth": _np(d.rbf.logwidth)}}
    return {**head, "blr": blr, "logvar": _np(d.logvar), "n_sample": _np(d.n_sample)}


def state_to_numpy(state: TrainState) -> Dict[str, Any]:
    """The port's state as nested dicts of numpy arrays, keyed by the JAX
    package's field names (``params.recognition.layers[i].w`` ...)."""
    p = state.params
    rec = p.recognition
    lik = p.likelihood
    d = state.dynamics
    return {
        "params": {
            "recognition": {
                "layers": [_linear(l) for l in rec.layers],
                "mean": _linear(rec.mean),
                "logvar": _linear(rec.logvar),
            },
            "decoder": _linear(p.decoder),
            "likelihood": ({"logvar": _np(lik.logvar)}
                           if isinstance(lik, GaussianLikParams) else {"empty": None}),
            "prior": {"mean": _np(p.prior.mean), "logvar": _np(p.prior.logvar)},
        },
        "dynamics": _dynamics(d),
        "lik_n_sample": _np(state.lik_n_sample),
    }


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"params.recognition.layers.0.w": leaf, ...}`` from nested dicts,
    lists, or NamedTuples (the JAX side); ``None`` leaves are dropped."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def ensemble_from_numpy(cfg: VJFConfig, tree, device=torch.device("cuda")) -> list:
    """The port's ensemble, a list of ``TrainState``s, from a JAX ensemble
    state stacked on a leading member axis (``init_ensemble``'s, after
    ``jax.tree.map(np.asarray, states)``): member m is every leaf's row m."""
    n = len(tree.lik_n_sample)
    return [state_from_numpy(cfg, _member(tree, m), device) for m in range(n)]


def ensemble_to_numpy(states) -> Dict[str, Any]:
    """The port's ensemble as one tree of numpy arrays stacked on a leading
    member axis, under the JAX package's field names (:func:`state_to_numpy`
    of every member, leaf by leaf)."""
    return _stack([state_to_numpy(st) for st in states])


def _member(tree, m: int):
    """Row ``m`` of every leaf of a NamedTuple tree of stacked arrays."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_member(v, m) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_member(v, m) for v in tree)
    return None if tree is None else np.asarray(tree)[m]


def _stack(trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        return [_stack([t[i] for t in trees]) for i in range(len(t0))]
    return None if t0 is None else np.stack(trees)
