"""The program's training state as the reference reads it: a plain dict of
tensors in the reference's layout (``reference/plain.py``), read from the
attributes of the port's ``TrainState``, and a digest of it."""
from __future__ import annotations

import hashlib

import torch


def as_dict(state) -> dict:
    """``state`` (a ``vjf_tpu_torch`` ``TrainState``) as a dict of tensors,
    copies that nothing the program does later can change."""
    p, d = state.params, state.dynamics
    rec = p.recognition
    out = {
        "w_layers": [layer.weight.detach() for layer in rec.layers],
        "b_layers": [layer.bias.detach() for layer in rec.layers],
        "w_mean": rec.mean.weight.detach(),
        "w_logvar": rec.logvar.weight.detach(),
        "b_logvar": rec.logvar.bias.detach().reshape(1, -1),
        "w_dec": p.decoder.weight.detach(),
        "b_dec": p.decoder.bias.detach().reshape(1, -1),
        "lik_logvar": getattr(p.likelihood, "logvar", torch.zeros((), device=d.logvar.device)),
        "lik_n": state.lik_n_sample,
        "w_dyn": d.blr.w_mean, "precision": d.blr.precision, "cov": d.blr.cov,
        "state_logvar": d.logvar, "dyn_n": d.n_sample,
    }
    if hasattr(d, "inducing"):
        out.update(centroid=d.inducing, whiten=d.whiten, log_scale=d.log_scale,
                   log_lengthscale=d.log_lengthscale)
    else:
        out.update(centroid=d.rbf.centroid, logwidth=d.rbf.logwidth)
    return {k: ([t.detach().float().clone() for t in v] if isinstance(v, list)
                else v.detach().float().clone()) for k, v in out.items()}


def digest(state) -> str:
    """A hash of every byte of every tensor of ``state``, in a fixed order."""
    h = hashlib.sha256()
    for k, v in sorted(as_dict(state).items()):
        for t in (v if isinstance(v, list) else [v]):
            h.update(k.encode())
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]
