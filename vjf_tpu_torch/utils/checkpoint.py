"""Checkpoints and snapshots (counterpart of ``vjf_tpu/utils/checkpoint.py``).

The whole model (parameters, the RLS posterior, the noise estimates and
their counters) is one tree of NamedTuples and tensors, so a save and a
restore are exact and a resume is bit-identical. Every file here is ONE
``torch.save`` file written atomically: to ``<path>.tmp``, flushed,
``fsync``-ed, renamed over ``path`` with ``os.replace``, and the directory
``fsync``-ed, so a kill at any instant leaves the previous complete file or
the new one.

The tree is encoded into what ``torch.load(weights_only=True)`` accepts
(dicts, lists, tuples, str/int/float/bool/None and tensors), and decoded by
rebuilding only this package's NamedTuples, ``nn.Linear`` layers, the
``Recognition`` network and CPU ``torch.Generator`` states. Loading never
unpickles an arbitrary object, so a file from elsewhere cannot run code; it
can still hold any values, so resume only from files you trust to be what
they claim. Tensors are stored on the CPU in their own dtypes and restored
to the device the caller names; host scalars stay Python floats (float64).
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import warnings
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import VJFConfig
from ..models.recognition import Recognition, linear_from

_FORMAT = "vjf_tpu_torch/1"


class FitLoopState(NamedTuple):
    """Host-side fit-loop progress for the exact resume of a model: where
    the JAX package keeps a PRNG key, the port keeps a CPU generator."""

    epoch: int
    lr: float
    warm_up: bool
    running_loss: float
    generator: torch.Generator


def _encode(tree) -> Any:
    if isinstance(tree, torch.Tensor):
        # clone: a view would save its whole storage
        return tree.detach().to("cpu", copy=True).clone()
    if isinstance(tree, torch.Generator):
        return {"__generator__": tree.get_state()}
    if isinstance(tree, Recognition):
        return {"__recognition__": {"layers": [_encode(l) for l in tree.layers],
                                    "mean": _encode(tree.mean),
                                    "logvar": _encode(tree.logvar)}}
    if isinstance(tree, nn.Linear):
        return {"__linear__": [_encode(tree.weight),
                               None if tree.bias is None else _encode(tree.bias)]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return {"__namedtuple__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {k: _encode(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, dict):
        return {"__dict__": {k: _encode(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _namedtuple(name: str):
    module, _, qualname = name.partition(":")
    if not module.startswith("vjf_tpu_torch."):
        raise ValueError(f"checkpoint names a type outside vjf_tpu_torch: {name!r}")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    if not (isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")):
        raise ValueError(f"checkpoint names a type that is not a NamedTuple: {name!r}")
    return cls


def _decode(obj, device) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        if "__generator__" in obj:
            gen = torch.Generator()
            gen.set_state(obj["__generator__"])
            return gen
        if "__linear__" in obj:
            w, b = obj["__linear__"]
            return linear_from(w.to(device), None if b is None else b.to(device))
        if "__recognition__" in obj:
            r = obj["__recognition__"]
            return Recognition([_decode(l, device) for l in r["layers"]],
                               _decode(r["mean"], device), _decode(r["logvar"], device))
        if "__namedtuple__" in obj:
            cls = _namedtuple(obj["__namedtuple__"])
            return cls(**{k: _decode(v, device) for k, v in obj["fields"].items()})
        return {k: _decode(v, device) for k, v in obj["__dict__"].items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, device) for v in obj)
    return obj


def _atomic_save(payload: dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        # flush and fsync before the rename: os.replace alone is atomic
        # against a kill, but on power loss a filesystem may keep the rename
        # with truncated content
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # some filesystems refuse a directory fsync


def _load(path: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != _FORMAT:
        raise ValueError(f"{path!r} is not a vjf_tpu_torch checkpoint")
    return payload


def save_checkpoint(path: str, state, cfg: Optional[VJFConfig] = None,
                    loop: Optional[FitLoopState] = None) -> None:
    """Save a ``TrainState`` with, optionally, its config and fit-loop
    progress, to the one file ``path``."""
    _atomic_save({"format": _FORMAT, "kind": "checkpoint", "state": _encode(state),
                  "cfg": None if cfg is None else dataclasses.asdict(cfg),
                  "loop": None if loop is None else _encode(loop)}, path)


def load_checkpoint(path: str,
                    device=torch.device("cuda")) -> Tuple[Any, Optional[FitLoopState]]:
    """``(state, loop or None)`` from :func:`save_checkpoint`, the tensors on
    ``device`` (the card unless the caller asks for ``device="cpu"``). The
    file describes its own structure, so no template is needed."""
    payload = _load(path)
    loop = payload["loop"]
    return _decode(payload["state"], device), None if loop is None else _decode(loop, device)


def load_config(path: str) -> VJFConfig:
    """The config saved with a checkpoint. Fields this version does not know
    (a knob retired since the file was written) are dropped with a warning."""
    d = _load(path)["cfg"]
    if d is None:
        raise ValueError(f"{path!r} was saved without its config")
    d = dict(d)
    d["hidden_sizes"] = tuple(d["hidden_sizes"])
    fields = {f.name for f in dataclasses.fields(VJFConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        warnings.warn(f"checkpoint config carries retired/unknown fields {unknown}; "
                      "ignoring them")
        d = {k: v for k, v in d.items() if k in fields}
    return VJFConfig(**d)


def config_digest(cfg: VJFConfig) -> str:
    """A process-stable fingerprint of ``cfg`` (Python's ``hash`` is salted
    per process), stored in the fit and stream snapshots and checked on
    resume: the hex md5 of the same JSON the JAX package digests."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    return hashlib.md5(blob).hexdigest()


def save_snapshot(path: str, snapshot) -> None:
    """Persist a fit or stream snapshot (``models.vjf.FitSnapshot``,
    ``StreamSnapshot``) to the one file ``path``. Its optional fields vary
    from save to save (the selection tracker is None until it is not), so
    the structure travels in the file."""
    _atomic_save({"format": _FORMAT, "kind": "snapshot", "snapshot": _encode(snapshot)}, path)


def load_snapshot(path: str, device=torch.device("cuda")):
    """A snapshot from :func:`save_snapshot`, its tensors on ``device``."""
    payload = _load(path)
    if payload.get("kind") != "snapshot":
        raise ValueError(f"{path!r} is a model checkpoint, not a fit or stream snapshot")
    return _decode(payload["snapshot"], device)


def save_ensemble_checkpoint(path: str, snapshot) -> None:
    """Persist a ``parallel.ensemble.EnsembleSnapshot`` (the per-member fit
    state machine: the member states, the phase and plateau arrays, the
    learning rates, the member generators, the demotion and selection
    machinery) to the one file ``path``, for the exact resume of
    ``fit_ensemble``. Where the JAX package writes an ``.npz`` with a
    pickled treedef, this is the same one ``torch.save`` file as the fit
    snapshots, loaded with ``weights_only=True``."""
    _atomic_save({"format": _FORMAT, "kind": "ensemble", "snapshot": _encode(snapshot)}, path)


def load_ensemble_checkpoint(path: str, device=torch.device("cuda")):
    """An ensemble snapshot from :func:`save_ensemble_checkpoint`, its
    tensors on ``device``; the host state comes back as Python floats, ints
    and bools, so a resume continues bit for bit."""
    payload = _load(path)
    if payload.get("kind") != "ensemble":
        raise ValueError(f"{path!r} is not a fit_ensemble snapshot")
    return _decode(payload["snapshot"], device)
