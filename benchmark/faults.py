"""Faults planted in the program's timed path, to show that the check
catches them (``tests/test_bench_faults.py``, and on the card
``control.py``). Each patches a function of the port, as a module
attribute, for the duration of a ``with`` block; no file changes.

* ``unchanged``: every step returns its state unchanged (no SGD step, no
  closed-form update), its posterior still computed.
* ``sgd_off``: the SGD step alone left out, so the trained weights stay
  where they were; the closed-form updates still run.
* ``half_batch``: the second half of the trials left out, every mean taken
  over the first half (a trial mask).
* ``altered``: one answer altered where it is produced: the first trial's
  posterior mean left at zero, as if never written, at every step of the
  segment.

A fault across chips (the exchange left out) has no place in a one-chip
cell."""
from __future__ import annotations

import contextlib
import dataclasses

NAMES = ("unchanged", "sgd_off", "half_batch", "altered")


@contextlib.contextmanager
def planted(name: str):
    import torch

    import vjf_tpu_torch.ops.fused_step as fs

    attr = "mega_epoch_call" if name == "altered" else "run_epoch_fused"
    orig = getattr(fs, attr)
    if name == "unchanged":
        def fault(cfg, flags, *args, **kw):
            return orig(cfg, dataclasses.replace(flags, sgd=False, update=False), *args, **kw)
    elif name == "sgd_off":
        def fault(cfg, flags, *args, **kw):
            return orig(cfg, dataclasses.replace(flags, sgd=False), *args, **kw)
    elif name == "half_batch":
        def fault(cfg, flags, state, ys, *args, mask=None, **kw):
            mask = torch.ones(ys.shape[:2], dtype=ys.dtype, device=ys.device)
            mask[:, ys.shape[1] // 2:] = 0.0
            return orig(cfg, flags, state, ys, *args, mask=mask, **kw)
    elif name == "altered":
        def fault(*args, **kw):
            carry, q_pack, scal = orig(*args, **kw)
            q_pack[..., 0, 0, :] = 0.0
            return carry, q_pack, scal
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(fs, attr, fault)
    try:
        yield
    finally:
        setattr(fs, attr, orig)
