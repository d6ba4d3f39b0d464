"""Metrics stream, progress reporting and profiling hooks (counterpart of
``vjf_tpu/utils/metrics.py``).

The step already returns its metrics per step; these are host-side
consumers of them: a progress callback for ``fit`` (tqdm where it is
installed), a JSONL writer, a ``torch.profiler`` trace scope and a
steps-per-second meter that waits for the card before it reads the clock.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import torch


def _last(x) -> float:
    return float(torch.as_tensor(x).reshape(-1)[-1])


def _mean(x) -> float:
    return float(torch.mean(torch.as_tensor(x, dtype=torch.float64)))


def progress_callback(verbose: bool = True, total: Optional[int] = None) -> Callable:
    """Epoch-granular progress reporter for ``models.vjf.fit``."""
    bar = None
    if verbose:
        try:
            from tqdm import tqdm

            bar = tqdm(total=total, desc="fit")
        except ImportError:
            bar = None

    def cb(epoch: int, epoch_loss: float, result) -> None:
        if bar is not None:
            m = result.metrics
            bar.update(1)
            bar.set_postfix({"Loss": f"{epoch_loss:.4f}", "Recon": f"{_last(m.recon):.4f}",
                             "Dynamics": f"{_last(m.dynamics):.4f}",
                             "Entropy": f"{_last(m.entropy):.4f}"})
        elif verbose:
            print(f"epoch {epoch}: loss={epoch_loss:.6f}")

    return cb


class MetricsWriter:
    """Append-only JSONL metrics log (one line per epoch)."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()

    def __call__(self, epoch: int, epoch_loss: float, result) -> None:
        m = result.metrics
        rec = {"epoch": epoch, "t": round(time.time() - self._t0, 3),
               "loss": float(epoch_loss), "recon": _mean(m.recon),
               "dynamics": _mean(m.dynamics), "entropy": _mean(m.entropy)}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def multiplex(*callbacks: Callable) -> Callable:
    def cb(epoch, loss, result):
        for c in callbacks:
            c(epoch, loss, result)

    return cb


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` scope (host and, where there is one, the card)
    that writes ``trace.json`` (Chrome trace format) into ``logdir``; a
    no-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock steps-per-second meter. It synchronises the card before
    each reading of the clock, so the time covers the work enqueued, not
    the enqueueing."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        _sync()
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n_steps: int, sync_scalar=None):
        if sync_scalar is not None:
            float(torch.as_tensor(sync_scalar).reshape(-1)[-1])
        self.steps += n_steps

    @property
    def steps_per_sec(self) -> float:
        _sync()
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("nan")
