"""Utilities of the port (counterpart of ``vjf_tpu/utils``): checkpoints
and snapshots, metrics, debugging, ragged trials and evaluation."""
from . import checkpoint, debugging, metrics, ragged
from .checkpoint import (
    FitLoopState,
    load_checkpoint,
    load_config,
    load_ensemble_checkpoint,
    save_checkpoint,
    save_ensemble_checkpoint,
)
from .debugging import assert_all_finite, enable_nan_debugging
from .metrics import MetricsWriter, StepTimer, multiplex, profiler_trace, progress_callback
from .ragged import PaddedTrials, pad_trials, split_trials

__all__ = [
    "checkpoint",
    "debugging",
    "metrics",
    "ragged",
    "PaddedTrials",
    "pad_trials",
    "split_trials",
    "FitLoopState",
    "save_checkpoint",
    "load_checkpoint",
    "load_config",
    "save_ensemble_checkpoint",
    "load_ensemble_checkpoint",
    "MetricsWriter",
    "StepTimer",
    "multiplex",
    "profiler_trace",
    "progress_callback",
    "assert_all_finite",
    "enable_nan_debugging",
]
