"""Multi-model and multi-process training (counterpart of
``vjf_tpu/parallel``): ensembles of independent members trained in one
launch stream (``fit_ensemble``, its members spread over ranks by
``shard_ensemble``), and over a ``dp`` process group the exact-sync sharded
fused epoch and the relaxed-sync epoch (``run_epoch_sync_every``)."""
from .ensemble import EnsembleFitResult, EnsembleSnapshot, fit_ensemble, forecast_ensemble
from .mesh import make_dp_group
from .replicated import init_ensemble, run_epoch_ensemble, shard_ensemble
from .sharded import (
    gather_rows,
    make_sharded_epoch,
    make_sharded_epochs,
    run_epoch_fused_sharded,
    run_epoch_sync_every,
    run_epochs_fused_sharded,
    shard_data,
    shard_state,
)

__all__ = [
    "EnsembleFitResult",
    "EnsembleSnapshot",
    "fit_ensemble",
    "forecast_ensemble",
    "init_ensemble",
    "run_epoch_ensemble",
    "shard_ensemble",
    "gather_rows",
    "make_dp_group",
    "make_sharded_epoch",
    "make_sharded_epochs",
    "run_epoch_fused_sharded",
    "run_epoch_sync_every",
    "run_epochs_fused_sharded",
    "shard_data",
    "shard_state",
]
