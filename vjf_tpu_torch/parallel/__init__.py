"""Multi-model and multi-process training (counterpart of
``vjf_tpu/parallel``): ensembles of independent members trained in one
launch stream (``fit_ensemble``, its members spread over ranks by
``shard_ensemble``), and over a ``dp`` x ``tp`` mesh (``make_mesh``; a bare
``dp`` process group is a mesh of one axis) the exact-sync sharded epoch on
either route (``make_sharded_epoch``: the fused route over ``dp``, the
autograd route over ``dp`` and ``tp``) and the relaxed-sync epoch
(``run_epoch_sync_every``)."""
from .ensemble import EnsembleFitResult, EnsembleSnapshot, fit_ensemble, forecast_ensemble
from .mesh import Mesh, make_dp_group, make_mesh
from .replicated import init_ensemble, run_epoch_ensemble, shard_ensemble
from .sharded import (
    channel_rows,
    gather_rows,
    make_sharded_epoch,
    make_sharded_epochs,
    run_epoch_autograd_sharded,
    run_epoch_fused_sharded,
    run_epoch_sync_every,
    run_epochs_autograd_sharded,
    run_epochs_fused_sharded,
    shard_data,
    shard_state,
    shard_trials,
)

__all__ = [
    "EnsembleFitResult",
    "EnsembleSnapshot",
    "fit_ensemble",
    "forecast_ensemble",
    "init_ensemble",
    "run_epoch_ensemble",
    "shard_ensemble",
    "Mesh",
    "channel_rows",
    "gather_rows",
    "make_dp_group",
    "make_mesh",
    "make_sharded_epoch",
    "make_sharded_epochs",
    "run_epoch_autograd_sharded",
    "run_epoch_fused_sharded",
    "run_epoch_sync_every",
    "run_epochs_autograd_sharded",
    "run_epochs_fused_sharded",
    "shard_data",
    "shard_state",
    "shard_trials",
]
