"""Multi-process training (counterpart of ``vjf_tpu/parallel``): the
exact-sync sharded fused epoch over a ``dp`` process group."""
from .mesh import make_dp_group
from .sharded import (
    make_sharded_epoch,
    make_sharded_epochs,
    run_epoch_fused_sharded,
    run_epochs_fused_sharded,
    shard_data,
    shard_state,
)

__all__ = [
    "make_dp_group",
    "make_sharded_epoch",
    "make_sharded_epochs",
    "run_epoch_fused_sharded",
    "run_epochs_fused_sharded",
    "shard_data",
    "shard_state",
]
