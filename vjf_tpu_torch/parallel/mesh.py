"""The ``dp`` process group (counterpart of ``vjf_tpu/parallel/mesh.py``).

JAX lays devices out on named mesh axes and lets SPMD insert the
collectives. Here each rank is a process and every collective is explicit
(``parallel.sharded``: the exact-sync step's all-reduce of the flat
``FusedSums`` buffer, the relaxed-sync merge, the gathers). The ``dp`` axis
is a plain ``torch.distributed`` process group rather than a
``DeviceMesh``: the port has one axis, and a group is what the collectives
take. It is what every entry point's ``mesh=`` names. The ``tp`` axis
(channel sharding) is not ported (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import torch.distributed as dist


def make_dp_group() -> dist.ProcessGroup:
    """The process group whose ranks split the trials: every rank of the
    default group. The caller starts ``torch.distributed`` first, naming its
    address, rank and world size (``init_process_group(backend,
    init_method="tcp://localhost:<port>", rank=r, world_size=n)``); without
    it this raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call init_process_group(backend, "
            "init_method=..., rank=..., world_size=...) before make_dp_group"
        )
    return dist.group.WORLD
