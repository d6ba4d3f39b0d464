"""The process groups of training over several cards (counterpart of
``vjf_tpu/parallel/mesh.py``).

JAX lays devices out on named mesh axes and lets SPMD insert the
collectives. Here each rank is a process and every collective is explicit
(``parallel.sharded``). The axes are the algorithm's own:

* ``dp``, trials: every step couples the trials only through its batch
  sums, one all-reduce of them a step;
* ``tp``, observation channels: the decoder rows, the likelihood and the
  recognition network's input product split over channels (the autograd
  epoch over ranks; the fused route keeps whole channels on every rank and
  names ``dp`` alone, as the JAX package's ``shard_map`` does).

:func:`make_mesh` lays the ranks of the default group out as JAX's
``make_mesh`` lays devices out: rank ``r`` sits at ``(r // tp, r % tp)``,
with ``tp = 2`` when the world size is even and above 1, else every rank
on ``dp``. A bare ``dp`` process group (:func:`make_dp_group`) is a mesh
of one axis. Every entry point's ``mesh=`` takes either.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist


class Mesh(NamedTuple):
    """This rank's view of a ``dp`` x ``tp`` layout: the group of its ``dp``
    axis (the ranks with its ``tp`` index), the group of its ``tp`` axis
    (None without one), the group of the whole mesh, its coordinates and
    the mesh's shape."""

    dp: dist.ProcessGroup
    tp: Optional[dist.ProcessGroup]
    everyone: dist.ProcessGroup
    coords: Tuple[int, int]       # (dp index, tp index)
    shape: Tuple[int, int]        # (dp size, tp size)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def _initialised(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call init_process_group(backend, "
            f"init_method=..., rank=..., world_size=...) before {what}"
        )


def make_dp_group() -> dist.ProcessGroup:
    """The process group whose ranks split the trials: every rank of the
    default group. The caller starts ``torch.distributed`` first, naming its
    address, rank and world size (``init_process_group(backend,
    init_method="tcp://localhost:<port>", rank=r, world_size=n)``); without
    it this raises."""
    _initialised("make_dp_group")
    return dist.group.WORLD


def mesh_shape(n: int, axis_names: Tuple[str, ...] = ("dp", "tp"),
               shape: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """``(dp, tp)`` of :func:`make_mesh` over ``n`` ranks; rank ``r`` sits
    at ``divmod(r, tp)``."""
    if shape is None:
        tp = 2 if len(axis_names) > 1 and n % 2 == 0 and n > 1 else 1
        shape = (n // tp, tp)
    shape = tuple(int(s) for s in shape) + (1,) * (2 - len(shape))
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not lay out {n} ranks as (dp, tp)")
    return shape


def make_mesh(axis_names: Tuple[str, ...] = ("dp", "tp"),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A ``dp`` x ``tp`` :class:`Mesh` over every rank of the default group.

    Default layout, as the JAX package's: ``tp = 2`` when the world size is
    even and above 1 (so ``dp = n / 2``), else everything on ``dp``.
    ``axis_names=("dp",)`` puts every rank on ``dp``; ``shape=(dp, tp)``
    gives the layout explicitly. Every rank calls this in the same order
    (each builds every subgroup, as ``dist.new_group`` asks). ``tp`` splits
    the channels only where it divides ``ydim``
    (``parallel.sharded.channel_rows``)."""
    _initialised("make_mesh")
    n, rank = dist.get_world_size(), dist.get_rank()
    n_dp, n_tp = mesh_shape(n, axis_names, shape)
    d, t = divmod(rank, n_tp)
    if n_tp == 1:
        return Mesh(dp=dist.group.WORLD, tp=None, everyone=dist.group.WORLD, coords=(d, 0),
                    shape=(n_dp, 1))
    dp_groups = [dist.new_group([i * n_tp + j for i in range(n_dp)]) for j in range(n_tp)]
    tp_groups = [dist.new_group([i * n_tp + j for j in range(n_tp)]) for i in range(n_dp)]
    return Mesh(dp=dp_groups[t], tp=tp_groups[d], everyone=dist.group.WORLD, coords=(d, t),
                shape=(n_dp, n_tp))


def as_mesh(mesh) -> Mesh:
    """``mesh`` as a :class:`Mesh`: a bare ``dp`` process group is a mesh of
    one axis. Anything else raises ``ValueError``, so a collective is never
    skipped quietly."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        raise ValueError("the sharded path needs a dp process group (parallel.make_dp_group) "
                         "or a mesh (parallel.make_mesh)")
    if not isinstance(mesh, dist.ProcessGroup):
        raise ValueError("mesh must be a dp process group (parallel.make_dp_group) or a "
                         f"parallel.make_mesh Mesh, not a {type(mesh).__name__}")
    _initialised("a sharded call")
    rank = dist.get_rank(mesh)
    if rank < 0:
        raise ValueError("this process is not a member of the dp group")
    return Mesh(dp=mesh, tp=None, everyone=mesh, coords=(rank, 0),
                shape=(dist.get_world_size(mesh), 1))
