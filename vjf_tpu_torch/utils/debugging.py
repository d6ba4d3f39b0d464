"""Numerical debugging toggles (counterpart of ``vjf_tpu/utils/debugging.py``).

The step's guards zero a non-finite term and skip a non-finite update;
when something does go non-finite these find it instead of masking it.
"""
from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch
from torch import nn


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise where a backward pass first produces NaN
    (``torch.autograd.set_detect_anomaly``): the autograd step's gradients.
    The fused kernels have no backward graph, so run the epoch with
    ``fused_step='off'`` to cover every step."""
    torch.autograd.set_detect_anomaly(enable)


def tree_leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every tensor in a tree of NamedTuples, dicts,
    lists, tuples and ``nn.Module``s, in order; ``None`` leaves are
    skipped."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}.{name}" if path else name, p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in tree._asdict().items():
            yield from tree_leaves_with_path(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{path}[{i}]")


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Host-side check: raises ``FloatingPointError`` listing the path of
    every floating leaf that holds a NaN or an infinity."""
    bad = [p for p, leaf in tree_leaves_with_path(tree)
           if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")


def debug_finite_callback(tree: Any, label: str = "state") -> bool:
    """Print a line when any floating leaf of ``tree`` is non-finite and
    return whether all are finite. It reads one flag from the card each
    call, a host sync: use it on suspect epochs, not inside a hot loop."""
    ok = True
    for _, leaf in tree_leaves_with_path(tree):
        if leaf.is_floating_point():
            ok = ok and bool(torch.isfinite(leaf).all())
    if not ok:
        print(f"[vjf_tpu_torch] non-finite values detected in {label}")
    return ok
