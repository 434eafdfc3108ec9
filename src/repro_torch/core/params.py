"""Parameter specs: one declaration yields the shapes and the initial values.

``repro.core.params`` with a ``torch.Generator`` in place of a
``jax.random`` key.  The distributions are the reference's (fan-in scaled
normals, ``shape[-2]`` as fan-in for stacked weights of rank >= 3, scaled
normal embeddings, zero norms); the bits differ, so parity tests carry the
reference's values over with ``repro_torch.interop.params_from_numpy``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

import torch


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"          # fan_in | normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, tuples and lists.
    Dict keys are visited in sorted order — ``jax.tree``'s leaf order, so
    the generator draws leaves in the reference's order."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(map_tree(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, t) for t in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in :func:`map_tree`'s order (``jax.tree.leaves``)."""
    leaves = []
    map_tree(leaves.append, tree)
    return leaves


def _init_leaf(s: Spec, gen: torch.Generator, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    a = torch.randn(s.shape, generator=gen, dtype=dtype, device=device)
    if s.init in ("embed", "normal"):
        return a.mul_(s.scale)
    fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[0], 1)
    if len(s.shape) >= 3:  # (.., in, out) stacked weights
        fan_in = s.shape[-2]
    return a.mul_(s.scale / np.sqrt(fan_in))


def init_tree(specs, gen: torch.Generator, device: torch.device,
              dtype: torch.dtype = torch.float32):
    """Materialize a tree of :class:`Spec` leaves on ``device``; ``gen``
    must live on the same device."""
    return map_tree(lambda s: _init_leaf(s, gen, device, dtype), specs)
