"""Carry a parameter tree across from the JAX package.

The reference's params come over as numpy (``jax.tree.map(np.asarray,
params)``): the same keys, the same shapes, blocks still stacked on their
leading repeat axis and weights still laid out (in, out), so nothing is
transposed.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.core.params import map_tree
from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays -> the same tree of tensors on ``device``
    (default: the GPU), dtype for dtype."""
    dev = resolve_device(device)
    return map_tree(lambda a: torch.tensor(np.asarray(a), device=dev), tree)
