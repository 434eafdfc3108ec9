"""Carry a parameter tree and an optimizer state across from the JAX
package.

The reference's trees come over as numpy (``jax.tree.map(np.asarray,
tree)``): the same keys, the same shapes, blocks still stacked on their
leading repeat axis and weights still laid out (in, out), so nothing is
transposed.  A zero1 strip state is the same list of (G, n/G) bucket
strips, in owner order, in both packages.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.core.params import map_tree
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWState, SgdState


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays -> the same tree of tensors on ``device``
    (default: the GPU), dtype for dtype."""
    dev = resolve_device(device)
    return map_tree(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def opt_state_from_numpy(state, device=None):
    """The reference's optimizer state as numpy (its ``SgdState`` or
    ``AdamWState``, over the param tree or, under zero1, over the list of
    (G, n/G) strips) -> the port's, on ``device`` (default: the GPU).
    Together with :func:`params_from_numpy` it carries a run across
    mid-training."""
    fields = getattr(state, "_fields", None)
    if fields == ("velocity",):
        return SgdState(params_from_numpy(state.velocity, device))
    if fields == ("mu", "nu", "count"):
        return AdamWState(params_from_numpy(state.mu, device),
                          params_from_numpy(state.nu, device),
                          int(np.asarray(state.count)))
    raise TypeError(f"not a momentum-SGD or AdamW state: "
                    f"{type(state).__name__} with fields {fields}")
