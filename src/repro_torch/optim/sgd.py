"""Momentum SGD — the paper's optimizer (``repro.optim.sgd``).

Not ``torch.optim``: the state is a tree keyed like the params, as in the
reference, and the update is written out as the reference writes it.
Unlike the reference's pure function, ``update`` works in place: it
advances the given params and velocity tensors and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.params import map_tree, tree_leaves


class SgdState(NamedTuple):
    velocity: Any


@dataclass(frozen=True)
class MomentumSGD:
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params) -> SgdState:
        return SgdState(map_tree(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: SgdState, params, lr: float
               ) -> Tuple[Any, SgdState]:
        """v = momentum * v + g + weight_decay * p, then p = p - lr * v,
        leaf by leaf, in place."""
        for g, v, p in zip(tree_leaves(grads), tree_leaves(state.velocity),
                           tree_leaves(params)):
            v.mul_(self.momentum).add_(g)
            if self.weight_decay:
                v.add_(p, alpha=self.weight_decay)
            p.sub_(v, alpha=lr)
        return params, state
