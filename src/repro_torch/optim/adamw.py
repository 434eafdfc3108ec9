"""AdamW (``repro.optim.adamw``): for the transformer families; the
paper's CNN/DNN experiments use momentum SGD.  Like ``MomentumSGD``, the
update works in place on the params and the moment trees."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import numpy as np

import torch

from repro_torch.core.params import map_tree, tree_leaves


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: int


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamWState:
        return AdamWState(map_tree(torch.zeros_like, params),
                          map_tree(torch.zeros_like, params), 0)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr: float
               ) -> Tuple[Any, AdamWState]:
        c = state.count + 1
        # bias corrections in f32, as the reference computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(c))
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                step.add_(p, alpha=self.weight_decay)
            p.sub_(step, alpha=lr)
        return params, AdamWState(state.mu, state.nu, c)
