"""train_step assembly (``repro.train.train_step``): loss -> grads ->
synchronous-SGD update: the serial optimizer, or the explicit zero1
update of ``optim.dist``.

PyTorch runs eagerly, so there is no jit and no buffer donation: the step
computes the gradients with ``torch.autograd.grad`` over the param tree's
leaves (flat for the CNN and DNN, nested for the transformer) and the
optimizer updates the params and its state in place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.params import map_tree, tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaves in sorted-key
    order (the reference's ``jax.tree`` order), in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def make_train_step(loss_fn: Callable, optimizer, lr_schedule,
                    grad_clip: float = 1.0,
                    dist_update: Optional[Callable] = None):
    """loss_fn(params, batch) -> scalar loss.  Returns
    step(params, opt_state, step_idx, batch) -> (params, opt_state, metrics),
    which advances ``params`` and ``opt_state`` in place and returns them.
    ``dist_update`` (optional): the explicit distributed update
    ``(params, grads, opt_state, lr, step) -> (params, opt_state)`` built by
    ``optim.dist.make_distributed_update``, in place of the serial
    ``optimizer.update``: the clipped gradients go through the bucketed
    part-reduce, the strip optimizer and the part-broadcast.  The matching
    ``opt_state`` comes from the ``init_fn`` of the same call."""

    def train_step(params, opt_state, step_idx, batch):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(params, batch)
        it = iter(torch.autograd.grad(loss, leaves))
        grads = map_tree(lambda _: next(it), params)
        gnorm = global_norm(grads)
        if grad_clip > 0:
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for g in tree_leaves(grads):
                g.mul_(scale)
        lr = lr_schedule(step_idx)
        if dist_update is not None:
            params, opt_state = dist_update(params, grads, opt_state, lr,
                                            step_idx)
        else:
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step
