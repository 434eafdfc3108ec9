"""train_step assembly (``repro.train.train_step``): loss -> grads ->
synchronous-SGD update: the serial optimizer, or the explicit zero1
update of ``optim.dist``; or, in ``make_overlapped_train_step``, the
paper's §3.1 schedule, each bucket's reduce issued inside the backward
pass (``comm.overlap``).

PyTorch runs eagerly, so there is no jit and no buffer donation: the step
computes the gradients with ``torch.autograd.grad`` over the param tree's
leaves (flat for the CNN and DNN, nested for the transformer) and the
optimizer updates the params and its state in place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.comm.overlap import make_overlap_grad
from repro_torch.comm.schedule import group_axes
from repro_torch.core import collectives as coll
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


@torch.no_grad()
def clip_strips(g_strips, mesh, axis_arg, grad_clip: float) -> torch.Tensor:
    """The global norm of the reduced mean-gradient strips, and the strips
    clipped to ``grad_clip`` in place (none when ``grad_clip <= 0``).
    Every element of the mean gradient lies in exactly one member's strip
    (bucket padding is zeros), so the group sum of the members' square-sums
    is the norm squared."""
    sq = sum(torch.sum(torch.square(s), dim=-1) for s in g_strips)
    gnorm = torch.sqrt(mesh.one(coll.psum(sq, mesh, axis_arg)))
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for g in g_strips:
            g.mul_(scale)
    return gnorm


def make_overlapped_train_step(loss_fn: Callable, lr_schedule, mesh,
                               data_axes, comm, local_update: Callable,
                               grad_clip: float = 1.0):
    """The §3.1 backprop-overlapped realization of the zero1 step
    (``repro.train.make_overlapped_train_step``).  Returns
    step(params, opt_state, step_idx, batch) -> (params, opt_state, metrics)
    with ``make_train_step``'s metrics; it advances ``params`` and
    ``opt_state`` in place.

    The loss and the tapped backward run first: every bucket's part-reduce
    is issued when its last leaf gradient exists (``comm.overlap``), on a
    side stream on the card, joined before the strips are read.  The global
    gradient norm comes from the reduced strips and the clip scales them
    (:func:`clip_strips`); ``local_update`` (``optim.dist.
    make_overlapped_update``, the same ``comm``) applies and broadcasts.
    Every member computes the full batch's loss and gradient, as in the
    monolithic step, so with ``grad_clip=0`` the two steps feed the same
    bytes to the same kernels.
    """
    _, axis_arg, G = group_axes(mesh, data_axes)
    overlap_grad = make_overlap_grad(loss_fn, mesh, axis_arg, comm, G)

    def train_step(params, opt_state, step_idx, batch):
        loss, g_strips = overlap_grad(params, batch)
        gnorm = clip_strips(g_strips, mesh, axis_arg, grad_clip)
        lr = lr_schedule(step_idx)
        params, opt_state = local_update(params, g_strips, opt_state, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step
