"""train_step assembly (``repro.train.train_step``): loss -> grads ->
synchronous-SGD update: the serial optimizer, or the explicit zero1
update of ``optim.dist``; or, in ``make_overlapped_train_step``, the
paper's §3.1 schedule, each bucket's reduce issued inside the backward
pass (``comm.overlap``).

PyTorch runs eagerly, so there is no jit and no buffer donation: the step
computes the gradients with ``torch.autograd.grad`` over the param tree's
leaves (flat for the CNN and DNN, nested for the transformer) and the
optimizer updates the params and its state in place.

On a local mesh every member computes the whole batch's loss and gradient
(the reference's monolithic step hands each member the same global
gradient).  On a process mesh (``launch.mesh.ProcessMesh``) each rank
computes its own rows of the batch (``data.pipeline.make_placer``), as the
reference's ranks do under ``bspec = P(axis)``: its gradient is its rows',
so the step reduces first and takes the norm and the clip from the reduced
strips (:func:`clip_strips`, or the update's own ``clip`` under dp and
zero1-gspmd, ``optim.dist.GspmdUpdate``), and its loss is the group mean.
A cluster mesh's rank (``launch.mesh.ClusterMesh``) computes its pod's rows
once for all the members it holds, and takes the same path.

Under a model axis the params and gradients are in member layout
(``core.sharding``): on a local mesh every block once, so the global norm
is :func:`global_norm` of the tree as it is; on a process mesh the update's
``clip`` counts a model-sharded leaf's squares once over its model group
and a replicated leaf once, not M times.  :func:`zero1_state_shardings` is
the reference's metadata of the zero1-gspmd state.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.comm.overlap import make_overlap_grad
from repro_torch.comm.schedule import group_axes
from repro_torch.core import collectives as coll
from repro_torch.core.params import map_tree, tree_leaves
from repro_torch.core.sharding import ShardingRules, zero1_state_spec


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaves in sorted-key
    order (the reference's ``jax.tree`` order), in f32.  On a local mesh's
    member layout every block is held once, so this is the full tree's."""
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
    ``opt_state`` comes from the ``init_fn`` of the same call.  On a process
    mesh the clip moves between the update's reduce and its apply (module
    docstring)."""
    up = getattr(dist_update, "plan", None)
    if up is not None and up.mesh.batch_shard is not None:
        return _sharded_train_step(loss_fn, lr_schedule, grad_clip,
                                   dist_update)

    def train_step(params, opt_state, step_idx, batch):
        loss, grads = _loss_and_grads(loss_fn, params, batch)
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


def _loss_and_grads(loss_fn, params, batch):
    """The loss and its gradient tree.  A leaf the loss does not reach
    takes a zero gradient, as ``jax.grad`` gives it (musicgen's ``embed``
    and ``lm_head``: the audio loss reads the frame embeddings and the
    codebook heads), so that the optimizer still decays it."""
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(params, batch)
    it = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
    return loss, map_tree(lambda _: next(it), params)


def group_mean(loss: torch.Tensor, mesh, axis_arg, G: int) -> torch.Tensor:
    """The group mean of the ranks' losses of their own batch rows (the
    reference's ``psum(loss) / G``), each member of a rank counting its
    rank's loss."""
    return mesh.one(coll.psum(mesh.replicated(loss.detach()), mesh,
                              axis_arg)) / G


def _sharded_train_step(loss_fn, lr_schedule, grad_clip, dist_update):
    """The monolithic step of a process mesh (zero1, stale-sync, gossip):
    loss and gradient of this rank's batch rows, the update's reduce, the
    norm and the clip of the reduced strips, then the update's apply and
    broadcast.  Under stale-sync the clipped strips are this step's fresh
    reduce, which the apply carries to the next step and applies then (the
    reference's carry holds clipped means too); the reported norm is this
    step's."""
    up = dist_update.plan
    clip = getattr(dist_update, "clip", None) or (
        lambda g, c: clip_strips(g, up.mesh, up.axis_arg, c))

    def train_step(params, opt_state, step_idx, batch):
        loss, grads = _loss_and_grads(loss_fn, params, batch)
        g_strips = dist_update.reduce(params, grads, opt_state, step_idx)
        gnorm = clip(g_strips, grad_clip)
        lr = lr_schedule(step_idx)
        params, opt_state = dist_update.local(params, g_strips, opt_state,
                                              lr, step_idx)
        metrics = {"loss": group_mean(loss, up.mesh, up.axis_arg, up.G),
                   "grad_norm": gnorm, "lr": lr}
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
    On a local mesh every member computes the full batch's loss and
    gradient, as in the monolithic step, so with ``grad_clip=0`` the two
    steps feed the same bytes to the same kernels.  On a process mesh each
    rank computes its own batch rows and reports the group-mean loss.
    """
    _, axis_arg, G = group_axes(mesh, data_axes)
    overlap_grad = make_overlap_grad(loss_fn, mesh, axis_arg, comm, G)
    sharded = mesh.batch_shard is not None

    def train_step(params, opt_state, step_idx, batch):
        loss, g_strips = overlap_grad(params, batch)
        if sharded:
            loss = group_mean(loss, mesh, axis_arg, G)
        gnorm = clip_strips(g_strips, mesh, axis_arg, grad_clip)
        lr = lr_schedule(step_idx)
        params, opt_state = local_update(params, g_strips, opt_state, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def axes_leaves(tree) -> list:
    """The logical-axes tuples of a ``param_axes`` tree, in leaf order."""
    if _is_axes(tree):
        return [tree]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in axes_leaves(tree[k])]
    return [a for t in tree for a in axes_leaves(t)]


def zero1_state_shardings(opt_state, param_axes, mesh,
                          rules: ShardingRules = ShardingRules()):
    """ZeRO-1 (the paper's strip scheme as GSPMD places it): the spec of
    every optimizer-state leaf, a tree of ``opt_state``'s structure.  A
    state tensor takes its param's spec plus the data axes on the first
    dim that is unsharded and divisible (``core.sharding.
    zero1_state_spec``); a scalar takes ``()``.  The state fields repeat
    the param tree, so leaves match the param axes cyclically, scalars
    skipped, as in the reference."""
    flat_axes = axes_leaves(param_axes)
    n, pi = len(flat_axes), 0

    def one(leaf):
        nonlocal pi
        if getattr(leaf, "ndim", 0) == 0:
            return ()
        spec = zero1_state_spec(flat_axes[pi % n], tuple(leaf.shape), mesh,
                                rules)
        pi += 1
        return spec
    return map_tree(one, opt_state)

