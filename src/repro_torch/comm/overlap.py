"""Backprop-overlapped bucket reduction, the paper's §3.1 schedule
(``repro.comm.overlap``).

The monolithic zero1 step reduces the gradient only after the backward
pass returns, so all of its communication is exposed.  The paper instead
issues each layer's weight-gradient communication as soon as that layer's
backprop finishes: the last layer's gradients exist first, and all but the
"bubble" of each transfer hides under the rest of backprop.

This module realizes that schedule per fusion bucket.  Each bucket's
leaves pass through an identity tap on the forward pass, a
``torch.autograd.Function``; its backward, which the autograd engine calls
once the cotangent of every one of the bucket's leaves exists
(``Bucket.trigger_index``), packs them into the fusion buffer (a missing
cotangent is zeros), issues the bucket's part-reduce and passes the
cotangents on unchanged.  Two details make that the real issue point:

- The engine runs ready nodes in descending sequence number, that is
  creation order reversed, and the taps are created before any forward op.
  So each tap's node is given the top priority (as the engine gives
  ``AccumulateGrad``), a later bucket above an earlier one; otherwise every
  tap would wait for the whole backward pass.
- On a CUDA device the reduce runs on a side stream, one per device
  (:func:`comm_stream`): it first waits for the gradient kernels already
  queued on the compute stream, and every tensor the compute stream
  allocated and the side stream reads (the cotangents) is recorded on it,
  so the caching allocator does not hand that memory to a later backward
  kernel while the ring still reads it.  The step joins the side stream
  (:func:`join_comm`) before it reads a strip: the only join, no device
  synchronise.  On the CPU the same code runs without streams.

The reduced strips leave the backward pass through a list the taps fill.
Every tap also takes one zero ``anchor`` that requires grad, so its outputs
require grad whatever the params do, and ``autograd.grad(loss, anchor)``
runs every tap and only what they need.  The reduce is the monolithic
update's own (``comm.schedule.reduce_mean`` of the packed bucket, every
member's partial the same gradient), so the strips equal its reduce
bitwise.  int8 rides the tap through the bound backend; top-k cannot (its
error-feedback residual has no place in a stateless tap: ``RunSpec``
refuses the pair).

The analytic counterpart is ``core.balance.bucket_bubble_schedule``, fed by
:func:`bucket_triggers` / :func:`issue_order`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.bucketer import (
    Bucket,
    BucketPlan,
    CommConfig,
    pack_bucket,
    plan_buckets,
)
from repro_torch.comm.schedule import make_schedule, reduce_mean
from repro_torch.core.params import map_tree, tree_leaves
from repro_torch.telemetry.events import NULL_RECORDER

#: the autograd engine's highest node priority (``AccumulateGrad``'s)
_TOP_PRIORITY = 2 ** 64 - 1


# ---------------------------------------------------------------------------
# readiness metadata: bucket -> issue point of the §3.1 schedule
# ---------------------------------------------------------------------------
def bucket_triggers(plan: BucketPlan,
                    leaf_layer: Optional[Sequence[int]] = None
                    ) -> Tuple[int, ...]:
    """Per bucket, the forward-order layer whose weight-gradient pass
    completes it: the minimum layer over its leaves.  ``leaf_layer`` maps
    flat leaf index -> forward layer; ``None`` takes each leaf as its own
    layer in tree order (``Bucket.trigger_index``)."""
    if leaf_layer is None:
        return tuple(b.trigger_index for b in plan.buckets)
    return tuple(min(leaf_layer[s.index] for s in b.slots)
                 for b in plan.buckets)


def issue_order(triggers: Sequence[int]) -> Tuple[int, ...]:
    """Bucket indices in backprop issue order (``core.balance.issue_order``,
    the one definition)."""
    from repro_torch.core.balance import issue_order as _rule
    return _rule(triggers)


# ---------------------------------------------------------------------------
# the side stream
# ---------------------------------------------------------------------------
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def comm_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """The side stream the taps reduce on: one per CUDA device, shared by
    the autograd engine's device thread (the taps) and the step's join;
    None for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


def join_comm(device: torch.device) -> None:
    """Order the compute stream after every reduce issued on ``device``'s
    side stream (nothing on a CPU device)."""
    stream = comm_stream(device)
    if stream is not None:
        torch.cuda.current_stream(stream.device).wait_stream(stream)


# ---------------------------------------------------------------------------
# the comm hooks
# ---------------------------------------------------------------------------
class _BucketTap(torch.autograd.Function):
    """Identity on one bucket's leaves; its backward hands their cotangents
    to ``issue`` and passes them on unchanged."""

    @staticmethod
    def forward(ctx, issue, anchor, *leaves):
        ctx.issue = issue
        return tuple(leaf.view_as(leaf) for leaf in leaves)

    @staticmethod
    def backward(ctx, *cts):
        ctx.issue(cts)
        return (None, None, *cts)


def make_overlap_grad(loss_fn: Callable, mesh, axes, comm: CommConfig,
                      G: int, recorder=NULL_RECORDER) -> Callable:
    """Build ``overlap_grad(params, batch, join=True) -> (loss, g_strips)``.

    ``g_strips`` holds one fully reduced f32 mean-gradient strip per bucket
    of ``plan_buckets(params, G, comm.bucket_bytes)``, each member's in the
    layout of ``optim.dist.make_overlapped_update`` (``(G, n/G)`` on a
    local mesh, ``(n/G,)`` on a process mesh), every bucket's reduce issued
    inside the backward pass through ``comm.backend``.  Every member's
    partial is the full batch's gradient (``mesh.replicated``), as in the
    monolithic update.  ``join=False`` leaves the side stream unjoined: the
    caller calls :func:`join_comm` before it reads a strip.  ``recorder``
    takes the spans ``forward`` (the tapped loss) and ``backward``
    (the tapped backward, its reduces and the join).
    """
    sched = make_schedule(mesh, axes, comm.hierarchical, comm.backend,
                          comm.cross_backend, wire_format=comm.wire_format,
                          topk_ratio=comm.topk_ratio)

    def reduce_bucket(bucket: Bucket, cts) -> torch.Tensor:
        buf = pack_bucket({s.index: c for s, c in zip(bucket.slots, cts)},
                          bucket)
        return reduce_mean(sched, mesh.replicated(buf), comm.wire_dtype, G)

    def overlap_grad(params, batch, join: bool = True):
        plan = plan_buckets(params, G, comm.bucket_bytes)
        flat = tree_leaves(params)
        dev = flat[0].device
        stream = comm_stream(dev)
        strips: List[Optional[torch.Tensor]] = [None] * plan.n_collectives

        def issuer(b: int, bucket: Bucket) -> Callable:
            def issue(cts):
                if stream is None:
                    strips[b] = reduce_bucket(bucket, cts)
                    return
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    strips[b] = reduce_bucket(bucket, cts)
                for c in cts:
                    c.record_stream(stream)
            return issue

        anchor = torch.zeros((), device=dev, requires_grad=True)
        tapped = list(flat)
        n = plan.n_collectives
        for b, bucket in enumerate(plan.buckets):
            outs = _BucketTap.apply(issuer(b, bucket), anchor,
                                    *(flat[s.index] for s in bucket.slots))
            outs = outs if isinstance(outs, tuple) else (outs,)
            outs[0].grad_fn._set_sequence_nr(_TOP_PRIORITY - (n - 1 - b))
            for s, leaf in zip(bucket.slots, outs):
                tapped[s.index] = leaf
        it = iter(tapped)
        with recorder.span("forward"):
            loss = loss_fn(map_tree(lambda _: next(it), params), batch)
        with recorder.span("backward"):
            torch.autograd.grad(loss, anchor, allow_unused=True)
            for b, bucket in enumerate(plan.buckets):
                if strips[b] is None:       # no leaf of it reached the loss
                    issuer(b, bucket)([torch.zeros_like(flat[s.index])
                                       for s in bucket.slots])
            if join:
                join_comm(dev)
        if stream is not None:
            # allocated on the side stream, read on the compute stream
            current = torch.cuda.current_stream(dev)
            for s in strips:
                s.record_stream(current)
        return loss.detach(), strips

    return overlap_grad


# ---------------------------------------------------------------------------
# analytic exposure: what the schedule is predicted to hide
# ---------------------------------------------------------------------------
def exposed_comm(plan: BucketPlan, comm_times: Sequence[float],
                 layer_comps: Sequence[float], hw,
                 leaf_layer: Optional[Sequence[int]] = None,
                 efficiency: float = 1.0) -> Tuple[float, float, List[float]]:
    """(exposed_off, exposed_on, bubbles): predicted exposed communication
    in seconds with the monolithic schedule (all of ``sum(comm_times)``)
    and with the §3.1 overlap schedule
    (``core.balance.overlap_exposed_time``), and the per-bucket §3.1
    bubbles (``bucket_bubble_schedule``), from this plan's triggers."""
    from repro_torch.core.balance import (bucket_bubble_schedule,
                                          overlap_exposed_time)
    triggers = bucket_triggers(plan, leaf_layer)
    bubbles = bucket_bubble_schedule(comm_times, triggers, layer_comps, hw,
                                     efficiency)
    off = float(sum(comm_times))
    on = float(overlap_exposed_time(comm_times, triggers, layer_comps, hw,
                                    efficiency))
    return off, on, bubbles
