"""Paper §3.4 — the distributed synchronous-SGD update, as a phase pipeline
(``repro.optim.dist``).

Between the gradient and the SGD step, gradients are part-reduced over the
data-parallel group: each member receives the fully reduced gradient of a
1/G strip, applies the optimizer to its strip only (optimizer state exists
only for the strip: ZeRO-1), then part-broadcasts the updated strip so that
every member again holds the full weights.  :class:`UpdatePlan` makes the
three phases explicit over one shared layout:

    reduce(grads)     -> g_strips    one wire-dtype part-reduce per fusion
                                     bucket, mean in f32
    apply(strips)     -> new strips  each member's param strips through the
                                     serial optimizer, on its state rows
    broadcast(strips) -> params      one f32 part-broadcast per bucket,
                                     unpacked into the params in place

On a local mesh (``launch.mesh.LocalMesh``) the G members are rows of one
tensor: the strip state is one ``(G, n/G)`` tensor per bucket, in owner
order, the reference's layout; a bucket's member partials are one buffer
viewed G times (``expand``, no copy), since every member enters with the
same clipped global gradient, as in the reference's monolithic step (its
``in_specs=P()``); ``apply`` runs the optimizer once on all G rows (it is
elementwise).  On a process mesh (``launch.mesh.ProcessMesh``) each rank
holds its ``(n/G,)`` strip of the state and computes the same global
gradient.  The mesh decides the layout (``per_member``, ``replicated``,
``own``, ``one``); the phases are written once for both.

:func:`make_topk_ef_update` wraps the same pipeline for
``wire_format="topk"``: top-k sparsification with error feedback.  The int8
wire format needs no update of its own: it rides
:func:`make_distributed_update` through the bound backend.
:func:`make_overlapped_update` is the apply and broadcast phases alone, for
the §3.1 backprop-overlapped step, whose reduces the ``comm.overlap`` taps
issue inside the backward pass.  :func:`make_stale_sync_update` moves the
phases apart across steps: step t applies the strips reduced at step t - 1
from a carried buffer (bounded staleness 1).  ``parallel="gossip"`` is
:func:`make_distributed_update` with the reduce phase on the GossipGraD
partner exchange (``comm.backends.gossip``; the schedule carries the step,
so the partner rotation advances).  The monolithic constructors'
``update_fn`` is a :class:`DistUpdate`, callable whole or in its reduce and
apply halves (a process mesh's train step clips between them).

Model ways (paper §3.3).  The reference runs these modes under
``shard_map`` with params ``P()``: every member sees full leaves, plans its
buckets over the full tree at G = the data extent, and every model member
of a group updates the same strip.  :class:`ModelGatheredUpdate` does the
same around any of them: it gathers the model shards into full gradients
and params, runs the pipeline above on the mesh's ``data_view()``, and lets
each member keep its columns; so the bucket plan, the strip layout and the
checkpoints are those of ``model_ways=1``.  :class:`GspmdUpdate` is the
reference's two GSPMD modes, per leaf on each member's own shard: ``dp``
(the optimizer on the member's params and state, the gradient the mean over
the data axes) and ``zero1-gspmd`` (each leaf's gradient reduce-scattered
along its state's data dim, ``train.zero1_state_shardings``, the member's
strip updated, the params all-gathered back).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.comm.backends.ring import topk_chunk_k
from repro_torch.comm.bucketer import (
    BucketPlan,
    CommConfig,
    pack_bucket,
    plan_buckets,
    unpack_bucket,
)
from repro_torch.comm.schedule import (
    Schedule,
    group_axes,
    make_schedule,
    reduce_mean,
)
from repro_torch.core import collectives as coll
from repro_torch.core.params import map_tree, tree_leaves
from repro_torch.core.sharding import (
    ShardingCtx,
    entry_axes,
    from_members,
    to_members,
    used_axes,
    zero1_state_spec,
)
from repro_torch.kernels.ref import topk_mask_ref
from repro_torch.telemetry.events import NULL_RECORDER

DEFAULT_COMM = CommConfig()


def owner_perm(hierarchical: bool, axes_sizes) -> Optional[np.ndarray]:
    """Row j of a (G, n/G) state tensor belongs to the member at flat mesh
    index j, which under the hierarchical schedule owns strip
    ``d * G_out + p``: value-initialised state must be laid out in owner
    order.  None for the flat schedule (identity layout)."""
    if hierarchical and len(axes_sizes) == 2:
        g_out, g_in = axes_sizes
        return np.array(
            [d * g_out + p for p in range(g_out) for d in range(g_in)])
    return None


@dataclass(frozen=True)
class UpdatePlan:
    """The shared layout and phase set of the §3.4 update: which mesh axes
    form the group, how the tree fuses into buckets, which member owns
    which strip.  Each phase is one span of ``recorder`` (``reduce``,
    ``apply``, ``broadcast``), over all its buckets."""
    optimizer: Any
    mesh: Any
    axes: Tuple[str, ...]
    axis_arg: Any                  # single-name-or-tuple collective form
    G: int
    comm: CommConfig
    recorder: Any = field(default=NULL_RECORDER, compare=False)

    @classmethod
    def build(cls, optimizer, mesh, data_axes=("data",),
              comm: Optional[CommConfig] = DEFAULT_COMM,
              recorder=NULL_RECORDER) -> "UpdatePlan":
        """``comm=None`` selects the per-tensor schedule: one bucket per
        leaf (``bucket_bytes=0``)."""
        axes, axis_arg, G = group_axes(mesh, data_axes)
        if comm is None:
            comm = CommConfig(bucket_bytes=0)
        return cls(optimizer, mesh, axes, axis_arg, G, comm, recorder)

    # -- shared layout ------------------------------------------------
    def buckets(self, params) -> BucketPlan:
        return plan_buckets(params, self.G, self.comm.bucket_bytes)

    def schedule(self, step=None) -> Schedule:
        return make_schedule(self.mesh, self.axis_arg, self.comm.hierarchical,
                             self.comm.backend, self.comm.cross_backend,
                             step=step, wire_format=self.comm.wire_format,
                             topk_ratio=self.comm.topk_ratio)

    def owner_layout(self) -> Optional[np.ndarray]:
        return owner_perm(self.comm.hierarchical,
                          [self.mesh.shape[a] for a in self.axes])

    @torch.no_grad()
    def init_fn(self, params):
        """The strip state: per bucket a (G, n/G) tensor in owner order
        (``owner_layout``) on a local mesh, this rank's (n/G,) strip on a
        process mesh."""
        plan = self.buckets(params)
        flat = tree_leaves(params)
        return self.optimizer.init(
            self._own_strips(flat, plan, self.schedule().owner_index()))

    # -- the three phases ----------------------------------------------
    def _own_strips(self, flat, plan: BucketPlan, owner
                    ) -> List[torch.Tensor]:
        """Each member's strip of every bucket of ``flat``, in the layout of
        the strip state (``owner``: the schedule's ``owner_index``)."""
        return [self.mesh.own(pack_bucket(flat, b).view(self.G, -1), owner)
                for b in plan.buckets]

    def reduce(self, sched: Schedule, plan: BucketPlan, grads
               ) -> List[torch.Tensor]:
        """Phase 1: one part-reduce per bucket, wire dtype, mean in f32.
        Every member's partial is the same global gradient (a view on a
        local mesh).  Returns each member's mean-gradient strip per
        bucket."""
        flat_grads = tree_leaves(grads)
        with self.recorder.span("reduce"):
            return [reduce_mean(sched, self.mesh.replicated(
                pack_bucket(flat_grads, b)), self.comm.wire_dtype, self.G)
                for b in plan.buckets]

    def apply(self, sched: Schedule, plan: BucketPlan, params, g_strips,
              opt_state, lr):
        """Phases 2-3: each member's param strips through the serial
        optimizer on its state rows (elementwise, so fusing tensors into one
        buffer does not change the math).  Updates the strips and the state
        in place and returns them."""
        with self.recorder.span("apply"):
            p_strips = self._own_strips(tree_leaves(params), plan,
                                        sched.owner_index())
            return self.optimizer.update(g_strips, opt_state, p_strips, lr)

    def broadcast(self, sched: Schedule, plan: BucketPlan, params,
                  new_p_strips):
        """Phase 4: one f32 part-broadcast per bucket, each unpacked (one
        member's copy of the gathered buffer) into the params in place
        before the next bucket is gathered."""
        flat_params = tree_leaves(params)
        with self.recorder.span("broadcast"):
            for strips, b in zip(new_p_strips, plan.buckets):
                full = sched.broadcast(strips)
                for i, leaf in unpack_bucket(self.mesh.one(full), b):
                    flat_params[i].copy_(leaf)
        return params


class DistUpdate:
    """The ``update_fn`` of :func:`make_distributed_update`,
    :func:`make_topk_ef_update` and :func:`make_stale_sync_update`:
    callable as the whole update,

        update_fn(params, grads, opt_state, lr, step=0)
            -> (params, opt_state),

    and in its two halves, for the train step of a process mesh whose ranks
    hold gradients of their own batch rows: there the norm and the clip can
    only be taken from the reduced strips, between the halves
    (``train.make_train_step``)::

        g_strips = update_fn.reduce(params, grads, opt_state, step)
        params, opt_state = update_fn.local(params, g_strips, opt_state, lr,
                                            step)

    ``plan`` is the :class:`UpdatePlan` (mesh, group axes, G, comm);
    ``reduce_fn(sched, buckets, grads, opt_state) -> g_strips`` and
    ``apply_fn(sched, buckets, params, g_strips, opt_state, lr) -> (params,
    opt_state)`` are the composition's two halves."""

    def __init__(self, plan: UpdatePlan, reduce_fn, apply_fn):
        self.plan = plan
        self._reduce = reduce_fn
        self._apply = apply_fn

    @torch.no_grad()
    def __call__(self, params, grads, opt_state, lr, step=0):
        buckets, sched = self.plan.buckets(params), self.plan.schedule(step)
        g_strips = self._reduce(sched, buckets, grads, opt_state)
        return self._apply(sched, buckets, params, g_strips, opt_state, lr)

    @torch.no_grad()
    def reduce(self, params, grads, opt_state, step=0):
        return self._reduce(self.plan.schedule(step),
                            self.plan.buckets(params), grads, opt_state)

    @torch.no_grad()
    def local(self, params, g_strips, opt_state, lr, step=0):
        return self._apply(self.plan.schedule(step),
                           self.plan.buckets(params), params, g_strips,
                           opt_state, lr)


def make_distributed_update(optimizer, mesh, data_axes=("data",),
                            comm: Optional[CommConfig] = DEFAULT_COMM,
                            recorder=NULL_RECORDER):
    """Build ``(init_fn, update_fn)`` realizing the paper's update over
    ``mesh``: the reduce -> apply -> broadcast pipeline of one
    :class:`UpdatePlan`.  Params and grads enter as the full trees (every
    member's gradient is the global one); the optimizer state lives as
    per-bucket strips (``init_fn``).  ``update_fn`` advances the params and
    the state in place and returns them.  ``recorder`` takes the phases'
    spans (:class:`UpdatePlan`), as in every constructor below.

    update_fn(params, grads, opt_state, lr, step=0)
        -> (params, new_opt_state)
    """
    up = UpdatePlan.build(optimizer, mesh, data_axes, comm, recorder)

    def reduce(sched, plan, grads, opt_state):
        return up.reduce(sched, plan, grads)

    def apply(sched, plan, params, g_strips, opt_state, lr):
        new_p_strips, new_state = up.apply(sched, plan, params, g_strips,
                                           opt_state, lr)
        return up.broadcast(sched, plan, params, new_p_strips), new_state

    return up.init_fn, DistUpdate(up, reduce, apply)


def make_overlapped_update(optimizer, mesh, data_axes=("data",),
                           comm: Optional[CommConfig] = None,
                           recorder=NULL_RECORDER):
    """The backprop-overlapped composition: ``(init_fn, local_update)``,
    where ``local_update(params, g_strips, opt_state, lr) -> (params,
    opt_state)`` is the apply and broadcast phases alone.  It takes the
    per-bucket mean-gradient strips already reduced inside the backward pass
    by the ``comm.overlap`` taps (``train.make_overlapped_train_step``), and
    advances the params and the state in place.  ``init_fn`` is the shared
    strip init, so both paths' states have one layout."""
    comm = DEFAULT_COMM if comm is None else comm
    up = UpdatePlan.build(optimizer, mesh, data_axes, comm, recorder)
    sched = up.schedule()

    @torch.no_grad()
    def local_update(params, g_strips, opt_state, lr):
        plan = up.buckets(params)
        new_p_strips, new_state = up.apply(sched, plan, params, g_strips,
                                           opt_state, lr)
        return up.broadcast(sched, plan, params, new_p_strips), new_state

    return up.init_fn, local_update


def make_stale_sync_update(optimizer, mesh, data_axes=("data",),
                           comm: Optional[CommConfig] = None,
                           recorder=NULL_RECORDER):
    """Bounded staleness 1 (``repro.optim.dist.make_stale_sync_update``):
    step t applies the mean-gradient strips reduced at step t - 1 and
    carries its own fresh reduce to step t + 1.  The reduce and apply
    phases share no state, so the strip-owner layout lets them move apart
    across steps; a full step of compute is then there to hide every byte
    of the reduce (``core.balance.stale_sync_exposed_time``), at the price
    of a one-step-old gradient.

    opt_state wraps the zero1 strip state::

        {"stale":  per bucket, the carried mean-gradient strips, f32:
                   (G, n/G) in owner order on a local mesh (the
                   reference's layout), this rank's (n/G,) row on a
                   process mesh,
         "synced": int32 scalar on the device, 0 until a reduce has been
                   carried,
         "zero1":  the inner strip state, zero1's layout (so a zero1
                   checkpoint resumes here with the carry re-initialised:
                   ``api.run``)}

    While ``synced == 0`` (the first step, and the first after a
    re-initialised carry) a step applies its own reduce rather than zeros.
    The choice is a ``torch.where`` on the device: no host sync.  The
    ``update_fn`` is a :class:`DistUpdate`: on a process mesh the train
    step clips the fresh strips between its halves, so the carry holds
    clipped means, as the reference's does.

    update_fn(params, grads, opt_state, lr, step=0)
        -> (params, opt_state), both advanced in place
    """
    comm = DEFAULT_COMM if comm is None else comm
    up = UpdatePlan.build(optimizer, mesh, data_axes, comm, recorder)

    @torch.no_grad()
    def init_fn(params):
        dev = tree_leaves(params)[0].device
        stale = [mesh.replicated(torch.zeros(
            b.padded_size // up.G, dtype=torch.float32,
            device=dev)).contiguous() for b in up.buckets(params).buckets]
        return {"stale": stale,
                "synced": torch.zeros((), dtype=torch.int32, device=dev),
                "zero1": up.init_fn(params)}

    def reduce(sched, plan, grads, opt_state):
        return up.reduce(sched, plan, grads)

    def apply(sched, plan, params, fresh, opt_state, lr):
        synced = opt_state["synced"]
        # consume last step's reduce; an empty carry (first step, or a
        # resume that re-initialised it) takes this step's own
        applied = [torch.where(synced > 0, c, f)
                   for c, f in zip(opt_state["stale"], fresh)]
        new_p_strips, inner = up.apply(sched, plan, params, applied,
                                       opt_state["zero1"], lr)
        synced.fill_(1)
        # the fresh strips are this step's own tensors (the reduce
        # allocates them): the carry takes them as they are, no copy, in
        # the caller's state dict
        opt_state["stale"] = list(fresh)
        opt_state["zero1"] = inner
        return up.broadcast(sched, plan, params, new_p_strips), opt_state

    return init_fn, DistUpdate(up, reduce, apply)


def topk_ef_reduce(up: UpdatePlan, sched: Schedule, plan: BucketPlan, grads,
                   residual: List[torch.Tensor]) -> List[torch.Tensor]:
    """The reduce phase of the top-k error-feedback update: per bucket, the
    carried residual plus the packed gradient, its largest-|x| entries kept
    (``topk_chunk_k`` of the bucket, at least G) and part-reduced through
    the topk-bound schedule; ``residual`` becomes ``buffer - kept`` in
    place.  Returns each member's mean-gradient strip per bucket, under
    ``up``'s ``reduce`` span."""
    flat_grads = tree_leaves(grads)
    g_strips = []
    with up.recorder.span("reduce"):
        for b, buf in zip(plan.buckets, residual):
            buf.add_(up.mesh.replicated(pack_bucket(flat_grads, b).float()))
            k = topk_chunk_k(b.padded_size, up.comm.topk_ratio, floor=up.G)
            kept = topk_mask_ref(buf, k)
            g_strips.append(reduce_mean(sched, kept, up.comm.wire_dtype,
                                        up.G))
            buf.sub_(kept)
    return g_strips


def make_topk_ef_update(optimizer, mesh, data_axes=("data",),
                        comm: Optional[CommConfig] = None,
                        recorder=NULL_RECORDER):
    """The ``wire_format="topk"`` composition: top-k sparsified reduce with
    local error feedback (``repro.optim.dist.make_topk_ef_update``).  Each
    step every member adds its carried residual to the packed bucket
    gradient, keeps the ``topk_ratio`` largest-|g| entries (at least G, so
    that every wire chunk gets one), and carries ``buffer - kept`` forward:
    what sparsification drops this step is offered again the next.  The
    kept buckets then ride the reduce phase, whose topk-bound backend moves
    (values, indices) messages with per-hop re-selection.

    opt_state wraps the zero1 strip state::

        {"residual": per bucket, each member's unsent gradient mass, f32:
                     (G, padded_size) on a local mesh (the reference's
                     layout), this rank's (padded_size,) on a process mesh,
         "zero1":    the inner strip state}

    update_fn(params, grads, opt_state, lr, step=0)
        -> (params, opt_state), both advanced in place
    """
    comm = DEFAULT_COMM if comm is None else comm
    if comm.wire_format != "topk":
        raise ValueError(
            "make_topk_ef_update requires CommConfig(wire_format='topk'); "
            f"got {comm.wire_format!r}")
    up = UpdatePlan.build(optimizer, mesh, data_axes, comm, recorder)

    @torch.no_grad()
    def init_fn(params):
        dev = tree_leaves(params)[0].device
        residual = [mesh.replicated(torch.zeros(
            b.padded_size, dtype=torch.float32, device=dev)).contiguous()
            for b in up.buckets(params).buckets]
        return {"residual": residual, "zero1": up.init_fn(params)}

    def reduce(sched, plan, grads, opt_state):
        return topk_ef_reduce(up, sched, plan, grads, opt_state["residual"])

    def apply(sched, plan, params, g_strips, opt_state, lr):
        new_p_strips, inner = up.apply(sched, plan, params, g_strips,
                                       opt_state["zero1"], lr)
        return (up.broadcast(sched, plan, params, new_p_strips),
                {"residual": opt_state["residual"], "zero1": inner})

    return init_fn, DistUpdate(up, reduce, apply)


class ModelGatheredUpdate:
    """A :class:`DistUpdate` (zero1, stale-sync, gossip, top-k) at
    model_ways > 1 (module docstring): ``params`` and ``grads`` enter in
    ``ctx``'s member layout (``specs``: the param ``Spec`` tree); the
    inner update, built on ``mesh.data_view()``, sees them whole, and its
    state is the strip state of ``model_ways=1``.  The halves are
    ``DistUpdate``'s, for a process mesh's train step."""

    def __init__(self, inner: DistUpdate, ctx: ShardingCtx, specs):
        self.inner, self.ctx, self.specs = inner, ctx, specs
        self.plan = inner.plan

    def _scatter(self, params, full):
        """Each member keeps its columns of the updated full params."""
        for p, f in zip(tree_leaves(params),
                        tree_leaves(self.ctx.place(full, self.specs))):
            if p is not f:
                p.copy_(f)
        return params

    @torch.no_grad()
    def __call__(self, params, grads, opt_state, lr, step=0):
        full = self.ctx.full(params, self.specs)
        full, opt_state = self.inner(full, self.ctx.full(grads, self.specs),
                                     opt_state, lr, step)
        return self._scatter(params, full), opt_state

    @torch.no_grad()
    def reduce(self, params, grads, opt_state, step=0):
        full = self.ctx.full(grads, self.specs)
        return self.inner.reduce(full, full, opt_state, step)

    @torch.no_grad()
    def local(self, params, g_strips, opt_state, lr, step=0):
        full, opt_state = self.inner.local(
            self.ctx.full(params, self.specs), g_strips, opt_state, lr, step)
        return self._scatter(params, full), opt_state


def make_model_gathered(make_update, optimizer, mesh, ctx: ShardingCtx,
                        specs, **kw):
    """``make_update`` (one of this module's constructors) at the model
    ways of ``mesh``: ``(init_fn, update_fn)`` over ``mesh.data_view()``,
    wrapped in :class:`ModelGatheredUpdate`; its ``init_fn`` takes the
    member-layout params.  At model_ways 1 it is ``make_update`` itself."""
    if mesh.model_ways == 1:
        return make_update(optimizer, mesh, **kw)
    init_fn, update = make_update(optimizer, mesh.data_view(), **kw)
    return (lambda params: init_fn(ctx.full(params, specs)),
            ModelGatheredUpdate(update, ctx, specs))


def _data_dim(spec, axes) -> Optional[int]:
    """The dim of ``spec`` that holds the data axes ``axes``, None when no
    dim holds any, and -1 when they sit on several dims (FSDP's
    ``"embed_fsdp"`` on one, the other data axes on another: mixtral's
    zero1-gspmd state with ``pods > 1``)."""
    dims = [i for i, e in enumerate(spec)
            if set(entry_axes(e)) & {"pod", "data"}]
    if not dims:
        return None
    if len(dims) > 1 or tuple(entry_axes(spec[dims[0]])) != tuple(axes):
        return -1
    return dims[0]


def _data_only(spec) -> tuple:
    """``spec`` with its model entries dropped: the data axes' placement
    of a block that every model member of a data group holds alike."""
    return tuple(None if "model" in entry_axes(e) else e for e in spec)


class GspmdUpdate:
    """The reference's GSPMD update modes over ``mesh`` (module docstring):
    ``dp`` (``zero1=False``) and ``zero1-gspmd`` (``zero1=True``).  Params
    and gradients are in ``ctx``'s member layout (``specs``: the param
    ``Spec`` tree).  The dp state has the params' layout; the zero1-gspmd
    state the member layout of :func:`~repro_torch.core.sharding.
    zero1_state_spec` (on a local mesh ``(G, M, ...)`` for a weight whose
    rows take the data strip), the reference's ``opt_state`` placed by
    ``zero1_state_shardings``.

    On a local mesh every member's gradient is the whole batch's, so the
    mean over the data axes is the gradient itself and the reduce-scatter
    is a re-layout into strips.  On a process mesh each rank's gradient is
    of its data group's rows: dp takes the mean over the data axes with
    ``all_reduce``, zero1-gspmd each leaf's ``reduce_scatter_tensor`` along
    its state's data dim.  On a cluster mesh a rank's gradient is of its
    pod's rows, which all its members share: the mean over the data axes is
    the mean over the pods, one ``all_reduce`` a leaf, and the rest is the
    local mesh's (a state strip over ``"pod"`` holds the rank's pod block).
    Each refuses a card's buffers over gloo, as
    ``core.collectives.part_reduce`` does (the sums would run in host
    memory).

    update_fn(params, grads, opt_state, lr, step=0) -> (params, opt_state),
    both advanced in place; ``reduce`` and ``local`` are its halves and
    ``clip`` the norm and clip between them (``train.make_train_step``)."""

    def __init__(self, optimizer, mesh, ctx: ShardingCtx, specs,
                 zero1: bool):
        self.optimizer, self.mesh, self.zero1 = optimizer, mesh, zero1
        self.axes, self.axis_arg, self.G = group_axes(mesh, mesh.data_axes)
        self.plan = self            # the train step reads mesh, axis_arg, G
        leaves = tree_leaves(specs)
        self.held = [ctx.held(s) for s in leaves]
        self.strip = [zero1_state_spec(s.axes, s.shape, mesh, ctx.rules)
                      for s in leaves] if zero1 else self.held

    def _map(self, fn, tree, *others):
        """``fn(i, leaf, *other_leaves)`` over a tree of the params'
        structure, i the leaf's index."""
        its = [iter(tree_leaves(o)) for o in others]
        idx = iter(range(len(self.held)))
        return map_tree(lambda x: fn(next(idx), x, *(next(i) for i in its)),
                        tree)

    def _data_group(self, buf, axes=None):
        pg = self.mesh.group(self.axes if axes is None else axes)[0]
        if coll.gloo_stages(buf, pg):
            raise NotImplementedError(
                "the plain all-reduce or reduce-scatter of a card's buffers "
                "over gloo would sum them in host memory: run dp and "
                "zero1-gspmd over NCCL (one rank per card), or zero1 on the "
                "pallas-ring backend")
        return pg

    def _strips(self, tree):
        """Each member's strips of a param-layout tree (no reduction)."""
        if not self.zero1:
            return tree
        if self.mesh.member_dims:
            return self._map(lambda i, x: to_members(
                from_members(x, self.held[i], self.mesh), self.strip[i],
                self.mesh), tree)

        def own(i, x):
            if _data_dim(self.strip[i], self.axes) is None:
                return x.clone()
            return to_members(x, _data_only(self.strip[i]), self.mesh)
        return self._map(own, tree)

    @torch.no_grad()
    def init_fn(self, params):
        return self.optimizer.init(self._strips(params))

    def _pod_mean(self, g):
        """The mean of a cluster rank's pod gradient over the pods, in
        place."""
        import torch.distributed as dist
        P = self.mesh.n_ranks
        coll.dist_call("all-reduce", g, P, dist.all_reduce, g,
                       group=self._data_group(g, ("pod",)))
        return g.div_(P)

    @torch.no_grad()
    def reduce(self, params, grads, opt_state, step=0):
        """The mean gradient over the data axes, in the state's layout."""
        if self.mesh.pod_across_ranks:
            grads = self._map(lambda i, g: self._pod_mean(g), grads)
        if self.mesh.member_dims or self.G == 1:
            return self._strips(grads)
        import torch.distributed as dist

        def one(i, g):
            pg = self._data_group(g)
            k = _data_dim(self.strip[i], self.axes) if self.zero1 else None
            if k is None or k < 0:
                # the mean whole, then (data axes on several dims) the
                # member's strip of it
                coll.dist_call("all-reduce", g, self.G, dist.all_reduce,
                               g, group=pg)
                g.div_(self.G)
                return g if k is None else to_members(
                    g, _data_only(self.strip[i]), self.mesh)
            x = g.movedim(k, 0).contiguous()
            out = x.new_empty(x.shape[0] // self.G, *x.shape[1:])
            coll.dist_call("reduce-scatter", x, self.G,
                           dist.reduce_scatter_tensor, out, x, group=pg)
            return out.div_(self.G).movedim(0, k).contiguous()
        return self._map(one, grads)

    @torch.no_grad()
    def local(self, params, g, opt_state, lr, step=0):
        """The optimizer on each member's strips, then (zero1-gspmd) the
        params gathered back from the updated strips, in place."""
        if not self.zero1:
            return self.optimizer.update(g, opt_state, params, lr)
        strips, opt_state = self.optimizer.update(g, opt_state,
                                                  self._strips(params), lr)

        def back(i, p, s):
            if self.mesh.member_dims:
                p.copy_(to_members(from_members(s, self.strip[i], self.mesh),
                                   self.held[i], self.mesh))
                return p
            if _data_dim(self.strip[i], self.axes) is None or self.G == 1:
                return p.copy_(s)
            return p.copy_(from_members(s, _data_only(self.strip[i]),
                                        self.mesh))
        self._map(back, params, strips)
        return params, opt_state

    def __call__(self, params, grads, opt_state, lr, step=0):
        return self.local(params, self.reduce(params, grads, opt_state, step),
                          opt_state, lr, step)

    @torch.no_grad()
    def clip(self, g, grad_clip: float) -> torch.Tensor:
        """The global norm of the reduced gradient ``g`` (the state's
        layout) and ``g`` clipped to ``grad_clip`` in place.  A block held
        by several members (replicated over an axis its spec does not use)
        counts once: on a process mesh only where its coordinate on those
        axes is 0, before the sum over every rank; on a cluster mesh, whose
        ranks hold their members' blocks once each, a block the pods share
        only on rank 0."""
        mesh = self.mesh
        sq = []
        for i, x in enumerate(tree_leaves(g)):
            used = used_axes(self.strip[i], mesh)
            if mesh.pod_across_ranks:
                if "pod" not in used and mesh.rank:
                    continue
            elif not mesh.member_dims:
                c = mesh.coords(mesh.member)
                if any(c[a] for a in mesh.axis_names if a not in used):
                    continue
            sq.append(torch.sum(torch.square(x.float())))
        total = sum(sq) if sq else torch.zeros((), device=mesh.device)
        if mesh.pod_across_ranks:
            total = mesh.one(coll.psum(mesh.replicated(total), mesh, "pod"))
        elif not mesh.member_dims:
            total = coll.psum(total, mesh, mesh.axis_names)
        gnorm = torch.sqrt(total)
        if grad_clip > 0:
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for x in tree_leaves(g):
                x.mul_(scale)
        return gnorm
