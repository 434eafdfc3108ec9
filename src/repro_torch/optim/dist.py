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

Backprop overlap, stale-sync, gossip and top-k error feedback are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

import torch

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
from repro_torch.core.params import tree_leaves

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
    which strip."""
    optimizer: Any
    mesh: Any
    axes: Tuple[str, ...]
    axis_arg: Any                  # single-name-or-tuple collective form
    G: int
    comm: CommConfig

    @classmethod
    def build(cls, optimizer, mesh, data_axes=("data",),
              comm: Optional[CommConfig] = DEFAULT_COMM) -> "UpdatePlan":
        """``comm=None`` selects the per-tensor schedule: one bucket per
        leaf (``bucket_bytes=0``)."""
        axes, axis_arg, G = group_axes(mesh, data_axes)
        if comm is None:
            comm = CommConfig(bucket_bytes=0)
        return cls(optimizer, mesh, axes, axis_arg, G, comm)

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
        return [reduce_mean(sched,
                            self.mesh.replicated(pack_bucket(flat_grads, b)),
                            self.comm.wire_dtype, self.G)
                for b in plan.buckets]

    def apply(self, sched: Schedule, plan: BucketPlan, params, g_strips,
              opt_state, lr):
        """Phases 2-3: each member's param strips through the serial
        optimizer on its state rows (elementwise, so fusing tensors into one
        buffer does not change the math).  Updates the strips and the state
        in place and returns them."""
        p_strips = self._own_strips(tree_leaves(params), plan,
                                    sched.owner_index())
        return self.optimizer.update(g_strips, opt_state, p_strips, lr)

    def broadcast(self, sched: Schedule, plan: BucketPlan, params,
                  new_p_strips):
        """Phase 4: one f32 part-broadcast per bucket, each unpacked (one
        member's copy of the gathered buffer) into the params in place
        before the next bucket is gathered."""
        flat_params = tree_leaves(params)
        for strips, b in zip(new_p_strips, plan.buckets):
            full = sched.broadcast(strips)
            for i, leaf in unpack_bucket(self.mesh.one(full), b):
                flat_params[i].copy_(leaf)
        return params


def make_distributed_update(optimizer, mesh, data_axes=("data",),
                            comm: Optional[CommConfig] = DEFAULT_COMM):
    """Build ``(init_fn, update_fn)`` realizing the paper's update over
    ``mesh``: the reduce -> apply -> broadcast pipeline of one
    :class:`UpdatePlan`.  Params and grads enter as the full trees (every
    member's gradient is the global one); the optimizer state lives as
    per-bucket strips (``init_fn``).  ``update_fn`` advances the params and
    the state in place and returns them.

    update_fn(params, grads, opt_state, lr, step=0)
        -> (params, new_opt_state)
    """
    up = UpdatePlan.build(optimizer, mesh, data_axes, comm)

    @torch.no_grad()
    def update_fn(params, grads, opt_state, lr, step=0):
        plan = up.buckets(params)
        sched = up.schedule(step)
        g_strips = up.reduce(sched, plan, grads)
        new_p_strips, new_state = up.apply(sched, plan, params, g_strips,
                                           opt_state, lr)
        return up.broadcast(sched, plan, params, new_p_strips), new_state

    return up.init_fn, update_fn
