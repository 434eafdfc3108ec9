"""Collective schedules for the bucketed gradient reduction, paper §3.4
(``repro.comm.schedule``).

Both schedules implement the reference's contract over a mesh
(``launch.mesh``): ``reduce`` turns each member's fusion buffer of partial
sums into that member's 1-D strip (sum over the group, f32 out),
``broadcast`` is its exact inverse on updated strips, and ``owner_index`` is
the flat strip index each member owns (a tuple, one per member, on a local
mesh; this rank's int on a process mesh).  Member tensors follow the mesh:
``(M, N)`` on a local mesh, ``(N,)`` on a process mesh.

The wire collectives go through a backend (``comm.backends``); schedules own
the wire-dtype casts and the level composition.

FlatSchedule
    One ring over the (possibly composed) group.
HierarchicalSchedule (paper §3.3/§3.4 group composition)
    For ``("pod", "data")``: the in-pod reduce-scatter over ``data`` first
    (wire dtype), then the cross-pod hop over ``pod`` on the 1/G_in strips
    in f32.  Member ``(p, d)`` owns flat strip ``d * G_out + p``;
    ``broadcast`` inverts with all-gathers in the opposite order.  On a local
    mesh each level runs once per group: per pod in-pod, per data index
    across pods.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.comm.backends import (
    CollectiveBackend,
    LaxBackend,
    get_backend,
)
from repro_torch.core.collectives import (
    AxisNames,
    flat_group_index,
    group_index,
)


def group_axes(mesh, data_axes) -> Tuple[Tuple[str, ...], AxisNames, int]:
    """(axes, axis_arg, G) for the data-parallel group present on ``mesh``:
    the requested axes filtered to the mesh's data axes (the model axis is
    never one: the §3.4 update runs over the data members), the
    single-name-or-tuple form the collectives take, and the group size."""
    axes = tuple(a for a in data_axes if a in mesh.data_axes)
    axis_arg = axes if len(axes) > 1 else axes[0]
    G = 1
    for a in axes:
        G *= mesh.shape[a]
    return axes, axis_arg, G


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a member tensor without materialising a stride-0 member
    dimension (one buffer viewed by every member of a local mesh)."""
    if x.dim() == 2 and x.shape[0] > 1 and x.stride(0) == 0:
        return x[0].to(dtype).expand(x.shape)
    return x.to(dtype)


@dataclass(frozen=True)
class FlatSchedule:
    """Single-level ring over all data axes at once."""
    mesh: Any
    axes: AxisNames
    backend: CollectiveBackend = field(default_factory=LaxBackend)

    def owner_index(self):
        return flat_group_index(self.mesh, self.axes)

    def reduce(self, buf: torch.Tensor, wire_dtype=torch.float32
               ) -> torch.Tensor:
        strip = self.backend.part_reduce(_cast(buf, wire_dtype), self.mesh,
                                         self.axes)
        return strip.float()

    def broadcast(self, strip: torch.Tensor) -> torch.Tensor:
        return self.backend.part_broadcast(strip, self.mesh, self.axes)


@dataclass(frozen=True)
class HierarchicalSchedule:
    """Two-level in-pod (``inner``) + cross-pod (``outer``) schedule, with
    a backend per level."""
    mesh: Any
    outer: str
    inner: str
    inner_backend: CollectiveBackend = field(default_factory=LaxBackend)
    outer_backend: CollectiveBackend = field(default_factory=LaxBackend)

    def owner_index(self):
        # stage 1 scatters chunk d to inner member d; stage 2 scatters
        # sub-chunk p of chunk d to outer member p -> flat strip d*G_out + p
        g_out = self.mesh.shape[self.outer]
        return self.mesh.per_member(
            lambda m: group_index(self.mesh, self.inner, m) * g_out
            + group_index(self.mesh, self.outer, m))

    def reduce(self, buf: torch.Tensor, wire_dtype=torch.float32
               ) -> torch.Tensor:
        in_pod = self.inner_backend.part_reduce(_cast(buf, wire_dtype),
                                                self.mesh, self.inner)
        # cross-pod hop: strip bytes only, always f32 accumulate
        return self.outer_backend.part_reduce(in_pod.float(), self.mesh,
                                              self.outer)

    def broadcast(self, strip: torch.Tensor) -> torch.Tensor:
        in_pod = self.outer_backend.part_broadcast(strip, self.mesh,
                                                   self.outer)
        return self.inner_backend.part_broadcast(in_pod, self.mesh,
                                                 self.inner)


Schedule = Union[FlatSchedule, HierarchicalSchedule]


def bind_step(backend: CollectiveBackend, step) -> CollectiveBackend:
    """Bind the train-step index into a step-scheduled backend (the gossip
    partner rotation); step-free backends (lax, pallas-ring) pass
    through."""
    binder = getattr(backend, "bind_step", None)
    return backend if binder is None else binder(step)


def bind_wire_format(backend: CollectiveBackend, wire_format: Optional[str],
                     topk_ratio: float = 0.05) -> CollectiveBackend:
    """Bind ``CommConfig.wire_format`` into a backend that takes one: bound
    to ``int8`` or ``topk``, ``part_reduce`` runs the compressed ring
    (``fp32`` and ``bf16`` are the schedule's wire-dtype cast).  Both levels
    of the hierarchical schedule are bound, so its cross-pod hop (the lax
    backend by default) runs the compressed ring on the oracles."""
    if wire_format is None:
        return backend
    binder = getattr(backend, "bind_wire_format", None)
    return backend if binder is None else binder(wire_format, topk_ratio)


def reduce_mean(sched: Schedule, buf: torch.Tensor, wire_dtype,
                G: int) -> torch.Tensor:
    """THE reduce phase for one fusion buffer: wire-dtype part-reduce
    through the schedule, mean in f32."""
    return sched.reduce(buf, wire_dtype) / G


def make_schedule(mesh, axes: AxisNames, hierarchical: bool = False,
                  backend: Union[str, CollectiveBackend] = "lax",
                  cross_backend: Union[str, CollectiveBackend, None] = None,
                  step=None, wire_format: Optional[str] = None,
                  topk_ratio: float = 0.05) -> Schedule:
    """Pick the schedule for ``axes`` of ``mesh`` and bind its backend(s).

    The hierarchical form needs exactly two axes ``(outer, inner)``; one
    axis degrades to the flat ring, more than two raise.  ``backend`` drives
    the flat ring or the in-pod level; ``cross_backend`` (default
    ``"lax"``) the cross-pod hop.  ``step`` is bound into step-scheduled
    backends, ``wire_format`` into both levels."""
    def resolve(b):
        b = get_backend(b)
        b = b if step is None else bind_step(b, step)
        return bind_wire_format(b, wire_format, topk_ratio)

    if hierarchical and not isinstance(axes, str) and len(axes) > 2:
        raise ValueError(
            "hierarchical schedule composes exactly two axes "
            f"(outer, inner); got {len(axes)}: {axes}. Fold the extra axes "
            "into the mesh topology (e.g. one 'pod' x one 'data' axis) or "
            "use hierarchical=False for a single flat ring.")
    if hierarchical and not isinstance(axes, str) and len(axes) == 2:
        return HierarchicalSchedule(
            mesh=mesh, outer=axes[0], inner=axes[1],
            inner_backend=resolve(backend),
            outer_backend=resolve(
                "lax" if cross_backend is None else cross_backend))
    return FlatSchedule(mesh=mesh, axes=axes, backend=resolve(backend))
