"""The plain backend (``repro.comm.backends.lax_backend``): the collectives
of ``core.collectives``, which the ring backend is held against.

The compressed wire formats (``int8`` / ``topk``, bound by the schedule
layer) have no dense reduce-scatter, so for them this backend runs the ring
backend's schedule with the hop math of the ``kernels.ref`` oracles (plain
PyTorch, no kernel), as the reference's does with jnp: the plain path the
ring's kernels are held against.  It is the hierarchical schedule's default
cross-pod level.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.comm.backends.ring import WireOps, wire_part_reduce
from repro_torch.core import collectives as coll
from repro_torch.core.collectives import (
    AxisNames,
    axes_tuple,
    axis_size,
    flat_reduce,
    split_levels,
)
from repro_torch.kernels import ref as kref

ORACLE_OPS = WireOps(kref.int8_quantize_ref, kref.ring_hop_int8_ref,
                     kref.topk_select_ref, kref.ring_hop_topk_ref)


@dataclass(frozen=True)
class LaxBackend:
    name: str = "lax"
    wire_format: str = "fp32"
    topk_ratio: float = 0.05

    def bind_wire_format(self, wire_format: str,
                         topk_ratio: float) -> "LaxBackend":
        return dataclasses.replace(self, wire_format=wire_format,
                                   topk_ratio=topk_ratio)

    def part_reduce(self, x: torch.Tensor, mesh,
                    axis_name: AxisNames) -> torch.Tensor:
        if self.wire_format in ("int8", "topk"):
            return self._compressed_part_reduce(x, mesh, axis_name)
        return coll.part_reduce(x, mesh, axis_name)

    def part_broadcast(self, x: torch.Tensor, mesh,
                       axis_name: AxisNames) -> torch.Tensor:
        return coll.part_broadcast(x, mesh, axis_name)

    def psum(self, x: torch.Tensor, mesh, axis_name: AxisNames
             ) -> torch.Tensor:
        return coll.psum(x, mesh, axis_name)

    def _compressed_part_reduce(self, x: torch.Tensor, mesh,
                                axis_name: AxisNames) -> torch.Tensor:
        """The §3.4 ring with compressed wire messages, hop math straight
        from the ``kernels.ref`` oracles (``lax_backend.py:57-97``)."""
        if x.dim() != 1 + mesh.member_dims:
            raise NotImplementedError(
                "compressed wire formats take the schedules' canonical 1-D "
                f"fusion buffers (one per member); got shape "
                f"{tuple(x.shape)}")
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        if x.shape[-1] % G:
            raise ValueError(f"buffer size {x.shape[-1]} not a strip "
                             f"multiple of group {G}")
        if split_levels(mesh, axes_tuple(axis_name)):
            return flat_reduce(x, mesh, axes_tuple(axis_name),
                               self._compressed_part_reduce)
        return wire_part_reduce(x, mesh, axes_tuple(axis_name),
                                self.wire_format, self.topk_ratio, ORACLE_OPS)
