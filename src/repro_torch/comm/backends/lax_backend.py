"""The plain backend (``repro.comm.backends.lax_backend``): the collectives
of ``core.collectives``, which the ring backend is held against.

The reference's compressed wire formats (``int8`` / ``topk``) run a jnp
ring here; they are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.collectives import AxisNames


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

    def _compressed_part_reduce(self, x, mesh, axis_name):
        raise NotImplementedError(
            f"wire_format={self.wire_format!r} is not ported yet: the port "
            "moves fp32 and bf16")
