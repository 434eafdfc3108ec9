"""The ``CollectiveBackend`` protocol (``repro.comm.backends.base``); the
package docstring states the contract."""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.collectives import AxisNames


@runtime_checkable
class CollectiveBackend(Protocol):
    """One implementation of the paper's three group collectives over a
    mesh's ``axis_name`` (one axis or a tuple).

    name:            registry id (``COLLECTIVE_BACKENDS``).
    part_reduce:     reduce each member's 1-D buffer over the group and
                     scatter strips: flat group member i
                     (``collectives.flat_group_index``) receives the fully
                     reduced chunk i.
    part_broadcast:  the exact inverse on strips: every member ends with
                     the group's strips in owner order.
    psum:            full all-reduce, any member shape.

    Member tensors follow the mesh (``launch.mesh``): ``(M, ...)`` with one
    row per member on a local mesh, this rank's tensor on a process mesh.
    All three reduce in the dtype they are handed and return it (the
    schedules own the wire-dtype casts).
    """
    name: str

    def part_reduce(self, x: torch.Tensor, mesh,
                    axis_name: AxisNames) -> torch.Tensor:
        ...

    def part_broadcast(self, x: torch.Tensor, mesh,
                       axis_name: AxisNames) -> torch.Tensor:
        ...

    def psum(self, x: torch.Tensor, mesh, axis_name: AxisNames
             ) -> torch.Tensor:
        ...
