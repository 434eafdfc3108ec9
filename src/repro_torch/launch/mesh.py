"""Meshes of data-parallel members (``repro.launch.mesh``).

The reference runs G members as G devices of a ``jax`` mesh, on the CPU as
G forced host devices.  The port has two kinds of mesh with the same axes,
``("data",)`` or ``("pod", "data")`` when ``pods > 1``:

:class:`LocalMesh`    all G members on one device: a member tensor carries a
                      leading dimension of G in flat member order (row-major
                      over the axes, ``core.collectives.flat_group_index``).
                      This is how one card runs the §3.4 update of G members;
                      its ring is the reference's stacked single-core ring.
:class:`ProcessMesh`  one member per rank of an initialised
                      ``torch.distributed`` group; member tensors carry no
                      member dimension.

Which layout a member tensor has is the mesh's one decision: the
collectives, backends, schedules and ``optim.dist.UpdatePlan`` are written
once against the methods below (``member_dims``, ``per_member``,
``replicated``, ``own``, ``one``, ``map_members`` and ``collective``), which
each mesh implements for its layout.

Model ways (the reference's ``"model"`` axis) are not ported: a
``model_ways > 1`` raises.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _axes_for(pods: int) -> Tuple[str, ...]:
    return ("pod", "data") if pods > 1 else ("data",)


def _check_extents(members: int, pods: int, model_ways: int) -> None:
    if model_ways != 1:
        raise NotImplementedError(
            f"model_ways={model_ways}: model-parallel meshes are not ported "
            "yet; the port's meshes are data-parallel only")
    if pods < 1 or members < 1 or members % pods:
        raise ValueError(f"{members} members do not split into {pods} pods")


class _Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, member: int) -> Dict[str, int]:
        """Axis coordinates of flat member index ``member`` (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            member, out[a] = divmod(member, self.shape[a])
        return out

    def groups(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """The member groups of a collective over ``axes`` (in mesh order):
        one group per coordinate of the other axes, each listing its flat
        member indices in flat group order."""
        if list(axes) != [a for a in self.axis_names if a in axes]:
            raise ValueError(f"axes {axes} must be a subset of the mesh's "
                             f"{self.axis_names}, in that order")
        out: Dict[tuple, List[int]] = {}
        for m in range(self.size):
            c = self.coords(m)
            out.setdefault(tuple(c[a] for a in self.axis_names
                                 if a not in axes), []).append(m)
        return [out[k] for k in sorted(out)]


def member_rows(x: torch.Tensor, members: Sequence[int]) -> torch.Tensor:
    """Rows ``members`` of a local-mesh tensor: a view when they are evenly
    spaced (every group of a one- or two-axis mesh is), a copy otherwise."""
    step = members[1] - members[0] if len(members) > 1 else 1
    if step > 0 and all(b - a == step for a, b in zip(members, members[1:])):
        return x[members[0]:members[-1] + 1:step]
    return x[list(members)]


Collective = Callable[[torch.Tensor], torch.Tensor]


class LocalMesh(_Mesh):
    """G members held on one device along a leading member dimension."""
    member_dims = 1

    def per_member(self, fn: Callable[[int], int]) -> Tuple[int, ...]:
        """``fn`` of every flat member index, one per member row."""
        return tuple(fn(m) for m in range(self.size))

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """Every member's copy of the same tensor: a view, no copy."""
        return x.expand(self.size, *x.shape)

    def own(self, rows: torch.Tensor, owner: Tuple[int, ...]
            ) -> torch.Tensor:
        """Each member's row of a ``(G, ...)`` tensor of strips, ``owner``
        being ``per_member`` of the strip each member owns."""
        return member_rows(rows, owner)

    def one(self, x: torch.Tensor) -> torch.Tensor:
        """One member's copy of a member tensor every member holds alike."""
        return x[0]

    def map_members(self, x: torch.Tensor, fn: Collective) -> torch.Tensor:
        """``fn`` on each member's tensor."""
        return torch.stack([fn(r) for r in x])

    def collective(self, x: torch.Tensor, axes: Tuple[str, ...],
                   stacked: Collective, over_ranks: Collective
                   ) -> torch.Tensor:
        """A collective over ``axes``: ``stacked`` on each group's ``(G,
        ...)`` member rows, its result rows going back to the group's
        members (``over_ranks`` is the process mesh's form)."""
        groups = self.groups(axes)
        if len(groups) == 1:
            return stacked(member_rows(x, groups[0]))
        outs: List[torch.Tensor] = [stacked(member_rows(x, g))
                                    for g in groups]
        out = outs[0].new_empty(x.shape[0], *outs[0].shape[1:])
        for g, o in zip(groups, outs):
            out[list(g)] = o
        return out

    def __init__(self, members: int, pods: int = 1, model_ways: int = 1,
                 device: Optional[torch.device] = None):
        _check_extents(members, pods, model_ways)
        self.axis_names = _axes_for(pods)
        self.shape = dict(zip(self.axis_names,
                              (pods, members // pods) if pods > 1
                              else (members,)))
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, device={self.device})"


class ProcessMesh(_Mesh):
    """One member per rank of the initialised default process group, flat
    member index = rank.  Builds one process group per collective axis set
    (every rank must construct the mesh, in the same order)."""
    member_dims = 0

    def __init__(self, pods: int = 1, model_ways: int = 1,
                 device: Optional[torch.device] = None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        _check_extents(world, pods, model_ways)
        self.axis_names = _axes_for(pods)
        self.shape = dict(zip(self.axis_names,
                              (pods, world // pods) if pods > 1
                              else (world,)))
        self.rank = dist.get_rank()
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self._groups = {}
        subsets = [self.axis_names] + ([(a,) for a in self.axis_names]
                                       if pods > 1 else [])
        for axes in subsets:
            for ranks in self.groups(axes):
                pg = dist.group.WORLD if len(ranks) == world \
                    else dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = (pg, ranks)

    def group(self, axes: Tuple[str, ...]):
        """(process group, its global ranks in flat group order) of this
        rank's group over ``axes``."""
        return self._groups[tuple(axes)]

    def per_member(self, fn: Callable[[int], int]) -> int:
        return fn(self.rank)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def own(self, rows: torch.Tensor, owner: int) -> torch.Tensor:
        return rows[owner]

    def one(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def map_members(self, x: torch.Tensor, fn: Collective) -> torch.Tensor:
        return fn(x)

    def collective(self, x: torch.Tensor, axes: Tuple[str, ...],
                   stacked: Collective, over_ranks: Collective
                   ) -> torch.Tensor:
        """A collective over ``axes``: ``over_ranks`` on this rank's buffer
        (``stacked`` is the local mesh's form)."""
        return over_ranks(x)

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def make_local_mesh(members: int, pods: int = 1, model_ways: int = 1,
                    device=None) -> LocalMesh:
    """``members`` data-parallel members on ``device``, in ``pods`` pods."""
    return LocalMesh(members, pods, model_ways, device)


def make_process_mesh(pods: int = 1, model_ways: int = 1,
                      device=None) -> ProcessMesh:
    """One member per rank of the initialised ``torch.distributed`` group,
    in ``pods`` pods of consecutive ranks."""
    return ProcessMesh(pods, model_ways, device)
