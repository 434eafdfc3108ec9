"""Meshes of members (``repro.launch.mesh``).

The reference runs its members as the devices of a ``jax`` mesh, on the
CPU as forced host devices.  The port has two kinds of mesh with the
reference's axes, ``("data", "model")``, or ``("pod", "data", "model")``
when ``pods > 1``: the G = pods x data data-parallel members of the
paper's §3.3 groups, each group split ``model_ways`` ways.  Flat member
index m is row-major over the axes, so the model members of one data group
are consecutive.

:class:`LocalMesh`    all G x model_ways members on one device: a member
                      tensor carries a leading dimension of the member
                      count in flat member order
                      (``core.collectives.flat_group_index``).  This is how
                      one card runs the §3.4 update of G members; its ring
                      is the reference's stacked single-core ring.
:class:`ProcessMesh`  one member per rank of an initialised
                      ``torch.distributed`` group, rank = flat member index;
                      member tensors carry no member dimension.  Each axis
                      set has its own process group (the model group and
                      the data group of every rank among them).

Which layout a member tensor has is the mesh's one decision: the
collectives, backends, schedules, ``optim.dist.UpdatePlan``, the data
placer and the checkpoints are written once against the methods below
(``member_dims``, ``per_member``, ``replicated``, ``own``, ``one``,
``map_members``, ``collective``, ``gather_members``, ``batch_shard`` and
``model_blocks``), which each mesh implements for its layout.  A local
mesh's members all see the full batch; a process mesh's rank sees its data
group's rows of it, the same rows as the other model members of its group.

The §3.4 strip update runs over the data axes alone, on ``data_view()``:
the mesh of the G data members (model axis 1), which the model members of
a group share (``optim.dist.ModelGatheredUpdate``).  The model-sharded
params and the model-axis collectives are ``core.sharding`` and
``core.collectives``.

:func:`make_production_mesh` is the reference's 256- or 512-member mesh
on the ``meta`` device, which the dry run plans on; its members' programs
run on :meth:`ProcessMesh.member_view`.  :func:`make_host_mesh` factors
the devices it is given as the reference's does.
:func:`make_cluster_mesh` is the mesh of a cluster run
(``MeshSpec(cluster=True)``): one member a process, the pod axis the
process boundary; it refuses model ways (ROADMAP Queue A item 9d).

A mesh's device defaults to the GPU (``device.resolve_device``): pass
``device="cpu"`` to hold the members on the CPU.
"""
from __future__ import annotations

import itertools
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


def _axes_for(pods: int) -> Tuple[str, ...]:
    return ("pod", "data", "model") if pods > 1 else ("data", "model")


def _shape_for(data_members: int, pods: int, model_ways: int
               ) -> Dict[str, int]:
    """The axes' extents of ``data_members`` data members in ``pods`` pods,
    each split ``model_ways`` ways."""
    if (pods < 1 or model_ways < 1 or data_members < 1
            or data_members % pods):
        raise ValueError(f"{data_members} data members do not split into "
                         f"{pods} pods (model_ways={model_ways})")
    ext = ((pods, data_members // pods) if pods > 1
           else (data_members,)) + (model_ways,)
    return dict(zip(_axes_for(pods), ext))


def _divisible_factorization(n: int, model_ways: int, pods: int):
    """Largest factorization (model_ways', pods') with model_ways' <=
    model_ways and pods' <= pods such that ``pods' * model_ways'`` divides
    ``n``, so that the data axis absorbs every member.  Model ways take
    priority (shrinking the model group changes the math less than
    training on fewer members); always terminates at (1, 1)."""
    for mw in range(model_ways, 0, -1):
        for p in range(min(pods, n // mw), 0, -1):
            if n % (mw * p) == 0:
                return mw, p
    return 1, 1


def fit_world(n: int, model_ways: int = 1, pods: int = 1,
              what: str = "make_process_mesh", unit: str = "ranks"
              ) -> Tuple[int, int]:
    """(model_ways, pods) for a world of ``n`` members, as the reference's
    ``make_host_mesh`` clamps them: both counts clamped to what the world
    holds, and a request that does not divide it replaced, with a warning
    (``what`` names the caller, ``unit`` the members), by
    :func:`_divisible_factorization` (no member goes unused)."""
    model_ways = max(1, min(model_ways, n))
    pods = max(1, min(pods, n // model_ways))
    if n % (model_ways * pods):
        dropped = n - pods * (n // (model_ways * pods)) * model_ways
        mw2, p2 = _divisible_factorization(n, model_ways, pods)
        warnings.warn(
            f"{what}: model_ways={model_ways} x pods={pods} does not divide "
            f"the {n} {unit} and would silently drop {dropped} of them; "
            f"using the largest divisible factorization model_ways={mw2} x "
            f"pods={p2} instead (all {n} {unit.split()[-1]} used)",
            stacklevel=3)
        model_ways, pods = mw2, p2
    return model_ways, pods


class _Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The data-parallel group axes: ``("pod", "data")`` or
        ``("data",)``."""
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def data_size(self) -> int:
        """G, the data-parallel members (groups of the paper's §3.3)."""
        return math.prod(self.shape[a] for a in self.data_axes)

    @property
    def model_ways(self) -> int:
        return self.shape["model"]

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

    def gather_members(self, x: torch.Tensor) -> torch.Tensor:
        """The ``(G, ...)`` tensor of every member's rows: ``x`` itself."""
        return x

    batch_shard = None     # every member sees the whole batch

    def model_blocks(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each model member's block of a model-sharded leaf in member
        layout (``core.sharding``: ``(M, *block)``), contiguous views."""
        return x.unbind(0)

    def data_view(self) -> "LocalMesh":
        """The mesh of the G data members alone (module docstring)."""
        if self.model_ways == 1:
            return self
        return LocalMesh(self.data_size, self.shape.get("pod", 1),
                         device=self.device)

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
        """``members`` data members (``MeshSpec.members_per_device``) in
        ``pods`` pods, each split ``model_ways`` ways: members x model_ways
        members in all."""
        self.shape = _shape_for(members, pods, model_ways)
        self.axis_names = tuple(self.shape)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, device={self.device})"


class ProcessMesh(_Mesh):
    """One member per rank of the initialised default process group, flat
    member index = rank.  Builds one process group per set of axes (the
    model axis only when it is more than 1; every rank must construct the
    mesh, in the same order)."""
    member_dims = 0

    def __init__(self, pods: int = 1, model_ways: int = 1,
                 device: Optional[torch.device] = None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        model_ways, pods = fit_world(world, model_ways, pods)
        self.shape = _shape_for(world // model_ways, pods, model_ways)
        self.axis_names = tuple(self.shape)
        self.rank = self.member = dist.get_rank()
        self.device = resolve_device(device)
        self._groups = {}
        live = [a for a in self.axis_names
                if a != "model" or model_ways > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                for ranks in self.groups(axes):
                    pg = dist.group.WORLD if len(ranks) == world \
                        else dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = (pg, ranks)

    @classmethod
    def member_view(cls, shape: Dict[str, int], member: int = 0,
                    device="meta") -> "ProcessMesh":
        """Member ``member``'s view of a mesh of axes ``shape``, with no
        process group behind it: the program one member of the production
        mesh runs, on ``meta`` tensors (``launch.dryrun``).  Every
        collective it reaches is recorded by ``core.collectives``' counter
        and moves nothing; a group is ``(None, its ranks)``."""
        v = object.__new__(cls)
        v.shape = dict(shape)
        v.axis_names = tuple(shape)
        v.rank = v.member = member
        v.device = torch.device(device)
        v._groups = {}
        live = [a for a in v.axis_names if a != "model" or v.shape[a] > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                ranks = next(g for g in v.groups(axes) if member in g)
                v._groups[axes] = (None, ranks)
        return v

    def data_view(self) -> "ProcessMesh":
        """The mesh of the G data members alone (module docstring): this
        rank's data group, its member index the rank's place there; it
        shares this mesh's process groups."""
        if self.model_ways == 1:
            return self
        v = object.__new__(ProcessMesh)
        v.shape = {**self.shape, "model": 1}
        v.axis_names = self.axis_names
        v.rank, v.device = self.rank, self.device
        v.member = self._groups[self._key(self.data_axes)][1].index(
            self.rank)
        v._groups = {k: g for k, g in self._groups.items()
                     if "model" not in k}
        return v

    def _key(self, axes) -> Tuple[str, ...]:
        """``axes`` without a model axis of 1 (it changes no group)."""
        return tuple(a for a in axes
                     if a != "model" or self.shape["model"] > 1)

    def group(self, axes: Tuple[str, ...]):
        """(process group, its global ranks in flat group order) of this
        rank's group over ``axes``."""
        return self._groups[self._key(axes)]

    def per_member(self, fn: Callable[[int], int]) -> int:
        return fn(self.member)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def own(self, rows: torch.Tensor, owner: int) -> torch.Tensor:
        return rows[owner]

    def one(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def map_members(self, x: torch.Tensor, fn: Collective) -> torch.Tensor:
        return fn(x)

    def gather_members(self, x: torch.Tensor) -> torch.Tensor:
        """The ``(G, ...)`` tensor of every rank's ``x`` (rank order = flat
        member order), on every rank: a collective.  Over gloo a card's
        tensor is staged through host memory and the result stays there."""
        import torch.distributed as dist

        from repro_torch.core.collectives import dist_call, staged_for
        pg, ranks = self.group(self.data_axes)
        x = staged_for(x, pg).contiguous()
        out = x.new_empty(len(ranks) * x.numel())
        dist_call("all-gather", out, len(ranks),
                  dist.all_gather_into_tensor, out, x.reshape(-1),
                  group=pg)
        return out.view(len(ranks), *x.shape)

    @property
    def batch_shard(self) -> Tuple[int, int]:
        """(d, G), d this rank's data-group index: the rank keeps rows
        ``[d*B/G, (d+1)*B/G)`` of each global batch
        (``data.pipeline.make_placer``), as do the other model members of
        its group."""
        from repro_torch.core.collectives import group_index
        return (group_index(self, self.data_axes, self.member),
                self.data_size)

    def model_blocks(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """This rank's block of a model-sharded leaf: the leaf itself."""
        return (x,)

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
    """``members`` data-parallel members on ``device`` (default: the GPU),
    in ``pods`` pods, each split ``model_ways`` ways."""
    return LocalMesh(members, pods, model_ways, device)


def make_process_mesh(pods: int = 1, model_ways: int = 1,
                      device=None) -> ProcessMesh:
    """One member per rank of the initialised ``torch.distributed`` group,
    in ``pods`` pods of consecutive ranks, ``model_ways`` consecutive ranks
    a data group, on ``device`` (default: the GPU).  A world that
    ``model_ways x pods`` does not divide takes the largest divisible
    factorization, with a warning (:func:`fit_world`)."""
    return ProcessMesh(pods, model_ways, device)


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """The reference's production mesh (``repro.launch.mesh.
    make_production_mesh``): ``("data", "model")`` = ``(16, 16)``, 256
    members, or ``("pod", "data", "model")`` = ``(2, 16, 16)``, 512, on the
    ``meta`` device.  It allocates nothing: the dry run plans on it
    (``core.hybrid.plan``, ``launch.specs``) and counts one member's
    program on its :meth:`ProcessMesh.member_view`."""
    if multi_pod:
        return LocalMesh(32, pods=2, model_ways=16, device="meta")
    return LocalMesh(16, model_ways=16, device="meta")


def make_host_mesh(model_ways: int = 1, pods: int = 1,
                   devices: Optional[int] = None, device=None) -> LocalMesh:
    """Best-effort mesh over the devices given (``repro.launch.mesh.
    make_host_mesh``), for the examples and tests.  The reference's devices
    are ``jax.devices()``, on the CPU forced host devices; the port's are
    the members of one :class:`LocalMesh` on ``device`` (default: the
    GPU), ``devices`` of them (default: one per visible card on a card,
    else one).  Both counts are clamped to ``devices``, and a request that
    does not divide it (6 devices, model_ways=4) takes the largest
    divisible factorization, with the reference's warning, so that every
    device is used (:func:`fit_world`)."""
    dev = resolve_device(device)
    if devices is None:
        devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    model_ways, pods = fit_world(devices, model_ways, pods,
                                 "make_host_mesh", "visible devices")
    return LocalMesh(devices // model_ways, pods, model_ways, dev)


def mesh_devices(mesh) -> int:
    """The member count of ``mesh`` (the reference's device count)."""
    return math.prod(mesh.shape.values())


def make_cluster_mesh(model_ways: int = 1, device=None):
    """The mesh of a cluster run (``repro.launch.mesh.make_cluster_mesh``):
    the pod axis is the process boundary, one member a process, so axes
    ``("pod", "data", "model")`` = ``(world, 1, 1)`` over the live process
    group, and the reference's zero1 world layout for the same world.  With
    one process (no group, or a group of one) it is a one-member local
    mesh, as the reference falls back to the host mesh.  Model ways raise:
    a cluster of one member a process has none to split (ROADMAP Queue A
    item 9d), and shrinking a world with a model axis is later work.

    ``device`` defaults to the GPU: rank r takes ``cuda:(r % cards)``; pass
    ``device="cpu"`` for CPU ranks."""
    import torch.distributed as dist
    if model_ways != 1:
        raise NotImplementedError(
            f"model_ways={model_ways} on a cluster mesh is not ported yet "
            "(ROADMAP.md Queue A item 9d): a cluster runs one member a "
            "process; model ways run on make_local_mesh or "
            "make_process_mesh")
    world = dist.get_world_size() if dist.is_initialized() else 1
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if world == 1:
        return LocalMesh(1, device=dev)
    return ProcessMesh(pods=world, device=dev)
