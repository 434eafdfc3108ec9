"""Paper §3.4 — the two communication primitives, plain
(``repro.core.collectives``).

    part-reduce    = reduce partial tensors over a member group, scatter the
                     result strips  (MPI_Reduce_scatter)
    part-broadcast = every member broadcasts its strip to the group
                     (MPI_Allgather)

The reference calls them inside ``jax.shard_map``, where the mesh is
implicit; here the mesh is an argument (``launch.mesh``), and each
collective gives its two forms to ``mesh.collective``, which runs the one
that fits its layout:

* on a :class:`~repro_torch.launch.mesh.LocalMesh` a member tensor is
  ``(M, N)``, row m member m's buffer: part-reduce sums a group's rows and
  cuts the sum into strips, part-broadcast tiles a group's strips;
* on a :class:`~repro_torch.launch.mesh.ProcessMesh` a member tensor is this
  rank's ``(N,)`` buffer, and the two are ``reduce_scatter_tensor`` /
  ``all_gather_into_tensor`` over the group's process group.

These are the internals of the port's ``lax`` backend, the plain
collectives the ring backend is held against: the same strip ownership
(flat group member i owns chunk i) and the same wire-dtype semantics (they
reduce in the dtype they are handed).  They take the schedules' canonical
1-D buffers (one per member).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

AxisNames = Union[str, Tuple[str, ...]]


def axes_tuple(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_size(mesh, axis_name: AxisNames) -> int:
    return math.prod(mesh.shape[a] for a in axes_tuple(axis_name))


def group_index(mesh, axis_name: AxisNames, member: int) -> int:
    """Flat member ``member``'s index in its group over ``axis_name``:
    row-major over the axis tuple, THE strip-owner convention every backend
    shares."""
    c = mesh.coords(member)
    i = 0
    for a in axes_tuple(axis_name):
        i = i * mesh.shape[a] + c[a]
    return i


def flat_group_index(mesh, axis_name: AxisNames):
    """Each member's ``group_index``: a tuple with one int per member on a
    local mesh, this rank's int on a process mesh."""
    return mesh.per_member(lambda m: group_index(mesh, axis_name, m))


def _check_1d(x: torch.Tensor, mesh) -> None:
    if x.dim() != 1 + mesh.member_dims:
        raise NotImplementedError(
            "the collectives take one 1-D buffer per member (a (members, N) "
            f"tensor on a local mesh, (N,) on a process mesh); got shape "
            f"{tuple(x.shape)}. Flatten first (flatten_pad).")


def part_reduce(x: torch.Tensor, mesh, axis_name: AxisNames) -> torch.Tensor:
    """Reduce-scatter each member's buffer over the group: member i of the
    group receives the group sum of chunk i.  Paper Fig. 1."""
    _check_1d(x, mesh)
    axes = axes_tuple(axis_name)
    G = axis_size(mesh, axes)
    if x.shape[-1] % G:
        raise ValueError(f"buffer size {x.shape[-1]} not a strip multiple "
                         f"of group {G}")

    def over_ranks(buf):
        import torch.distributed as dist
        out = buf.new_empty(buf.shape[0] // G)
        dist.reduce_scatter_tensor(out, buf.contiguous(),
                                   group=mesh.group(axes)[0])
        return out

    return mesh.collective(x, axes, lambda rows: rows.sum(0).reshape(G, -1),
                           over_ranks)


def part_broadcast(x: torch.Tensor, mesh, axis_name: AxisNames
                   ) -> torch.Tensor:
    """All-gather each member's strip over the group: every member ends
    with the group's strips in owner order.  Paper Fig. 2."""
    _check_1d(x, mesh)
    axes = axes_tuple(axis_name)
    G = axis_size(mesh, axes)

    def over_ranks(buf):
        import torch.distributed as dist
        out = buf.new_empty(G * buf.shape[0])
        dist.all_gather_into_tensor(out, buf.contiguous(),
                                    group=mesh.group(axes)[0])
        return out

    return mesh.collective(
        x, axes, lambda rows: rows.reshape(1, -1).expand(G, -1), over_ranks)


def psum(x: torch.Tensor, mesh, axis_name: AxisNames) -> torch.Tensor:
    """All-reduce over the group, any member shape."""
    axes = axes_tuple(axis_name)

    def over_ranks(buf):
        import torch.distributed as dist
        out = buf.clone()
        dist.all_reduce(out, group=mesh.group(axes)[0])
        return out

    return mesh.collective(
        x, axes, lambda rows: rows.sum(0, keepdim=True).expand_as(rows),
        over_ranks)


# ---------------------------------------------------------------------------
# Strip helpers: arbitrary-shaped tensors are flattened and padded so every
# group member owns an equal 1-D strip.
# ---------------------------------------------------------------------------
def padded_size(n: int, group: int) -> int:
    return ((n + group - 1) // group) * group


def flatten_pad(x: torch.Tensor, group: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = padded_size(flat.numel(), group) - flat.numel()
    return F.pad(flat, (0, pad)) if pad else flat


def unflatten(flat: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return flat[:math.prod(shape)].reshape(shape)
