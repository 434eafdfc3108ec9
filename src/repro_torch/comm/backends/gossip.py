"""GossipGraD-style partner exchange as a collective backend
(``repro.comm.backends.gossip``).

The synchronous ring fully reduces every bucket each step: 2*(G-1)
messages, every member sees every other member's gradient.  GossipGraD
replaces the full reduction with ONE partner exchange per step under a
rotating pairing: at shift ``s = 1 + step % (G - 1)`` member p sends the
chunk ``(p + s) % G`` of its buffer to member ``(p + s) % G`` and receives
its own chunk p from member ``(p - s) % G``.  Each member mixes gradients
with a single peer per step, and the rotation walks the whole group every
G - 1 steps.

Composed with the zero1 strip update, ``part_reduce`` hands strip owner p
the pair sum of members p and p - s; ``part_broadcast`` all-gathers the
updated strips exactly as in the synchronous schedule, so params (and the
optimizer strips) stay identical across members every step.  Only the
gradient estimator changes: each strip's update uses a rotating pair mean.
The checkpoint layout is zero1's.

Scaling convention (the reference's): the schedules divide the reduce
output by G for the synchronous mean, so ``part_reduce`` returns the pair
sum scaled by ``G / 2`` in the wire dtype (a bf16 buffer stays bf16), and
the caller's ``/ G`` yields the pair mean.  This composes unchanged through
``HierarchicalSchedule`` (in-pod pair sum times ``G_in / 2``, then the
cross-pod sum).  ``core.balance.gossip_exchange_time`` is the cost model.

The step is a Python int here (the port's train step is eager), so the
shift is chosen on the host; bind it with :meth:`GossipBackend.bind_step`
(``comm.schedule.bind_step`` does it for every step-scheduled backend).
G = 1 is the identity.

Local mesh
    The G messages are one gather of the member rows (row p: member
    ``(p - s) % G``'s chunk p), and the pair add of all G members is one
    launch of the ring's fold kernel (``kernels.ring.
    ring_hop_accum_members``): the f32 or bf16 add of the §3.4 hop.
Process mesh
    The chunk moves by ``comm.backends.ring._exchange`` at shift s, and the
    add is ``kernels.ring.ring_hop_accum(chunks, recv, p)``, ``recv +
    chunks[p]``, bitwise the reference's ``own + recv``.
Cluster mesh
    Over ``"pod"`` the process mesh's exchange for all of a rank's rows at
    once; over ``("pod", "data")`` each member's partner is a row of its own
    rank or of another (``_split_pairs``), its add the same fold kernel.

``part_broadcast`` is the synchronous all-gather of the ring backend
(``kernels.ring.ring_all_gather`` on a local mesh, the ring's hops on a
process mesh): exact data movement.  Wire formats: fp32 and bf16 only
(``api.spec.MODE_CAPS["gossip"]``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.comm.backends.ring import RingBackend, _exchange
from repro_torch.core.collectives import (
    AxisNames,
    axes_tuple,
    axis_size,
    chunk_major,
    dist_call,
    flatten_pad,
    rank_index,
    split_levels,
    staged_for,
    unflatten,
)
from repro_torch.kernels import ring as kring


def _shift_perm(G: int, s: int) -> List[Tuple[int, int]]:
    """Member i sends to (i + s) % G, so i receives from (i - s) % G."""
    return [(i, (i + s) % G) for i in range(G)]


def shift_of(step: int, G: int) -> int:
    """The partner shift of ``step`` on a group of G > 1 members."""
    return 1 + int(step) % (G - 1)


def _split_pairs(x: torch.Tensor, mesh, axes, s: int) -> torch.Tensor:
    """The pair sums over ``axes`` that cross the ranks of a cluster mesh
    and hold axes inside them (``("pod", "data")``): member ``i = p * n +
    j`` (n members of the group a rank) sends its chunk ``(i + s) % G`` to
    member ``(i + s) % G``, a row of its own rank (a copy) or of another
    (a tagged send, staged through host memory over gloo), and adds the
    chunk i it receives to its own on the ring's fold kernel."""
    import torch.distributed as dist
    inner = tuple(a for a in axes if a != "pod")
    G, n, p = axis_size(mesh, axes), axis_size(mesh, inner), mesh.rank
    pg = mesh.group(("pod",))[0]
    out = x.new_empty(x.shape[0], x.shape[1] // G)
    for rows in mesh.inner.groups(inner):
        chunks = [x[r].reshape(G, -1) for r in rows]
        recv = [torch.empty_like(c[0]) for c in chunks]
        ops, landed = [], []
        for j, c in enumerate(chunks):
            me = p * n + j
            dst, src = (me + s) % G, (me - s) % G
            if dst // n == p:
                recv[dst % n].copy_(c[dst])
            else:
                ops.append(dist.P2POp(dist.isend, staged_for(c[dst], pg),
                                      dst // n, group=pg, tag=dst))
            if src // n != p:
                buf = staged_for(recv[j], pg)
                landed.append((j, buf))
                ops.append(dist.P2POp(dist.irecv, buf, src // n, group=pg,
                                      tag=me))

        def exchange():
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if ops:
            dist_call("collective-permute", recv[0], G, exchange)
        for j, buf in landed:
            if buf is not recv[j]:
                recv[j].copy_(buf)
        for j, (r, c) in enumerate(zip(rows, chunks)):
            out[r] = kring.ring_hop_accum(c, recv[j], p * n + j)
    return out


@dataclass(frozen=True)
class GossipBackend:
    """``step`` selects the partner rotation; 0 (the default) pairs each
    member with its +1 neighbour.  ``bind_step`` rebinds it per train
    step."""
    name: str = "gossip"
    step: int = 0

    def bind_step(self, step) -> "GossipBackend":
        return dataclasses.replace(self, step=int(step))

    def _check(self, x: torch.Tensor, mesh) -> None:
        if x.dim() != 1 + mesh.member_dims:
            raise NotImplementedError(
                "GossipBackend takes the schedules' canonical 1-D fusion "
                f"buffers (one per member); got shape {tuple(x.shape)}. "
                "Flatten first (collectives.flatten_pad) or use LaxBackend.")

    def part_reduce(self, x: torch.Tensor, mesh,
                    axis_name: AxisNames) -> torch.Tensor:
        self._check(x, mesh)
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        if x.shape[-1] % G:
            raise ValueError(f"buffer size {x.shape[-1]} not a strip "
                             f"multiple of group {G}")
        axes = axes_tuple(axis_name)
        s = shift_of(self.step, G)

        def over_rows(rows):
            m = torch.arange(G, device=rows.device)
            recv = rows.reshape(G, G, -1)[(m - s) % G, m]
            return kring.ring_hop_accum_members(rows, recv)

        def over_ranks(rows):
            p = rank_index(mesh, axes)
            chunks = chunk_major(rows, G)
            recv = torch.empty_like(chunks[p])
            _exchange(chunks[(p + s) % G], recv, mesh, axes, shift=s)
            return kring.ring_hop_accum(chunks, recv, p).view(
                rows.shape[0], -1)

        if split_levels(mesh, axes):
            pairs = _split_pairs(x, mesh, axes, s)
        else:
            pairs = mesh.collective(x, axes, over_rows, over_ranks)
        # pair sum scaled so that the schedule's / G yields the pair mean
        return pairs * (G / 2.0)

    def part_broadcast(self, x: torch.Tensor, mesh,
                       axis_name: AxisNames) -> torch.Tensor:
        # the updated strips all-gather as in the synchronous schedule, on
        # the ring's all-gather: params stay replicated, only the gradient
        # mixing is partial
        return RingBackend().part_broadcast(x, mesh, axis_name)

    def psum(self, x: torch.Tensor, mesh, axis_name: AxisNames
             ) -> torch.Tensor:
        """The gossip 'all-reduce', ``part_broadcast(part_reduce(x))``:
        every member ends with the same strip-wise pair-mixed sum."""
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        shape = x.shape[mesh.member_dims:]
        flat = mesh.map_members(x, lambda r: flatten_pad(r, G))
        full = self.part_broadcast(self.part_reduce(flat, mesh, axis_name),
                                   mesh, axis_name)
        return mesh.map_members(full, lambda r: unflatten(r, shape))
