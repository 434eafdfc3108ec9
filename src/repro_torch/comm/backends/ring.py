"""The paper's §3.4 ring, on the port's hand-written kernels
(``repro.comm.backends.pallas_ring``).

Registered under the reference's name ``"pallas-ring"`` so that a
``CommConfig`` carries across unchanged.

Local mesh (G members on one device)
    ``part_reduce`` is ``kernels.ring.ring_reduce_scatter`` on each group's
    ``(G, N)`` rows (a view, a member stride of 0 included), and
    ``part_broadcast`` is ``kernels.ring.ring_all_gather``.

Process and cluster meshes (ranks)
    The reference's loop (``pallas_ring.py:100-121, 157-171``): member p
    sends its chunk ``(p - 1) % G`` to rank p + 1 first; at step s it
    receives the partial of chunk ``(p - 2 - s) % G`` from rank p - 1
    (``torch.distributed.batch_isend_irecv`` in place of ``lax.ppermute``),
    adds its own chunk with ``kernels.ring.ring_hop_accum`` and forwards it.
    After G - 1 hops the reduced chunk p sits on member p: the owner
    convention of ``LaxBackend``, so the two are interchangeable.
    ``part_broadcast`` is the same hop loop, pure data movement.  The L rows
    of a cluster mesh's rank ride one loop over ``"pod"``, chunk i of every
    row side by side (``core.collectives.chunk_major``): one hop kernel a
    hop for all L; a flat group over ``("pod", "data")`` runs as the stacked
    ring inside the rank, then the loop (``core.collectives.flat_reduce``).

Both forms add in the ring's order and in the wire dtype, so they agree with
each other, and with the reference's ring, bitwise.

**Compressed wire formats** (``wire_format``, bound by the schedule layer):
the same ring with other messages (``pallas_ring.py:123-155``).  ``"int8"``
sends ``(q int8, scale f32)``: member p quantizes its chunk ``(p - 1) % G``
(``kernels.ring.int8_quantize``), and each hop dequantizes, adds in f32 and
re-quantizes on a fresh scale (``ring_hop_int8``); the owned strip is
dequantized once, at the end, outside the kernel.  ``"topk"`` sends
``(values f32, indices int32)`` of the ``topk_chunk_k`` largest |x|: each
hop scatters the message dense and adds (``ring_hop_topk``), and the
selection before each forward (``_topk_select``, never after the last hop:
the owned strip keeps the dense sum) stays outside the kernel.  On a local
mesh each hop is one call of the member-batched kernel for all G members;
on a process mesh the ``(q, scale)`` and ``(values, indices)`` pairs move
by ``_exchange``.  The part-broadcast is never compressed: lossy weights
would break the replicated-params invariant.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Sequence

import torch

from repro_torch.core.collectives import (
    AxisNames,
    axes_tuple,
    axis_size,
    chunk_major,
    dist_call,
    flat_broadcast,
    flat_reduce,
    flatten_pad,
    gloo_stages,
    rank_index,
    row_major,
    split_levels,
    staged_for,
    unflatten,
)
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ring as kring


def _exchange(send: torch.Tensor, recv: torch.Tensor, mesh,
              axes, shift: int = 1) -> None:
    """Send ``send`` to the member ``shift`` places on in this rank's group
    ring (the next one by default) and receive the message of the member
    ``shift`` places back into ``recv``, both staged through host memory
    where the group is gloo's (``core.collectives.staged_for``)."""
    import torch.distributed as dist
    pg, ranks = mesh.group(axes)
    i, G = ranks.index(mesh.rank), len(ranks)
    staged = gloo_stages(send, pg)
    out = torch.empty(recv.shape, dtype=recv.dtype) if staged else recv
    def hop():
        ops = [dist.P2POp(dist.isend, staged_for(send, pg),
                          ranks[(i + shift) % G], group=pg),
               dist.P2POp(dist.irecv, out, ranks[(i - shift) % G],
                          group=pg)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    dist_call("collective-permute", send, G, hop)
    if staged:
        recv.copy_(out)


def topk_chunk_k(n: int, ratio: float, floor: int = 1) -> int:
    """Entries kept per ``n``-element wire message at ``ratio`` (>= floor,
    <= n; the n cap wins), shared by both backends so that their wire
    layouts agree."""
    return min(n, max(floor, math.ceil(ratio * n)))


def _topk_select(x: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest-|x| entries along the last
    dimension, ties to the lower index (``lax.top_k``'s rule).  Selection is
    not a memory-bound combine, so it stays outside the hop kernel."""
    idx = kref.topk_indices_ref(x, k)
    return x.gather(-1, idx), idx.to(torch.int32)


class WireOps(NamedTuple):
    """The per-member steps of a compressed ring (``wire_ring``)."""
    quantize: Callable      # (n,) -> (q, scale)
    hop_int8: Callable      # (chunks, q, scale, c) -> (q, scale)
    select: Callable        # (x, k) -> (values, indices)
    hop_topk: Callable      # (chunks, values, indices, c) -> dense (n,)


KERNEL_OPS = WireOps(kring.int8_quantize, kring.ring_hop_int8, _topk_select,
                     kring.ring_hop_topk)


def wire_ring(chunks: Sequence[torch.Tensor], ps: Sequence[int], G: int,
              wire_format: str, ratio: float,
              recv: Callable[[List[tuple]], List[tuple]], ops: WireOps
              ) -> List[torch.Tensor]:
    """The reference's compressed ring for the members held here:
    ``chunks[i]`` (G, n) f32 is flat group member ``ps[i]``'s buffer, and
    ``recv(msgs)`` gives the message each of them receives from its left
    neighbour.  Returns each member's reduced strip (f32)."""
    if wire_format == "int8":
        msgs = [ops.quantize(c[(p - 1) % G]) for c, p in zip(chunks, ps)]
        for step in range(G - 1):
            msgs = [ops.hop_int8(c, *m, (p - 2 - step) % G)
                    for c, p, m in zip(chunks, ps, recv(msgs))]
        return [kref.int8_dequantize_ref(*m) for m in msgs]
    k = topk_chunk_k(chunks[0].shape[1], ratio)
    msgs = [ops.select(c[(p - 1) % G], k) for c, p in zip(chunks, ps)]
    for step in range(G - 1):
        dense = [ops.hop_topk(c, *m, (p - 2 - step) % G)
                 for c, p, m in zip(chunks, ps, recv(msgs))]
        if step < G - 2:
            msgs = [ops.select(d, k) for d in dense]
    return dense


def wire_part_reduce(x: torch.Tensor, mesh, axes, wire_format: str,
                     ratio: float, ops: WireOps, stacked=None
                     ) -> torch.Tensor:
    """Part-reduce with compressed messages: ``stacked`` on each group's
    ``(G, N)`` rows of a local mesh (default: :func:`wire_ring` over the
    rows with ``ops``), :func:`wire_ring` on the rows a rank holds, each
    row's ring its own (its own scales), their messages moved together by
    ``_exchange``."""
    G = axis_size(mesh, axes)

    def over_rows(rows):
        return torch.stack(wire_ring(
            [r.reshape(G, -1).float() for r in rows], range(G), G,
            wire_format, ratio, lambda ms: [ms[(i - 1) % G] for i in range(G)],
            ops))

    def over_ranks(rows):
        def recv(msgs):
            out = []
            for parts in zip(*msgs):     # one message part of every row
                t = torch.stack(parts)
                r = torch.empty_like(t)
                _exchange(t, r, mesh, axes)
                out.append(r.unbind(0))
            return list(zip(*out))

        p = rank_index(mesh, axes)
        return torch.stack(wire_ring(
            [r.reshape(G, -1).float() for r in rows], [p] * len(rows), G,
            wire_format, ratio, recv, ops))

    return mesh.collective(x, axes, stacked or over_rows, over_ranks)


def _int8_members(rows: torch.Tensor) -> torch.Tensor:
    """The int8 ring of all G members of a local mesh's ``(G, N)`` rows,
    one member-batched kernel call per hop."""
    rows = rows.float()
    q, s = kring.int8_quantize_members(rows)
    for step in range(rows.shape[0] - 1):
        q, s = kring.ring_hop_int8_members(rows, q, s, step)
    return q.float() * s[:, None]


def _topk_members(rows: torch.Tensor, ratio: float) -> torch.Tensor:
    """The top-k ring of all G members of a local mesh's ``(G, N)`` rows."""
    rows = rows.float()
    G, N = rows.shape
    k = topk_chunk_k(N // G, ratio)
    vals, idx = _topk_select(kring.member_chunks(rows, -1), k)
    for step in range(G - 1):
        dense = kring.ring_hop_topk_members(rows, vals, idx, step)
        if step < G - 2:
            vals, idx = _topk_select(dense, k)
    return dense


@dataclass(frozen=True)
class RingBackend:
    name: str = "pallas-ring"
    wire_format: str = "fp32"
    topk_ratio: float = 0.05

    def bind_wire_format(self, wire_format: str,
                         topk_ratio: float) -> "RingBackend":
        return dataclasses.replace(self, wire_format=wire_format,
                                   topk_ratio=topk_ratio)

    def _check(self, x: torch.Tensor, mesh) -> None:
        if x.dim() != 1 + mesh.member_dims:
            raise NotImplementedError(
                "RingBackend takes the schedules' canonical 1-D fusion "
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
        if split_levels(mesh, axes):
            return flat_reduce(x, mesh, axes, self.part_reduce)
        if self.wire_format in ("int8", "topk"):
            stacked = _int8_members if self.wire_format == "int8" \
                else lambda rows: _topk_members(rows, self.topk_ratio)
            return wire_part_reduce(x, mesh, axes, self.wire_format,
                                    self.topk_ratio, KERNEL_OPS, stacked)

        def over_ranks(rows):
            # the rows' rings as one: chunk i of every row side by side
            p = rank_index(mesh, axes)
            chunks = chunk_major(rows, G)
            send = chunks[(p - 1) % G]
            recv = torch.empty_like(send)
            for s in range(G - 1):
                _exchange(send, recv, mesh, axes)
                send = kring.ring_hop_accum(chunks, recv, (p - 2 - s) % G)
            return send.view(rows.shape[0], -1)

        return mesh.collective(x, axes, kring.ring_reduce_scatter,
                               over_ranks)

    def part_broadcast(self, x: torch.Tensor, mesh,
                       axis_name: AxisNames) -> torch.Tensor:
        self._check(x, mesh)
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        axes = axes_tuple(axis_name)
        if split_levels(mesh, axes):
            return flat_broadcast(x, mesh, axes, self.part_broadcast)

        def over_ranks(strips):
            p = rank_index(mesh, axes)
            out = strips.new_empty(G, strips.numel())
            out[p] = strips.reshape(-1)
            for s in range(G - 1):
                # the strips of owner (p - 1 - s) arrive from the left
                # neighbour
                _exchange(out[(p - s) % G], out[(p - 1 - s) % G], mesh, axes)
            return row_major(out, strips.shape[0])

        return mesh.collective(x, axes, kring.ring_all_gather, over_ranks)

    def psum(self, x: torch.Tensor, mesh, axis_name: AxisNames
             ) -> torch.Tensor:
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        shape = x.shape[mesh.member_dims:]
        flat = mesh.map_members(x, lambda r: flatten_pad(r, G))
        full = self.part_broadcast(self.part_reduce(flat, mesh, axis_name),
                                   mesh, axis_name)
        return mesh.map_members(full, lambda r: unflatten(r, shape))
