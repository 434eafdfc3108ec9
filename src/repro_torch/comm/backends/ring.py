"""The paper's §3.4 ring, on the port's hand-written kernels
(``repro.comm.backends.pallas_ring``).

Registered under the reference's name ``"pallas-ring"`` so that a
``CommConfig`` carries across unchanged.

Local mesh (G members on one device)
    ``part_reduce`` is ``kernels.ring.ring_reduce_scatter`` on each group's
    ``(G, N)`` rows (a view, a member stride of 0 included), and
    ``part_broadcast`` is ``kernels.ring.ring_all_gather``.

Process mesh (one member per rank)
    The reference's loop (``pallas_ring.py:100-121, 157-171``): member p
    sends its chunk ``(p - 1) % G`` to rank p + 1 first; at step s it
    receives the partial of chunk ``(p - 2 - s) % G`` from rank p - 1
    (``torch.distributed.batch_isend_irecv`` in place of ``lax.ppermute``),
    adds its own chunk with ``kernels.ring.ring_hop_accum`` and forwards it.
    After G - 1 hops the reduced chunk p sits on member p: the owner
    convention of ``LaxBackend``, so the two are interchangeable.
    ``part_broadcast`` is the same hop loop, pure data movement.

Both forms add in the ring's order and in the wire dtype, so they agree with
each other, and with the reference's ring, bitwise.  The compressed wire
formats (``int8`` / ``topk``) are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core.collectives import (
    AxisNames,
    axes_tuple,
    axis_size,
    flat_group_index,
    flatten_pad,
    unflatten,
)
from repro_torch.kernels import ring as kring


def _exchange(send: torch.Tensor, recv: torch.Tensor, mesh,
              axes) -> None:
    """Send ``send`` to the next member of this rank's group ring and
    receive the previous member's message into ``recv``.  gloo moves host
    memory, so over gloo a card's messages are staged through it (the way
    ranks that share one card talk: NCCL takes one rank per card)."""
    import torch.distributed as dist
    pg, ranks = mesh.group(axes)
    i, G = ranks.index(mesh.rank), len(ranks)
    staged = send.is_cuda and dist.get_backend(pg) == "gloo"
    out = torch.empty(recv.shape, dtype=recv.dtype) if staged else recv
    ops = [dist.P2POp(dist.isend, send.cpu() if staged else send,
                      ranks[(i + 1) % G], group=pg),
           dist.P2POp(dist.irecv, out, ranks[(i - 1) % G], group=pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv.copy_(out)


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
        if self.wire_format in ("int8", "topk"):
            raise NotImplementedError(
                f"wire_format={self.wire_format!r} is not ported yet: the "
                "ring moves fp32 and bf16")
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        if x.shape[-1] % G:
            raise ValueError(f"buffer size {x.shape[-1]} not a strip "
                             f"multiple of group {G}")
        axes = axes_tuple(axis_name)

        def over_ranks(buf):
            p = flat_group_index(mesh, axes)
            chunks = buf.reshape(G, -1)
            send = chunks[(p - 1) % G]
            recv = torch.empty_like(send)
            for s in range(G - 1):
                _exchange(send, recv, mesh, axes)
                send = kring.ring_hop_accum(chunks, recv, (p - 2 - s) % G)
            return send

        return mesh.collective(x, axes, kring.ring_reduce_scatter,
                               over_ranks)

    def part_broadcast(self, x: torch.Tensor, mesh,
                       axis_name: AxisNames) -> torch.Tensor:
        self._check(x, mesh)
        G = axis_size(mesh, axis_name)
        if G == 1:
            return x
        axes = axes_tuple(axis_name)

        def over_ranks(strip):
            p = flat_group_index(mesh, axes)
            out = strip.new_empty(G, strip.shape[0])
            out[p] = strip
            for s in range(G - 1):
                # the strip of owner (p - 1 - s) arrives from the left
                # neighbour
                _exchange(out[(p - s) % G], out[(p - 1 - s) % G], mesh, axes)
            return out.reshape(-1)

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
