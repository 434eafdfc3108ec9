"""Pluggable collective backends (``repro.comm.backends``), the extension
point behind the schedule seam (``repro_torch.comm.schedule``).

A backend implements the paper's group collectives over a mesh
(``launch.mesh``); the schedules own the bucket layout, the wire-dtype casts
and the two-level pod composition.  The contract is the reference's:

**Strip ownership.**  ``part_reduce`` splits each member's 1-D buffer into G
equal chunks and delivers the fully reduced chunk i to the member whose flat
group index (``core.collectives.flat_group_index``, row-major over the axis
tuple) is i; ``part_broadcast`` is the exact inverse.  The zero1 strip
update slices params with the same index.

**Wire-dtype semantics.**  Backends reduce in the dtype they are handed and
never cast.

Backends, selected by name (``CommConfig.backend``):

``lax`` (:class:`LaxBackend`)
    The plain collectives of ``core.collectives``: a sum over the member
    rows on a local mesh, ``reduce_scatter_tensor`` /
    ``all_gather_into_tensor`` on a process mesh.  The port's stand-in for
    XLA's collectives.
``pallas-ring`` (:class:`RingBackend`)
    The paper's §3.4 ring on the port's hand-written CUDA kernels
    (``kernels/ring.py``).  It keeps the reference's name so that a
    ``CommConfig`` carries across unchanged.
``gossip`` (:class:`GossipBackend`)
    GossipGraD partner exchange: one chunk-sized message a member per step
    under the rotating pairing ``partner = (rank + step + 1) % G`` (the
    shift ``1 + step % (G - 1)``) in place of the full ring reduction, the
    pair add on the ring's fold kernel.  Not a drop-in ring replacement:
    ``part_reduce`` delivers the rotating pair mean, a change of the
    consistency model selected by ``parallel="gossip"``
    (``api.spec.MODE_CAPS`` refuses it under the synchronous modes).  Its
    partner rotation is step-scheduled: bind the train step with
    ``bind_step`` / ``schedule.bind_step``.
"""
from __future__ import annotations

from typing import Union

from repro_torch.comm.backends.base import CollectiveBackend  # noqa: F401
from repro_torch.comm.backends.gossip import GossipBackend
from repro_torch.comm.backends.lax_backend import LaxBackend
from repro_torch.comm.backends.ring import RingBackend

COLLECTIVE_BACKENDS = ("lax", "pallas-ring", "gossip")

_FACTORIES = {"lax": LaxBackend, "pallas-ring": RingBackend,
              "gossip": GossipBackend}


def get_backend(backend: Union[str, CollectiveBackend]) -> CollectiveBackend:
    """Resolve a backend name to an instance; instances pass through."""
    if isinstance(backend, str):
        try:
            return _FACTORIES[backend]()
        except KeyError:
            raise ValueError(
                f"unknown collective backend {backend!r}; "
                f"known: {COLLECTIVE_BACKENDS}") from None
    return backend
