"""Paper §3.1 — the computation/communication overlap model of synchronous
SGD (``repro.core.balance``, its §3.1 overlap section, formula for formula).

All comp quantities are FLOPs, all comm quantities bytes, all times
seconds; ``hw`` is a :class:`~repro_torch.configs.base.HardwareConfig` (the
port's ``H100_SXM`` or the paper's platforms).  ``issue_order`` is the one
ordering rule of the overlap schedule: ``comm.bucketer.BucketPlan.
backprop_order`` and ``comm.overlap`` use it, so the closed forms and the
executable schedule cannot disagree on order.  The rest of the reference's
module (§3.2-§3.3 model and hybrid parallelism) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.configs.base import HardwareConfig


@dataclass
class LayerBalance:
    name: str
    comp: float    # FLOPs per node per iteration (3 passes)
    comm: float    # bytes per node per iteration (data-parallel volume)


def bubble_schedule(layers: Sequence[LayerBalance], hw: HardwareConfig,
                    efficiency: float = 1.0) -> List[float]:
    """Paper §3.1:
        ocomp_i  = sum_{j<i} comp_j + comp_i/3
        ocomms_i = sum_{j<=i} comms_j
        bubble_i = ocomms_i/comms_sys - ocomp_i/comp_sys
    Layers in forward order; layer i's communication, issued right after
    its weight gradient, overlaps the backprop of layers j < i and layer
    i's own input-gradient pass (the comp_i/3 term).  Per-layer bubbles in
    seconds, negative when fully hidden."""
    comp_sys = hw.peak_flops * efficiency
    bubbles = []
    for i, li in enumerate(layers):
        ocomp = sum(lyr.comp for lyr in layers[:i]) + li.comp / 3.0
        ocomms = sum(lyr.comm for lyr in layers[: i + 1])
        bubbles.append(ocomms / hw.link_bw - ocomp / comp_sys)
    return bubbles


def issue_order(triggers: Sequence[int]) -> Tuple[int, ...]:
    """Bucket indices in backprop issue order: descending trigger layer (a
    bucket completed by a later layer is ready earlier in backprop), ties
    toward the later tree-order bucket."""
    return tuple(sorted(range(len(triggers)),
                        key=lambda b: (triggers[b], b), reverse=True))


def bucket_bubble_schedule(comm_times: Sequence[float],
                           triggers: Sequence[int],
                           layer_comps: Sequence[float],
                           hw: HardwareConfig,
                           efficiency: float = 1.0) -> List[float]:
    """The §3.1 bubble schedule at fusion-bucket granularity, the analytic
    model of ``comm.overlap``'s executable schedule.

    ``comm_times[b]``   seconds of communication of bucket ``b`` (tree
                        order).
    ``triggers[b]``     the forward-order layer whose weight-gradient pass
                        completes bucket ``b`` (``overlap.bucket_triggers``).
    ``layer_comps[t]``  FLOPs of layer ``t`` per node per iteration (all
                        three passes).

    In issue order, bucket ``b``'s bubble is its own transfer plus all
    issued after it, less the backprop left below its trigger and the
    trigger layer's own input-gradient pass:

        bubble_b = (comm_b + comms issued after b) / comms_sys
                 - (sum_{j < trigger_b} comp_j + comp_{trigger_b}/3) / comp_sys

    Returned in bucket (tree) order, seconds, negative when fully hidden.
    With one bucket per layer this is :func:`bubble_schedule`.
    """
    comp_sys = hw.peak_flops * efficiency
    order = issue_order(triggers)
    total_comm = float(sum(comm_times))
    bubbles = [0.0] * len(comm_times)
    issued = 0.0
    for b in order:
        t = triggers[b]
        ocomp = sum(layer_comps[:t]) + layer_comps[t] / 3.0
        bubbles[b] = (total_comm - issued) - ocomp / comp_sys
        issued += comm_times[b]
    return bubbles


def overlap_exposed_time(comm_times: Sequence[float],
                         triggers: Sequence[int],
                         layer_comps: Sequence[float],
                         hw: HardwareConfig,
                         efficiency: float = 1.0) -> float:
    """Exposed communication (seconds) of the §3.1 overlap schedule, by
    timeline: buckets transfer on one shared link in issue order, each
    issued when its trigger layer's weight gradient finishes and due when
    that layer's next forward starts.  The step stalls by the worst
    lateness over buckets (a stall shifts every later deadline), so the
    result is at most ``sum(comm_times)``, which it equals when no compute
    can overlap."""
    comp_sys = hw.peak_flops * efficiency
    order = issue_order(triggers)
    t_bp = 2.0 / 3.0 * sum(layer_comps) / comp_sys
    below = [0.0]                     # prefix sums: sum_{j<t} comp_j
    for c in layer_comps:
        below.append(below[-1] + c)
    link_free = 0.0
    exposed = 0.0
    for b in order:
        t = triggers[b]
        issue = (2.0 / 3.0 * (below[len(layer_comps)] - below[t + 1])
                 + layer_comps[t] / 3.0) / comp_sys
        finish = max(issue, link_free) + comm_times[b]
        link_free = finish
        deadline = t_bp + below[t] / 3.0 / comp_sys
        exposed = max(exposed, finish - deadline)
    return max(0.0, exposed)


def scaling_efficiency(layers: Sequence[LayerBalance], hw: HardwareConfig,
                       efficiency: float = 1.0) -> float:
    """Paper §3.1: efficiency = (sum comp_i / comp_sys) /
    (sum_i bubble_i+ + sum comp_i / comp_sys); positive bubbles are the
    communication left exposed."""
    comp_sys = hw.peak_flops * efficiency
    t_comp = sum(lyr.comp for lyr in layers) / comp_sys
    bubbles = bubble_schedule(layers, hw, efficiency)
    t_bubble = sum(max(0.0, b) for b in bubbles)
    return t_comp / (t_comp + t_bubble)
