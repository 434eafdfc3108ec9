"""The program's spans in a ``torch.profiler`` trace.

The port opens a profiler range ``repro_torch.<kind>`` for each span of its
recorder while a profiler runs (``repro_torch.telemetry.events``):
``step`` around ``Run.step``, inside it ``forward``, ``backward``,
``clip`` and ``update``, and inside ``update`` the §3.4 update's
``reduce``, ``apply`` and ``broadcast``.  :func:`summarize` charges each
device operation of a traced stretch to the innermost range whose host
interval holds the start of the runtime call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...; the call and the
operation carry one correlation id, the profiler event's ``id``).  The
match is by time, not by the profiler's parent chain: on a card autograd
runs the backward on a device thread of its own, so the ops that launch
the backward's kernels are no children of ``repro_torch.backward``.

It also counts the device operations launched inside ``repro_torch.step``
and the host's seconds in synchronizing runtime calls that start there, by
the innermost range they start in.  No per-layer metric reads these yet
(``bench/trace.py`` would hand them to the readers); ``tools/
phase_split.py`` prints them for a cell.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from bench.trace import STEP_SPAN

PREFIX = "repro_torch."
STEP = "step"
# host calls that wait for the card: the stream, event and device syncs
# and the blocking copy (``cudaMemcpyAsync`` does not wait)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize",
                        "cudaDeviceSynchronize", "cudaMemcpy"})
RUNTIME = re.compile(r"cu(da)?[A-Z]")   # a CUDA API call: cudaX or cuX
UPDATE = ("update", "reduce", "apply", "broadcast")


@dataclass
class SpanSummary:
    steps: int                  # training steps in the traced stretch
    count: dict = field(default_factory=dict)     # ranges of each kind
    device_s: dict = field(default_factory=dict)  # device s by innermost kind
    outside_s: float = 0.0      # launched outside every range
    unmatched_s: float = 0.0    # no launching call in the trace
    total_s: float = 0.0        # every device operation's seconds
    step_launches: int = 0      # device operations launched inside ``step``
    sync_s: dict = field(default_factory=dict)    # host s of SYNC_CALLS
    #                             started inside ``step``, by innermost kind

    def _per_step(self, x: float):
        """``x`` a step; None when the trace holds no device operation or
        no range of the program."""
        if self.total_s <= 0 or not self.count.get(STEP):
            return None
        return x / self.steps

    def ms_per_step(self, *kinds):
        """Device ms a step charged to ``kinds``."""
        s = self._per_step(sum(self.device_s.get(k, 0.0) for k in kinds))
        return None if s is None else s * 1e3

    def launches_per_step(self):
        return self._per_step(float(self.step_launches))

    def sync_ms_per_step(self):
        s = self._per_step(sum(self.sync_s.values()))
        return None if s is None else s * 1e3


def _is_device_op(e, cuda) -> bool:
    """A device operation (kernel, copy, set), not a device copy of a host
    range (``record_function``'s, the benchmark's step, NCCL's)."""
    return (e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name != STEP_SPAN and not e.name.startswith(PREFIX))


class _Ranges:
    """The program's host ranges; the innermost that holds a time."""

    def __init__(self, ranges):
        ranges.sort(key=lambda r: (r[1], -r[2]))   # an outer range first
        self.kind = [r[0] for r in ranges]
        self.start = np.array([r[1] for r in ranges], dtype=np.float64)
        self.end = np.array([r[2] for r in ranges], dtype=np.float64)
        steps = [(a, b) for k, a, b in ranges if k == STEP]
        self.step_start = np.array([a for a, _ in steps], dtype=np.float64)
        self.step_end = np.array([b for _, b in steps], dtype=np.float64)

    def innermost(self, t: float):
        """The kind of the latest-starting range that holds ``t`` (ranges
        nest, so it is the innermost), or None."""
        held = np.flatnonzero((self.start <= t) & (t <= self.end))
        return self.kind[held[-1]] if held.size else None

    def in_step(self, t: float) -> bool:
        return bool(np.any((self.step_start <= t) & (t <= self.step_end)))


def summarize(events, steps: int) -> SpanSummary:
    """``events``: a stretch of ``steps`` steps traced with the host's ops
    and the device's (the profiler's ``events()``: one clock,
    microseconds)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ranges, launch, syncs, ops = [], {}, [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if _is_device_op(e, cuda):
                ops.append((getattr(e, "id", None), (b - a) * 1e-6))
        elif e.name.startswith(PREFIX):
            ranges.append((e.name[len(PREFIX):], a, b))
        elif RUNTIME.match(e.name):
            if getattr(e, "id", None) is not None:
                launch[e.id] = a
            if e.name in SYNC_CALLS:
                syncs.append((a, (b - a) * 1e-6))
    out = SpanSummary(steps)
    for kind, _, _ in ranges:
        out.count[kind] = out.count.get(kind, 0) + 1
    out.total_s = sum(s for _, s in ops)
    rng = _Ranges(ranges)
    device_s = defaultdict(float)
    for op_id, s in ops:
        t = launch.get(op_id)
        if t is None:
            out.unmatched_s += s
            continue
        kind = rng.innermost(t)
        if kind is None:
            out.outside_s += s
            continue
        device_s[kind] += s
        out.step_launches += rng.in_step(t)
    out.device_s = dict(device_s)
    sync_s = defaultdict(float)
    for t, s in syncs:
        if rng.in_step(t):
            sync_s[rng.innermost(t)] += s
    out.sync_s = dict(sync_s)
    return out
