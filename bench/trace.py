"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device seconds by class (``kernels.json``: by the operation's name
and the host op that launched it), the seconds in which any operation ran
on the card, and the breakdown (the device operations that took most
time; the idle gaps by what the host was doing while they lasted)."""
from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

CLASSES = [(c["class"], re.compile(c["op"]), re.compile(c["kernel"]))
           for c in json.loads((Path(__file__).resolve().parent
                                / "kernels.json").read_text())["classes"]]
TOP = 10
NAME_CHARS = 160
STEP_SPAN = "bench.step"   # the benchmark's range around each traced step


def kernel_class(name: str, op: str = "") -> str:
    """The class of the first rule of ``kernels.json`` that the device
    operation ``name``, launched by the host op ``op``, matches."""
    return next(c for c, o, k in CLASSES if o.search(op) and k.search(name))


@dataclass
class TraceSummary:
    steps: int                     # training steps in each traced stretch
    window_s: float                # the lean stretch on the host clock
    busy_s: float = 0.0            # union of its device operations
    class_s: dict = field(default_factory=dict)   # device seconds by class
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def ms_per_step(self, cls: str):
        """Device ms a step of class ``cls``; None when it never ran."""
        s = self.class_s.get(cls, 0.0)
        return s / self.steps * 1e3 if s > 0 else None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _split(events):
    """(device, host) lists of (name, start, end), microseconds on the
    profiler's clock.  The device's leaves out the copies of host ranges
    on the device timeline (``record_function``'s, as the benchmark's step
    range and NCCL's ``nccl:coalesced``), which are no operations."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type != cuda:
            host.append((e.name, *span))
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name == STEP_SPAN):
            dev.append((e.name, *span))
    return dev, host


def busy_seconds(events) -> float:
    """Seconds in which any device operation of ``events`` ran."""
    return sum(b - a for a, b in _merge([(a, b) for _, a, b
                                         in _split(events)[0]])) * 1e-6


def summarize(events, steps: int, lean_events, lean_window_s: float
              ) -> TraceSummary:
    """``events``: a stretch of ``steps`` steps traced with the host's ops
    (the profiler's ``events()``; device and host events share its clock);
    ``lean_events``: another such stretch traced with device activity
    alone, over ``lean_window_s`` on the host clock, for the busy
    seconds."""
    dev, host = _split(events)
    out = TraceSummary(steps, lean_window_s, busy_seconds(lean_events))
    if not dev:
        return out
    by_name = defaultdict(float)
    for name, a, b in dev:
        by_name[name] += (b - a) * 1e-6
    # each name's time split over classes as its launches by host op were
    launched = defaultdict(lambda: defaultdict(float))
    for e in events:
        for k in getattr(e, "kernels", None) or ():
            launched[k.name][kernel_class(k.name, e.name)] += k.duration
    by_class = defaultdict(float)
    for name, s in by_name.items():
        shares = launched.get(name) or {kernel_class(name): 1.0}
        total = sum(shares.values())
        for cls, d in shares.items():
            by_class[cls] += s * d / total
    out.class_s = dict(by_class)
    out.device_ops = [[n[:NAME_CHARS], s] for n, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    busy = _merge([(a, b) for _, a, b in dev])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    out.idle_gaps = _gaps_by_host_op(gaps, host)
    return out


def _gaps_by_host_op(gaps, host):
    """Each idle gap charged to the shortest host event (the most
    specific) of those that cover at least half of it, or else to the one
    that covers most of it; summed by that event's name, the ``TOP``
    largest sums."""
    if not gaps or not host:
        return []
    names = [h[0] for h in host]
    start = np.array([h[1] for h in host], dtype=np.float64)
    end = np.array([h[2] for h in host], dtype=np.float64)
    dur = end - start
    sums = defaultdict(float)
    for a, b in gaps:
        over = np.minimum(end, b) - np.maximum(start, a)
        best = over.max()
        if best <= 0:
            sums["(no host event)"] += (b - a) * 1e-6
            continue
        cand = np.flatnonzero(over >= min(best, 0.5 * (b - a)))
        pick = cand[np.argmin(dur[cand])]
        sums[names[pick][:NAME_CHARS]] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(sums.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
