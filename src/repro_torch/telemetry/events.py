"""Span and event recorders (``repro.telemetry.events``).

The trainer's phases (step, data_wait, first_step, ckpt_write), the train
step's (forward, backward, clip, update; ``train.train_step``), the §3.4
update's (reduce, apply, broadcast; ``optim.dist.UpdatePlan``),
``Run.step``'s step and the serving engine's (prefill, decode, preempt)
each become a SPAN: a dict ``{"kind", "ph": "span", "t0", "t1", "dur",
"depth", **attrs}`` stamped from ``time.monotonic()`` (never the wall
clock: the cluster heartbeat rides these events, and must survive a
wall-clock jump).  Instant events carry ``"ph": "instant"``.  Listeners
see every completed event: the JSONL sink (``telemetry.sinks.JsonlSink``),
the cluster heartbeat writer (``cluster.launcher.make_heartbeat_listener``)
and tests.  A recorder that keeps its events feeds one histogram per span
kind (``hist("span/<kind>_s")``).

While a ``torch.profiler`` session is active, every span of a live
``Recorder`` is also a profiler range named ``repro_torch.<kind>``, on the
profiler's clock and timeline beside the device's kernels.  A span that
nothing would see (no listener, no kept events, no profiler) is the shared
null span, so an untraced run pays one check a span.

``NULL_RECORDER`` is the no-op default: library code threads
``recorder.span(...)`` / ``recorder.event(...)`` / ``recorder.count(...)``
unconditionally and pays one attribute lookup when nothing records.  A
caller may pass any object with the methods its consumer calls (the serving
engine calls ``span`` and ``event``, the trainer and the train step
``span`` and ``count``).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import torch.autograd.profiler as _profiler

from repro_torch.telemetry.metrics import (
    NULL_HISTOGRAM,
    Counter,
    Gauge,
    Histogram,
    metrics_summary,
)

# the cluster's process-index variable (cluster.spec.ENV_PROCESS_ID), read
# here so that telemetry does not import the cluster package
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
RANGE_PREFIX = "repro_torch."    # the profiler ranges' names: prefix + kind

try:        # a RecordFunction range without record_function's op dispatch
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:
    from torch.autograd.profiler import record_function as _Range


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The do-nothing recorder: every method a constant-cost no-op, so
    library code threads ``recorder.span(...)`` unconditionally."""
    __slots__ = ()
    enabled = False
    sync = False
    trace_dir = None
    process_index = 0

    def span(self, kind: str, **attrs):
        return _NULL_SPAN

    def event(self, kind: str, **attrs) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, v: float) -> None:
        pass

    def hist(self, name: str):
        return NULL_HISTOGRAM

    def add_listener(self, fn: Callable) -> None:
        pass

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


class _Span:
    """One open span: the context manager ``Recorder.span`` hands out;
    ``range``: its profiler range, or None."""
    __slots__ = ("rec", "kind", "attrs", "t0", "range")

    def __init__(self, rec: "Recorder", kind: str, attrs: dict, rng=None):
        self.rec = rec
        self.kind = kind
        self.attrs = attrs
        self.t0 = 0.0
        self.range = rng

    def __enter__(self) -> "_Span":
        self.t0 = self.rec._clock()
        self.rec._stack.append(self)
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._finish_span(self)
        return False


class Recorder:
    """Collects completed events, notifies listeners and aggregates
    metrics.  ``clock`` is injectable for deterministic tests.

    ``keep_events=False`` bounds memory for long runs: listeners still see
    everything; ``events`` stays empty and no span feeds a histogram.  A
    span that no listener, kept event or profiler would see is the null
    span (module docstring).  ``sync``
    asks the trainer to wait for each step's result, trading asynchronous
    launches for honest span durations (``make_recorder`` sets it iff a
    trace is written)."""
    enabled = True

    def __init__(self, process: str = "main", process_index: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 keep_events: bool = True, sync: bool = False):
        self.process = process
        self.process_index = process_index
        self.events: List[dict] = []
        self.trace_dir: Optional[str] = None
        self.sync = sync
        self._clock = clock
        self._keep = keep_events
        self._stack: List[_Span] = []
        self._listeners: List[Callable] = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._closed = False

    # -- spans and events ----------------------------------------------
    def span(self, kind: str, **attrs):
        profiled = _profiler._is_profiler_enabled
        if self._keep or self._listeners:
            return _Span(self, kind, attrs,
                         _Range(RANGE_PREFIX + kind) if profiled else None)
        return _Range(RANGE_PREFIX + kind) if profiled else _NULL_SPAN

    def _finish_span(self, span: _Span) -> None:
        t1 = self._clock()
        # LIFO pop; an out-of-order exit must not corrupt the depth
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:
            self._stack.remove(span)
        ev = {"kind": span.kind, "ph": "span", "t0": span.t0, "t1": t1,
              "dur": t1 - span.t0, "depth": len(self._stack)}
        ev.update(span.attrs)
        if self._keep:
            self.hist(f"span/{span.kind}_s").observe(ev["dur"])
        self._emit(ev)

    def event(self, kind: str, **attrs) -> None:
        ev = {"kind": kind, "ph": "instant", "t0": self._clock()}
        ev.update(attrs)
        self._emit(ev)

    def _emit(self, ev: dict) -> None:
        if self._keep:
            self.events.append(ev)
        for fn in self._listeners:
            fn(ev)

    # -- metrics -------------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        c.add(n)

    def gauge(self, name: str, v: float) -> None:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        g.set(v)

    def hist(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def metrics(self) -> dict:
        return metrics_summary(self._counters, self._gauges, self._hists)

    # -- lifetime ------------------------------------------------------
    def add_listener(self, fn: Callable) -> None:
        self._listeners.append(fn)

    def close(self) -> None:
        """Emit the final metrics snapshot and close the listeners that
        have a ``close``.  A second close does nothing."""
        if self._closed:
            return
        self._closed = True
        self.event("metrics", **self.metrics())
        for fn in self._listeners:
            closer = getattr(fn, "close", None)
            if closer is not None:
                closer()


def make_recorder(tspec=None, process: str = "train") -> Recorder:
    """The recorder of one run, from a ``TelemetrySpec`` (or None).

    Always a live recorder, since listeners (the cluster heartbeat) must
    work untraced; without ``trace_dir`` nothing touches the disk and no
    event list is kept.  The process index comes from the cluster's
    ``REPRO_PROCESS_ID``, so that the processes' trace files never
    collide."""
    idx = int(os.environ.get(ENV_PROCESS_ID, "0") or "0")
    trace_dir = getattr(tspec, "trace_dir", None)
    rec = Recorder(process=process, process_index=idx,
                   keep_events=bool(trace_dir), sync=bool(trace_dir))
    if trace_dir:
        from repro_torch.telemetry.sinks import JsonlSink, trace_path
        os.makedirs(trace_dir, exist_ok=True)
        rec.trace_dir = trace_dir
        rec.add_listener(JsonlSink(trace_path(trace_dir, idx)))
        rec.event("meta", process=process, process_index=idx,
                  pid=os.getpid(), clock="monotonic")
    return rec
