"""Telemetry sinks (``repro.telemetry.sinks``): a JSONL event stream, a
Chrome-trace exporter and the merge of the processes' streams.

Per-process layout under a trace directory:

    trace_p<i>.jsonl   every event of cluster process i, one JSON object a
                       line (written live by :class:`JsonlSink`; the last
                       line is the final metrics snapshot)
    trace.json         the merged Chrome trace: load it in
                       ``chrome://tracing`` or https://ui.perfetto.dev

A single-process run merges its own file at ``Run.close``; a cluster run
leaves the per-process files to the supervisor's merge
(``launch.cluster``), since workers merging at once would race each other.
Timestamps are per-process ``time.monotonic``; the merge rebases each
process to its own first event so that the timelines start at 0 (no
cross-process skew is meant or implied).
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional

_SPAN_META = ("kind", "ph", "t0", "t1", "dur", "depth")


def trace_path(trace_dir: str, process_index: int) -> str:
    return os.path.join(trace_dir, f"trace_p{process_index}.jsonl")


class JsonlSink:
    """Recorder listener that streams every event to a JSONL file.
    Line-buffered so a SIGKILLed worker loses at most one event; writes
    after ``close`` are dropped (the recorder may outlive the sink)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w", buffering=1)
        self._closed = False

    def __call__(self, ev: dict) -> None:
        if not self._closed:
            self._f.write(json.dumps(ev, separators=(",", ":")) + "\n")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._f.close()


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def to_chrome_events(events: List[dict], pid: int = 0,
                     name: Optional[str] = None,
                     ts_offset: Optional[float] = None) -> List[dict]:
    """Recorder events -> Chrome trace ``traceEvents`` (``ph: "X"``
    complete spans, ``ph: "i"`` instants; ``ts``/``dur`` in microseconds).
    ``ts_offset`` rebases timestamps (defaults to the earliest ``t0``)."""
    spans = [e for e in events if "t0" in e]
    if ts_offset is None:
        ts_offset = min((e["t0"] for e in spans), default=0.0)
    out = []
    if name:
        out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": name}})
    for e in spans:
        args = {k: v for k, v in e.items() if k not in _SPAN_META}
        ts = (e["t0"] - ts_offset) * 1e6
        if e.get("ph") == "span":
            # nested spans share tid 0 — Chrome stacks "X" events that
            # nest in time into the flame rows itself
            out.append({"name": e["kind"], "cat": "span", "ph": "X",
                        "ts": ts, "dur": e["dur"] * 1e6, "pid": pid,
                        "tid": 0, "args": args})
        else:
            out.append({"name": e["kind"], "cat": "instant", "ph": "i",
                        "ts": ts, "pid": pid, "tid": 0, "s": "p",
                        "args": args})
    return out


def write_chrome_trace(path: str,
                       events_by_pid: Dict[int, List[dict]],
                       names: Optional[Dict[int, str]] = None) -> str:
    trace_events = []
    for pid in sorted(events_by_pid):
        nm = (names or {}).get(pid)
        trace_events.extend(to_chrome_events(events_by_pid[pid], pid=pid,
                                             name=nm))
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, f)
    return path


def merge_process_traces(trace_dir: str,
                         out_name: str = "trace.json") -> Optional[str]:
    """Merge every ``trace_p*.jsonl`` in ``trace_dir`` into one Chrome
    trace (one pid per cluster process).  Returns the merged path, or
    ``None`` when no per-process files exist yet."""
    files = sorted(glob.glob(os.path.join(trace_dir, "trace_p*.jsonl")))
    if not files:
        return None
    by_pid: Dict[int, List[dict]] = {}
    names: Dict[int, str] = {}
    for path in files:
        m = re.search(r"trace_p(\d+)\.jsonl$", path)
        pid = int(m.group(1)) if m else len(by_pid)
        events = read_jsonl(path)
        by_pid[pid] = events
        meta = next((e for e in events if e.get("kind") == "meta"), {})
        names[pid] = f"{meta.get('process', 'proc')}[{pid}]"
    return write_chrome_trace(os.path.join(trace_dir, out_name),
                              by_pid, names)
