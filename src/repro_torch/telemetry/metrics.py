"""Counters, gauges and histograms of the telemetry subsystem
(``repro.telemetry.metrics``).

The histogram keeps every observation (runs are short enough that exact
percentiles beat bucketed estimates) and answers numpy-convention
percentiles; the serving engine keeps its per-request latencies in one, and
every span kind of a :class:`~repro_torch.telemetry.events.Recorder` feeds
one.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Counter:
    """Monotonically increasing count (steps, tokens, preemptions...)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (active slots, free pages...)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


_EMPTY = {"count": 0, "mean": None, "p50": None, "p99": None, "max": None}


class Histogram:
    """Exact-sample histogram: keeps every observation and answers
    numpy-convention percentiles (linear interpolation)."""
    __slots__ = ("_values",)

    def __init__(self) -> None:
        self._values: List[float] = []

    def observe(self, v: float) -> None:
        self._values.append(float(v))

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def total(self) -> float:
        return float(sum(self._values))

    def percentile(self, p: float) -> Optional[float]:
        if not self._values:
            return None
        return float(np.percentile(np.asarray(self._values), p))

    def summary(self) -> dict:
        """{count, mean, p50, p99, max}; ``None`` stats when empty."""
        if not self._values:
            return dict(_EMPTY)
        a = np.asarray(self._values)
        return {"count": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max())}


class NullHistogram:
    """The no-op histogram ``NullRecorder.hist`` hands out."""
    __slots__ = ()
    count = 0
    total = 0.0

    def observe(self, v: float) -> None:
        pass

    def percentile(self, p: float) -> Optional[float]:
        return None

    def summary(self) -> dict:
        return dict(_EMPTY)


NULL_HISTOGRAM = NullHistogram()


def metrics_summary(counters: Dict[str, Counter],
                    gauges: Dict[str, Gauge],
                    histograms: Dict[str, Histogram]) -> dict:
    """One JSON-ready snapshot of every metric a recorder accumulated: the
    last line of the JSONL sink."""
    return {
        "counters": {k: c.value for k, c in sorted(counters.items())},
        "gauges": {k: g.value for k, g in sorted(gauges.items())},
        "histograms": {k: h.summary()
                       for k, h in sorted(histograms.items())},
    }
