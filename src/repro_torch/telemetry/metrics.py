"""The histogram of ``repro.telemetry.metrics`` the serving engine keeps its
per-request latencies in."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


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

    def percentile(self, p: float) -> Optional[float]:
        if not self._values:
            return None
        return float(np.percentile(np.asarray(self._values), p))
