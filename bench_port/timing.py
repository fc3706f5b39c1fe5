"""Host-clock spans and the statistics the benchmark reports."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of ``values`` by linear interpolation
    between order statistics (``statistics.quantiles``' inclusive method)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("quantile of no values")
    if len(vals) == 1:
        return vals[0]
    pos = q * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class Spans:
    """Named host-clock intervals: ``with spans("factorize"): ...``."""

    def __init__(self):
        self.by_name: dict[str, list[tuple[float, float]]] = defaultdict(list)

    def add(self, name: str, start: float, end: float) -> None:
        self.by_name[name].append((start, end))

    def seconds(self, name: str) -> list[float]:
        return [e - s for s, e in self.by_name.get(name, [])]

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter())
