"""Per-phase wall times and problem counters (cholmod_common's stats
analog): one :class:`Stats` accumulates them, :func:`timed` is the
context-manager instrument."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

__all__ = ["Stats", "timed", "GLOBAL_STATS"]


@dataclasses.dataclass
class Stats:
    """Accumulated phase timers and counters."""

    times: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    values: dict = dataclasses.field(default_factory=dict)

    def add_time(self, phase: str, seconds: float) -> None:
        self.times[phase] += seconds
        self.counts[phase] += 1

    def record(self, key: str, value) -> None:
        self.values[key] = value


GLOBAL_STATS = Stats()


@contextlib.contextmanager
def timed(phase: str, stats: Stats | None = None):
    """Context manager: ``with timed("factorize"): ...``"""
    s = stats if stats is not None else GLOBAL_STATS
    t0 = time.perf_counter()
    try:
        yield s
    finally:
        s.add_time(phase, time.perf_counter() - t0)
