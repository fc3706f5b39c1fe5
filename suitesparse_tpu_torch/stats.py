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

    def gflops(self, phase: str, flops: float) -> float:
        """``flops`` over the seconds ``phase`` has taken, in GFLOP/s (0
        for a phase not timed)."""
        t = self.times.get(phase, 0.0)
        return flops / t / 1e9 if t > 0 else 0.0

    def report(self) -> str:
        """A table of the phases (calls, seconds), then the values."""
        lines = ["phase                          calls   seconds"]
        for phase in sorted(self.times):
            lines.append(f"{phase:<30} {self.counts[phase]:>5} "
                         f"{self.times[phase]:>9.4f}")
        for k in sorted(self.values):
            lines.append(f"{k:<30} = {self.values[k]}")
        return "\n".join(lines)

    def clear(self) -> None:
        self.times.clear()
        self.counts.clear()
        self.values.clear()


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
