"""Per-phase wall times, problem counters and trace spans (cholmod_common's
stats analog): one :class:`Stats` accumulates the times and counters,
:func:`timed` is the entry points' instrument, :func:`span` names a phase
inside them.

Tracing is on exactly while ``torch.profiler`` records. A span is then a
profiler range ``sst.<name>`` on the timeline and clock of the kernels it
launches; an entry point's range carries its call number, and a
zero-length ``sst.counts`` range at its end carries that call's counter
deltas (the profiler shows a range's arguments with ``record_shapes``).
The ranges are function-scope ones (``_RecordFunctionFast``), which file
no device-side row, unlike ``record_function``'s user-scope ranges: a
busy union over the trace's device rows reads the same with the spans as
without them. Off, a span is one flag check and a shared no-op context:
no range, no clock read, no allocation. A Python garbage collection that
runs while a span is open is traced as ``sst.gc``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import time
from collections import defaultdict

import torch

__all__ = ["Stats", "timed", "span", "tracing", "count", "GLOBAL_STATS"]

PREFIX = "sst."
tracing = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Stats:
    """Accumulated phase timers and counters."""

    times: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    values: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    def add_time(self, phase: str, seconds: float) -> None:
        self.times[phase] += seconds
        self.counts[phase] += 1

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``key`` (bytes copied, cache misses)."""
        self.counters[key] += n

    def record(self, key: str, value) -> None:
        self.values[key] = value

    def gflops(self, phase: str, flops: float) -> float:
        """``flops`` over the seconds ``phase`` has taken, in GFLOP/s (0
        for a phase not timed)."""
        t = self.times.get(phase, 0.0)
        return flops / t / 1e9 if t > 0 else 0.0

    def report(self) -> str:
        """A table of the phases (calls, seconds), then the values, then
        the counters where there are any."""
        lines = ["phase                          calls   seconds"]
        for phase in sorted(self.times):
            lines.append(f"{phase:<30} {self.counts[phase]:>5} "
                         f"{self.times[phase]:>9.4f}")
        for k in sorted(self.values):
            lines.append(f"{k:<30} = {self.values[k]}")
        for k in sorted(self.counters):
            lines.append(f"{k:<30} # {self.counters[k]}")
        return "\n".join(lines)

    def clear(self) -> None:
        self.times.clear()
        self.counts.clear()
        self.values.clear()
        self.counters.clear()


GLOBAL_STATS = Stats()


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``GLOBAL_STATS``' counter ``key``."""
    GLOBAL_STATS.counters[key] += n


class _Off:
    """The shared context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_open = 0           # program spans open while tracing (for the gc span)
_calls = itertools.count(1)


class _Span:
    """A profiler range ``sst.<name>`` with the arguments ``args``."""

    __slots__ = ("_rf",)

    def __init__(self, name: str, args: dict | None = None):
        self._rf = torch._C._profiler._RecordFunctionFast(
            PREFIX + name, (), args or {})

    def __enter__(self):
        global _open
        self._rf.__enter__()
        _open += 1
        return self

    def __exit__(self, *exc):
        global _open
        _open -= 1
        self._rf.__exit__(*exc)
        return False


def span(name: str, args: dict | None = None):
    """``with span("factor.gather"): ...``: the range ``sst.<name>`` while
    tracing (``args`` its arguments), else :data:`OFF`. No span
    synchronizes the device."""
    if not tracing():
        return OFF
    return _Span(name, args)


def _memory_counts() -> dict:
    """The caching allocator's retries and cudaMalloc segments so far."""
    if not torch.cuda.is_initialized():
        return {}
    m = torch.cuda.memory_stats()
    return {"alloc_retries": m.get("num_alloc_retries", 0),
            "malloc_segments": m.get("segment.all.allocated", 0)}


@contextlib.contextmanager
def _entry(phase: str):
    """An entry point's span: its call number, and at its end the call's
    deltas of ``GLOBAL_STATS``' counters (with the allocator's, counted
    while tracing)."""
    call = next(_calls)
    counters = GLOBAL_STATS.counters
    before = dict(counters)
    with _Span(phase, {"call": call}):
        mem0 = _memory_counts()
        try:
            yield
        finally:
            for key, v in _memory_counts().items():
                if v != mem0.get(key, 0):
                    count(key, v - mem0.get(key, 0))
            delta = {k: v - before.get(k, 0) for k, v in counters.items()
                     if v != before.get(k, 0)}
            with _Span("counts", {"call": call, **delta}):
                pass


@contextlib.contextmanager
def timed(phase: str, stats: Stats | None = None):
    """Context manager: ``with timed("factorize"): ...``; the entry
    point's span ``sst.<phase>`` while tracing."""
    s = stats if stats is not None else GLOBAL_STATS
    t0 = time.perf_counter()
    try:
        if tracing():
            with _entry(phase):
                yield s
        else:
            yield s
    finally:
        s.add_time(phase, time.perf_counter() - t0)


_gc_span = None


def _gc_traced(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a collection inside an open span, traced."""
    global _gc_span
    if phase == "start":
        if _open and tracing():
            _gc_span = _Span("gc", {"generation": info["generation"]})
            _gc_span.__enter__()
    elif _gc_span is not None:
        sp, _gc_span = _gc_span, None
        sp.__exit__(None, None, None)


gc.callbacks.append(_gc_traced)
