"""Median milliseconds of a step's ``factorize`` over the traced run's
window, by the benchmark's host-clock span that ends at a device
synchronize."""

from bench_port import timing

LAYER = "factor"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "refactor_ms"
BETTER = "lower"


def read(run):
    s = run.spans.seconds("factorize")
    return timing.quantile(s, 0.5) * 1e3 if s else None
