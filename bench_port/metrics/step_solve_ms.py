"""Median milliseconds of a step's ``solve`` over the traced run's window
(the new factor's relayout and W2 state, the sweep, the numpy round
trip), by the benchmark's host-clock span."""

from bench_port import timing

LAYER = "solve"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "refactor_ms"
BETTER = "lower"


def read(run):
    s = run.spans.seconds("solve")
    return timing.quantile(s, 0.5) * 1e3 if s else None
