"""Milliseconds a step of host time inside the port's span
``sst.factor.groups`` (the group loop's launches, ``_run_plan``), over
the program's profiled steps (``program_trace``)."""

from bench_port import program_trace

LAYER = "factor"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "refactor_ms"
BETTER = "lower"


def read(run):
    p = program_trace.of(run)
    if p is None or "sst.factor.groups" not in p.span_s:
        return None
    return p.span_s["sst.factor.groups"] / p.steps * 1e3
