"""Milliseconds a step of host time at the factor's head: the port's spans
``sst.factor.gather`` (A's values gathered into the factor's order on the
host) and ``sst.factor.upload`` (those values to the card, in the compute
dtype), over the program's profiled steps (``program_trace``)."""

from bench_port import program_trace

LAYER = "factor"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "refactor_ms"
BETTER = "lower"
SPANS = ("sst.factor.gather", "sst.factor.upload")


def read(run):
    p = program_trace.of(run)
    if p is None or not all(k in p.span_s for k in SPANS):
        return None
    return sum(p.span_s[k] for k in SPANS) / p.steps * 1e3
