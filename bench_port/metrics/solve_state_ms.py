"""Device milliseconds a step of the work a new factor's solve launches to
build its per-factor state: the busy union of the device rows launched
inside the port's spans ``sst.solve.relayout`` (``Lx`` relaid into the
coarse solve plan) and ``sst.solve.state`` (W2, inv or classic state),
each row tied to its span by its correlation to the CPU operation that
launched it, over the program's profiled steps (``program_trace``)."""

from bench_port import program_trace

LAYER = "solve"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "refactor_ms"
BETTER = "lower"


def read(run):
    p = program_trace.of(run)
    if p is None or p.busy_s <= 0 or not p.launched_rows:
        return None
    return program_trace.launched_union(
        p, ("sst.solve.relayout", "sst.solve.state")) / p.steps * 1e3
