"""The device's idle share inside the port's span ``sst.factor.groups``
(the group loop), in percent: one less the device's busy time inside the
span's host intervals over their length, over the program's profiled
steps (``program_trace``): the loss to a launch-bound loop."""

from bench_port import program_trace

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "refactor_ms"
BETTER = "lower"


def read(run):
    p = program_trace.of(run)
    if p is None or p.busy_s <= 0 or not p.span_s.get("sst.factor.groups"):
        return None
    return 100.0 * (1.0 - p.busy_in["sst.factor.groups"]
                    / p.span_s["sst.factor.groups"])
