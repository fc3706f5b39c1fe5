"""The device's idle share over the profiled steps, in percent: one less
the union of the device's operation intervals over the traced window."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "refactor_ms"
BETTER = "lower"


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
