"""The factor's share of its roofline, in percent: the least time the card
takes for the work the matrix and ordering need (``roofline.factor_work``:
CHOLMOD's flop count at the configuration's peak, or A read once and L
written once at 3.35 TB/s, whichever is longer) over the device's busy
time inside the profiled steps' ``factorize`` spans, a step."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "refactor_ms"
BETTER = "higher"


def read(run):
    p = run.profile
    if p is None or not p.busy_in.get("factorize"):
        return None
    per_step = p.busy_in["factorize"] / p.steps
    return 100.0 * run.mix.work()["bound_s"] / per_step
