"""Seconds of the first ``factorize`` of set-up, synchronized: the
supernodal analysis, the device plan, the upload of its index arrays and
the factor itself, by the host clock."""

LAYER = "plan and upload"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "lower"


def read(run):
    return run.marks.get("first_factor_s")
