"""Seconds of the port's host analysis (``analyze``: the ordering, the
etree and the column counts), by the host clock around the call in
set-up."""

LAYER = "host analysis"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "lower"


def read(run):
    return run.marks.get("analyze_s")
