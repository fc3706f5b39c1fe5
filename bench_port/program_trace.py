"""The port's own spans (``sst.*``, from ``suitesparse_tpu_torch.stats``)
over profiled steps, for the per-layer metrics that read them.

``trace.read`` reduces the harness's profiled steps to the benchmark's own
``bench.`` spans. The readers of the port's spans share one more profile
of ``harness.PROFILED_STEPS`` steps a run (:func:`of`, kept on the run),
with the same phases, synchronized as the harness's profiled steps are,
and reduce its raw events here:

- ``span_s``: host seconds inside each span name (its intervals merged);
- the busy union: the device rows that are work (not CUPTI's bookkeeping,
  not the device-side row of a user annotation such as a ``bench.``
  span's: the port's spans are function-scope ranges and file none);
- ``busy_in``: device busy inside each span name's host intervals;
- ``launched_s``: device busy of the rows launched inside each span name,
  each row tied by its correlation to the CPU operation that launched it;
- ``self_share``: for each entry span (``sst.factorize``, ``sst.solve``),
  the share of its host time that no span nested in it covers;
- ``idle_gaps``: the longest idle gaps of the device, each named by the
  innermost span open at its middle (a port's span, else a ``bench.``
  span, else ``host``).

A program without spans (``stats.span`` missing) is not profiled again:
:func:`of` returns None, and so does every reader.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import traceback

from bench_port import timing
from bench_port.harness import PROFILED_STEPS, WINDOW_SPAN
from bench_port.trace import NOT_DEVICE_WORK, TOP, gaps, merge

PROGRAM = "sst."
BENCH = "bench."
ENTRIES = ("sst.factorize", "sst.solve")


@dataclasses.dataclass(frozen=True)
class Ev:
    """One raw profiler event: times in ns; ``corr`` its correlation id,
    ``link`` that of the CPU operation that launched it (0 for a CPU
    operation itself)."""

    name: str
    device: bool
    start: int
    end: int
    corr: int = 0
    link: int = 0
    annotation: bool = False


@dataclasses.dataclass
class ProgramProfile:
    steps: int
    window_s: float
    busy_s: float
    span_s: dict
    busy_in: dict
    launched_s: dict
    launched_rows: dict      # span name -> merged device intervals (ns)
    counts: dict
    self_share: dict
    idle_gaps: list


def work(e: Ev) -> bool:
    """Whether a device row is work."""
    return e.device and not e.annotation and e.name not in NOT_DEVICE_WORK \
        and not e.name.startswith((BENCH, PROGRAM))


class Intervals:
    """Sorted disjoint intervals, with membership by bisection."""

    def __init__(self, ivs):
        self.ivs = merge(ivs)
        self.starts = [s for s, _e in self.ivs]

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ivs[i][1]

    def length(self) -> int:
        return sum(e - s for s, e in self.ivs)

    def overlap(self, union: list) -> int:
        """Length of the sorted disjoint ``union`` inside these, in one
        pass (``trace.overlap`` rescans the spans for each interval: too
        slow for a trace's hundreds of group spans)."""
        total, i = 0, 0
        for a, b in self.ivs:
            while i < len(union) and union[i][1] <= a:
                i += 1
            j = i
            while j < len(union) and union[j][0] < b:
                total += min(b, union[j][1]) - max(a, union[j][0])
                j += 1
        return total


def label(spans: list, t: float) -> str:
    """The innermost span (the shortest interval) of ``spans`` ((name,
    start, end), program and benchmark spans) open at ``t``, without its
    prefix; ``host`` where none is."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    if best is None:
        return "host"
    name = best[0]
    return name[len(BENCH):] if name.startswith(BENCH) else name


def reduce(events: list, steps: int) -> ProgramProfile | None:
    """The profile of ``events`` (:class:`Ev`) whose steps ran inside the
    span ``WINDOW_SPAN``; None where the window holds no program span."""
    win = [e for e in events if e.name == WINDOW_SPAN and not e.device]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    host = [e for e in events if not e.device and e.name != WINDOW_SPAN
            and e.name.startswith((PROGRAM, BENCH))]
    prog: dict[str, list] = {}
    for e in host:
        if e.name.startswith(PROGRAM):
            prog.setdefault(e.name, []).append((e.start, e.end))
    if not prog:
        return None
    union = [(max(s, w0), min(e, w1)) for s, e in merge(
        (e.start, e.end) for e in events if work(e)) if e > w0 and s < w1]
    merged = {k: Intervals(v) for k, v in prog.items()}
    busy_in = {k: v.overlap(union) / 1e9 for k, v in merged.items()}
    span_s = {k: v.length() / 1e9 for k, v in merged.items()}
    # the CPU operations' starts by correlation id, then each device row
    # by the span names its launching operation started in
    op_start = {e.corr: e.start for e in events
                if not e.device and e.link == 0}
    rows: dict[str, list] = {}
    for e in events:
        if work(e) and e.link in op_start:
            t = op_start[e.link]
            for k, v in merged.items():
                if t in v:
                    rows.setdefault(k, []).append((e.start, e.end))
    rows = {k: merge(v) for k, v in rows.items()}
    launched_s = {k: sum(e - s for s, e in v) / 1e9 for k, v in rows.items()}
    self_share = {}
    for name in ENTRIES:
        total = covered = 0
        for s, e in prog.get(name, ()):
            inner = [(max(a, s), min(b, e)) for k, v in prog.items()
                     for a, b in v if a >= s and b <= e
                     and (a, b) != (s, e)]
            total += e - s
            covered += sum(b - a for a, b in merge(inner))
        if total:
            self_share[name] = 100.0 * (total - covered) / total
    spans = [(e.name, e.start, e.end) for e in host]
    idle = sorted(gaps(union, w0, w1), key=lambda iv: iv[0] - iv[1])[:TOP]
    return ProgramProfile(
        steps=steps, window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in union) / 1e9, span_s=span_s,
        busy_in=busy_in, launched_s=launched_s, launched_rows=rows,
        counts={k: len(v) for k, v in prog.items()}, self_share=self_share,
        idle_gaps=[[label(spans, (s + e) / 2), (e - s) / 1e9]
                   for s, e in idle])


def launched_union(p: ProgramProfile, names) -> float:
    """Device seconds of the union of the rows launched inside any of the
    span ``names``."""
    return sum(e - s for s, e in merge(
        iv for k in names for iv in p.launched_rows.get(k, ()))) / 1e9


def raw_events(prof) -> list:
    """The raw events of a finished ``torch.profiler.profile`` as
    :class:`Ev` (without parsing them into ``FunctionEvent``s)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for k in prof.profiler.kineto_results.events():
        if getattr(k, "is_hidden_event", lambda: False)():
            continue
        start = k.start_ns()
        annotation = getattr(k, "is_user_annotation", lambda: False)()
        out.append(Ev(name=k.name(), device=k.device_type() == cuda,
                      start=start, end=start + k.duration_ns(),
                      corr=k.correlation_id(),
                      link=k.linked_correlation_id(),
                      annotation=bool(annotation)))
    return out


def _profile(run) -> ProgramProfile | None:
    """``PROFILED_STEPS`` more steps of ``run`` under ``torch.profiler``,
    as ``harness.Run.profiled`` runs them, reduced."""
    torch = run.torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    k0 = max(run.mix.answers, default=0) + 1
    keep = run.spans
    run.spans = timing.Spans()
    try:
        run.sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                for k in range(k0, k0 + PROFILED_STEPS):
                    run.mix.step(k, sync=True,
                                 label=torch.profiler.record_function)
                run.sync()
    finally:
        run.spans = keep
    return reduce(raw_events(prof), PROFILED_STEPS)


def of(run) -> ProgramProfile | None:
    """The program's span profile of ``run``, made at the first call and
    kept on the run; None for a program without spans, or where it
    failed (its traceback on standard error)."""
    if "program_profile" not in vars(run):
        p = None
        if hasattr(getattr(run.sst, "stats", None), "span"):
            try:
                p = _profile(run)
            except Exception:        # a reader reports nothing, not a crash
                traceback.print_exc()
            if p is not None:
                print(f"program spans over {p.steps} profiled steps: host "
                      f"s {p.span_s}; device busy in each s {p.busy_in}; "
                      f"launched in each s {p.launched_s}; spans "
                      f"{p.counts}; self share % {p.self_share}; busy "
                      f"{p.busy_s} of {p.window_s} s; idle gaps "
                      f"{p.idle_gaps}", file=sys.stderr)
        run.program_profile = p
    return run.program_profile
