"""Device time from ``torch.profiler``: the busy union, the idle gaps by the
benchmark's span that was open, and the device operations by self time.

``busy_intervals`` is ``suitesparse_tpu_torch.prof._busy_s`` copied (the
union of the kernels', copies' and memsets' intervals, CUPTI's bookkeeping
rows left out), returning the merged intervals, and leaving out the
device-side rows of the benchmark's own spans as well; ``HAND_KERNELS``
are the ``__global__`` functions of the port's ``kernels/csrc``, copied
from the same module, to name them in the breakdown.
"""

from __future__ import annotations

import dataclasses

import torch

# CUPTI bookkeeping rows that the profiler files under the device but that
# are no device work
NOT_DEVICE_WORK = {"Command Buffer Full", "Activity Buffer Request"}
HAND_KERNELS = ("potrf_trsm_kernel", "extend_add_tiles_kernel",
                "extend_add_kernel", "solve_step_fwd_kernel",
                "solve_step_bwd_kernel", "trisolve_kernel", "pmatvec_kernel",
                "bmatvec_kernel")
SPAN_PREFIX = "bench."
TOP = 10


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(union, spans) -> float:
    """Length of the part of the disjoint ``union`` inside the disjoint
    ``spans``."""
    total = 0.0
    spans = sorted(spans)
    for s, e in union:
        for a, b in spans:
            if b <= s:
                continue
            if a >= e:
                break
            total += min(e, b) - max(s, a)
    return total


def gaps(union, start: float, end: float) -> list[tuple[float, float]]:
    """The idle intervals of ``[start, end]`` outside the disjoint
    ``union``."""
    out, t = [], start
    for s, e in union:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def device_work(name: str) -> bool:
    """Whether a device row is work: not CUPTI's bookkeeping and not the
    device-side copy of one of the benchmark's own spans (the profiler
    files a ``record_function`` range on the device timeline too)."""
    return name not in NOT_DEVICE_WORK and not name.startswith(SPAN_PREFIX)


def kernel_name(name: str) -> str:
    """The bare function name of a profiler kernel row:
    ``void (anonymous namespace)::extend_add_kernel<double, double>(...)``
    gives ``extend_add_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        name = name.split(cut)[0]
    return name.split("::")[-1].strip()


def busy_intervals(events) -> list[tuple[float, float]]:
    """The merged device intervals (microseconds) of ``events``."""
    return merge((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and device_work(e.name))


@dataclasses.dataclass
class Profile:
    """What a profiled stretch of steps read: seconds of the traced window
    and of device work in it, device work inside each span name, the top
    device operations and the longest idle gaps by span."""

    window_s: float
    busy_s: float
    busy_in: dict
    span_s: dict
    device_ops: list
    idle_gaps: list
    hand_kernels: dict
    steps: int


def _label(spans: dict, t: float) -> str:
    for name, ivs in spans.items():
        for s, e in ivs:
            if s <= t <= e:
                return name
    return "host"


def read(prof, window_name: str, steps: int) -> Profile:
    """Reduce a finished ``torch.profiler.profile`` whose steps ran inside
    ``record_function(window_name)`` and whose phases ran inside
    ``record_function("bench.<phase>")``."""
    events = prof.events()
    win = [e for e in events if e.name == window_name]
    if not win:
        raise RuntimeError(f"the trace has no {window_name} span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    spans: dict[str, list] = {}
    for e in events:
        if e.name.startswith(SPAN_PREFIX) and e.name != window_name:
            spans.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    union = [(max(s, w0), min(e, w1)) for s, e in busy_intervals(events)
             if e > w0 and s < w1]
    busy = sum(e - s for s, e in union)
    busy_in = {k: overlap(union, merge(v)) / 1e6 for k, v in spans.items()}
    span_s = {k: sum(e - s for s, e in merge(v)) / 1e6
              for k, v in spans.items()}
    idle = sorted(gaps(union, w0, w1), key=lambda iv: iv[0] - iv[1])[:TOP]
    idle_gaps = [[_label(spans, (s + e) / 2), (e - s) / 1e6]
                 for s, e in idle]
    # the device's own rows (kernels, copies, memsets), by self time
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA
            and device_work(r.key)]
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    device_ops = [[r.key[:200], r.self_device_time_total / 1e6]
                  for r in rows[:TOP]]
    hand = {}
    for r in rows:
        k = kernel_name(r.key)
        if k in HAND_KERNELS:
            ms, n = hand.get(k, (0.0, 0))
            hand[k] = (ms + r.self_device_time_total / 1e3, n + r.count)
    return Profile(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                   busy_in=busy_in, span_s=span_s, device_ops=device_ops,
                   idle_gaps=idle_gaps, hand_kernels=hand, steps=steps)
