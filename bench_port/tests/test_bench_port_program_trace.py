"""The reduction of the port's own spans (``program_trace``) on made-up
events, ``trace.read`` unmoved by them, and the readers on a small CPU
run."""

import types

import pytest
import torch

from bench_port import harness, program_trace, trace
from bench_port.program_trace import Ev
from bench_port.tests.test_bench_port_control import small_cell

W = harness.WINDOW_SPAN
NEW = ("factor_head_ms", "factor_enqueue_ms", "factor_loop_idle",
       "solve_state_ms")


def host(name, s, e, corr=0):
    return Ev(name, False, s, e, corr=corr)


def row(name, s, e, link=0, annotation=False):
    return Ev(name, True, s, e, link=link, annotation=annotation)


# one step in ns: the benchmark's spans, the port's spans inside them, the
# CPU operations that launch (correlation ids 1-4) and their device rows
BENCH_ONLY = [
    host(W, 0, 1000),
    host("bench.factorize", 100, 600), host("bench.solve", 650, 945),
    row("bench.factorize", 300, 640, annotation=True),
    row("gemm", 300, 400, link=1), row("potrf", 450, 560, link=2),
    row("w2", 700, 760, link=3), row("sweep", 800, 900, link=4),
    row("Command Buffer Full", 0, 1000),
    host("aten::mm", 280, 290, corr=1), host("aten::potrf", 420, 430, corr=2),
    host("aten::bmm", 690, 695, corr=3), host("aten::mv", 780, 790, corr=4),
]
PROGRAM = [
    host("sst.factorize", 110, 590, corr=10),
    host("sst.factor.gather", 120, 250, corr=11),
    host("sst.factor.groups", 260, 580, corr=12),
    host("sst.solve", 660, 940, corr=13),
    host("sst.solve.state", 680, 700, corr=14),
    host("sst.solve.sweep", 760, 800, corr=15),
    host("sst.gc", 200, 240, corr=16),
]


def fe(e):
    """``e`` as the ``FunctionEvent`` fields ``trace.read`` reads (us)."""
    return types.SimpleNamespace(
        name=e.name, device_type=(torch.autograd.DeviceType.CUDA if e.device
                                  else torch.autograd.DeviceType.CPU),
        time_range=types.SimpleNamespace(start=e.start, end=e.end))


def read_bench(events):
    prof = types.SimpleNamespace(events=lambda: [fe(e) for e in events],
                                 key_averages=lambda: [])
    return trace.read(prof, W, 1)


def test_bench_trace_reads_the_same_with_program_spans():
    """The port's spans are CPU ranges that file no device row:
    ``trace.read`` (the harness's busy union, spans and gaps) is the
    same with them as without them."""
    a, b = read_bench(BENCH_ONLY), read_bench(BENCH_ONLY + PROGRAM)
    assert (a.busy_s, a.busy_in, a.span_s, a.idle_gaps) == \
        (b.busy_s, b.busy_in, b.span_s, b.idle_gaps)
    assert a.busy_s == pytest.approx(370e-6)


def test_a_trace_without_program_spans_reduces_to_nothing():
    assert program_trace.reduce(BENCH_ONLY, 1) is None


def test_program_spans_reduce():
    p = program_trace.reduce(BENCH_ONLY + PROGRAM, 1)
    ns = 1e-9
    # busy as the harness reads it: the annotation and bookkeeping rows out
    assert p.busy_s == pytest.approx(370 * ns)
    assert p.span_s["sst.factor.groups"] == pytest.approx(320 * ns)
    assert p.busy_in["sst.factor.groups"] == pytest.approx(210 * ns)
    # by launch: gemm and potrf in the groups, w2 in the solve's state,
    # the sweep's row in the sweep, none in the gather
    assert p.launched_s["sst.factor.groups"] == pytest.approx(210 * ns)
    assert p.launched_s["sst.solve.state"] == pytest.approx(60 * ns)
    assert p.launched_s["sst.solve.sweep"] == pytest.approx(100 * ns)
    assert "sst.factor.gather" not in p.launched_s
    assert program_trace.launched_union(
        p, ("sst.solve.relayout", "sst.solve.state")) == \
        pytest.approx(60 * ns)
    # self time: the factor's 480 less gather and groups (the gc span
    # nested in gather adds nothing); the solve's 280 less 20 and 40
    assert p.self_share["sst.factorize"] == pytest.approx(100 * 30 / 480)
    assert p.self_share["sst.solve"] == pytest.approx(100 * 220 / 280)
    # each gap by the innermost span open at its middle
    gaps = dict((round(s / ns), name) for name, s in p.idle_gaps)
    assert gaps == {300: "sst.factor.gather", 50: "sst.factor.groups",
                    140: "host", 40: "sst.solve.sweep", 100: "host"}
    assert program_trace.label([("bench.solve", 0, 9)], 5) == "solve"


def test_a_program_without_spans_is_not_profiled_again():
    run = types.SimpleNamespace(sst=types.SimpleNamespace(
        stats=types.SimpleNamespace()))
    assert program_trace.of(run) is None and run.program_profile is None


def test_readers_on_a_small_cpu_run():
    """The readers' profile runs three more steps and leaves the run's
    host spans as they were; on the CPU the device metrics read nothing."""
    cell = small_cell("lap3d80_fp32.refactor", 11)
    run = harness.Run(cell, "cpu")
    k = run.window(run.setup(20260), 0.0)
    spans = {n: list(v) for n, v in run.spans.by_name.items()}
    got = {m["name"]: cell.reader(m).read(run) for m in cell.per_layer
           if m["name"] in NEW}
    assert {n: list(v) for n, v in run.spans.by_name.items()} == spans
    assert got["factor_head_ms"] > 0 and got["factor_enqueue_ms"] > 0
    assert got["factor_loop_idle"] is None and got["solve_state_ms"] is None
    p = run.program_profile
    assert p.counts["sst.factorize"] == p.counts["sst.solve"] == \
        harness.PROFILED_STEPS
    assert max(run.mix.answers) == k + harness.PROFILED_STEPS - 1
