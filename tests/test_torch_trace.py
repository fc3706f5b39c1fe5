"""The port's spans and counters (``stats.span``, ``stats.timed``,
``Stats.count``) on the CPU: with the profiler off nothing of it is
touched; under ``torch.profiler`` each phase of a factor and of a solve
is one range a call, nested in its entry point's range; the byte
counters equal the sizes of the arrays copied."""

import gc
import types

import numpy as np
import pytest
import torch

import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import prof, stats
from suitesparse_tpu_torch.numeric import segmented
from suitesparse_tpu_torch.numeric import supernodal_device as sd

CPU = [torch.profiler.ProfilerActivity.CPU]
ENTRIES = ("sst.factorize", "sst.solve")
PHASES = {
    "sst.factorize": ("sst.factor.symbolic", "sst.factor.plan",
                      "sst.factor.gather", "sst.factor.upload",
                      "sst.factor.groups", "sst.factor.check"),
    "sst.solve": ("sst.solve.route", "sst.solve.relayout", "sst.solve.state",
                  "sst.solve.rhs", "sst.solve.sweep", "sst.solve.finish"),
}
GROUP_ARGS = {"level", "index", "B", "R", "C", "potrf", "K2", "K7_classes"}


def fresh(k=11):
    """A Laplacian above the device factor's threshold and a new analysis
    of it (no plan cached on it yet)."""
    A = sstt.fixtures.laplacian_3d(k)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    return A, sstt.analyze(A, cfg), cfg


def counted(fn):
    """``fn()`` and the change of every ``GLOBAL_STATS`` counter across
    it."""
    before = dict(stats.GLOBAL_STATS.counters)
    out = fn()
    after = stats.GLOBAL_STATS.counters
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def entry_of(e):
    """The entry point's range that ``e`` is nested in, or None."""
    p = e.cpu_parent
    while p is not None and p.name not in ENTRIES:
        p = p.cpu_parent
    return p


def test_off_enters_no_range_and_reads_no_memory_stats(monkeypatch):
    calls = []

    class Range:
        def __init__(self, *args, **kw):
            calls.append(args[:1])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda *a, **k: calls.append("memory_stats") or {})
    A, S, cfg = fresh()
    assert not stats.tracing()
    F = sstt.factorize(A, S, cfg, "cpu")
    x = sstt.solve(F, np.ones(A.ncol), cfg)
    gc.collect()
    assert calls == [] and np.isfinite(x).all()
    assert stats.span("factor.gather") is stats.OFF
    assert stats.span("factor.group", {"level": 0}) is stats.OFF


def test_spans_nest_under_their_entry_points():
    A, S, cfg = fresh()
    b = 1.0 + np.arange(A.ncol) / A.ncol
    sstt.factorize(A, S, cfg, "cpu")          # the plan and its upload
    with torch.profiler.profile(activities=CPU, record_shapes=True) as p:
        for _ in range(2):
            F = sstt.factorize(A, S, cfg, "cpu")
            sstt.solve(F, b, cfg)
    plan = F.F.dplan.plan
    ngroups = sum(len(gl) for gl in plan.groups)
    ev = [e for e in p.events() if e.name.startswith("sst.")]
    entries = [e for e in ev if e.name in ENTRIES]
    assert [e.name for e in entries] == ["sst.factorize", "sst.solve"] * 2
    calls = [e.kwinputs["call"] for e in entries]
    assert calls == list(range(calls[0], calls[0] + 4))
    for entry in entries:
        inner = [e for e in ev if entry_of(e) is entry]
        names = [e.name for e in inner]
        for phase in PHASES[entry.name]:
            assert names.count(phase) == 1, (entry.name, phase, names)
        if entry.name == "sst.factorize":
            groups = [e for e in inner if e.name == "sst.factor.group"]
            assert len(groups) == ngroups
            assert all(set(g.kwinputs) == GROUP_ARGS for g in groups)
            assert all(g.cpu_parent.name == "sst.factor.groups"
                       for g in groups)
            assert "sst.factor.index_upload" not in names
        direct = [e for e in inner if e.cpu_parent is entry]
        counts = [e for e in direct if e.name == "sst.counts"]
        assert len(counts) == 1
        assert counts[0].kwinputs["call"] == entry.kwinputs["call"]
        covered = sum(e.time_range.elapsed_us() for e in direct)
        assert covered >= 0.9 * entry.time_range.elapsed_us(), entry.name


def test_first_factor_uploads_the_index_arrays_inside_its_span():
    A, S, cfg = fresh()
    with torch.profiler.profile(activities=CPU) as p:
        sstt.factorize(A, S, cfg, "cpu")
    names = [e.name for e in p.events() if e.name.startswith("sst.")]
    assert names.count("sst.factor.index_upload") == 1
    up = next(e for e in p.events() if e.name == "sst.factor.index_upload")
    assert entry_of(up).name == "sst.factorize"


def test_byte_counters_equal_the_arrays():
    A, S, cfg = fresh()
    F, d = counted(lambda: sstt.factorize(A, S, cfg, "cpu"))
    dp = F.F.dplan
    values = A.nnz * A.data.itemsize
    assert d == {"plan.build": 1, "h2d_bytes.index": dp.index_bytes,
                 "h2d_bytes.values": values}
    assert dp.index_bytes == segmented.nbytes(dp.host) > 0
    for nrhs in (1, 3):
        b = np.ones((A.ncol, nrhs)) if nrhs > 1 else np.ones(A.ncol)
        x, d = counted(lambda: sstt.solve(F, b, cfg))
        assert d["h2d_bytes.rhs"] == (A.ncol + 1) * nrhs * 8
        assert d["d2h_bytes.x"] == A.ncol * nrhs * 4     # float32 x
        assert d.get("relayout.build", 0) == (nrhs == 1)
        assert d.get("solve_state.build", 0) == (nrhs == 1)
        assert np.isfinite(x).all()
    F, d = counted(lambda: sstt.factorize(A, S, cfg, "cpu"))
    assert d == {"h2d_bytes.values": values}


def test_segment_uploads_are_spans_and_counted():
    A, S, cfg = fresh(6)
    Ss = sstt.numeric.supernodal.supernodal_symbolic(A, S, cfg)
    seg = cfg.replace(segment_bytes=20000, compute_dtype="float64")
    with torch.profiler.profile(activities=CPU) as p:
        F, d = counted(lambda: sd.factorize_device(A, Ss, seg, "cpu"))
    assert F.segments > 1
    ups = [e for e in p.events() if e.name == "sst.factor.index_upload"]
    assert len(ups) == F.segments
    assert all(e.cpu_parent.name == "sst.factor.groups" for e in ups)
    dtype = torch.float64
    assert d["h2d_bytes.index"] == sum(
        segmented.nbytes(segmented.to_device(sd._select(ix, dtype), "cpu"))
        for ix in F.dplan.host)


def test_gc_inside_a_span_is_traced():
    with torch.profiler.profile(activities=CPU) as p:
        with stats.span("outer"):
            gc.collect()
        gc.collect()
    spans = [e for e in p.events() if e.name.startswith("sst.")]
    collections = [e for e in spans if e.name == "sst.gc"]
    assert collections
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "sst.outer"
               for e in collections)


def test_report_prints_counters_only_when_there_are_any():
    s = stats.Stats()
    s.add_time("factorize", 0.5)
    plain = s.report()
    assert "#" not in plain
    s.count("h2d_bytes.values", 64)
    s.count("h2d_bytes.values", 64)
    s.count("plan.build")
    assert s.report() == plain + ("\nh2d_bytes.values               # 128"
                                  "\nplan.build                     # 1")
    s.clear()
    assert not s.counters and s.report() == stats.Stats().report()


def test_busy_union_leaves_out_user_annotation_rows():
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, start, end, annotation=False, device=cuda):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(start=start, end=end))

    rows = [ev("gemm", 0, 10), ev("copy", 20, 30),
            ev("Command Buffer Full", 40, 50),
            ev("my.phase", 0, 100, annotation=True),
            ev("host op", 0, 100, device=torch.autograd.DeviceType.CPU)]
    assert prof._busy_s(rows) == (20 / 1e6, 2)
