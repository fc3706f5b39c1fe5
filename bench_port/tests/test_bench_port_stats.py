"""The busy union, the idle gaps and the percentiles on made-up data."""

import statistics
import types

import numpy as np
import pytest
import torch

from bench_port import timing, trace


def ev(name, s, e, dev=True):
    kind = (torch.autograd.DeviceType.CUDA if dev
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=s,
                                                                  end=e))


def test_busy_union():
    events = [ev("k1", 0, 10), ev("k2", 5, 15), ev("k3", 20, 30),
              ev("host", 0, 100, dev=False),
              ev("Command Buffer Full", 40, 90),
              ev("bench.factorize", 0, 95)]     # a span's device-side row
    assert trace.busy_intervals(events) == [(0, 15), (20, 30)]


def test_kernel_name():
    assert trace.kernel_name("void (anonymous namespace)::extend_add_kernel"
                             "<double, double>(double*, int)") == \
        "extend_add_kernel"
    assert trace.kernel_name("void potrf_trsm_kernel<8>(float*)") == \
        "potrf_trsm_kernel"
    assert trace.kernel_name("sm90_xmma_gemm_f64") == "sm90_xmma_gemm_f64"


def test_gaps_and_overlap():
    union = [(0, 15), (20, 30), (50, 60)]
    assert trace.gaps(union, 0, 70) == [(15, 20), (30, 50), (60, 70)]
    assert trace.gaps(union, -5, 25) == [(-5, 0), (15, 20)]
    assert trace.overlap(union, [(10, 25)]) == 5 + 5
    assert trace.overlap(union, [(0, 100)]) == 35
    assert trace.merge([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]


def test_quantile_matches_statistics():
    rng = np.random.default_rng(3)
    vals = list(rng.uniform(0, 1, 101))
    q = statistics.quantiles(vals, n=10, method="inclusive")
    assert timing.quantile(vals, 0.9) == pytest.approx(q[8])
    assert timing.quantile(vals, 0.5) == pytest.approx(statistics.median(vals))
    assert timing.quantile([4.0], 0.9) == 4.0
    assert timing.quantile([1, 2, 3, 4, 5], 0.9) == pytest.approx(4.6)


def test_spans():
    sp = timing.Spans()
    with sp("a"):
        pass
    sp.add("a", 1.0, 3.5)
    assert len(sp.seconds("a")) == 2 and sp.seconds("a")[1] == 2.5
    assert sp.seconds("b") == []
