"""The port's static reports: ``supernodal_device.roofline_report`` and
``supernodal_solve.solve_report``. Each table's TOTAL row equals the sum
recomputed here from the plan, by the formulas the reports state (the
port's routes and the card's peaks); the reference's TPU constants and
its one-hot placement flops appear in neither."""

import numpy as np
import pytest

import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.device import CARD, CARD_BYTES_S, CARD_FLOP_S
from suitesparse_tpu_torch.numeric import supernodal_device as sd
from suitesparse_tpu_torch.numeric import supernodal_solve as ss
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal


@pytest.fixture(scope="module")
def planned():
    A = sstt.fixtures.laplacian_3d(10)
    S = analyze_supernodal(A, sstt.ordering.nested_dissection_order(
        A, sstt.DEFAULT))
    return S, sd.device_plan(A, S, "cpu").plan


def _total(report: str) -> list:
    line = report.splitlines()[-1].split()
    assert line[0] == "TOTAL"
    return [float(v) for v in line[1:]]


def test_reports_need_a_plan():
    A = sstt.fixtures.laplacian_3d(4)
    S = analyze_supernodal(A)
    with pytest.raises(ValueError):
        sd.roofline_report(S)
    with pytest.raises(ValueError):
        ss.solve_report(S)


@pytest.mark.parametrize("e", [4, 8])
def test_roofline_total_is_the_plans_sum(planned, e):
    S, plan = planned
    fl = byt = ms = 0.0
    for g in (g for gl in plan.groups for g in gl):
        C, RU = g.C, g.R - g.C
        f = g.B * (C ** 3 / 3 + RU * C * C + 2.0 * RU * RU * C)
        b = g.asrc.size * (16 + 2 * e) \
            + e * g.B * (2 * g.R * g.R + g.R * C + RU * RU)
        for src, dst, idx in g._pair_arrays:
            valid = (idx >= 0).sum(1).astype(np.int64)
            b += 3 * e * int((valid ** 2).sum()) \
                + 4 * (idx.size + dst.size + src.size)
        fl, byt = fl + f, byt + b
        ms += 1e3 * max(b / CARD_BYTES_S, f / CARD_FLOP_S[e])
    rep = sd.roofline_report(S, e)
    assert CARD in rep.splitlines()[0]
    assert len(rep.splitlines()) == 3 + sum(len(gl) for gl in plan.groups)
    mflop, mb, inten, bound = _total(rep)
    assert f"{mflop:.1f}" == f"{fl / 1e6:.1f}"
    assert f"{mb:.1f}" == f"{byt / 1e6:.1f}"
    assert f"{inten:.2f}" == f"{fl / byt:.2f}"
    assert f"{bound:.4f}" == f"{ms:.4f}"
    # no placement product: the flops are the dense fronts' alone
    assert fl < 2.5 * S.fl


@pytest.mark.parametrize("nrhs,e", [(1, 4), (8, 8)])
def test_solve_total_is_the_plans_sum(planned, nrhs, e):
    S, plan = planned
    groups = [g for gl in plan.groups for g in gl]
    pan = e * plan.dev_size
    rhs = 2 * e * nrhs * sum(g.B * g.R for g in groups)
    fl = 2.0 * plan.dev_size * nrhs
    ms = sum(2e3 * max((e * sum(g.B * g.R * g.C for g in gl)
                        + 2 * e * nrhs * sum(g.B * g.R for g in gl))
                       / CARD_BYTES_S,
                       2.0 * nrhs * sum(g.B * g.R * g.C for g in gl)
                       / CARD_FLOP_S[e]) for gl in plan.groups)
    rep = ss.solve_report(S, nrhs, e)
    assert CARD in rep.splitlines()[0] and "2 us" not in rep
    steps, pmb, rmb, mflop, bound = _total(rep)
    assert steps == len(groups)
    assert f"{pmb:.2f}" == f"{pan / 1e6:.2f}"
    assert f"{rmb:.2f}" == f"{rhs / 1e6:.2f}"
    assert f"{mflop:.2f}" == f"{fl / 1e6:.2f}"
    assert f"{bound:.4f}" == f"{ms:.4f}"
