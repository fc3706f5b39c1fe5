"""Port's w2 sweep with its kernel routes (K5 ``pmatvec_t`` and K6
``bmatvec``, plain versions on the CPU) vs the reference's w2 sweep with
its own (``SSTPU_SOLVE_PMV=1``, ``SSTPU_SOLVE_BMV=1``, Pallas in interpret
mode).

Both sides lower the kernels' thresholds so that ``laplacian_3d(12)`` has
groups on each route: the reference through ``SSTPU_PMV_MIN_CELLS=20000``
and ``SSTPU_BMV_BMIN=4``, the port through its module constants. The
reference keeps its TPU padding and VMEM clauses, so a group may take
another route on each side; both apply the same W2 in fp32 with sums in
another order, so x is held to 1e-4 * max|x| and the residual to 1e-5, as
the plain w2 parity test holds them."""

import types

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.numeric import supernodal_solve as ref_solve
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.kernels.bmatvec import bmatvec
from suitesparse_tpu_torch.kernels.pmatvec import pmatvec_t
from suitesparse_tpu_torch.numeric import supernodal_device, supernodal_solve
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

X_TOL = 1e-4
RESID_TOL = 1e-5
KERNELS = sstt.DEFAULT.replace(solve_pmv=True, solve_bmv=True)
REF_ENV = (("SSTPU_PALLAS", "1"), ("SSTPU_PLACE", "tile"),
           ("SSTPU_TILE_RMIN", "32"), ("SSTPU_SOLVE_INV", "1"),
           ("SSTPU_SOLVE_W2", "1"), ("SSTPU_SOLVE_PMV", "1"),
           ("SSTPU_PMV_MIN_CELLS", "20000"), ("SSTPU_SOLVE_BMV", "1"),
           ("SSTPU_BMV_BMIN", "4"), ("SSTPU_SOLVE_SORT", "0"))


@pytest.fixture(autouse=True)
def low_thresholds(monkeypatch):
    monkeypatch.setattr(supernodal_solve, "PMV_MIN_CELLS", 20000)
    monkeypatch.setattr(supernodal_solve, "BMV_MIN_BATCH", 4)


@pytest.fixture(scope="module")
def factors():
    """One problem factored by the reference and by the port (CPU), each on
    its own analysis of the same matrix with the reference's ordering."""
    mp = pytest.MonkeyPatch()
    for k, v in REF_ENV:
        mp.setenv(k, v)
    A = sst.io.fixtures.laplacian_3d(12)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(A, S, sst.DEFAULT)
    At = sstt.fixtures.laplacian_3d(12)
    St = port_analyze_supernodal(At, S.perm)
    Ft = supernodal_device.factorize_device(At, St, sstt.DEFAULT, "cpu",
                                            tile_rmin=32)
    yield At, Fj, Ft
    mp.undo()


def _rhs(n, nrhs):
    b = 1.0 + np.arange(n) / n
    return b if nrhs == 1 else \
        np.tile(b.reshape(-1, 1), (1, nrhs)) * (1.0 + np.arange(nrhs) / nrhs)


def _routes(F, nrhs, config=KERNELS):
    return [supernodal_solve.w2_route(g.B, g.R, g.C, nrhs, config)
            for gl in F.dplan.plan.groups for g in gl]


@pytest.mark.parametrize("nrhs", [1, 3])
def test_w2_kernel_solve_matches_reference(factors, nrhs):
    A, Fj, Ft = factors
    b = _rhs(A.ncol, nrhs)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV:
            mp.setenv(k, v)
        xj = ref_solve.solve_device(Fj, b, sst.DEFAULT)
    before = (pmatvec_t.launches, bmatvec.launches,
              bmatvec.transposed_launches)
    xt = supernodal_solve.solve_device(Ft, b, KERNELS)
    assert (pmatvec_t.launches, bmatvec.launches,
            bmatvec.transposed_launches) == before      # plain on the CPU
    assert xt.shape == xj.shape == b.shape and np.isfinite(xt).all()
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
    for k in range(nrhs):
        col = (lambda v: v) if nrhs == 1 else (lambda v: v[:, k])
        assert sstt.residual_norm(A, col(xt), col(b)) < RESID_TOL


def test_routing_takes_each_kernel_at_small_nrhs(factors):
    _A, _Fj, Ft = factors
    r1 = _routes(Ft, 1)
    assert "pmv" in r1 and "bmv" in r1 and "matmul" in r1
    assert set(_routes(Ft, 8)) == set(r1)
    assert set(_routes(Ft, 64)) == {"matmul"}
    assert set(_routes(Ft, 1, sstt.DEFAULT)) == {"matmul"}
    assert set(_routes(Ft, 1, KERNELS.replace(
        compute_dtype="float64"))) == {"matmul"}
    for g, r in zip((g for gl in Ft.dplan.plan.groups for g in gl), r1):
        if r == "pmv":
            assert g.B <= 32 and g.B * g.R * g.C >= 20000
        elif r == "bmv":
            assert g.B >= 4


def test_alternating_nrhs_rebuilds_no_state(factors):
    A, _Fj, Ft0 = factors
    F = supernodal_device.factorize_device(A, Ft0.S, sstt.DEFAULT, "cpu",
                                           tile_rmin=32)
    xs = {}
    for nrhs in (1, 64, 1):
        xs[nrhs] = supernodal_solve.solve_device(F, _rhs(A.ncol, nrhs),
                                                 KERNELS)
        if nrhs == 1 and len(xs) == 1:
            state = {k: v[1] for k, v in F._solve.items()}
    assert set(state) == {("relayout",), ("w2", torch.float32),
                          ("w2t", torch.float32, 20000)}
    assert set(F._solve) == set(state)
    assert all(F._solve[k][1] is v for k, v in state.items())
    # W2^T exactly for the K5 groups of the coarse solve plan, which the
    # solve takes, and W2 shared with the plain w2 sweep; every panel
    # contiguous, as the kernels take it
    W2t = state[("w2t", torch.float32, 20000)]
    flat = [t for row in W2t for t in row]
    coarse = supernodal_solve._coarse_plan(F.S)
    assert [t is not None for t in flat] == [
        supernodal_solve.w2_route(g.B, g.R, g.C, 1, KERNELS) == "pmv"
        for gl in coarse.groups for g in gl]
    W2 = state[("w2", torch.float32)]
    assert all(t.is_contiguous() for row in W2 for t in row)
    assert all(t.is_contiguous() for t in flat if t is not None)
    supernodal_solve.solve_device(F, _rhs(A.ncol, 1), sstt.DEFAULT)
    assert F._solve[("w2", torch.float32)][1] is state[("w2",
                                                        torch.float32)]
    # another threshold picks other groups: a state of its own
    supernodal_solve.PMV_MIN_CELLS = 40000
    supernodal_solve.solve_device(F, _rhs(A.ncol, 1), KERNELS)
    assert ("w2t", torch.float32, 40000) in F._solve


def test_capacity_gate_counts_the_w2t_copies(factors, monkeypatch):
    _A, _Fj, Ft = factors
    plan = Ft.dplan.plan
    w2 = supernodal_solve._w2_need(plan, torch.float32, sstt.DEFAULT)
    assert w2 == 2 * 4 * plan.dev_size
    pmv_cells = sum(g.B * g.R * g.C for gl in plan.groups for g in gl
                    if supernodal_solve.w2_route(g.B, g.R, g.C, 1, KERNELS)
                    == "pmv")
    assert pmv_cells > 0
    assert supernodal_solve._w2_need(plan, torch.float32, KERNELS) == \
        w2 + 2 * 4 * pmv_cells
    # a card with exactly W2's room: w2 fits, W2 with its W2^T copies not
    # (on the factor's own plan, which a solve takes where the copy in the
    # coarse solve plan does not fit)
    card = types.SimpleNamespace(Lx=types.SimpleNamespace(
        device=torch.device("cuda", 0)), dplan=Ft.dplan)
    monkeypatch.setattr(supernodal_solve, "solve_ladder", lambda F: "fine")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (w2, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    assert supernodal_solve._w2_fits(card, torch.float32, sstt.DEFAULT)
    assert not supernodal_solve._w2_fits(card, torch.float32, KERNELS)


def test_refinement_with_both_kernels_reaches_fp64_residual(factors):
    A, _Fj, Ft = factors
    b = _rhs(A.ncol, 1)
    xr = sstt.solve_refined(Ft, A, b, config=KERNELS)
    assert sstt.residual_norm(A, xr, b) < 1e-14
