"""Port's inverse-panel sweep without W2 (``solve_mode="inv"``) against the
reference's ``solve_device`` in the same mode.

The reference runs with ``SSTPU_SOLVE_INV=1 SSTPU_SOLVE_W2=0`` (W = L11^-1
a group, two matvecs a step) and unsorted routing (``SSTPU_SOLVE_SORT=0``),
its ``jnp.matmul`` on every group. The port routes by its default route
(fused: one placement a parent group; on the CPU the unsorted sweep's
bits, ``tests/test_torch_solve_routes.py``), and applies W and L21 through
``torch.matmul``, or with ``solve_bmv`` through K6 (``kernels/bmatvec``),
whose CPU tensors take its plain version; ``BMV_MIN_BATCH`` is lowered so
that the small problem's groups reach it. Both sides solve with the same
factor values (the reference's, carried into the port's layout), so x is
held to 1e-10 * max|x| in fp64 and 1e-4 * max|x| in fp32 (sums in other
orders), and the residual to 1e-5 in fp32 (the factor's own accuracy)."""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.numeric import supernodal_solve as ref_solve
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.kernels import bmatvec as bmv_mod
from suitesparse_tpu_torch.kernels.bmatvec import bmv_geometry
from suitesparse_tpu_torch.numeric import supernodal_device, supernodal_solve
from suitesparse_tpu_torch.numeric.supernodal import factor_from_arrays
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

X_TOL = {"float32": 1e-4, "float64": 1e-10}
RESID_TOL = 1e-5
BMIN = 8                  # K6's batch threshold for this small problem
INV = sstt.DEFAULT.replace(solve_mode="inv")


@pytest.fixture(scope="module")
def problem():
    """laplacian_3d(10) analysed once; the reference's fp32 and fp64
    factors and the port's factors carried from them."""
    mp = pytest.MonkeyPatch()
    for k, v in (("SSTPU_PLACE", "tile"),
                 ("SSTPU_TILE_RMIN", "32"), ("SSTPU_SOLVE_INV", "1"),
                 ("SSTPU_SOLVE_W2", "0"), ("SSTPU_SOLVE_SORT", "0"),
                 ("SSTPU_SOLVE_BMV", "0")):
        mp.setenv(k, v)
    A = sst.io.fixtures.laplacian_3d(10)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    At = sstt.fixtures.laplacian_3d(10)
    St = port_analyze_supernodal(At, S.perm)
    out = {}
    for dtype in ("float32", "float64"):
        Fj = ref_device.factorize_device(
            A, S, sst.DEFAULT.replace(compute_dtype=dtype))
        Ft = factor_from_arrays(At, St, np.asarray(Fj.Lx), Fj.minor, "cpu",
                                tile_rmin=32)
        out[dtype] = (Fj, Ft)
    yield At, out
    mp.undo()


def _rhs(n, nrhs):
    b = 1.0 + np.arange(n) / n
    return b if nrhs == 1 else \
        np.tile(b.reshape(-1, 1), (1, nrhs)) * (1.0 + np.arange(nrhs) / nrhs)


@pytest.mark.parametrize("bmv", [False, True], ids=["matmul", "k6"])
@pytest.mark.parametrize("nrhs", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_inv_solve_matches_reference(problem, dtype, nrhs, bmv,
                                     monkeypatch):
    A, factors = problem
    Fj, Ft = factors[dtype]
    monkeypatch.setattr(supernodal_solve, "BMV_MIN_BATCH", BMIN)
    calls = {"fwd": 0, "t": 0}
    inner = supernodal_solve.bmatvec

    def counted(M, X, transpose=False):
        calls["t" if transpose else "fwd"] += 1
        return inner(M, X, transpose)

    monkeypatch.setattr(supernodal_solve, "bmatvec", counted)
    b = _rhs(A.ncol, nrhs)
    xj = ref_solve.solve_device(
        Fj, b, sst.DEFAULT.replace(compute_dtype=dtype))
    cfg = INV.replace(compute_dtype=dtype, solve_bmv=bmv)
    assert supernodal_solve.solve_mode(Ft, cfg) == "inv"
    x = supernodal_solve.solve_device(Ft, b, cfg)
    assert x.shape == xj.shape == b.shape and np.isfinite(x).all()
    assert np.abs(x - xj).max() <= X_TOL[dtype] * np.abs(xj).max()
    col = (lambda v: v) if nrhs == 1 else (lambda v: v[:, -1])
    assert sstt.residual_norm(A, col(x), col(b)) < \
        (1e-12 if dtype == "float64" else RESID_TOL)
    # K6 takes both panels of its groups, both ways, fp32 only; the groups
    # of the coarse solve plan, which the solve takes
    assert supernodal_solve.solve_ladder(Ft) == "coarse"
    groups = [g for gl in supernodal_solve._coarse_plan(Ft.S).groups
              for g in gl]
    k6 = [g for g in groups
          if supernodal_solve.inv_route(g.B, g.C, g.R - g.C, nrhs, cfg)
          == "bmv"]
    if bmv and dtype == "float32":
        assert k6
        n_panels = sum(1 + (g.R > g.C) for g in k6)
        assert calls == {"fwd": n_panels, "t": n_panels}
    else:
        assert not k6 and calls == {"fwd": 0, "t": 0}


def test_inv_routes_and_gates():
    """``inv_route``: the reference's ``_use_bmv`` without W2's rows."""
    on = INV.replace(solve_bmv=True)
    B = supernodal_solve.BMV_MIN_BATCH
    assert supernodal_solve.inv_route(B, 16, 48, 1, on) == "bmv"
    assert supernodal_solve.inv_route(B, 16, 0, 8, on) == "bmv"
    assert supernodal_solve.inv_route(B - 1, 16, 48, 1, on) == "matmul"
    assert supernodal_solve.inv_route(B, 16, 48, 9, on) == "matmul"
    assert supernodal_solve.inv_route(B, 16, 48, 1, INV) == "matmul"
    assert supernodal_solve.inv_route(
        B, 16, 48, 1, on.replace(compute_dtype="float64")) == "matmul"
    # a below block past K6's shared memory keeps the group off K6
    assert supernodal_solve.inv_route(B, 16, 40000, 8, on) == "matmul"


def test_k6_geometry_holds_for_the_inv_panels(problem):
    """Every (C, C) and (RU, C) panel that the inv sweep sends to K6, both
    ways and at every nrhs it admits, has a launch plan that fits the
    card's shared memory, on the test problem and on wide model-like
    shapes (C up to 96, RU up to 720)."""
    A, factors = problem
    Ft = factors["float32"][1]
    on = INV.replace(solve_bmv=True)
    shapes = {(g.B, g.C, g.R - g.C) for gl in Ft.dplan.plan.groups
              for g in gl}
    shapes |= {(B, C, RU) for B in (32, 200, 2500) for C in (8, 16, 48, 96)
               for RU in (0, 8, 64, 240, 720)}
    seen = 0
    for B, C, RU in sorted(shapes):
        for nrhs in range(1, 9):
            if supernodal_solve.inv_route(max(B, 32), C, RU, nrhs, on) \
                    != "bmv":
                continue
            for I in ((C, RU) if RU else (C,)):
                for t in (False, True):
                    g = bmv_geometry(max(B, 32), I, C, nrhs, t)
                    assert g.smem <= bmv_mod.SMEM_BYTES and g.blocks >= 1
                    seen += 1
    assert seen > 100


def test_inv_state_is_cached_and_keyed(problem, monkeypatch):
    A, factors = problem
    _Fj, F0 = factors["float32"]
    F = factor_from_arrays(A, F0.S, F0.Lx.numpy(), F0.minor, "cpu",
                           tile_rmin=32)
    monkeypatch.setattr(supernodal_solve, "BMV_MIN_BATCH", BMIN)
    b = _rhs(A.ncol, 1)
    supernodal_solve.solve_device(F, b, INV)
    key = ("inv", torch.float32, False, BMIN)
    copy = ("relayout",)            # the factor relaid into the solve plan
    assert set(F._solve) == {copy, key}
    W = F._solve[key][1]
    assert all(L21c is None for row in W for _w, L21c in row)
    supernodal_solve.solve_device(F, _rhs(A.ncol, 3), INV)
    assert F._solve[key][1] is W                    # nrhs changes nothing
    on = INV.replace(solve_bmv=True)
    supernodal_solve.solve_device(F, b, on)
    key_on = ("inv", torch.float32, True, BMIN)
    assert set(F._solve) == {copy, key, key_on}
    Won = F._solve[key_on][1]
    assert any(L21c is not None for row in Won for _w, L21c in row)
    for row, row_on in zip(W, Won):
        for (w, _), (w_on, _) in zip(row, row_on):
            assert torch.equal(w, w_on)
    # another batch threshold picks other groups: a state of its own (F3)
    monkeypatch.setattr(supernodal_solve, "BMV_MIN_BATCH", 2 * BMIN)
    supernodal_solve.solve_device(F, b, on)
    assert ("inv", torch.float32, True, 2 * BMIN) in F._solve
    # the W of each group of the solve plan is L11^-1 (identity on
    # padding), from the factor's copy in that plan
    dpc = supernodal_solve._coarse_entry(F.S, F.dplan)[0]
    rt = supernodal_solve._routing(F.S, dpc)
    lx2 = F._solve[copy][2]
    assert F._solve[key][0] is lx2
    for sglist, row in zip(rt.splan.groups, W):
        for sg, (w, _) in zip(sglist, row):
            L11, _L21 = supernodal_solve._group_panels(lx2, sg,
                                                       torch.float64)
            eye = torch.eye(sg.C, dtype=torch.float64)
            assert torch.allclose(L11 @ w.double(), eye.expand_as(L11),
                                  atol=1e-4)


@pytest.mark.parametrize("mode", ["inv", "w2", "classic", "px"])
def test_solve_dispatch_runs_what_solve_device_runs(problem, mode):
    """``solve_dispatch`` gives the sweep and its device arguments with
    every cache filled: calling it twice gives solve_device's x, and its
    arguments stay as they were."""
    A, factors = problem
    F = factors["float32"][1]
    cfg = {"inv": INV, "w2": sstt.DEFAULT,
           "classic": sstt.DEFAULT.replace(solve_mode="classic"),
           "px": sstt.DEFAULT}[mode]
    if mode == "px":
        F = _px_factor(F)
    b = _rhs(A.ncol, 4)
    fn, args = supernodal_solve.solve_dispatch(F, b, cfg)
    keep = [a.clone() for a in args]
    y1 = fn(*args)
    y2 = fn(*args)
    assert all(torch.equal(a, k) for a, k in zip(args, keep))
    assert y1.shape == (A.ncol, 4) and torch.equal(y1, y2)
    x = np.empty((A.ncol, 4))
    x[F.S.perm] = y1.numpy()
    assert np.array_equal(x, supernodal_solve.solve_device(F, b, cfg))
    if mode != "px":
        assert supernodal_solve.solve_mode(F, cfg) == \
            ("w2" if mode == "w2" else mode)


def _px_factor(F):
    """The px-layout factor of the same values (what ``load_factor``
    builds from a saved file)."""
    from suitesparse_tpu_torch.numeric.supernodal import TorchPxFactor
    return TorchPxFactor(S=F.S, Lx=torch.as_tensor(F.lx_host()),
                         minor=F.minor)
