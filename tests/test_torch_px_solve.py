"""The port's px-layout solve against the reference's.

A factor in the CHOLMOD px layout (the reference's ``layout == "px"``: a
factor rebuilt by ``load_factor``) solves on the device through the px
sweep: per level, groups of supernodes padded to (R, C) on the factor
plan's ladders, each gathering its panels out of ``Lx``; forward
``xc = L11^-1 y[cols]``, ``y[below] -= L21 xc``; backward in reverse.

The plan must equal the reference's ``build_solve_plan(S, "px")`` entry by
entry. The sweep is held to the reference's ``solve_device`` on the same
px factor (the reference's host ``factorize_host`` values, fp64, cast to
the compute dtype by both) at 1 and 8 right-hand sides: 1e-5 of max|x| in
fp32 (both sum in fp32, in other orders), 1e-10 in fp64. The reference
runs as its tests run it off the TPU: its K4 gate is false there, so it
solves with ``triangular_solve``. The port's K4 gate is the reference's
(B >= 32, C <= 96, fp32) and on a CPU tensor K4 runs its plain version;
the fixture ``laplacian_3d(11)`` (S.fl >= 5e6, the device threshold) has a
leaf group of 186 supernodes that takes it, and levels whose groups update
the same ancestor row several times (the scatter must accumulate)."""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal as ref_supernodal
from suitesparse_tpu.numeric import supernodal_solve as ref_solve
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import simplicial, supernodal_solve
from suitesparse_tpu_torch.numeric.supernodal import (SupernodalFactorAdapter,
                                                      TorchPxFactor)
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

X_TOL = {"float32": 1e-5, "float64": 1e-10}
RESID_TOL = {"float32": 1e-5, "float64": 1e-12}

PROBLEMS = {
    "laplacian_3d_11": lambda pkg: pkg.io.fixtures.laplacian_3d(11),
    "laplacian_2d_30": lambda pkg: pkg.io.fixtures.laplacian_2d(30),
}


def _analyses(name):
    Aj = PROBLEMS[name](sst)
    Sj = analyze_supernodal(Aj, nested_dissection_order(Aj, sst.DEFAULT))
    A = PROBLEMS[name](sstt)
    return Aj, Sj, A, port_analyze_supernodal(A, Sj.perm)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_px_plan_equals_the_reference(name):
    _Aj, Sj, _A, S = _analyses(name)
    ref = ref_solve.build_solve_plan(Sj, "px")
    plan = supernodal_solve.px_plan(S)
    assert supernodal_solve.px_plan(S) is plan is S._solve_plans["px"]
    assert (plan.n, plan.lx_size) == (ref.n, ref.lx_size) == (S.n, S.lnz)
    assert len(plan.groups) == len(ref.groups)
    for glist, rlist in zip(plan.groups, ref.groups):
        assert len(glist) == len(rlist)
        for g, r in zip(glist, rlist):
            assert (g.R, g.C, g.B) == (r.R, r.C, r.B)
            for f in ("panel_src", "col_idx", "below_idx", "nc"):
                a, b = getattr(g, f), getattr(r, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.fixture(scope="module")
def px_factors():
    """The same px factor of laplacian_3d(11) in each package."""
    Aj, Sj, A, S = _analyses("laplacian_3d_11")
    Fj = ref_supernodal.factorize_host(Aj, Sj)
    assert Fj.ok and Fj.layout == "px" and S.fl >= 5e6
    return A, Fj, S


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nrhs", [1, 8])
def test_px_sweep_matches_the_reference_solve(px_factors, monkeypatch, dtype,
                                              nrhs):
    A, Fj, S = px_factors
    cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
    tdt = torch.float32 if dtype == "float32" else torch.float64
    F = TorchPxFactor(S=S, Lx=torch.from_numpy(Fj.Lx).to(tdt),
                      minor=Fj.minor)
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    B = b if nrhs == 1 else \
        np.tile(b.reshape(-1, 1), (1, nrhs)) * (1.0 + np.arange(nrhs) / nrhs)
    calls = []
    real = supernodal_solve.batched_trisolve

    def k4(L, Y, transpose=False):
        calls.append((L.shape[0], L.shape[1], Y.shape[2], transpose))
        return real(L, Y, transpose)

    monkeypatch.setattr(supernodal_solve, "batched_trisolve", k4)
    x = sstt.solve(SupernodalFactorAdapter(F), B, cfg)
    xj = ref_solve.solve_device(Fj, B, sst.DEFAULT.replace(
        compute_dtype=dtype))
    assert x.shape == B.shape and np.isfinite(x).all()
    assert np.abs(x - xj).max() <= X_TOL[dtype] * np.abs(xj).max()
    cols = [(x, B)] if nrhs == 1 else [(x[:, k], B[:, k]) for k in (0, 7)]
    for xc, bc in cols:
        assert sstt.residual_norm(A, xc, bc) < RESID_TOL[dtype]
    gated = [(g.B, g.C) for gl in supernodal_solve.px_plan(S).groups
             for g in gl
             if supernodal_solve.px_route(tdt, g.B, g.C, nrhs) == "trisolve"]
    if dtype == "float32":
        assert gated and sorted({c[:2] for c in calls}) == sorted(gated)
        assert {c[3] for c in calls} == {False, True}
        assert all(c[2] == nrhs for c in calls)
    else:
        assert not gated and not calls


def test_px_sweep_accumulates_repeated_rows_and_caches_its_state(px_factors):
    """Within a group several supernodes update one ancestor row; the
    panels are built once per factor and dtype, the plan once per S."""
    A, Fj, S = px_factors
    plan = supernodal_solve.px_plan(S)
    repeats = 0
    for gl in plan.groups:
        for g in gl:
            live = g.below_idx[g.below_idx < S.n]
            repeats += live.size - np.unique(live).size
    assert repeats > 0
    F = TorchPxFactor(S=S, Lx=torch.from_numpy(Fj.Lx).float(),
                      minor=Fj.minor)
    b = np.ones(A.ncol)
    x1 = supernodal_solve.solve_device(F, b)
    panels = F._solve[("px", torch.float32)][1]
    x2 = supernodal_solve.solve_px(F, b)
    assert F._solve[("px", torch.float32)][1] is panels
    assert np.array_equal(x1, x2)
    L11, L21 = panels[0][0]
    g = plan.groups[0][0]
    assert L11.shape == (g.B, g.C, g.C) and L21.shape == (g.B, g.R - g.C, g.C)
    pad = np.flatnonzero(g.nc < g.C)
    if pad.size:   # identity on L11's padding, zero L21 columns
        b0, c0 = int(pad[0]), int(g.nc[pad[0]])
        assert L11[b0, c0, c0] == 1 and (L21[b0, :, c0:] == 0).all()


def test_px_factor_takes_the_host_solvers_for_other_systems(px_factors):
    A, Fj, S = px_factors
    F = SupernodalFactorAdapter(TorchPxFactor(
        S=S, Lx=torch.from_numpy(Fj.Lx), minor=Fj.minor))
    b = 1.0 + np.arange(A.ncol) / A.ncol
    Fh = ref_supernodal.SupernodalFactorAdapter(Fj)
    for sys in ("L", "Lt", "P"):
        x = sstt.solve(F, b, sys=sys)
        xj = sst.solve(Fh, b, sys=sys)
        assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()
    x = simplicial.chol_solve(F, b)
    assert sstt.residual_norm(A, x, b) < 1e-12


def test_px_solve_refuses_a_failed_factor_and_complex_input(px_factors):
    _A, Fj, S = px_factors
    F = TorchPxFactor(S=S, Lx=torch.from_numpy(Fj.Lx), minor=3)
    with pytest.raises(ValueError, match="failed at column 3"):
        supernodal_solve.solve_px(F, np.ones(S.n))
    F.minor = S.n
    with pytest.raises(ValueError, match="real b"):
        supernodal_solve.solve_px(F, np.ones(S.n, dtype=complex))
