"""Port's classic multifrontal solve sweep vs the reference's classic sweep.

The reference runs as its own tests run it off the TPU, in its classic
mode: ``SSTPU_SOLVE_INV=0`` (no inverse panels), ``SSTPU_SOLVE_SORT=0``
(unsorted routing), tile placement from R >= 32, and ``SSTPU_PALLAS=1`` so
that its solve-step (K3) and trisolve (K4) kernels run in interpret mode.
The port analyzes the same matrix itself with the reference's ordering and
factors on the CPU, where its K3/K4 wrappers take their plain versions; it
routes a level at a time (the reference's mf2 routing, whatever the w2 and
inv sweeps' route).
Both sweeps solve with fp32 factors and sum in other orders, so x is held to
1e-4 * max|x| and the residual to 1e-5 (the factor's own accuracy).

Problems: ``laplacian_3d(12)`` (K3 groups, no K4 group) and a forest of 40
independent ``laplacian_3d(6)`` blocks, whose (B, C) = (40, 64) root group
has no below rows and goes to K4. The forest's flops per nonzero of L
(28.6) are below the automatic supernodal switch (40), so the entry points
would factor it on the host; both sides here factor it through their
supernodal device factorization directly."""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.numeric import supernodal_solve as ref_solve
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal_device, supernodal_solve
from suitesparse_tpu_torch.numeric.supernodal import factor_from_arrays
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

X_TOL = 1e-4
RESID_TOL = 1e-5
CLASSIC = sstt.DEFAULT.replace(solve_mode="classic")


def forest(pkg, k: int, nx: int):
    """k independent copies of laplacian_3d(nx) on the block diagonal,
    built with ``pkg``'s generator and CSC (the same matrix for both)."""
    A = pkg.io.fixtures.laplacian_3d(nx)
    n = A.ncol
    cols = np.repeat(np.arange(n), np.diff(A.indptr))
    return pkg.from_triplets(
        k * n, k * n, np.concatenate([A.indices + i * n for i in range(k)]),
        np.concatenate([cols + i * n for i in range(k)]), np.tile(A.data, k),
        sym=1)


PROBLEMS = {
    "laplacian_3d_12": lambda pkg: pkg.io.fixtures.laplacian_3d(12),
    "forest_40x6": lambda pkg: forest(pkg, 40, 6),
}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def factors(request):
    """(A, reference factor, port factor) of one problem."""
    mp = pytest.MonkeyPatch()
    for k, v in (("SSTPU_PALLAS", "1"), ("SSTPU_PLACE", "tile"),
                 ("SSTPU_TILE_RMIN", "32"), ("SSTPU_SOLVE_INV", "0"),
                 ("SSTPU_SOLVE_SORT", "0")):
        mp.setenv(k, v)
    make = PROBLEMS[request.param]
    Aj = make(sst)
    Sj = analyze_supernodal(Aj, nested_dissection_order(Aj, sst.DEFAULT))
    Fj = ref_device.factorize_device(Aj, Sj, sst.DEFAULT)
    A = make(sstt)
    S = port_analyze_supernodal(A, Sj.perm)
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu",
                                           tile_rmin=32)
    yield request.param, A, Fj, F
    mp.undo()


def _rhs(n, nrhs):
    b = 1.0 + np.arange(n) / n
    return b if nrhs == 1 else \
        np.tile(b.reshape(-1, 1), (1, nrhs)) * (1.0 + np.arange(nrhs) / nrhs)


@pytest.mark.parametrize("nrhs", [1, 64])
def test_classic_solve_matches_reference(factors, nrhs):
    _name, A, Fj, F = factors
    b = _rhs(A.ncol, nrhs)
    xj = ref_solve.solve_device(Fj, b, sst.DEFAULT)
    x = supernodal_solve.solve_device(F, b, CLASSIC)
    assert supernodal_solve.solve_mode(F, CLASSIC) == "classic"
    assert x.shape == xj.shape == b.shape and np.isfinite(x).all()
    assert np.abs(x - xj).max() <= X_TOL * np.abs(xj).max()
    for k in ([0] if nrhs == 1 else [0, nrhs - 1]):
        col = (lambda v: v) if nrhs == 1 else (lambda v: v[:, k])
        assert sstt.residual_norm(A, col(x), col(b)) < RESID_TOL


def test_routing_sends_groups_to_k3_and_k4(factors):
    name, _A, _Fj, F = factors
    routes = {}
    for gl in F.dplan.plan.groups:
        for g in gl:
            RU = g.R - g.C
            r = supernodal_solve.classic_route(torch.float32, g.B, g.C, RU, 1)
            routes[(g.B, g.C, RU)] = r
            # the reference's gates with the card's fit functions
            if RU > 0 and g.B >= 8 and g.C <= 96:
                assert r == "solve_step"
            elif g.B >= 32 and g.C <= 96:
                assert r == "trisolve"
            else:
                assert r == "library"
            assert supernodal_solve.classic_route(
                torch.float64, g.B, g.C, RU, 1) == "library"
    n_k3 = sum(r == "solve_step" for r in routes.values())
    if name == "forest_40x6":
        assert routes[(40, 64, 0)] == "trisolve"
        assert n_k3 == 8
        assert [k for k, r in routes.items() if r == "trisolve"] == \
            [(40, 64, 0)]
    else:
        assert n_k3 >= 2 and "trisolve" not in routes.values()


def test_auto_gives_w2_and_the_cache_keys_on_the_mode(factors, monkeypatch):
    _name, A, _Fj, F0 = factors
    F = supernodal_device.factorize_device(A, F0.S, sstt.DEFAULT, "cpu",
                                           tile_rmin=32)
    b = _rhs(A.ncol, 1)
    assert supernodal_solve.solve_mode(F, sstt.DEFAULT) == "w2"
    x_auto = supernodal_solve.solve_device(F, b, sstt.DEFAULT)
    # beside the states, the factor's copy in the coarse solve plan
    copy = ("relayout",)
    assert set(F._solve) == {copy, ("w2", torch.float32)}
    x_classic = supernodal_solve.solve_device(F, b, CLASSIC)
    assert set(F._solve) == {copy, ("w2", torch.float32),
                             ("classic", torch.float32)}
    W2 = F._solve[("w2", torch.float32)][1]
    assert np.abs(x_auto - x_classic).max() <= X_TOL * np.abs(x_auto).max()
    # a card whose memory has no room for W2: auto takes the classic sweep
    # on a factor without W2, but keeps the W2 that is already built
    monkeypatch.setattr(supernodal_solve, "_w2_fits",
                        lambda F, dtype, config: False)
    assert supernodal_solve.solve_mode(F, sstt.DEFAULT) == "w2"
    F2 = supernodal_device.factorize_device(A, F0.S, sstt.DEFAULT, "cpu",
                                            tile_rmin=32)
    assert supernodal_solve.solve_mode(F2, sstt.DEFAULT) == "classic"
    x2 = supernodal_solve.solve_device(F2, b, sstt.DEFAULT)
    assert set(F2._solve) == {copy, ("classic", torch.float32)}
    # the same sweep on equal factors (CPU threads may sum in other orders)
    assert np.abs(x2 - x_classic).max() <= 1e-6 * np.abs(x_classic).max()
    assert F._solve[("w2", torch.float32)][1] is W2
    # w2 is reached only through auto; the coarse plan is the plan every
    # sweep takes where its copy fits, not a mode ("inv" is a mode of its
    # own since the W-only sweep landed)
    for bad in ("coarse", "w2"):
        with pytest.raises(ValueError, match="solve_mode"):
            supernodal_solve.solve_mode(F, sstt.DEFAULT.replace(
                solve_mode=bad))


def test_factor_from_arrays_carries_a_jax_factor(factors):
    _name, A, Fj, F = factors
    Lx = np.asarray(Fj.Lx)
    assert Lx.shape == (F.dplan.plan.dev_size,)
    Fc = factor_from_arrays(A, F.S, Lx, Fj.minor, "cpu", tile_rmin=32)
    assert Fc.ok and Fc.Lx.dtype == torch.float32
    assert np.array_equal(Fc.Lx.numpy(), Lx)               # bit for bit
    with pytest.raises(ValueError, match="entries"):
        factor_from_arrays(A, F.S, Lx[:-1], Fj.minor, "cpu", tile_rmin=32)


def test_solve_refined_reaches_fp64_residual():
    """As the reference's own test asks of its device factor
    (tests/test_supernodal.py: laplacian_3d(7), refined residual < 1e-14)."""
    A = sstt.fixtures.laplacian_3d(7)
    S = port_analyze_supernodal(
        A, sstt.ordering.nested_dissection_order(A, sstt.DEFAULT))
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu")
    b = 1.0 + np.arange(A.ncol) / A.ncol
    for config in (sstt.DEFAULT, CLASSIC):
        x = sstt.solve(F, b, config)
        assert sstt.residual_norm(A, x, b) < 1e-5
        xr = sstt.solve_refined(F, A, b, config=config)
        assert sstt.residual_norm(A, xr, b) < 1e-14
