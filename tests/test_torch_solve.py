"""Port's w2 multifrontal solve vs the reference's ``solve_device``.

The reference runs its stacked-inverse (w2) sweep with unsorted routing
(``SSTPU_SOLVE_SORT=0``); the port takes its default route (fused: one
placement a parent group), which gives the class-sorted and the unsorted
sweeps' bits on the CPU (``tests/test_torch_solve_routes.py``,
``tests/test_torch_sorted_route.py``). Both sweeps apply the same W2
panels in fp32 with sums in another order, so x is held to 1e-4 * max|x|
and the residual to 1e-5 (the factor's own fp32 accuracy bounds both)."""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.io import fixtures
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


@pytest.fixture(scope="module")
def factors():
    """One problem, factored by the reference and by the port (CPU), each
    on its own analysis of the same matrix with the reference's ordering."""
    mp = pytest.MonkeyPatch()
    for k, v in (("SSTPU_PALLAS", "1"), ("SSTPU_PLACE", "tile"),
                 ("SSTPU_TILE_RMIN", "32"), ("SSTPU_SOLVE_INV", "1"),
                 ("SSTPU_SOLVE_W2", "1"), ("SSTPU_SOLVE_SORT", "0")):
        mp.setenv(k, v)
    A = fixtures.laplacian_3d(12)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(A, S, sst.DEFAULT)
    At = sstt.fixtures.laplacian_3d(12)
    St = port_analyze_supernodal(At, S.perm)
    Ft = supernodal_device.factorize_device(At, St, sstt.DEFAULT, "cpu",
                                            tile_rmin=32)
    yield At, Fj, Ft
    mp.undo()


def _carried(A, Fj, Ft):
    """The reference factor's values carried into the port's layout, after
    checking that the two plans lay the factor out alike."""
    def shapes(plan):
        return [[(g.R, g.C, g.B, g.panel_base) for g in gl]
                for gl in plan.groups]

    ref = Fj.S._device_plan
    assert shapes(Ft.dplan.plan) == shapes(ref)
    assert Ft.dplan.plan.dev_size == ref.dev_size
    return factor_from_arrays(A, Ft.S, np.asarray(Fj.Lx), Fj.minor, "cpu",
                              tile_rmin=32)


def _rhs(n, nrhs):
    b = 1.0 + np.arange(n) / n
    return b if nrhs == 1 else \
        np.tile(b.reshape(-1, 1), (1, nrhs)) * (1.0 + np.arange(nrhs) / nrhs)


@pytest.mark.parametrize("carried", [False, True],
                         ids=["port_factor", "jax_factor"])
@pytest.mark.parametrize("nrhs", [1, 64])
def test_w2_solve_matches_reference(factors, nrhs, carried):
    A, Fj, Ft = factors
    F = _carried(A, Fj, Ft) if carried else Ft
    b = _rhs(A.ncol, nrhs)
    xj = ref_solve.solve_device(Fj, b, sst.DEFAULT)
    xt = supernodal_solve.solve_device(F, b, sstt.DEFAULT)
    assert supernodal_solve.solve_mode(F, sstt.DEFAULT) == "w2"
    assert xt.shape == xj.shape == b.shape
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
    col = (lambda v: v) if nrhs == 1 else (lambda v: v[:, -1])
    assert sstt.residual_norm(A, col(xt), col(b)) < RESID_TOL


def test_from_jax_factor_carries_the_factor(factors):
    A, Fj, Ft = factors
    F = _carried(A, Fj, Ft)
    assert F.ok and F.minor == Fj.minor
    assert np.array_equal(F.Lx.numpy(), np.asarray(Fj.Lx))
    assert np.array_equal(F.lx_host(), Fj.lx_host())


def test_w2_cached_per_factor(factors):
    A, _Fj, Ft = factors
    key = ("w2", torch.float32)
    b = _rhs(A.ncol, 1)
    supernodal_solve.solve_device(Ft, b, sstt.DEFAULT)
    W2 = Ft._solve[key][1]
    supernodal_solve.solve_device(Ft, _rhs(A.ncol, 3), sstt.DEFAULT)
    assert Ft._solve[key][1] is W2               # nrhs does not change W2
    Ft2 = supernodal_device.factorize_device(A, Ft.S, sstt.DEFAULT, "cpu",
                                             tile_rmin=32)
    supernodal_solve.solve_device(Ft2, b, sstt.DEFAULT)
    # W2 of the coarse solve plan, built from Ft2's copy in that plan
    copy = Ft2._solve[("relayout",)]
    assert copy[0] is Ft2.Lx and Ft2._solve[key][0] is copy[2]
    assert Ft2._solve[key][1] is not W2


def test_solve_refuses_a_failed_factor():
    A = sstt.fixtures.laplacian_3d(8, shift=-3.0)
    S = port_analyze_supernodal(
        A, sstt.ordering.nested_dissection_order(A, sstt.DEFAULT))
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu")
    assert not F.ok
    with pytest.raises(ValueError, match="failed at column"):
        supernodal_solve.solve_device(F, np.ones(A.ncol), sstt.DEFAULT)
