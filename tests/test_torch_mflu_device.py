"""Port's symmetric-strategy device LU (``numeric/mflu_device.py``) against
the reference's.

Both analyse the same matrix with ``analyze_mflu`` (the same AMD order and
row pre-permutation, checked), factor it in fp64 and fp32, and are held
entry by entry: the L and U^T panels within 1e-12 (fp64) and 1e-4 (fp32)
of their largest entry, the pivot permutations equal. The solve is held to
the reference's host solve (x within 1e-10 relative in fp64) and to the
residual gate of the reference's tests (1e-8 in fp64, 1e-4 in fp32)."""

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import mflu_device as ref_dev
from suitesparse_tpu.numeric import multifrontal_lu as ref_mflu
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import mflu_device, multifrontal_lu

PANEL_TOL = {"float64": 1e-12, "float32": 1e-4}
RESID_TOL = {"float64": 1e-8, "float32": 1e-4}
D3 = np.array([[0.0, 2.0, 1.0],
               [4.0, 1.0, 0.5],
               [1.0, 0.0, 3.0]])

CASES = {
    "rand100": lambda pkg: pkg.io.fixtures.random_sparse(100, 100, 0.05,
                                                         seed=3),
    "rand400": lambda pkg: pkg.io.fixtures.random_sparse(400, 400, 0.02,
                                                         seed=9),
    # the reference's tests/test_mflu.py:45 case: a zero diagonal entry,
    # which the analysis's row pre-permutation moves off the diagonal
    "pivot3": lambda pkg: pkg.from_dense(D3),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make = CASES[request.param]
    Aj, A = make(sst), make(sstt)
    Sj = ref_mflu.analyze_mflu(Aj)
    S = multifrontal_lu.analyze_mflu(A)
    assert np.array_equal(Sj.perm, S.perm)
    assert np.array_equal(Sj._rowpre, S._rowpre)
    return request.param, Aj, Sj, A, S


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_panels_and_pivots_match_the_reference(case, dtype):
    name, Aj, Sj, A, S = case
    Fj = ref_dev.factorize_lu_device(
        Aj, Sj, sst.DEFAULT.replace(compute_dtype=dtype))
    F = mflu_device.factorize_lu_device(
        A, S, sstt.DEFAULT.replace(compute_dtype=dtype), "cpu")
    assert F.ok and Fj.ok
    for mine, ref in ((F.Lpanels, Fj.Lpanels), (F.Utpanels, Fj.Utpanels)):
        ref = np.asarray(ref, dtype=np.float64)
        assert mine.shape == ref.shape
        assert np.abs(mine.double().numpy() - ref).max() <= \
            PANEL_TOL[dtype] * np.abs(ref).max()
    assert np.array_equal(F.perms.numpy(), np.asarray(Fj.perms))
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    x = mflu_device.solve_mflu_device(F, b)
    assert sstt.residual_norm(A, x, b) < RESID_TOL[dtype]
    if dtype == "float64":
        xj = ref_dev.solve_mflu_device(Fj, b)
        assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()
        if name == "pivot3":
            assert np.allclose(D3 @ x, b, atol=1e-12)


def test_factor_many_and_several_right_hand_sides():
    """The plan and its upload are built once on S: a second factor of new
    values reuses them; a 2-D b solves column by column."""
    A = sstt.fixtures.random_sparse(150, 150, 0.04, seed=5)
    S = multifrontal_lu.analyze_mflu(A)
    cfg = sstt.DEFAULT.replace(compute_dtype="float64")
    F1 = mflu_device.factorize_lu_device(A, S, cfg, "cpu")
    plan, groups = S._mflu_dev_plan, S._torch_mflu["cpu"]
    A2 = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data * 1.5, 0)
    F2 = mflu_device.factorize_lu_device(A2, S, cfg, "cpu")
    assert S._mflu_dev_plan is plan and S._torch_mflu["cpu"] is groups
    assert F2.groups is F1.groups
    b = np.stack([np.ones(150), np.arange(150.0)], axis=1)
    x2 = mflu_device.solve_mflu_device(F2, b)
    for k in range(2):
        assert sstt.residual_norm(A2, x2[:, k], b[:, k]) < 1e-10
        assert np.allclose(x2[:, k],
                           mflu_device.solve_mflu_device(F2, b[:, k]))


def test_updates_are_placed_by_flat_position():
    """``_flat_dst``: a child update's cell (i, j) lands at dst*R*R +
    idx_i*R + idx_j of the flattened fronts, a padded row or column at the
    dump cell B*R*R; the plan's classes equal the reference's."""
    idx = np.array([[2, 0, -1], [1, -1, -1]], dtype=np.int32)
    dst = np.array([1, 0], dtype=np.int32)
    pos = mflu_device._flat_dst(dst, idx, R=4, B=2).reshape(2, 3, 3)
    assert pos[0, 0, 0] == 16 + 2 * 4 + 2 and pos[0, 0, 1] == 16 + 8 + 0
    assert pos[0, 1, 0] == 16 + 2 and pos[1, 0, 0] == 4 + 1
    assert (pos[0, 2] == 32).all() and (pos[0, :, 2] == 32).all()
    assert (pos[1, 1:] == 32).all() and (pos[1, :, 1:] == 32).all()
    A = sstt.fixtures.random_sparse(100, 100, 0.05, seed=3)
    Aj = sst.io.fixtures.random_sparse(100, 100, 0.05, seed=3)
    S, Sj = multifrontal_lu.analyze_mflu(A), ref_mflu.analyze_mflu(Aj)
    Cg = multifrontal_lu._perm_general(A, S)
    Cgj = ref_mflu._perm_general(Aj, Sj)
    P = mflu_device.build_lu_plan(S, Cg, Cg.transpose())
    Pj = ref_dev.build_lu_plan(Sj, Cgj, Cgj.transpose())
    assert P.dev_size == Pj.dev_size
    for gl, glj in zip(P.groups, Pj.groups, strict=True):
        for g, gj in zip(gl, glj, strict=True):
            assert (g.R, g.C, g.B, g.panel_base) == \
                (gj.R, gj.C, gj.B, gj.panel_base)
            assert np.array_equal(g.adst, gj.adst)
            assert np.array_equal(g.asrc, gj.asrc)
            for p, pj in zip(g.pairs, gj.pairs, strict=True):
                assert p[:3] == pj[:3]
                for a, aj in zip(p[3:], pj[3:]):
                    assert np.array_equal(a, aj)


def test_a_non_finite_factor_reports_minor():
    """A non-finite entry of A gives non-finite panels: ``minor`` is 0, as
    the reference's factor reports it, and the solve refuses."""
    D = np.array([[4.0, 1.0, 0.0], [1.0, 4.0, 1.0], [0.0, 1.0, np.inf]])
    cfg = sstt.DEFAULT.replace(compute_dtype="float64")
    A = sstt.from_dense(D)
    F = mflu_device.factorize_lu_device(
        A, multifrontal_lu.analyze_mflu(A), cfg, "cpu")
    Aj = sst.from_dense(D)
    Fj = ref_dev.factorize_lu_device(
        Aj, ref_mflu.analyze_mflu(Aj),
        sst.DEFAULT.replace(compute_dtype="float64"))
    assert F.minor == Fj.minor == 0 and not F.ok
    with pytest.raises(ValueError, match="not finite"):
        mflu_device.solve_mflu_device(F, np.ones(3))
