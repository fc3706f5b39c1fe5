"""The port's host factor modification (``numeric/modify.py``), sparse
right-hand-side solves (``numeric/spsolve.py``) and exact rational LU
(``numeric/exact.py``) against the JAX package's copies.

Both packages run the same numpy code on the same seeded input, so the
factors, patterns and solutions are held to each other exactly (rank-1 and
rank-k modifications within 1e-14 of the largest entry, where the two
packages' factors came from the same simplicial code); the exact solutions
as rationals, entry by entry."""

from fractions import Fraction

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import exact as ref_exact
from suitesparse_tpu.numeric import modify as ref_modify
from suitesparse_tpu.numeric import simplicial as ref_simplicial
from suitesparse_tpu.numeric import spsolve as ref_spsolve
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import exact, modify, simplicial, spsolve


def factors(n=60, seed=0):
    """(port A, S, F), (reference A, S, F) of one random SPD matrix, both
    ordered by the reference's AMD."""
    Aj = sst.io.fixtures.random_spd(n, density=0.08, seed=seed)
    A = sstt.fixtures.random_spd(n, density=0.08, seed=seed)
    perm = sst.ordering.amd_order(Aj)
    Sj = ref_simplicial.symbolic_cholesky(Aj, perm)
    S = simplicial.symbolic_cholesky(A, perm)
    return ((A, S, simplicial.chol_up(A, S)),
            (Aj, Sj, ref_simplicial.chol_up(Aj, Sj)))


def w_in_pattern(L, jmin, seed):
    """Dense w whose pattern is a subset of L(:, jmin)'s pattern."""
    rng = np.random.default_rng(seed)
    rows = L.indices[L.indptr[jmin]:L.indptr[jmin + 1]]
    w = np.zeros(L.ncol)
    w[rows] = rng.standard_normal(rows.size)
    return w


def same_factor(F, Fj, tol=1e-14):
    assert np.array_equal(F.L.indptr, Fj.L.indptr)
    assert np.array_equal(F.L.indices, Fj.L.indices)
    assert np.abs(F.L.data - Fj.L.data).max(initial=0.0) <= \
        tol * np.abs(Fj.L.data).max()


@pytest.mark.parametrize("sigma,jmin,seed", [(1.0, 0, 1), (1.0, 20, 3),
                                             (-1.0, 5, 2)])
def test_rank1_updown(sigma, jmin, seed):
    (A, S, F), (Aj, Sj, Fj) = factors(seed=seed)
    w = w_in_pattern(F.L, jmin, seed)
    if sigma < 0:                      # downdate what an update added
        assert modify.updown(F, 1.0, w) and ref_modify.updown(Fj, 1.0, w)
    assert modify.updown(F, sigma, w) == ref_modify.updown(Fj, sigma, w) \
        is True
    same_factor(F, Fj)
    C = A.symperm(S.perm).to_dense() + (sigma > 0) * np.outer(w, w)
    assert np.allclose(F.L.to_dense(), np.linalg.cholesky(C), atol=1e-10)


@pytest.mark.parametrize("k,seed", [(2, 7), (4, 8)])
def test_rank_k_update_and_solve(k, seed):
    (A, S, F), (Aj, Sj, Fj) = factors(seed=seed)
    rng = np.random.default_rng(seed)
    W = np.column_stack([w_in_pattern(F.L, int(rng.integers(0, 30)),
                                      seed * 10 + v) for v in range(k)])
    b = rng.standard_normal(F.L.ncol)
    y = np.linalg.solve(F.L.to_dense(), b)
    yj = y.copy()
    assert modify.updown_solve(F, 1.0, W, y)
    assert ref_modify.updown_solve(Fj, 1.0, W, yj)
    same_factor(F, Fj)
    assert np.abs(y - yj).max() <= 1e-12 * np.abs(yj).max()
    assert np.allclose(F.L.to_dense() @ y, b, atol=1e-8)
    assert modify.updown_k(F, -1.0, W) and ref_modify.updown_k(Fj, -1.0, W)
    same_factor(F, Fj, 1e-12)


def test_downdate_to_indefinite_fails_as_the_reference():
    (A, S, F), (Aj, Sj, Fj) = factors(seed=6)
    w = np.zeros(F.L.ncol)
    w[0] = 2.0 * abs(F.L.data[F.L.indptr[0]])
    assert modify.updown(F, -1.0, w) is False
    assert ref_modify.updown(Fj, -1.0, w) is False


def test_partial_and_full_refactor():
    (A, S, F), (Aj, Sj, Fj) = factors(n=80, seed=8)
    rng = np.random.default_rng(9)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    data = A.data.copy()
    touched = set()
    pinv = np.empty(A.ncol, dtype=np.int64)
    pinv[S.perm] = np.arange(A.ncol)
    for c in (3, 17):
        sel = (cols == c) | (A.indices == c)
        data[sel] *= 1.0 + 0.3 * rng.random(int(sel.sum()))
        touched.update(pinv[cols[sel]].tolist())
        touched.update(pinv[A.indices[sel]].tolist())
    A2 = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, 1)
    A2j = sst.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, 1)
    assert np.array_equal(modify.affected_columns(S.parent, [3, 17]),
                          ref_modify.affected_columns(Sj.parent, [3, 17]))
    F2 = modify.refactor_partial(A2, S, F, sorted(touched))
    F2j = ref_modify.refactor_partial(A2j, Sj, Fj, sorted(touched))
    same_factor(F2, F2j)
    same_factor(F2, simplicial.chol_up(A2, S), 1e-12)
    F3 = modify.refactor_full(A2, S, F)
    same_factor(F3, ref_modify.refactor_full(A2j, Sj, Fj))


def test_row_delete_add_and_resymbol():
    (A, S, F), (Aj, Sj, Fj) = factors(n=50, seed=20)
    C = A.symperm(S.perm).to_dense()
    k = 17
    assert modify.rowdel(F, k) and ref_modify.rowdel(Fj, k)
    same_factor(F, Fj)
    assert modify.rowadd(F, k, C[:, k].copy())
    assert ref_modify.rowadd(Fj, k, C[:, k].copy())
    same_factor(F, Fj)
    G, Gj = modify.resymbol(A, F), ref_modify.resymbol(Aj, Fj)
    same_factor(G, Gj)
    assert G.L.nnz <= F.L.nnz


@pytest.mark.parametrize("seed", [31, 32])
def test_sparse_rhs_solves(seed):
    (A, S, F), (Aj, Sj, Fj) = factors(n=70, seed=seed)
    rng = np.random.default_rng(seed)
    bi = np.sort(rng.choice(A.ncol, 4, replace=False))
    bx = rng.standard_normal(4)
    assert np.array_equal(spsolve.reach(F.L, bi), ref_spsolve.reach(Fj.L, bi))
    xi, xx = spsolve.spsolve_lower(F.L, bi, bx)
    xij, xxj = ref_spsolve.spsolve_lower(Fj.L, bi, bx)
    assert np.array_equal(xi, xij) and np.array_equal(xx, xxj)
    want = np.arange(0, A.ncol, 3)
    yi, yx = spsolve.solve_subset(F, bi, bx, want)
    yij, yxj = ref_spsolve.solve_subset(Fj, bi, bx, want)
    assert np.array_equal(yi, yij) and np.allclose(yx, yxj, rtol=0,
                                                   atol=1e-14)
    b = np.zeros(A.ncol)
    b[bi] = bx
    x = simplicial.chol_solve(F, b)
    full = dict(zip(yi.tolist(), yx.tolist()))
    assert all(abs(full.get(int(i), 0.0) - x[i]) < 1e-10 for i in want)


@pytest.mark.parametrize("case", ["tridiag", "hilbert6", "sparse25"])
def test_exact_lusol_equals_the_reference(case):
    if case == "tridiag":
        D = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 2.0]])
        A, Aj = sstt.from_dense(D), sst.from_dense(D)
        b = np.array([1.0, 2.0, 3.0])
    elif case == "hilbert6":
        D = np.array([[1.0 / (i + j + 1) for j in range(6)]
                      for i in range(6)])
        A, Aj = sstt.from_dense(D), sst.from_dense(D)
        b = np.ones(6)
    else:
        A = sstt.fixtures.random_sparse(25, 25, density=0.15, seed=4)
        Aj = sst.io.fixtures.random_sparse(25, 25, density=0.15, seed=4)
        D = A.to_dense()
        b = np.arange(25, dtype=np.float64)
    x = exact.exact_lusol(A, b)
    assert x == ref_exact.exact_lusol(Aj, b)
    assert all(isinstance(v, Fraction) for v in x)
    n = len(x)
    for i in range(n):
        r = sum(Fraction(float(D[i, j])) * x[j] for j in range(n)) \
            - Fraction(float(b[i]))
        assert r == 0


def test_exact_singular_raises_as_the_reference():
    D = np.array([[1.0, 2.0], [2.0, 4.0]])
    with pytest.raises(AssertionError):
        exact.exact_lusol(sstt.from_dense(D), np.ones(2))
    with pytest.raises(AssertionError):
        ref_exact.exact_lusol(sst.from_dense(D), np.ones(2))
