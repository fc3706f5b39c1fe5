"""The port's host LU path against the JAX package, on the CPU.

- ``maxtrans``, ``strongcomp``, ``btf_order`` and the weighted matching
  ``wmatch`` (the port's copies of the C++ kernels) equal the reference's
  exactly; the matching also beats every permutation's pivot product
  (``tests/test_mflu_unsym.py:145``) and its completion keeps the weighted
  pairs (``:199``).
- ``lu_prep`` and ``offupdate`` equal the reference's bindings exactly.
- ``lusol``, ``factor_lu``/``solve_lu`` and ``refactor_lu`` on
  ``tests/test_lu.py``'s generated cases equal the reference's to 1e-12,
  and ``sstt.lusol`` answers as the reference's ``lusol`` does.
"""

import itertools

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import lu as ref_lu
from suitesparse_tpu.numeric import mflu_unsym as ref_mu
from suitesparse_tpu.ordering import btf as ref_btf
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import native
from suitesparse_tpu_torch.numeric import lu
from suitesparse_tpu_torch.numeric import mflu_unsym as mu
from suitesparse_tpu_torch.ordering import btf
from suitesparse_tpu_torch.sparse import from_dense

from test_torch_host import _reference_native


def pair(D):
    """(port CSC, reference CSC) of dense D."""
    return from_dense(D), sst.from_dense(D)


def random_square(n, density=0.2, seed=0):
    """``tests/test_lu.py``'s generator, diagonally dominant."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(D, rng.standard_normal(n) + np.sign(np.diag(D) + 0.5) * (
        np.abs(D).sum(axis=1) + 1.0))
    return D


def btf_blocks(seed=4):
    """``tests/test_lu.py``'s scrambled matrix of three strongly connected
    diagonal blocks with upper coupling."""
    rng = np.random.default_rng(seed)
    n = 60
    D = np.zeros((n, n))
    for lo, hi in [(0, 20), (20, 45), (45, 60)]:
        k = hi - lo
        B = rng.standard_normal((k, k)) * (rng.random((k, k)) < 0.4)
        np.fill_diagonal(B, np.abs(B).sum(axis=1) + 1.0)
        for i in range(k):
            B[i, (i + 1) % k] = B[i, (i + 1) % k] if B[i, (i + 1) % k] else 0.5
        D[lo:hi, lo:hi] = B
    D[5, 30] = 1.0
    D[25, 50] = 2.0
    p, q = rng.permutation(n), rng.permutation(n)
    return D[np.ix_(p, q)], rng


@pytest.mark.parametrize("seed", range(8))
def test_maxtrans_strongcomp_and_btf_equal_the_reference(seed):
    _reference_native()
    rng = np.random.default_rng(seed)
    m, n = rng.integers(3, 20, size=2)
    D = np.where(rng.random((m, n)) < 0.25, 1.0, 0.0)
    A, Aj = pair(D)
    for limit in (-1.0, 0.5):
        nm, match = btf.maxtrans(A, limit)
        nmj, matchj = ref_btf.maxtrans(Aj, limit)
        assert nm == nmj and np.array_equal(match, matchj)
    S = random_square(int(n) + 5, 0.1, seed) if seed % 2 else btf_blocks()[0]
    A, Aj = pair(S)
    nb, p, r = btf.strongcomp(A)
    nbj, pj, rj = ref_btf.strongcomp(Aj)
    assert nb == nbj and np.array_equal(p, pj) and np.array_equal(r, rj)
    B, Bj = btf.btf_order(A), ref_btf.btf_order(Aj)
    for f in ("rowperm", "colperm", "r"):
        assert np.array_equal(getattr(B, f), getattr(Bj, f)), f
    assert (B.nblocks, B.structural_rank) == (Bj.nblocks, Bj.structural_rank)


def test_btf_order_of_a_structurally_singular_matrix():
    _reference_native()
    D = random_square(15, 0.2, 7)
    D[:, 4] = 0.0
    A, Aj = pair(D)
    B, Bj = btf.btf_order(A), ref_btf.btf_order(Aj)
    assert B.structural_rank == Bj.structural_rank == 14
    assert np.array_equal(B.rowperm, Bj.rowperm)
    assert np.array_equal(B.colperm, Bj.colperm)


def test_weighted_matching_equals_the_reference_and_is_optimal():
    """``tests/test_mflu_unsym.py:145``: the matching's product of pivot
    magnitudes is the largest over all permutations, and it is the
    reference's matching."""
    ref_native = _reference_native()
    rng = np.random.default_rng(4)
    for _ in range(40):
        n = int(rng.integers(2, 7))
        M = np.where(rng.random((n, n)) < 0.6,
                     np.exp(rng.normal(0, 3, (n, n))), 0.0)
        M[np.arange(n), np.arange(n)] = np.maximum(M.diagonal(), 1e-8)
        A, Aj = pair(M)
        nm, match = native.wmatch(n, n, A.indptr, A.indices, A.data)
        nmj, matchj = ref_native.wmatch(n, n, Aj.indptr, Aj.indices, Aj.data)
        assert nm == nmj == n and np.array_equal(match, matchj)
        prod = np.prod([abs(M[match[j], j]) for j in range(n)])
        best = max(np.prod([abs(M[p[j], j]) for j in range(n)])
                   for p in itertools.permutations(range(n)))
        assert prod > best * (1 - 1e-9)


def test_matching_completion_preserves_weighted_pairs():
    """``tests/test_mflu_unsym.py:199``: a column whose stored entries are
    all 0.0 is unmatched by the weighted matcher; the completion augments
    it over the pattern, moving weighted pairs only along one alternating
    path, as the reference's does."""
    n = 6
    rows = np.array([0, 1, 2, 3, 4, 5, 1, 2, 0, 5])
    cols = np.array([0, 1, 2, 3, 4, 5, 0, 1, 5, 0])
    vals = np.array([3., 4., 5., 6., 7., 0., 1., 1., 0., 1.])
    A = sstt.from_triplets(n, n, rows, cols, vals)
    Aj = sst.from_triplets(n, n, rows, cols, vals)
    nm, match = native.wmatch(n, n, A.indptr, A.indices, A.data)
    assert nm == 5 and match[5] == -1
    nm2, m2 = mu._complete_matching(A, match)
    nm2j, m2j = ref_mu._complete_matching(Aj, match)
    assert nm2 == nm2j == n and np.array_equal(m2, m2j)
    for j in range(n):
        assert m2[j] in set(A.indices[A.indptr[j]:A.indptr[j + 1]])
    assert sum(int(match[j] >= 0 and m2[j] != match[j])
               for j in range(n)) <= 1


def test_lu_prep_and_offupdate_equal_the_reference():
    ref_native = _reference_native()
    D, rng = btf_blocks()
    A, Aj = pair(D)
    S = lu.analyze_lu(A)
    pinv = sstt.sparse.invert_permutation(S.rowperm)
    got = native.lu_prep(S.n, A.indptr, A.indices, pinv, S.colperm, S.r)
    want = ref_native.lu_prep(S.n, Aj.indptr, Aj.indices, pinv, S.colperm,
                              S.r)
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g, w)
    assert len(got[4]) == len(want[4]) == S.btf.nblocks
    for g, w in zip(got[4], want[4]):
        assert (g is None) == (w is None)
        if g is not None:
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert all(np.array_equal(a, b) for a, b in zip(got[5], want[5]))
    oip, oi, opos = got[5]
    ox = rng.standard_normal(oi.size)
    x = rng.standard_normal(S.n)
    xj = x.copy()
    native.offupdate(20, 60, oip, oi, ox, x)
    ref_native.offupdate(20, 60, oip, oi, ox, xj)
    assert np.array_equal(x, xj)


@pytest.mark.parametrize("n,seed", [(10, 0), (40, 1), (100, 2)])
def test_lusol_equals_the_reference(n, seed):
    _reference_native()
    D = random_square(n, seed=seed)
    A, Aj = pair(D)
    b = np.random.default_rng(seed + 10).standard_normal(n)
    x = sstt.lusol(A, b)
    assert sstt.residual_norm(A, x, b) < 1e-12
    assert np.allclose(x, sst.lusol(Aj, b), atol=1e-12)
    assert np.allclose(x, np.linalg.solve(D, b), atol=1e-8)


def test_block_factor_is_the_reference_s():
    """One block through the C++ Gilbert-Peierls kernel: P A = L U, and
    the factor arrays are the reference's bit for bit."""
    _reference_native()
    rng = np.random.default_rng(3)
    n = 30
    D = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    np.fill_diagonal(D, 10.0)
    C, Cj = pair(D)
    status, fac = native.lu_factor(n, C.indptr, C.indices, C.data, 1.0)
    assert status == 0
    blu = lu.BlockLU(*fac)
    bluj, statusj = ref_lu._factor_block(Cj, tol=1.0)
    assert statusj == 0
    for f in ("Lp", "Li", "Lx", "Up", "Ui", "Ux", "P"):
        assert np.array_equal(getattr(blu, f), getattr(bluj, f)), f
    L = sstt.CSC(n, n, blu.Lp, blu.Li, blu.Lx, 0).to_dense()
    U = sstt.CSC(n, n, blu.Up, blu.Ui, blu.Ux, 0).to_dense()
    assert np.allclose(L @ U, D[blu.P, :], atol=1e-10)
    assert np.allclose(np.diag(L), 1.0)


@pytest.mark.parametrize("cfg", [dict(lu_pivot_tol=1.0, lu_btf=False,
                                      lu_scale=0),
                                 dict(lu_scale=1), dict()])
def test_partial_pivoting_and_configs(cfg):
    """``tests/test_lu.py``'s small-pivot case (off-diagonal pivots), with
    and without BTF and row scaling."""
    D = np.array([[1e-16, 1.0, 0.0],
                  [1.0, 0.0, 2.0],
                  [0.0, 3.0, 1.0]])
    A, Aj = pair(D)
    b = np.array([1.0, 2.0, 3.0])
    x = sstt.lusol(A, b, sstt.DEFAULT.replace(**cfg))
    assert np.allclose(x, np.linalg.solve(D, b), atol=1e-10)
    assert np.allclose(x, sst.lusol(Aj, b, sst.DEFAULT.replace(**cfg)),
                       atol=1e-12)


def test_multi_rhs_over_btf_blocks_equals_the_reference():
    _reference_native()
    D, rng = btf_blocks()
    A, Aj = pair(D)
    S, Sj = lu.analyze_lu(A), ref_lu.analyze_lu(Aj)
    assert S.btf.nblocks >= 3
    assert np.array_equal(S.rowperm, Sj.rowperm)
    assert np.array_equal(S.colperm, Sj.colperm)
    N, Nj = lu.factor_lu(A, S), ref_lu.factor_lu(Aj, Sj)
    assert N.ok and np.array_equal(N.rowperm, Nj.rowperm)
    B = rng.standard_normal((60, 3))
    X = lu.solve_lu(N, B)
    assert np.allclose(X, ref_lu.solve_lu(Nj, B), atol=1e-12)
    for k in range(3):
        assert sstt.residual_norm(A, X[:, k], B[:, k]) < 1e-12
        assert np.allclose(X[:, k], lu.solve_lu(N, B[:, k]), atol=1e-12)


def test_refactor_same_pattern_equals_the_reference():
    _reference_native()
    rng = np.random.default_rng(5)
    D = random_square(50, density=0.25, seed=6)
    A, Aj = pair(D)
    N, Nj = lu.factor_lu(A, lu.analyze_lu(A)), \
        ref_lu.factor_lu(Aj, ref_lu.analyze_lu(Aj))
    scale = rng.uniform(0.5, 2.0, size=A.nnz)
    A2 = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data * scale, 0)
    Aj2 = sst.CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data * scale, 0)
    N2, Nj2 = lu.refactor_lu(A2, N), ref_lu.refactor_lu(Aj2, Nj)
    assert N2.ok and Nj2.ok
    b = rng.standard_normal(50)
    x = lu.solve_lu(N2, b)
    assert sstt.residual_norm(A2, x, b) < 1e-10
    assert np.allclose(x, ref_lu.solve_lu(Nj2, b), atol=1e-12)
    xr = lu.solve_lu_refined(N2, A2, b, 2)
    assert np.allclose(xr, ref_lu.solve_lu_refined(Nj2, Aj2, b, 2),
                       atol=1e-12)


def test_singular_factor_is_reported():
    D = np.array([[1.0, 2.0], [2.0, 4.0]])  # rank 1
    A, _ = pair(D)
    N = lu.factor_lu(A, lu.analyze_lu(A))
    assert not N.ok
    with pytest.raises(ValueError, match="singular"):
        lu.solve_lu(N, np.ones(2))
