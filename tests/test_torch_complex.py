"""Complex input to the port against the JAX package, on the CPU.

- The 2x2 real embedding (``embed_matrix``, ``embed_vec``,
  ``unembed_vec``, ``expand_perm``) equals the reference's exactly,
  patterns and values, explicit zeros included, for upper Hermitian and
  general input.
- ``sparse`` with complex values (``to_full_storage``, ``symperm``,
  ``from_triplets`` duplicates, ``matvec``, ``to_dense``) against dense
  numpy to 1e-14.
- The host LL^H (``chol_up``) equals the reference's on the same (A, S) to
  1e-12; the complex triangular solves against dense numpy.
- ``cholsol_complex_device`` against the reference's on the dense n = 90
  HPD of ``tests/test_complex_device.py`` and on a magnetic Laplacian with
  k = 8 (n = 1,024 real), both within 1e-4 and the reference's gate
  max|Hx - b| / max|b| < 1e-4; ``cholsol`` takes the embedding at
  ``S.fl >= 2e6`` and the host below, each right with ``ComplexWarning``
  an error; a value change in place flows through and another ordering
  analyses again.
- ``lusol`` (host KLU) against the reference's ``lu.lusol`` to 1e-10;
  ``lusol_complex_device`` and ``mflusol_unsym`` against the reference's
  to 1e-8; ``qrsol_complex_device`` against the reference's and against
  ``lstsq`` at 300 x 140 to 1e-4; the complex minimum norm at 30 x 50.
- F13 and F14: the port agrees with dense numpy where the reference drops
  the imaginary part.
"""

import warnings

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu import sparse as ref_sparse
from suitesparse_tpu.numeric import complex_embed as ref_ce
from suitesparse_tpu.numeric import lu as ref_lu
from suitesparse_tpu.numeric import multifrontal_lu as ref_ml
from suitesparse_tpu.numeric import qr as ref_qr
from suitesparse_tpu.numeric import simplicial as ref_simplicial
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import complex_embed as ce
from suitesparse_tpu_torch.numeric import mflu_unsym as mu
from suitesparse_tpu_torch.numeric import mfqr_device as md
from suitesparse_tpu_torch.numeric import multifrontal_lu as ml
from suitesparse_tpu_torch.numeric import simplicial, supernodal

CPU = "cpu"
ComplexWarning = np.exceptions.ComplexWarning


def hpd(n, seed):
    """``tests/test_complex_device.py``'s dense HPD matrix."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return H @ H.conj().T + 2 * n * np.eye(n)


def magnetic_laplacian(k, seed=0):
    """``laplacian_3d(k)`` with each strictly-upper entry times e^{i theta},
    theta ~ U(-pi, pi) from ``default_rng(seed)`` in storage order: a
    connection Laplacian plus the Dirichlet boundary, Hermitian positive
    definite, its diagonal's imaginary parts explicit zeros."""
    A = sstt.fixtures.laplacian_3d(k)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    off = A.indices < cols
    theta = np.random.default_rng(seed).uniform(-np.pi, np.pi,
                                                int(off.sum()))
    data = A.data.astype(np.complex128)
    data[off] *= np.exp(1j * theta)
    return sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, 1)


def rand_complex(m, n, density, seed, diag=0.0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    D[rng.random((m, n)) > density] = 0.0
    if diag:
        D[np.arange(min(m, n)), np.arange(min(m, n))] += diag
    return D


def ref_of(A):
    return sst.CSC(A.nrow, A.ncol, A.indptr.copy(), A.indices.copy(),
                   A.data.copy(), A.sym)


def rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


def herm_gate(Hd, x, b):
    """The reference's gate (``tests/test_complex_device.py:40``)."""
    return np.abs(Hd @ x - b).max() / np.abs(b).max()


def same_csc(A, R):
    assert (A.nrow, A.ncol, A.sym) == (R.nrow, R.ncol, R.sym)
    assert np.array_equal(A.indptr, R.indptr)
    assert np.array_equal(A.indices, R.indices)
    assert A.data.dtype == R.data.dtype
    assert np.array_equal(A.data, R.data)


@pytest.mark.parametrize("sym", [1, 0])
def test_embedding_equals_the_reference(sym):
    H = magnetic_laplacian(4, seed=3)
    A = H if sym == 1 else H.to_full_storage()
    M, R = ce.embed_matrix(A), ref_ce.embed_matrix(ref_of(A))
    same_csc(M, R)
    # the diagonal's zero imaginary parts stay as explicit entries
    assert M.nnz == (4 * A.nnz - A.ncol if sym == 1 else 4 * A.nnz)
    assert np.count_nonzero(M.data == 0.0) >= A.ncol
    rng = np.random.default_rng(1)
    for shape in ((A.ncol,), (A.ncol, 3)):
        b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        e = ce.embed_vec(b)
        assert np.array_equal(e, ref_ce.embed_vec(b))
        assert np.array_equal(ce.unembed_vec(e), ref_ce.unembed_vec(e))
        assert np.array_equal(ce.unembed_vec(e), b)
        # the isomorphism: M e(x) = e(A x)
        assert np.abs(M.matvec(e) - ce.embed_vec(A.matvec(b))).max() < 1e-12
    p = rng.permutation(A.ncol)
    assert np.array_equal(ce.expand_perm(p), ref_ce.expand_perm(p))


def test_embedding_of_general_rectangular_input():
    D = rand_complex(13, 7, 0.4, 2)
    D[3, 2] = 1.5           # a real entry: its zero imaginary part stays
    A = sstt.sparse.from_dense(D)
    same_csc(ce.embed_matrix(A), ref_ce.embed_matrix(ref_of(A)))
    assert ce.embed_matrix(A).nnz == 4 * A.nnz


def test_sparse_with_complex_values():
    H = magnetic_laplacian(3, seed=5)
    Hd = H.to_dense()
    assert np.array_equal(Hd, ref_of(H).to_dense())
    assert np.abs(Hd - Hd.conj().T).max() == 0.0
    F = H.to_full_storage()
    assert F.sym == 0 and np.abs(F.to_dense() - Hd).max() < 1e-14
    same_csc(F, ref_of(H).to_full_storage())
    p = np.random.default_rng(2).permutation(H.ncol)
    P = H.symperm(p)
    same_csc(P, ref_of(H).symperm(p))
    assert np.abs(P.to_dense() - Hd[np.ix_(p, p)]).max() < 1e-14
    # duplicates: real and imaginary parts summed apart; zeros kept
    rows = np.array([0, 2, 0, 1, 2, 1])
    cols = np.array([1, 0, 1, 1, 0, 2])
    vals = np.array([1 + 2j, 3 - 1j, -0.5 + 0.25j, 0j, 1j, 2.0 + 0j])
    T = sstt.from_triplets(3, 3, rows, cols, vals)
    dense = np.zeros((3, 3), complex)
    np.add.at(dense, (rows, cols), vals)
    assert T.data.dtype == np.complex128 and T.nnz == 4
    assert np.abs(T.to_dense() - dense).max() < 1e-14
    same_csc(T, ref_sparse.from_triplets(3, 3, rows, cols, vals))
    rng = np.random.default_rng(4)
    for shape in ((H.ncol,), (H.ncol, 2)):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        assert np.abs(H.matvec(x) - Hd @ x).max() < 1e-14 * np.abs(
            Hd @ x).max()
    assert H.norm1() == pytest.approx(np.abs(Hd).sum(axis=0).max(),
                                      rel=1e-14)


def test_host_llh_equals_the_reference():
    H = magnetic_laplacian(5, seed=1)
    p = sstt.ordering.amd_order(H)
    S = simplicial.symbolic_cholesky(H, p)
    Sr = ref_simplicial.symbolic_cholesky(ref_of(H), p)
    F = simplicial.chol_up(H, S)
    Fr = ref_simplicial.chol_up(ref_of(H), Sr)
    assert F.ok and Fr.ok and F.L.data.dtype == np.complex128
    assert np.array_equal(F.L.indices, Fr.L.indices)
    assert np.abs(F.L.data - Fr.L.data).max() < 1e-12
    L = F.L.to_dense()
    Pd = H.to_dense()[np.ix_(p, p)]
    assert np.abs(L @ L.conj().T - Pd).max() < 1e-12
    rng = np.random.default_rng(0)
    for shape in ((H.ncol,), (H.ncol, 3)):
        y = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        assert np.abs(L @ simplicial.lsolve(F.L, y) - y).max() < 1e-12
        assert np.abs(L.conj().T @ simplicial.ltsolve(F.L, y)
                      - y).max() < 1e-12
        U = sstt.sparse.from_dense(L.conj().T)
        assert np.abs(L.conj().T @ simplicial.usolve(U, y) - y).max() < 1e-12
        assert np.abs(L @ simplicial.utsolve(U, y) - y).max() < 1e-12
    b = rng.standard_normal(H.ncol) + 1j * rng.standard_normal(H.ncol)
    for x in (simplicial.chol_solve(F, b),
              simplicial.solve_system(F, b, "A")):
        assert np.abs(H.to_dense() @ x - b).max() < 1e-12
    with pytest.raises(ValueError, match="real-only"):
        simplicial.ldl_up(H, S)


def test_factorize_takes_the_host_llh_and_the_device_factors_refuse():
    H = magnetic_laplacian(6, seed=2)
    Hd = H.to_dense()
    b = np.ones(H.ncol) + 0.5j
    S = sstt.analyze(H)
    for kind in (sstt.FactorKind.AUTO, sstt.FactorKind.SUPERNODAL_LL,
                 sstt.FactorKind.SIMPLICIAL_LL):
        F = sstt.factorize(H, S, sstt.DEFAULT.replace(factor_kind=kind),
                           device=CPU)
        assert isinstance(F, simplicial.Factor) and F.d is None
        assert np.abs(Hd @ sstt.solve(F, b) - b).max() < 1e-12
    with pytest.raises(ValueError, match="cholsol"):
        supernodal.factorize(H, S, device=CPU)
    A = sstt.sparse.from_dense(rand_complex(30, 30, 0.2, 1, diag=4.0))
    with pytest.raises(ValueError, match="mflusol_unsym"):
        mu.lu_unsym_solve_device(A, np.ones(30), device=CPU)
    with pytest.raises(ValueError, match="qrsol"):
        md.mfqrsol_device(A, np.ones(30), device=CPU)


@pytest.mark.parametrize("case", ["dense90", "magnetic8"])
def test_cholsol_complex_device_matches_the_reference(case):
    if case == "dense90":
        Hd = hpd(90, 2)
        H = sstt.sparse.from_dense(Hd, sym=1)
        b = np.ones(90) + 1j * np.arange(90)
    else:
        H = magnetic_laplacian(8)
        Hd = H.to_dense()
        b = 1 + 1j * np.arange(H.ncol) / H.ncol
    with warnings.catch_warnings():
        warnings.simplefilter("error", ComplexWarning)
        x = ce.cholsol_complex_device(H, b, device=CPU)
    x_ref = ref_ce.cholsol_complex_device(ref_of(H), b)
    assert x.dtype == np.complex128 and x.shape == b.shape
    assert rel(x, x_ref) < 1e-4
    assert herm_gate(Hd, x, b) < 1e-4
    # the embedded analysis: conjugate pairs adjacent, even supernodes
    S = ce.embedded_analysis(H)
    assert S.n == 2 * H.ncol
    assert np.array_equal(S.perm[1::2], S.perm[0::2] + 1)
    widths = np.diff(S.super_first)
    assert np.all(widths % 2 == 0)


def test_cholsol_routes_big_complex_input_to_the_embedding(monkeypatch):
    calls = []
    orig = ce.cholsol_complex_device

    def spy(A, b, config=sstt.DEFAULT, **kw):
        calls.append(kw)
        return orig(A, b, config, **kw)

    monkeypatch.setattr(ce, "cholsol_complex_device", spy)
    for k, device_route in ((10, True), (8, False)):
        H = magnetic_laplacian(k, seed=k)
        Hd = H.to_dense()
        b = 1 + 1j * np.arange(H.ncol) / H.ncol
        fl = sstt.analyze(H).fl
        assert (fl >= ce.CPLX_DEVICE_FL) == device_route, fl
        del calls[:]
        with warnings.catch_warnings():
            warnings.simplefilter("error", ComplexWarning)
            x = sstt.cholsol(H, b, device=CPU)
        assert len(calls) == int(device_route)
        if device_route:
            assert calls[0]["device"] == CPU
            assert calls[0]["perm"] is not None
        assert herm_gate(Hd, x, b) < (1e-4 if device_route else 1e-12)


def test_midsize_complex_never_casts_to_real():
    """The reference's test of that name, on the port."""
    rng = np.random.default_rng(5)
    for n in (80, 130):
        H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        Hd = H @ H.conj().T + 3 * n * np.eye(n)
        A = sstt.sparse.from_dense(Hd, sym=1)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        with warnings.catch_warnings():
            warnings.simplefilter("error", ComplexWarning)
            x = sstt.cholsol(A, b, device=CPU)
        assert herm_gate(Hd, x, b) < 5e-4


def test_value_changes_flow_through_and_the_cache_keys_on_the_ordering():
    H = magnetic_laplacian(6, seed=4)
    Hd = H.to_dense()
    b = np.ones(H.ncol, dtype=np.complex128)
    x1 = ce.cholsol_complex_device(H, b, device=CPU)
    S1 = ce.embedded_analysis(H)
    assert herm_gate(Hd, x1, b) < 1e-4
    H.data *= 2.0                        # in place: same pattern
    x2 = ce.cholsol_complex_device(H, b, device=CPU)
    assert ce.embedded_analysis(H) is S1        # the analysis was reused
    assert herm_gate(2 * Hd, x2, b) < 1e-4
    assert rel(x2, x1 / 2) < 1e-4
    nd = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    x3 = ce.cholsol_complex_device(H, b, nd, device=CPU)
    S3 = ce.embedded_analysis(H, nd)
    assert S3 is not S1 and not np.array_equal(S3.perm, S1.perm)
    assert herm_gate(2 * Hd, x3, b) < 1e-4
    relaxed = nd.replace(nrelax=(0, 0, 0), zrelax=(0.0, 0.0, 0.0))
    ce.cholsol_complex_device(H, b, relaxed, device=CPU)
    S4 = ce.embedded_analysis(H, relaxed)
    assert S4 is not S3 and S4.nsuper > S3.nsuper


def test_host_lusol_matches_the_reference():
    G = rand_complex(80, 80, 0.12, 3, diag=4 + 2j)
    A = sstt.sparse.from_dense(G)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(80) + 1j * rng.standard_normal(80)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ComplexWarning)
        x = sstt.lusol(A, b)
        X = sstt.lusol(A, np.stack([b, 1j * b], axis=1))
    x_ref = ref_lu.lusol(ref_of(A), b)
    assert rel(x, x_ref) < 1e-10
    assert np.abs(G @ x - b).max() < 1e-10
    assert np.abs(G @ X - np.stack([b, 1j * b], axis=1)).max() < 1e-10
    # a real matrix with a complex right-hand side
    Ar = sstt.sparse.from_dense(G.real + 4 * np.eye(80))
    xr = sstt.lusol(Ar, b)
    assert np.abs((G.real + 4 * np.eye(80)) @ xr - b).max() < 1e-10
    # the same-pattern refactor of complex values: a fresh factor
    S = sstt.lu.analyze_lu(A)
    N = sstt.lu.factor_lu(A, S)
    A2 = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data * (1 - 1j), 0)
    N2 = sstt.lu.refactor_lu(A2, N)
    assert np.abs((G * (1 - 1j)) @ sstt.lu.solve_lu(N2, b) - b).max() < 1e-10


def test_device_lu_of_the_embedding_matches_the_reference():
    G = rand_complex(80, 80, 0.12, 3, diag=4 + 2j)
    A = sstt.sparse.from_dense(G)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(80) + 1j * rng.standard_normal(80)
    x_ref = ref_ce.lusol_complex_device(ref_of(A), b)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ComplexWarning)
        x = ce.lusol_complex_device(A, b, device=CPU)
        rungs0 = dict(mu.rungs)
        x2 = mu.mflusol_unsym(A, b, device=CPU)
        assert mu.rungs["lu"] == rungs0["lu"] + 1
        x3 = ml.mflusol(sstt.sparse.from_dense(np.triu(G, -3)), b,
                        device=CPU)
    assert rel(x, x_ref) < 1e-8 and rel(x2, x_ref) < 1e-8
    assert np.abs(G @ x2 - b).max() / np.abs(b).max() < 1e-8
    assert np.abs(np.triu(G, -3) @ x3 - b).max() / np.abs(b).max() < 1e-8


def test_qrsol_complex_device_matches_the_reference_and_lstsq():
    rng = np.random.default_rng(4)
    m, n = 300, 140
    C = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    A = sstt.sparse.from_dense(C)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    x = ce.qrsol_complex_device(A, b, device=CPU)
    x_ref = ref_ce.qrsol_complex_device(ref_of(A), b)
    x_ls = np.linalg.lstsq(C, b, rcond=None)[0]
    assert rel(x, x_ref) < 1e-4 and rel(x, x_ls) < 1e-4
    # through qrsol: m * n = 42,000 < 65,536 takes the host QR of the
    # embedding; a real A with a complex b embeds as well
    assert rel(sstt.qrsol(A, b, device=CPU), x_ls) < 1e-10
    xr = sstt.qrsol(sstt.sparse.from_dense(C.real), b, device=CPU)
    assert rel(xr, np.linalg.lstsq(C.real, b, rcond=None)[0]) < 1e-10


def test_qrsol_sends_big_complex_least_squares_to_the_device(monkeypatch):
    calls = []
    orig = md.mfqrsol_device

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return orig(*args, **kw)

    monkeypatch.setattr(md, "mfqrsol_device", spy)
    D = rand_complex(400, 180, 0.05, 6)
    D[np.arange(180), np.arange(180)] += 3.0
    A = sstt.sparse.from_dense(D)
    b = np.random.default_rng(6).standard_normal(400) + 0j
    x = sstt.qrsol(A, b, device=CPU)
    assert calls == [(800, 360)]
    assert rel(x, np.linalg.lstsq(D, b, rcond=None)[0]) < 1e-4


def test_min_norm_complex_underdetermined():
    rng = np.random.default_rng(8)
    m, n = 30, 50
    C = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    A = sstt.sparse.from_dense(C)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ComplexWarning)
        x = sstt.qrsol(A, b, device=CPU)
    assert np.abs(C @ x - b).max() / np.abs(b).max() < 1e-10
    assert rel(x, np.linalg.pinv(C) @ b) < 1e-10


def test_f13_symmetric_strategy_keeps_the_imaginary_part():
    n = 40
    rng = np.random.default_rng(13)
    D = np.diag(np.full(n, 6 + 1j))
    for i in range(n - 1):
        D[i, i + 1] = rng.standard_normal() + 1j * rng.standard_normal()
        D[i + 1, i] = rng.standard_normal() + 1j * rng.standard_normal()
    A = sstt.sparse.from_dense(D)
    assert A.symmetry()["structural"] == 1.0
    b = np.ones(n) + 1j * np.arange(n) / n
    with warnings.catch_warnings():
        warnings.simplefilter("error", ComplexWarning)
        x = ml.mflusol(A, b, device=CPU)
    assert np.abs(D @ x - b).max() / np.abs(b).max() < 1e-12
    with pytest.warns(ComplexWarning):
        x_ref = ref_ml.mflusol(ref_of(A), b)
    assert np.abs(D @ x_ref - b).max() / np.abs(b).max() > 0.1


def test_f14_small_complex_least_squares_keeps_the_imaginary_part():
    rng = np.random.default_rng(14)
    m, n = 60, 30
    C = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    A = sstt.sparse.from_dense(C)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    x_ls = np.linalg.lstsq(C, b, rcond=None)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error", ComplexWarning)
        x = sstt.qrsol(A, b, device=CPU)
    assert rel(x, x_ls) < 1e-10
    with pytest.warns(ComplexWarning):
        x_ref = ref_qr.qrsol(ref_of(A), b)
    assert rel(x_ref, x_ls) > 0.1


def test_complex_right_hand_side_on_a_real_device_factor():
    """A real device factor takes a real b only, as the reference's
    ``solve_device``: a complex b raises ``ValueError`` (complex systems
    run through ``cholsol``'s embedding) and the real solve still answers."""
    A = sstt.fixtures.laplacian_3d(12)
    S = sstt.analyze(A)
    n = A.ncol
    b = 1 + np.arange(n) / n
    F = sstt.factorize(A, S, device=CPU)
    assert isinstance(F.F, supernodal.TorchSupernodalFactor)
    with pytest.raises(ValueError, match="cholsol"):
        sstt.solve(F, b - 2j * b[::-1])
    assert sstt.residual_norm(A, sstt.solve(F, b), b) < 1e-5


def test_profiler_builds_the_smoke_cell():
    """``prof.magnetic_laplacian`` (the profiler's copy of the complex
    cell's matrix) equals this file's, and so ``chip_smoke.py``'s."""
    from suitesparse_tpu_torch import prof

    for k, seed in ((3, 0), (5, 7)):
        P, H = prof.magnetic_laplacian(k, seed), magnetic_laplacian(k, seed)
        assert np.array_equal(P.indptr, H.indptr)
        assert np.array_equal(P.indices, H.indices)
        assert np.array_equal(P.data, H.data) and P.sym == H.sym == 1
