"""The port's host QR, COLAMD and the ``qrsol`` router against the JAX
package.

The orderings, the column elimination tree analysis and R are compared
exactly or at fp64 rounding (the same numpy code in both packages), the
solutions at 1e-10; the router is held to its routes: the host below
65,536 cells, the device multifrontal QR above, the minimum-norm solution
for m < n, symmetric storage expanded first."""

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import qr as ref_qr
from suitesparse_tpu.ordering.colamd import colamd_order as ref_colamd
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import mfqr_device, qr, simplicial
from suitesparse_tpu_torch.ordering import colamd_order

from test_torch_host import _reference_native


def random_rect(m, n, density=0.3, seed=0, full_rank=True):
    """The dense test matrix of ``tests/test_qr.py`` as (port CSC,
    reference CSC, dense)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    if full_rank:
        k = min(m, n)
        D[np.arange(k), np.arange(k)] += 3.0 + np.arange(k) * 0.01
    r, c = np.nonzero(D)
    return (sstt.from_triplets(m, n, r, c, D[r, c]),
            sst.from_triplets(m, n, r, c, D[r, c]), D)


ORDER_CASES = [(40, 25, 0.3, 1), (200, 120, 0.05, 2), (500, 300, 0.01, 3)]


@pytest.mark.parametrize("aggressive", [True, False])
@pytest.mark.parametrize("m,n,dens,seed", ORDER_CASES)
def test_colamd_equals_the_reference(m, n, dens, seed, aggressive):
    _reference_native()
    A, Aj, _ = random_rect(m, n, dens, seed)
    q = colamd_order(A, sstt.DEFAULT.replace(amd_aggressive=aggressive))
    assert np.array_equal(np.sort(q), np.arange(n))
    assert np.array_equal(
        q, ref_colamd(Aj, sst.DEFAULT.replace(amd_aggressive=aggressive)))


@pytest.mark.parametrize("dense", ["row", "col"])
def test_colamd_sets_dense_rows_and_columns_aside_as_the_reference(dense):
    """A full row (past max(16, 10 sqrt(n)) entries) or a full column (past
    max(16, 10 sqrt(min(m, n)))) is set aside: the same order as the
    reference's, a dense column ordered last."""
    _reference_native()
    m, n = 900, 300
    rng = np.random.default_rng(17)
    D = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.01)
    D[np.arange(n), np.arange(n)] += 3.0
    if dense == "row":
        D[n + 5] = 1.0
    else:
        D[:, 7] = 1.0
    r, c = np.nonzero(D)
    A = sstt.from_triplets(m, n, r, c, D[r, c])
    q = colamd_order(A)
    assert np.array_equal(np.sort(q), np.arange(n))
    assert np.array_equal(q, ref_colamd(sst.from_triplets(m, n, r, c,
                                                          D[r, c])))
    if dense == "col":
        assert q[-1] == 7


@pytest.mark.parametrize("m,n,seed", [(20, 12, 1), (50, 30, 5), (35, 35, 6)])
def test_symbolic_and_host_qr_equal_the_reference(m, n, seed):
    _reference_native()
    A, Aj, D = random_rect(m, n, seed=seed)
    S, Sj = qr.symbolic_qr(A), ref_qr.symbolic_qr(Aj)
    for f in ("q", "parent", "rcount", "pinv", "leftmost"):
        assert np.array_equal(getattr(S, f), getattr(Sj, f)), f
    F, Fj = qr.qr_host(A, S), ref_qr.qr_host(Aj, Sj)
    assert np.array_equal(F.piv, Fj.piv) and F.rank_est == Fj.rank_est
    assert np.abs(F.R.to_dense() - Fj.R.to_dense()).max() <= 1e-12 * \
        np.abs(Fj.R.data).max()
    b = np.random.default_rng(seed).standard_normal(m)
    x, xj = qr.qr_solve(F, b), ref_qr.qr_solve(Fj, b)
    assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()
    # Q R reproduces A(:, q): apply_q maps R's columns back to A's rows
    R = F.R.to_dense()
    QR = np.stack([qr.apply_q(F, R[:, j]) for j in range(n)], axis=1)
    assert np.abs(QR - D[:, S.q]).max() < 1e-10
    assert np.abs(qr.apply_qt(F, b) - ref_qr.apply_qt(Fj, b)).max() < 1e-10


@pytest.mark.parametrize("solve", ["usolve", "utsolve"])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_upper_solves_equal_the_reference(solve, nrhs):
    A, Aj, _ = random_rect(40, 40, 0.2, 11)
    U = qr.qr_host(A, qr.symbolic_qr(A)).R
    Uj = ref_qr.qr_host(Aj, ref_qr.symbolic_qr(Aj)).R
    b = np.random.default_rng(12).standard_normal((40, nrhs)).squeeze()
    x = getattr(simplicial, solve)(U, b)
    from suitesparse_tpu.numeric import simplicial as ref_simplicial
    xj = getattr(ref_simplicial, solve)(Uj, b)
    assert x.shape == b.shape
    assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()


@pytest.mark.parametrize("p", [None, "perm"])
def test_permuted_equals_the_reference(p):
    A, Aj, _ = random_rect(30, 20, 0.2, 13)
    rng = np.random.default_rng(14)
    rows = rng.permutation(30) if p else None
    q = rng.permutation(20)
    C, Cj = A.permuted(rows, q), Aj.permuted(rows, q)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(C, f), getattr(Cj, f)), f


@pytest.mark.parametrize("m,n,seed", [(20, 12, 4), (50, 30, 5), (35, 35, 6)])
def test_small_least_squares_stay_on_the_host(m, n, seed):
    A, Aj, D = random_rect(m, n, seed=seed)
    b = np.random.default_rng(seed).standard_normal(m)
    calls = mfqr_device.device_factors
    x = sstt.qrsol(A, b, device="cpu")
    assert mfqr_device.device_factors == calls         # the host route
    assert np.abs(x - sst.qrsol(Aj, b)).max() <= 1e-10
    assert np.allclose(x, np.linalg.lstsq(D, b, rcond=None)[0], atol=1e-8)


@pytest.mark.parametrize("m,n,seed", [(12, 20, 7), (25, 60, 8), (60, 1200, 9)])
def test_min_norm_underdetermined_equals_the_reference(m, n, seed):
    A, Aj, D = random_rect(m, n, seed=seed)
    b = np.random.default_rng(seed).standard_normal(m)
    calls = mfqr_device.device_factors
    x = sstt.qrsol(A, b, device="cpu")
    assert mfqr_device.device_factors == calls         # m < n: the host
    assert np.allclose(D @ x, b, atol=1e-8)
    assert np.abs(x - sst.qrsol(Aj, b)).max() <= 1e-10
    assert np.allclose(x, np.linalg.lstsq(D, b, rcond=None)[0], atol=1e-6)


def test_symmetric_storage_is_expanded_first():
    """An upper-stored symmetric A (sym=1) is solved as the full matrix, on
    the host route and on the device route."""
    for nx in (4, 12):               # n = 64 host, n = 1728 device
        A = sstt.fixtures.laplacian_3d(nx)
        Aj = sst.io.fixtures.laplacian_3d(nx)
        b = 1.0 + np.arange(A.ncol) / A.ncol
        calls = mfqr_device.device_factors
        x = sstt.qrsol(A, b, sstt.DEFAULT.replace(compute_dtype="float64"),
                       device="cpu")
        assert mfqr_device.device_factors == calls + (nx == 12)
        assert sstt.residual_norm(A, x, b) < 1e-12
        xj = sst.qrsol(Aj, b, sst.DEFAULT.replace(compute_dtype="float64"))
        assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()


def test_device_route_past_the_threshold(monkeypatch):
    """Past 65,536 cells the multifrontal QR runs on the device, and a
    non-finite factor there raises instead of moving the problem to the
    host."""
    A, _, D = random_rect(400, 200, 0.02, 15)          # 80,000 cells
    b = np.random.default_rng(15).standard_normal(400)
    x_ref = np.linalg.lstsq(D, b, rcond=None)[0]
    cfg = sstt.DEFAULT.replace(compute_dtype="float64")
    calls = mfqr_device.device_factors
    x = sstt.qrsol(A, b, cfg, device="cpu")
    assert mfqr_device.device_factors == calls + 1
    assert np.allclose(x, x_ref, atol=1e-8)
    inner = mfqr_device.factorize_qr_device

    def poisoned(*args, **kw):
        F = inner(*args, **kw)
        F.pool[-1] = float("nan")
        F.ok = False
        return F

    monkeypatch.setattr(mfqr_device, "factorize_qr_device", poisoned)
    with pytest.raises(mfqr_device.NonFiniteFactor, match="panels"):
        sstt.qrsol(A, b, cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_a_zero_pivot_on_the_device_route_raises(dtype):
    """A column of explicit zeros gives R a zero pivot. The device route
    no longer divides by it: it returns the basic solution (that column's
    x exactly zero, least squares on the other columns: dense ``lstsq``
    without that column), and it still raises on a non-finite factor
    (``test_device_route_and_its_failure``)."""
    A, _, D = random_rect(400, 200, 0.02, 15)
    D[:, 5] = 0.0
    r, c = np.nonzero(D)
    A = sstt.from_triplets(400, 200, np.append(r, 7), np.append(c, 5),
                           np.append(D[r, c], 0.0))
    b = np.random.default_rng(15).standard_normal(400)
    calls = mfqr_device.device_factors
    cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
    x = sstt.qrsol(A, b, cfg, device="cpu")
    # the factor, then the factor of the columns that stay
    assert mfqr_device.device_factors == calls + 2
    assert np.isfinite(x).all() and x[5] == 0.0
    keep = np.arange(200) != 5
    x_ref = np.linalg.lstsq(D[:, keep], b, rcond=None)[0]
    tol = 1e-10 if dtype == "float64" else 1e-4
    assert np.abs(x[keep] - x_ref).max() <= tol * np.abs(x_ref).max()


def test_complex_input_raises():
    """Complex input, once refused, now solves through the 2x2 real
    embedding: complex A, and a real A with a complex b, give dense
    ``lstsq``'s x; the device factor itself still refuses complex values
    and names ``qrsol``."""
    A, _, D = random_rect(20, 12, seed=16)
    Ac = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices,
                  A.data * np.exp(1j * np.arange(A.nnz)))
    Dc = Ac.to_dense()
    b = np.ones(20) + 1j * np.arange(20) / 20
    for M, Md in ((Ac, Dc), (A, D)):
        x = sstt.qrsol(M, b, device="cpu")
        x_ref = np.linalg.lstsq(Md, b, rcond=None)[0]
        assert np.abs(x - x_ref).max() < 1e-10 * np.abs(x_ref).max()
    SQ = mfqr_device.analyze_mfqr(A)
    with pytest.raises(ValueError, match="qrsol"):
        mfqr_device.factorize_qr_device(Ac, SQ, np.ones(20), device="cpu")
