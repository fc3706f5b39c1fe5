"""F11: the port's device QR gives a rank-deficient A the basic solution.

The reference's device sweep divides by every pivot of R, so two equal
columns give a finite but unbounded x. The port's ``qr_solve_device`` fixes
at zero the x of each pivot with |R[k,k]| at or under the tolerance (SPQR's
20 (m + n) eps_64 max column norm, the host's, in fp64; 20 sqrt(m + n)
eps_32 max column norm in fp32), as the host ``qr_solve`` of both packages
does, and ``mfqrsol_device`` then
solves least squares on the columns that stay. Which of two equal columns
is dropped follows each path's column order, so x is held to the host's by
its residual and its size (within 10x of the host's ||x||_inf), not entry
by entry; the rank estimate must equal the host's and the dropped x must be
exactly zero. The reference's host basic x drops the dead pivot's row of R
and with it part of Q'b, so its residual lies above the least-squares
minimum (by up to 1e-2 relative here); the port's host x (F17 repaired)
keeps the same zeros and reaches that minimum (dense ``lstsq``) within
1e-10 relative, and so does the device's, within 1e-10 relative in fp64
and 1e-5 in fp32. A full-rank host answer stays within 1e-12 of the
reference's."""

import dataclasses

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import qr as ref_qr
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import mfqr_device, qr

M, N = 400, 200          # 80,000 cells: qrsol's device route
RESID_TOL = {"float64": 1e-10, "float32": 1e-5}


def duplicated(seed: int, dup: tuple):
    """A random 400 x 200 matrix (a strong diagonal, 2% fill) whose columns
    ``dup[1:]`` are copies of column ``dup[0]``, as (port CSC, reference
    CSC, dense)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((M, N)) * (rng.random((M, N)) < 0.02)
    D[np.arange(N), np.arange(N)] += 3.0 + np.arange(N) * 0.01
    for j in dup[1:]:
        D[:, j] = D[:, dup[0]]
    r, c = np.nonzero(D)
    return (sstt.from_triplets(M, N, r, c, D[r, c]),
            sst.from_triplets(M, N, r, c, D[r, c]), D)


def _lsq_resid(D, x, b):
    """||A'(Ax - b)|| / (||A||^2 ||x|| + ||A|| ||b||): the least-squares
    optimality of x, which the basic and the minimum-norm x share."""
    r = D @ x - b
    nA = np.linalg.norm(D, 2)
    return np.linalg.norm(D.T @ r) / (nA * nA * np.linalg.norm(x)
                                      + nA * np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed,dup", [(21, (5, 7)), (22, (0, 199)),
                                      (23, (3, 40, 41))])
def test_duplicated_columns_give_the_basic_solution(seed, dup, dtype):
    A, Aj, D = duplicated(seed, dup)
    b = np.random.default_rng(seed).standard_normal(M)
    cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
    SQ = mfqr_device.analyze_mfqr(A, cfg)
    F = mfqr_device.factorize_qr_device(A, SQ, b, cfg, "cpu")
    Fh = qr.qr_host(A, qr.symbolic_qr(A, cfg))
    Fj = ref_qr.qr_host(Aj, ref_qr.symbolic_qr(Aj, sst.DEFAULT))
    assert F.ok and F.rank_est == Fh.rank_est == Fj.rank_est \
        == N - len(dup) + 1
    # SPQR's tolerance in fp64 (the host's), sqrt(m + n) eps in fp32
    eps = torch.finfo(getattr(torch, dtype)).eps
    scale = 20 * np.linalg.norm(D, axis=0).max()
    want = scale * ((M + N) * np.finfo(np.float64).eps
                    if dtype == "float64" else np.sqrt(M + N) * eps)
    assert F.tol == pytest.approx(want, rel=1e-12)
    if dtype == "float64":
        assert F.tol == pytest.approx(Fh.tol, rel=1e-12)
    x = mfqr_device.qr_solve_device(F)[:, 0]
    xh = qr.qr_solve(Fh, b)
    xj = ref_qr.qr_solve(Fj, b)
    # each path drops all but one of the equal columns, exactly; the
    # port's host drops the reference's
    assert np.isfinite(x).all()
    assert sum(x[j] == 0.0 for j in dup) == len(dup) - 1
    assert sum(xh[j] == 0.0 for j in dup) == len(dup) - 1
    assert [xh[j] == 0.0 for j in dup] == [xj[j] == 0.0 for j in dup]
    x_min = np.linalg.lstsq(D, b, rcond=None)[0]
    rmin = np.linalg.norm(D @ x_min - b)
    rh = np.linalg.norm(D @ xh - b)
    # F17: the port's host x is least squares on the live columns, the
    # reference's keeps the gap of the row it drops
    assert abs(rh - rmin) <= 1e-10 * rmin
    assert np.linalg.norm(D @ xj - b) > rmin * (1 + 1e-8)
    # the sweep alone: finite, the dropped x zero, no larger than the host's
    assert np.abs(x).max() <= 10 * np.abs(xh).max()
    # the entry point: least squares on the columns that stay
    xq = sstt.qrsol(A, b, cfg, device="cpu")
    assert np.isfinite(xq).all()
    assert sum(xq[j] == 0.0 for j in dup) == len(dup) - 1
    rq = np.linalg.norm(D @ xq - b)
    assert abs(rq - rmin) <= RESID_TOL[dtype] * rmin
    assert rq <= rh * (1 + RESID_TOL[dtype])
    assert _lsq_resid(D, xq, b) < (1e-12 if dtype == "float64" else 1e-5)
    assert np.abs(xq).max() <= 10 * np.abs(xh).max()


def test_full_rank_factor_keeps_every_pivot():
    """A full-rank A: the rank is n and x is the one the sweep gave before
    (no pivot is under the tolerance, so no row changes)."""
    A, Aj, D = duplicated(24, (9,))
    b = np.random.default_rng(24).standard_normal(M)
    cfg = sstt.DEFAULT.replace(compute_dtype="float64")
    F = mfqr_device.factorize_qr_device(
        A, mfqr_device.analyze_mfqr(A, cfg), b, cfg, "cpu")
    assert F.rank_est == N
    x = mfqr_device.qr_solve_device(F)[:, 0]
    F.tol = None                          # the sweep without the rank rule
    assert np.array_equal(mfqr_device.qr_solve_device(F)[:, 0], x)
    assert np.array_equal(sstt.qrsol(A, b, cfg, device="cpu"), x)
    assert mfqr_device.dead_columns(
        dataclasses.replace(F, tol=0.0)).size == 0
    x_ref = np.linalg.lstsq(D, b, rcond=None)[0]
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    # the host QR's full-rank answer is the reference's
    Fh = qr.qr_host(A, qr.symbolic_qr(A, cfg))
    Fj = ref_qr.qr_host(Aj, ref_qr.symbolic_qr(Aj, sst.DEFAULT))
    assert Fh.rank_est == Fj.rank_est == N
    xh, xj = qr.qr_solve(Fh, b), ref_qr.qr_solve(Fj, b)
    assert np.abs(xh - xj).max() <= 1e-12 * np.abs(xj).max()
