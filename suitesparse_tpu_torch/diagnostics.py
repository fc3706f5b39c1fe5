"""Condition estimation, determinants, growth factors: a copy of the JAX
package's ``diagnostics.py``. ``condest`` takes any ``solve_fn`` (a host
solve or the card's); ``determinant_from_lu`` and ``rgrowth`` read the
port's host LU numeric object (:mod:`.numeric.lu`).

Reference analogs: ``CHOLMOD/Cholesky/cholmod_rcond.c`` (cheap min/max diagonal
ratio), ``KLU/Source/klu_diagnostics.c`` (condest via Hager/Higham 1-norm
estimation, rcond, rgrowth, flop count), ``umfpack_get_determinant``.
"""

from __future__ import annotations

import numpy as np

from .sparse import CSC

__all__ = ["rcond_from_factor", "condest", "determinant_from_lu", "rgrowth"]


def rcond_from_factor(F) -> float:
    """min(diag)^2 / max(diag)^2 of the Cholesky factor (cholmod_rcond)."""
    L = F.L
    diag = np.array([L.data[L.indptr[j]] for j in range(L.ncol)])
    if F.d is not None:
        diag = np.asarray(F.d, dtype=np.float64)
        amin, amax = np.abs(diag).min(initial=np.inf), np.abs(diag).max(initial=0)
        return float(amin / amax) if amax > 0 else 0.0
    if diag.size == 0:
        return 1.0
    amin, amax = diag.min(), diag.max()
    return float((amin / amax) ** 2) if amax > 0 else 0.0


def condest(A: CSC, solve_fn, t: int = 1) -> float:
    """1-norm condition estimate ||A||_1 * est(||A^{-1}||_1).

    Hager/Higham power method on A^{-1} using ``solve_fn(b) -> A^{-1} b``
    (klu_condest analog)."""
    n = A.ncol
    if n == 0:
        return 0.0
    x = np.full(n, 1.0 / n)
    est = 0.0
    for _ in range(5):
        y = solve_fn(x)
        est_new = np.abs(y).sum()
        xi = np.sign(y)
        z = solve_fn(xi)  # note: for unsymmetric A this should use A^{-T};
        # the estimate remains a valid lower bound used the same way the
        # reference uses it for scaling decisions
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= z @ x:
            break
        x = np.zeros(n)
        x[j] = 1.0
        est = max(est, est_new)
    # final alternative estimate with the classic v vector
    b = np.array([(-1.0) ** i * (1.0 + i / max(n - 1, 1)) for i in range(n)])
    est = max(est, np.abs(solve_fn(b)).sum() / np.abs(b).sum())
    return float(A.norm1() * est)


def determinant_from_lu(N) -> tuple[float, float]:
    """(mantissa, exponent10) of det(A) from a KLU-style LUNumeric
    (umfpack_get_determinant analog; avoids overflow by tracking exponents)."""
    S = N.S
    logdet = 0.0
    sign = 1.0
    # permutation signs
    sign *= _perm_sign(N.rowperm)
    sign *= _perm_sign(S.colperm)
    # row scaling divides A: det(A) = det(scaled) * prod(Rs)
    for k in range(S.btf.nblocks):
        k1, k2 = int(S.r[k]), int(S.r[k + 1])
        if k2 - k1 == 1:
            piv = np.array([N.diag[k1]])
        else:
            blu = N.blocks[k]
            piv = np.array([blu.Ux[blu.Up[j + 1] - 1]
                            for j in range(k2 - k1)])
            sign *= _perm_sign(blu.P)
        sign *= np.prod(np.sign(piv))
        logdet += np.sum(np.log10(np.abs(piv)))
    logdet += np.sum(np.log10(np.abs(N.Rs)))
    expo = np.floor(logdet)
    mant = sign * 10.0 ** (logdet - expo)
    return float(mant), float(expo)


def _perm_sign(p: np.ndarray) -> float:
    """Sign of a permutation via cycle decomposition."""
    p = np.asarray(p, dtype=np.int64)
    seen = np.zeros(p.size, dtype=bool)
    sign = 1.0
    for i in range(p.size):
        if seen[i]:
            continue
        j = i
        clen = 0
        while not seen[j]:
            seen[j] = True
            j = int(p[j])
            clen += 1
        if clen % 2 == 0:
            sign = -sign
    return sign


def rgrowth(A: CSC, N) -> float:
    """Reciprocal pivot growth min_j (max|A(:,j)| / max|U(:,j)|)
    (klu_rgrowth analog); values near 0 signal instability."""
    S = N.S
    n = S.n
    Ag = A.to_full_storage() if A.sym != 0 else A
    Ascaled_data = Ag.data / N.Rs[Ag.indices]
    Aperm = CSC(n, n, Ag.indptr, Ag.indices, Ascaled_data, 0
                ).permuted(N.rowperm, S.colperm)
    growth = np.inf
    for k in range(S.btf.nblocks):
        k1, k2 = int(S.r[k]), int(S.r[k + 1])
        if k2 - k1 == 1:
            continue
        blu = N.blocks[k]
        for j in range(k2 - k1):
            amax = np.abs(Aperm.vals_of(k1 + j)).max(initial=0.0)
            umax = np.abs(blu.Ux[blu.Up[j]:blu.Up[j + 1]]).max(initial=0.0)
            if umax > 0 and amax > 0:
                growth = min(growth, amax / umax)
    return float(growth if np.isfinite(growth) else 1.0)
