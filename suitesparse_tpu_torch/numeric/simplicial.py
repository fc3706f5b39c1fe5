"""Simplicial (column-at-a-time) Cholesky on the host: symbolic analysis,
up-looking LL' and LDL', and the CSC triangular solves (lower for the
Cholesky factors, upper for the host QR's R).

The small-problem path of the port (reference ``cs_schol.c``, ``cs_chol.c``,
``ldl.c``, ``cs_lsolve.c``/``cs_ltsolve.c``, ``cs_usolve.c``/
``cs_utsolve.c``). LL' takes complex Hermitian input (A = L L^H, the
reference's complex simplicial path); LDL' is real-only. The triangular
solves of a real factor and one right-hand side run in the host C++
library; complex ones take the reference's Python loops, as its
``_native_tri`` rule says. A non-positive
pivot at column k records ``minor = k`` and stops (the reference's
``L->minor`` contract, ``cholmod_core.h:1609-1620``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..sparse import CSC, invert_permutation
from ..symbolic.etree import col_counts, ereach, etree, postorder

__all__ = ["SymbolicChol", "symbolic_cholesky", "Factor", "chol_up",
           "ldl_up", "lsolve", "ltsolve", "usolve", "utsolve", "chol_solve",
           "solve_system"]


@dataclasses.dataclass
class SymbolicChol:
    """Cholesky symbolic analysis (cs_schol / cholmod_analyze analog)."""

    n: int
    perm: np.ndarray        # fill-reducing permutation p: C = A(p,p)
    parent: np.ndarray      # etree of C
    post: np.ndarray        # postorder of the etree
    colcount: np.ndarray    # nnz per column of L (incl. diagonal)
    Lp: np.ndarray          # column pointers of L (cumulative colcount)
    lnz: int                # nnz(L)
    fl: float               # factorization flop count: sum colcount[j]^2

    @property
    def pinv(self) -> np.ndarray:
        return invert_permutation(self.perm)


def _permuted(A: CSC, perm: np.ndarray) -> CSC:
    return A.symperm(perm) if not np.array_equal(perm, np.arange(A.ncol)) \
        else A


def symbolic_cholesky(A: CSC, perm: np.ndarray | None = None) -> SymbolicChol:
    """Symbolic analysis of PAP' for upper-stored symmetric A (identity
    ``perm`` if None)."""
    n = A.ncol
    if A.sym != 1:
        raise ValueError("symbolic_cholesky expects upper-stored symmetric "
                         "input (sym=1)")
    if perm is None:
        perm = np.arange(n, dtype=np.int64)
    C = _permuted(A, perm)
    parent = etree(C)
    post = postorder(parent)
    cc = col_counts(C, parent, post)
    Lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cc, out=Lp[1:])
    fl = float(np.sum(cc.astype(np.float64) ** 2))
    return SymbolicChol(n=n, perm=np.asarray(perm, dtype=np.int64),
                        parent=parent, post=post, colcount=cc, Lp=Lp,
                        lnz=int(Lp[-1]), fl=fl)


@dataclasses.dataclass
class Factor:
    """A(p,p) = L L' (or L D L' when ``d`` is present); L lower-triangular
    CSC with the diagonal entry first in each column. ``minor`` = n on
    success, else the column where the factorization failed."""

    L: CSC
    perm: np.ndarray
    d: np.ndarray | None = None    # LDL' diagonal (L unit-diagonal) if set
    minor: int = -1

    @property
    def ok(self) -> bool:
        return self.minor == self.L.ncol


def chol_up(A: CSC, S: SymbolicChol) -> Factor:
    """Up-looking simplicial LL' of C = A(p,p) (cs_chol analog): per column
    k the pattern of L[k, :k] is the etree reach of C[:,k], a sparse
    triangular solve against the finished columns gives the row, and the
    pivot is the square root of what remains. Complex Hermitian A gives
    A(p,p) = L L^H (L[k, i] = conj(y_i), the diagonal real)."""
    n = S.n
    C = _permuted(A, S.perm)
    cplx = np.iscomplexobj(C.data)
    dtype = np.complex128 if cplx else np.float64
    Lp = S.Lp
    Li = np.zeros(S.lnz, dtype=np.int64)
    Lx = np.zeros(S.lnz, dtype=dtype)
    fill = Lp[:-1].copy() + 1    # next write slot; the diagonal sits at Lp[k]
    x = np.zeros(n, dtype=dtype)
    mark = np.full(n, -1, dtype=np.int64)
    reach_buf = np.zeros(n, dtype=np.int64)
    minor = n
    for k in range(n):
        top = ereach(C, k, S.parent, mark, reach_buf)
        lo, hi = C.indptr[k], C.indptr[k + 1]
        x[C.indices[lo:hi]] = C.data[lo:hi]
        d = x[k].real if cplx else x[k]
        x[k] = 0.0
        for t in range(top, n):
            i = reach_buf[t]
            yi = x[i] / (Lx[Lp[i]].real if cplx else Lx[Lp[i]])
            x[i] = 0.0
            p0, p1 = Lp[i] + 1, fill[i]
            x[Li[p0:p1]] -= yi * Lx[p0:p1]
            d -= (yi * np.conj(yi)).real if cplx else yi * yi
            q = fill[i]
            Li[q] = k
            Lx[q] = np.conj(yi) if cplx else yi
            fill[i] = q + 1
        if d <= 0.0 or not np.isfinite(d):
            minor = k
            x[:] = 0.0
            break
        Li[Lp[k]] = k
        Lx[Lp[k]] = np.sqrt(d)
    return Factor(L=CSC(n, n, Lp, Li, Lx, 0), perm=S.perm, d=None,
                  minor=minor)


def ldl_up(A: CSC, S: SymbolicChol, dbound: float = 0.0) -> Factor:
    """Up-looking simplicial LDL' (LDL/ldl.c analog; indefinite D allowed).
    Real-only: complex Hermitian input takes :func:`chol_up`."""
    if np.iscomplexobj(A.data):
        raise ValueError("LDL' is real-only; complex Hermitian input takes "
                         "chol_up")
    n = S.n
    C = _permuted(A, S.perm)
    Lp = S.Lp
    Li = np.zeros(S.lnz, dtype=np.int64)
    Lx = np.zeros(S.lnz, dtype=np.float64)
    D = np.zeros(n, dtype=np.float64)
    fill = Lp[:-1].copy() + 1
    x = np.zeros(n, dtype=np.float64)
    mark = np.full(n, -1, dtype=np.int64)
    reach_buf = np.zeros(n, dtype=np.int64)
    minor = n
    for k in range(n):
        top = ereach(C, k, S.parent, mark, reach_buf)
        lo, hi = C.indptr[k], C.indptr[k + 1]
        x[C.indices[lo:hi]] = C.data[lo:hi]
        d = x[k]
        x[k] = 0.0
        for t in range(top, n):
            i = reach_buf[t]
            yi = x[i]          # solution of the unit-lower solve L y = C[:,k]
            lki = yi / D[i]
            x[i] = 0.0
            p0, p1 = Lp[i] + 1, fill[i]
            x[Li[p0:p1]] -= Lx[p0:p1] * yi
            d -= lki * yi
            q = fill[i]
            Li[q] = k
            Lx[q] = lki
            fill[i] = q + 1
        if d == 0.0 or not np.isfinite(d):
            minor = k
            x[:] = 0.0
            break
        if dbound > 0.0 and abs(d) < dbound:
            d = dbound if d >= 0 else -dbound
        D[k] = d
        Li[Lp[k]] = k
        Lx[Lp[k]] = 1.0
    return Factor(L=CSC(n, n, Lp, Li, Lx, 0), perm=S.perm, d=D, minor=minor)


def _work(M: CSC, b: np.ndarray) -> tuple[np.ndarray, bool]:
    """A copy of b to solve in (complex128 where M or b is complex,
    float64 otherwise), and whether the host library can take it (a real
    factor, one right-hand side)."""
    cplx = np.iscomplexobj(M.data) or np.iscomplexobj(b)
    x = np.array(b, dtype=np.complex128 if cplx else np.float64, copy=True)
    return x, not cplx and x.ndim == 1


def lsolve(L: CSC, b: np.ndarray) -> np.ndarray:
    """x = L \\ b, L lower CSC with the diagonal first per column; a real
    b (n,) runs in the host library, the rest column-sweeps here."""
    x, native_ok = _work(L, b)
    if native_ok:
        native.lsolve(L.ncol, L.indptr, L.indices, L.data, x)
        return x
    Lp, Li, Lx = L.indptr, L.indices, L.data
    for j in range(L.ncol):
        p0, p1 = Lp[j], Lp[j + 1]
        x[j] = x[j] / Lx[p0]
        if p1 > p0 + 1:
            x[Li[p0 + 1:p1]] -= np.multiply.outer(Lx[p0 + 1:p1], x[j])
    return x


def ltsolve(L: CSC, b: np.ndarray) -> np.ndarray:
    """x = L' \\ b (L^H for a complex factor)."""
    x, native_ok = _work(L, b)
    if native_ok:
        native.ltsolve(L.ncol, L.indptr, L.indices, L.data, x)
        return x
    Lp, Li, Lx = L.indptr, L.indices, np.conj(L.data)
    for j in range(L.ncol - 1, -1, -1):
        p0, p1 = Lp[j], Lp[j + 1]
        if p1 > p0 + 1:
            x[j] -= Lx[p0 + 1:p1] @ x[Li[p0 + 1:p1]]
        x[j] = x[j] / Lx[p0]
    return x


def usolve(U: CSC, b: np.ndarray) -> np.ndarray:
    """x = U \\ b, U upper CSC with the diagonal last per column
    (cs_usolve analog); a real b (n,) runs in the host library."""
    x, native_ok = _work(U, b)
    if native_ok:
        native.usolve(U.ncol, U.indptr, U.indices, U.data, x)
        return x
    Up, Ui, Ux = U.indptr, U.indices, U.data
    for j in range(U.ncol - 1, -1, -1):
        p0, p1 = Up[j], Up[j + 1]
        x[j] = x[j] / Ux[p1 - 1]
        if p1 - 1 > p0:
            x[Ui[p0:p1 - 1]] -= np.multiply.outer(Ux[p0:p1 - 1], x[j])
    return x


def utsolve(U: CSC, b: np.ndarray) -> np.ndarray:
    """x = U' \\ b (U^H for a complex factor)."""
    x, native_ok = _work(U, b)
    if native_ok:
        native.utsolve(U.ncol, U.indptr, U.indices, U.data, x)
        return x
    Up, Ui, Ux = U.indptr, U.indices, np.conj(U.data)
    for j in range(U.ncol):
        p0, p1 = Up[j], Up[j + 1]
        if p1 - 1 > p0:
            x[j] -= Ux[p0:p1 - 1] @ x[Ui[p0:p1 - 1]]
        x[j] = x[j] / Ux[p1 - 1]
    return x


def _dsolve(F, y: np.ndarray) -> np.ndarray:
    if F.d is None:
        return y
    return (y.T / F.d).T if y.ndim > 1 else y / F.d


def chol_solve(F, b: np.ndarray) -> np.ndarray:
    """x = A \\ b given A(p,p) = LL' (or LDL'): x = P'(L' \\ (D \\ (L \\ Pb)))."""
    if not F.ok:
        raise ValueError(f"factorization failed at column {F.minor}")
    z = ltsolve(F.L, _dsolve(F, lsolve(F.L, np.asarray(b)[F.perm])))
    x = np.empty_like(z)
    x[F.perm] = z
    return x


def solve_system(F, b: np.ndarray, sys: str = "A") -> np.ndarray:
    """The reference's nine solve systems (cholmod_solve,
    ``cholmod_cholesky.h:179-187``); for an LL' factor D = I.

    "A" x = P'(L'\\(D\\(L\\(Pb)))), "LDLt" L'\\(D\\(L\\b)), "LD" D\\(L\\b),
    "DLt" L'\\(D\\b), "L" L\\b, "Lt" L'\\b, "D" D\\b, "P" Pb, "Pt" P'b."""
    if not F.ok:
        raise ValueError(f"factorization failed at column {F.minor}")
    b = np.asarray(b, dtype=np.complex128 if np.iscomplexobj(F.L.data)
                   or np.iscomplexobj(b) else np.float64)
    if sys == "A":
        return chol_solve(F, b)
    if sys == "P":
        return b[F.perm]
    if sys == "Pt":
        x = np.empty_like(b)
        x[F.perm] = b
        return x
    systems = {
        "LDLt": lambda: ltsolve(F.L, _dsolve(F, lsolve(F.L, b))),
        "LD": lambda: _dsolve(F, lsolve(F.L, b)),
        "DLt": lambda: ltsolve(F.L, _dsolve(F, b)),
        "L": lambda: lsolve(F.L, b),
        "Lt": lambda: ltsolve(F.L, b),
        "D": lambda: _dsolve(F, b),
    }
    if sys not in systems:
        raise ValueError(f"unknown system {sys!r}")
    return systems[sys]()
