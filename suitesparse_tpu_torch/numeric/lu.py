"""Sparse LU for general square matrices: BTF blocking + left-looking LU.

The KLU-class path of the port, copied from the JAX package's
``numeric/lu.py`` (reference ``KLU/Source/klu_analyze.c`` BTF + per-block
ordering; ``klu_factor.c:384``/``klu_kernel.c`` Gilbert–Peierls
left-looking LU with threshold diagonal-preference pivoting;
``klu_refactor.c`` same-pattern refactorization; ``klu_solve.c:14`` block
back-substitution with off-diagonal updates; row scaling per
``klu_scale.c``). The numeric kernels run in the host C++ library
(``native/src/lu.cc``); the reference's Python Gilbert–Peierls fallback is
not copied, so without ``g++`` the first call raises.

This path stays on the host by design, as in the reference: KLU uses no
BLAS (circuit matrices give tiny supernodes), so nothing here runs on a
device. The card's LU is the unsymmetric multifrontal LU
(:func:`.multifrontal_lu.mflusol`, :mod:`.mflu_unsym`), whose escalation
ladder ends in :func:`lusol`. Complex input is not in the port yet
(ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..ordering.amd import amd_order
from ..ordering.btf import BTF, btf_order
from ..sparse import CSC, invert_permutation
from .simplicial import lsolve, usolve

__all__ = ["LUSymbolic", "LUNumeric", "analyze_lu", "factor_lu", "refactor_lu",
           "solve_lu", "solve_lu_refined", "lusol"]


@dataclasses.dataclass
class LUSymbolic:
    """BTF + per-block fill-reducing analysis (klu_analyze analog)."""

    n: int
    btf: BTF
    rowperm: np.ndarray    # global row perm AFTER per-block AMD, BEFORE pivoting
    colperm: np.ndarray    # global col perm (final)
    r: np.ndarray          # block boundaries


@dataclasses.dataclass
class BlockLU:
    Lp: np.ndarray
    Li: np.ndarray
    Lx: np.ndarray
    Up: np.ndarray
    Ui: np.ndarray
    Ux: np.ndarray
    P: np.ndarray          # pivot perm within the block (local rows)


@dataclasses.dataclass
class LUNumeric:
    """Numeric LU factors (klu Numeric analog)."""

    S: LUSymbolic
    blocks: list          # BlockLU per block (None for 1x1: use diag[])
    diag: np.ndarray      # pivot values of 1x1 blocks (0 elsewhere)
    rowperm: np.ndarray   # final global row perm incl. pivoting
    Rs: np.ndarray        # row scale factors (original row space)
    Off: CSC              # off-diagonal entries of A(rowperm, colperm) above blocks
    singular_col: int     # -1 if ok, else first singular column (global)

    @property
    def ok(self) -> bool:
        return self.singular_col == -1


def _real(A: CSC, what: str = "A") -> CSC:
    if np.iscomplexobj(A.data):
        raise NotImplementedError(
            f"complex {what} in the LU is not in the port yet (ROADMAP queue "
            "1 item 6)")
    return A.to_full_storage()


def analyze_lu(A: CSC, config: Config = DEFAULT) -> LUSymbolic:
    n = A.ncol
    if A.nrow != n:
        raise ValueError("LU requires square A")
    Ag = _real(A)
    if config.lu_btf:
        B = btf_order(Ag, work_limit=config.btf_work_limit)
    else:
        ident = np.arange(n, dtype=np.int64)
        B = BTF(rowperm=ident, colperm=ident.copy(),
                r=np.array([0, n], dtype=np.int64), nblocks=1,
                structural_rank=n)
    rowperm = B.rowperm.copy()
    colperm = B.colperm.copy()
    Aperm = Ag.permuted(rowperm, colperm)
    # per-block fill-reducing ordering on pattern(C+C')
    for k in range(B.nblocks):
        k1, k2 = int(B.r[k]), int(B.r[k + 1])
        if k2 - k1 <= 2:
            continue
        q = amd_order(_extract_block(Aperm, k1, k2), config)
        rowperm[k1:k2] = rowperm[k1:k2][q]
        colperm[k1:k2] = colperm[k1:k2][q]
    return LUSymbolic(n=n, btf=B, rowperm=rowperm, colperm=colperm, r=B.r)


def _extract_block(Aperm: CSC, k1: int, k2: int) -> CSC:
    """Diagonal block Aperm[k1:k2, k1:k2] as CSC with local indices.

    Aperm's rows are sorted within columns (``permuted`` sorts), so the
    block is a mask-filter that keeps their order."""
    nk = k2 - k1
    if nk == Aperm.ncol and k1 == 0:
        return Aperm                      # single-block BTF: the whole matrix
    lo, hi = int(Aperm.indptr[k1]), int(Aperm.indptr[k2])
    rr = Aperm.indices[lo:hi]
    sel = (rr >= k1) & (rr < k2)
    csel = np.zeros(hi - lo + 1, dtype=np.int64)
    np.cumsum(sel, out=csel[1:])
    indptr = csel[Aperm.indptr[k1:k2 + 1] - lo]
    return CSC(nk, nk, indptr, rr[sel] - k1, Aperm.data[lo:hi][sel], 0)


def _scale_rows(A: CSC, mode: int) -> tuple[CSC, np.ndarray]:
    """Row scaling (klu_scale analog): mode 0 none, 1 row-sum, 2 row-max."""
    n = A.nrow
    if mode == 0 or A.nnz == 0:
        return A, np.ones(n)
    absx = np.abs(A.data)
    if mode == 1:
        Rs = np.bincount(A.indices, weights=absx, minlength=n)
    else:
        Rs = np.zeros(n)
        np.maximum.at(Rs, A.indices, absx)
    Rs[Rs == 0.0] = 1.0
    scaled = CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data / Rs[A.indices],
                 A.sym)
    return scaled, Rs


def _prep_perm(S: LUSymbolic, Ascaled: CSC, rowperm, colperm, tag: str):
    """Permuted view + per-block extraction + off pattern as cached
    position maps (klu's analyze-once discipline applied to the
    permutation: a same-pattern re-factorization is pure O(nnz) gathers).

    Returns (Aperm, blocks, diag_pos, off, data) where blocks[k] is None
    for 1x1 blocks or (indptr, indices, pos) of the local diagonal block;
    diag_pos[j] is the data position of A[j, j] (-1 if absent) for 1x1
    blocks; off is (indptr, indices, pos) of the entries above the blocks;
    data is the permuted values."""
    store = getattr(S, "_lu_maps", None)
    if store is None:
        store = {}
        S._lu_maps = store
    key = (Ascaled.pattern_key(),
           zlib.crc32(np.ascontiguousarray(rowperm).tobytes()),
           zlib.crc32(np.ascontiguousarray(colperm).tobytes()))
    ent = store.get(tag)
    if ent is None or ent[0] != key:
        ip, ii, pos, diag_pos, blocks, off = native.lu_prep(
            S.n, Ascaled.indptr, Ascaled.indices,
            invert_permutation(rowperm), colperm, S.r)
        store[tag] = ent = (key, ip, ii, pos, blocks, diag_pos, off)
    _, ip, ii, pos, blocks, diag_pos, off = ent
    data = Ascaled.data[pos]
    return (CSC(S.n, S.n, ip, ii, data, 0), blocks, diag_pos, off, data)


def factor_lu(A: CSC, S: LUSymbolic, config: Config = DEFAULT) -> LUNumeric:
    n = S.n
    Ascaled, Rs = _scale_rows(_real(A), config.lu_scale)
    Aperm, bmaps, diag_pos, _off0, pdata = _prep_perm(
        S, Ascaled, S.rowperm, S.colperm, "analyze")

    blocks: list = [None] * S.btf.nblocks
    diag = np.zeros(n, dtype=Aperm.data.dtype)
    rowperm3 = S.rowperm.copy()
    singular_col = -1
    for k in range(S.btf.nblocks):
        k1, k2 = int(S.r[k]), int(S.r[k + 1])
        nk = k2 - k1
        if nk == 1:
            j = k1
            d = pdata[diag_pos[j]] if diag_pos[j] >= 0 else 0.0
            if d == 0.0 and singular_col == -1:
                singular_col = j
                if config.halt_if_singular:
                    break
            diag[j] = d
            continue
        bip, bi, bpos = bmaps[k]
        status, fac = native.lu_factor(nk, bip, bi, pdata[bpos],
                                       config.lu_pivot_tol)
        if status != 0:
            if singular_col == -1:
                singular_col = k1 + status - 1
            if config.halt_if_singular:
                break
            continue
        blu = BlockLU(*fac)
        blocks[k] = blu
        rowperm3[k1:k2] = S.rowperm[k1:k2][blu.P]

    # off-diagonal part in final row space (cached maps keyed by the pivoted
    # row permutation: values-stable pivots make repeat factors pure gathers)
    _ApermF, _bm, _dp, (oip, oi, opos), pdataF = _prep_perm(
        S, Ascaled, rowperm3, S.colperm, "final")
    Off = CSC(n, n, oip, oi, pdataF[opos], 0)
    return LUNumeric(S=S, blocks=blocks, diag=diag, rowperm=rowperm3, Rs=Rs,
                     Off=Off, singular_col=singular_col)


def refactor_lu(A: CSC, N: LUNumeric, config: Config = DEFAULT) -> LUNumeric:
    """Recompute factor values for a matrix with the SAME pattern
    (klu_refactor analog — the circuit-simulation fast path, no pivot
    search). The new values are written into ``N``'s block factors, which
    the returned factor shares."""
    S = N.S
    n = S.n
    Ascaled, Rs = _scale_rows(_real(A), config.lu_scale)
    Aperm, bmaps, diag_pos, offmap, pdata = _prep_perm(
        S, Ascaled, N.rowperm, S.colperm, "final")  # final row space
    singular_col = -1
    diag = np.zeros(n, dtype=Aperm.data.dtype)
    for k in range(S.btf.nblocks):
        k1, k2 = int(S.r[k]), int(S.r[k + 1])
        nk = k2 - k1
        if nk == 1:
            j = k1
            d = pdata[diag_pos[j]] if diag_pos[j] >= 0 else 0.0
            if d == 0.0 and singular_col == -1:
                singular_col = j
            diag[j] = d
            continue
        blu = N.blocks[k]
        bip, bi, bpos = bmaps[k]
        # the rows are already in the final (pivoted) order: local pivot =
        # identity
        rc = native.lu_refactor(nk, bip, bi, pdata[bpos], blu.Lp, blu.Li,
                                blu.Lx, blu.Up, blu.Ui, blu.Ux,
                                np.arange(nk, dtype=np.int64))
        if rc != 0 and singular_col == -1:
            singular_col = k1 + rc - 1
    # off-diagonal values refresh (cached positions)
    oip, oi, opos = offmap
    Off = CSC(n, n, oip, oi, pdata[opos], 0)
    return LUNumeric(S=S, blocks=N.blocks, diag=diag, rowperm=N.rowperm,
                     Rs=Rs, Off=Off, singular_col=singular_col)


def solve_lu(N: LUNumeric, b: np.ndarray) -> np.ndarray:
    """x = A \\ b by block back-substitution (klu_solve analog); b (n,) or
    (n, k)."""
    if not N.ok:
        raise ValueError(f"LU factorization singular at column "
                         f"{N.singular_col}")
    if np.iscomplexobj(b):
        raise NotImplementedError(
            "a complex right-hand side in the LU is not in the port yet "
            "(ROADMAP queue 1 item 6)")
    S = N.S
    b = np.asarray(b, dtype=np.float64)
    # scale + row-permute the rhs
    if b.ndim > 1:
        y = (b[N.rowperm].T / N.Rs[N.rowperm]).T
    else:
        y = b[N.rowperm] / N.Rs[N.rowperm]
    y = np.ascontiguousarray(y)
    Offp, Offi, Offx = N.Off.indptr, N.Off.indices, N.Off.data
    for k in range(S.btf.nblocks - 1, -1, -1):
        k1, k2 = int(S.r[k]), int(S.r[k + 1])
        nk = k2 - k1
        if nk == 1:
            y[k1] = y[k1] / N.diag[k1]
        elif y.ndim == 1:
            # the host sweeps straight on the factor arrays (klu_solve)
            blu = N.blocks[k]
            yk = np.ascontiguousarray(y[k1:k2])
            native.lsolve(nk, blu.Lp, blu.Li, blu.Lx, yk)
            native.usolve(nk, blu.Up, blu.Ui, blu.Ux, yk)
            y[k1:k2] = yk
        else:
            blu = N.blocks[k]
            Lb = CSC(nk, nk, blu.Lp, blu.Li, blu.Lx, 0)
            Ub = CSC(nk, nk, blu.Up, blu.Ui, blu.Ux, 0)
            y[k1:k2] = usolve(Ub, lsolve(Lb, y[k1:k2]))
        # off-diagonal updates to earlier blocks
        if Offp[k2] == Offp[k1]:
            continue  # no off entries in this block's columns
        if y.ndim == 1:
            native.offupdate(k1, k2, Offp, Offi, Offx, y)
            continue
        for j in range(k1, k2):
            lo, hi = Offp[j], Offp[j + 1]
            if hi > lo:
                y[Offi[lo:hi]] -= np.outer(Offx[lo:hi], y[j])
    x = np.empty_like(y)
    x[S.colperm] = y
    return x


def solve_lu_refined(N: LUNumeric, A: CSC, b: np.ndarray,
                     ir_steps: int = 2) -> np.ndarray:
    """Solve with iterative refinement (UMFPACK ``Control[UMFPACK_IRSTEP]``
    analog, ``umfpack_solve.c:102``): x ← x + A \\ (b - A x), up to
    ``ir_steps`` sweeps, stopping early when the residual stops improving."""
    x = solve_lu(N, b)
    if ir_steps <= 0:
        return x
    b = np.asarray(b, dtype=np.float64)
    prev = np.inf
    for _ in range(ir_steps):
        r = b - A.matvec(x)
        nrm = np.abs(r).max(initial=0.0)
        if nrm == 0.0 or nrm >= prev:
            break
        prev = nrm
        x = x + solve_lu(N, r)
    return x


def lusol(A: CSC, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """One-call general square solve (cs_lusol / klu_solve analog), with
    UMFPACK-style iterative refinement per ``config.ir_steps``."""
    S = analyze_lu(A, config)
    N = factor_lu(A, S, config)
    return solve_lu_refined(N, A, b, config.ir_steps)
