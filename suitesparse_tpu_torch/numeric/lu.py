"""Sparse LU for general square matrices: BTF blocking + left-looking LU.

The KLU-class path of the port, copied from the JAX package's
``numeric/lu.py`` (reference ``KLU/Source/klu_analyze.c`` BTF + per-block
ordering; ``klu_factor.c:384``/``klu_kernel.c`` Gilbert–Peierls
left-looking LU with threshold diagonal-preference pivoting;
``klu_refactor.c`` same-pattern refactorization; ``klu_solve.c:14`` block
back-substitution with off-diagonal updates; row scaling per
``klu_scale.c``). The numeric kernels of real blocks run in the host C++
library (``native/src/lu.cc``), so without ``g++`` the first real call
raises; complex blocks take the reference's Python Gilbert–Peierls kernel
(:func:`_lu_gp_python`), as in the reference.

This path stays on the host by design, as in the reference: KLU uses no
BLAS (circuit matrices give tiny supernodes), so nothing here runs on a
device. The card's LU is the unsymmetric multifrontal LU
(:func:`.multifrontal_lu.mflusol`, :mod:`.mflu_unsym`), whose escalation
ladder ends in :func:`lusol`.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..ordering.amd import amd_order
from ..ordering.btf import BTF, btf_order
from ..sparse import CSC, from_triplets, invert_permutation
from .simplicial import lsolve, usolve

__all__ = ["LUSymbolic", "LUNumeric", "analyze_lu", "factor_lu", "refactor_lu",
           "extract_lu", "sort_lu", "solve_lu", "solve_lu_refined", "lusol"]


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


def analyze_lu(A: CSC, config: Config = DEFAULT) -> LUSymbolic:
    n = A.ncol
    if A.nrow != n:
        raise ValueError("LU requires square A")
    Ag = A.to_full_storage()
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
    Ascaled, Rs = _scale_rows(A.to_full_storage(), config.lu_scale)
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
        if np.iscomplexobj(pdata):
            blu, status = _lu_gp_python(
                CSC(nk, nk, bip, bi, pdata[bpos], 0), config.lu_pivot_tol)
        else:
            status, fac = native.lu_factor(nk, bip, bi, pdata[bpos],
                                           config.lu_pivot_tol)
            blu = BlockLU(*fac) if status == 0 else None
        if status != 0:
            if singular_col == -1:
                singular_col = k1 + status - 1
            if config.halt_if_singular:
                break
            continue
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
    the returned factor shares. Complex A is factored afresh
    (:func:`factor_lu`): the refactor kernel is the host library's, which
    is real-only."""
    if np.iscomplexobj(A.data):
        return factor_lu(A, N.S, config)
    S = N.S
    n = S.n
    Ascaled, Rs = _scale_rows(A.to_full_storage(), config.lu_scale)
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


def _lu_gp_python(C: CSC, tol: float) -> tuple[BlockLU | None, int]:
    """Gilbert–Peierls left-looking LU of one block in Python (cs_lu-style),
    real or complex: the reference's kernel for the blocks the host library
    does not take. Returns (factor, status) as ``native.lu_factor`` does
    (status 0 ok, k + 1 when column k has no pivot)."""
    n = C.ncol
    pinv = np.full(n, -1, dtype=np.int64)
    P = np.empty(n, dtype=np.int64)
    x = np.zeros(n, dtype=np.complex128 if np.iscomplexobj(C.data)
                 else np.float64)
    marked = np.zeros(n, dtype=bool)
    Lp = np.zeros(n + 1, dtype=np.int64)
    Up = np.zeros(n + 1, dtype=np.int64)
    Lcols_i: list[np.ndarray] = []
    Lcols_x: list[np.ndarray] = []
    Ucols_i: list[np.ndarray] = []
    Ucols_x: list[np.ndarray] = []
    Lidx: list = [None] * n  # per factored column: (orig rows, values)

    for k in range(n):
        # symbolic: the DFS reach of column k through the finished columns
        topo: list[int] = []
        pattern: list[int] = []
        stack: list[tuple[int, int]] = []
        for rr0 in C.indices[C.indptr[k]:C.indptr[k + 1]]:
            if marked[rr0]:
                continue
            stack.append((int(rr0), 0))
            marked[rr0] = True
            while stack:
                rr, ei = stack[-1]
                j = pinv[rr]
                if j < 0:
                    pattern.append(rr)
                    stack.pop()
                    continue
                rows_j = Lidx[j][0]
                descended = False
                while ei < len(rows_j):
                    rn = int(rows_j[ei])
                    ei += 1
                    if not marked[rn]:
                        marked[rn] = True
                        stack[-1] = (rr, ei)
                        stack.append((rn, 0))
                        descended = True
                        break
                if not descended:
                    stack[-1] = (rr, ei)
                    topo.append(rr)
                    stack.pop()
        # numeric: the sparse triangular solve in topological order
        lo, hi = C.indptr[k], C.indptr[k + 1]
        x[C.indices[lo:hi]] = C.data[lo:hi]
        for rr in reversed(topo):
            j = pinv[rr]
            xj = x[rr]
            if xj != 0.0:
                rows_j, vals_j = Lidx[j]
                x[rows_j] -= vals_j * xj
        # pivot: the largest candidate, the diagonal where it is within tol
        cand = np.array(pattern, dtype=np.int64)
        if cand.size == 0:
            return None, k + 1
        av = np.abs(x[cand])
        amax = av.max()
        if amax == 0.0:
            return None, k + 1
        prow = int(cand[int(np.argmax(av))])
        if tol > 0 and k in cand and abs(x[k]) >= tol * amax:
            prow = k
        pivot = x[prow]
        ui = np.array([pinv[rr] for rr in reversed(topo)] + [k],
                      dtype=np.int64)
        ux = np.array([x[rr] for rr in reversed(topo)] + [pivot])
        Ucols_i.append(ui)
        Ucols_x.append(ux)
        P[k] = prow
        pinv[prow] = k
        others = cand[cand != prow]
        li = np.concatenate([[prow], others])
        lx = np.concatenate([[1.0], x[others] / pivot])
        Lcols_i.append(li)
        Lcols_x.append(lx)
        Lidx[k] = (others.copy(), lx[1:].copy())
        Lp[k + 1] = Lp[k] + li.size
        Up[k + 1] = Up[k] + ui.size
        for rr in topo:
            marked[rr] = False
            x[rr] = 0.0
        for rr in pattern:
            marked[rr] = False
            x[rr] = 0.0
    Li = pinv[np.concatenate(Lcols_i)] if Lcols_i else np.empty(0, np.int64)
    return BlockLU(Lp=Lp, Li=Li, Lx=np.concatenate(Lcols_x),
                   Up=Up, Ui=np.concatenate(Ucols_i),
                   Ux=np.concatenate(Ucols_x), P=P), 0


def extract_lu(N: LUNumeric):
    """The factorization as global CSC matrices (``klu_extract.c``):
    returns (L, U, F_off, P, Q, Rs) such that

        diag(1/Rs[P]) @ A[P, Q] = L @ U + F_off

    where L is unit-lower with the blocks' L factors, U upper with the
    blocks' U factors and the 1x1 pivots, and F_off the off-diagonal
    (above-block) entries in factor coordinates."""
    assert N.ok
    S = N.S
    n = S.n
    rL, cL, xL = [np.arange(n)], [np.arange(n)], [np.ones(n)]
    rU, cU, xU = [], [], []
    for k in range(S.btf.nblocks):
        k1, k2 = int(S.r[k]), int(S.r[k + 1])
        nk = k2 - k1
        if nk == 1:
            rU.append([k1])
            cU.append([k1])
            xU.append([N.diag[k1]])
            continue
        blu = N.blocks[k]
        cols = np.repeat(np.arange(nk), np.diff(blu.Lp))
        off = blu.Li != cols                # drop the unit diagonal's copy
        rL.append(k1 + blu.Li[off])
        cL.append(k1 + cols[off])
        xL.append(blu.Lx[off])
        colsU = np.repeat(np.arange(nk), np.diff(blu.Up))
        rU.append(k1 + blu.Ui)
        cU.append(k1 + colsU)
        xU.append(blu.Ux)
    cat = np.concatenate
    dt = N.diag.dtype
    L = from_triplets(n, n, cat([np.asarray(a) for a in rL]),
                      cat([np.asarray(a) for a in cL]),
                      cat([np.asarray(a, dtype=dt) for a in xL]))
    U = from_triplets(n, n, cat([np.asarray(a) for a in rU]),
                      cat([np.asarray(a) for a in cU]),
                      cat([np.asarray(a, dtype=dt) for a in xU]))
    return L, U, N.Off, N.rowperm, S.colperm, N.Rs


def sort_lu(N: LUNumeric) -> LUNumeric:
    """Sort the row indices within every factor column in place
    (``klu_sort.c``): Gilbert-Peierls leaves them in topological order."""
    for blu in N.blocks:
        if blu is None:
            continue
        for (Ip, Ii, Ix) in ((blu.Lp, blu.Li, blu.Lx),
                             (blu.Up, blu.Ui, blu.Ux)):
            for j in range(Ip.size - 1):
                lo, hi = Ip[j], Ip[j + 1]
                o = np.argsort(Ii[lo:hi], kind="stable")
                Ii[lo:hi] = Ii[lo:hi][o]
                Ix[lo:hi] = Ix[lo:hi][o]
    return N


def solve_lu(N: LUNumeric, b: np.ndarray) -> np.ndarray:
    """x = A \\ b by block back-substitution (klu_solve analog); b (n,) or
    (n, k), real or complex. A real factor and a real b (n,) sweep in the
    host library; the rest in numpy."""
    if not N.ok:
        raise ValueError(f"LU factorization singular at column "
                         f"{N.singular_col}")
    S = N.S
    b = np.asarray(b)
    cplx = np.iscomplexobj(b) or np.iscomplexobj(N.diag)
    b = b.astype(np.complex128 if cplx else np.float64)
    host = b.ndim == 1 and not cplx
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
        elif host:
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
        if host:
            native.offupdate(k1, k2, Offp, Offi, Offx, y)
            continue
        for j in range(k1, k2):
            lo, hi = Offp[j], Offp[j + 1]
            if hi > lo:
                y[Offi[lo:hi]] -= np.multiply.outer(Offx[lo:hi], y[j])
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
    b = np.asarray(b)
    if not np.iscomplexobj(b):
        b = b.astype(np.float64)
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
