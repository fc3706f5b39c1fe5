"""Multifrontal LU for square matrices (UMFPACK-class path): the router and
its host numerics.

The port's copy of the JAX package's ``numeric/multifrontal_lu.py``.
Reference analog: UMFPACK (``umf_kernel.c:36`` frontal matrices,
``umfpack_qsymbolic.c`` strategy selection, ``umfpack.h:194-212``).
:func:`mflusol` routes as the reference does:

  * a strongly unsymmetric pattern (structural symmetry < 0.5) or a
    diagonal with fewer than 0.9 n nonzeros goes to the UNSYMMETRIC
    strategy, the matched-front LU on the device (:mod:`.mflu_unsym`,
    whose escalation ladder ends in the host KLU path :func:`.lu.lusol`);
  * the rest takes the SYMMETRIC strategy: the supernodal structure of
    pattern(A+A') (AMD on A+A' with a zero-free diagonal from a maximum
    transversal), a dense LU with STATIC diagonal pivoting inside each
    front and iterative refinement, on the host (:func:`factorize_lu_host`,
    as in the reference; its device version ``mflu_device``, which no
    entry point of the reference reaches, is ROADMAP queue 1 item 9).

Complex input takes the same routes on the 2x2 real embedding
(:mod:`.complex_embed`).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..config import DEFAULT, Config
from ..ordering.amd import amd_order
from ..ordering.btf import maxtrans
from ..sparse import CSC, from_triplets
from ..symbolic.supernodes import SupernodalSymbolic, analyze_supernodal
from .mflu_unsym import mflusol_unsym

__all__ = ["MFLUFactor", "analyze_mflu", "factorize_lu_host", "solve_mflu",
           "mflusol", "find_singletons"]


def find_singletons(A: CSC):
    """Row/column singleton detection (UMFPACK ``umf_singletons.c``,
    called from ``umfpack_qsymbolic.c:1081``): repeatedly peel columns with a
    single live entry and rows with a single live entry; the pivots need no
    numeric factorization work. Returns (pivots, rows_left, cols_left) where
    pivots is an ordered list of (row, col).

    On the KLU path the BTF pre-permutation subsumes this (every singleton
    becomes a 1x1 diagonal block); this utility serves the UMFPACK-style
    unsymmetric analysis and structural diagnostics."""
    Ag = A.to_full_storage() if A.sym != 0 else A
    m, n = Ag.nrow, Ag.ncol
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ag.indptr))
    rows = Ag.indices
    live_r = np.ones(m, dtype=bool)
    live_c = np.ones(n, dtype=bool)
    ent_live = np.ones(rows.size, dtype=bool)
    rdeg = np.bincount(rows, minlength=m).astype(np.int64)
    cdeg = np.bincount(cols, minlength=n).astype(np.int64)
    # entry lists per row/col for peeling
    by_row = [[] for _ in range(m)]
    by_col = [[] for _ in range(n)]
    for t in range(rows.size):
        by_row[rows[t]].append(t)
        by_col[cols[t]].append(t)
    q = deque()
    for c in range(n):
        if cdeg[c] == 1:
            q.append(("c", c))
    for r in range(m):
        if rdeg[r] == 1:
            q.append(("r", r))
    pivots = []

    def kill_entry(t):
        if not ent_live[t]:
            return
        ent_live[t] = False
        r, c = rows[t], cols[t]
        rdeg[r] -= 1
        cdeg[c] -= 1
        if live_r[r] and rdeg[r] == 1:
            q.append(("r", r))
        if live_c[c] and cdeg[c] == 1:
            q.append(("c", c))

    def eliminate(r, c):
        pivots.append((int(r), int(c)))
        live_r[r] = False
        live_c[c] = False
        for t in by_row[r]:
            kill_entry(t)
        for t in by_col[c]:
            kill_entry(t)

    while q:
        kind, i = q.popleft()
        if kind == "c":
            if not live_c[i] or cdeg[i] != 1:
                continue
            t = next(t for t in by_col[i] if ent_live[t])
            if live_r[rows[t]]:
                eliminate(rows[t], i)
        else:
            if not live_r[i] or rdeg[i] != 1:
                continue
            t = next(t for t in by_row[i] if ent_live[t])
            if live_c[cols[t]]:
                eliminate(i, cols[t])
    return pivots, np.flatnonzero(live_r), np.flatnonzero(live_c)


@dataclasses.dataclass
class MFLUFactor:
    """A(p,p) = L U with supernodal panels.

    ``Lx`` panels: (nr × nc) column-major, unit diagonal implicit NOT — the
    diagonal of L is stored (L11 unit-lower with 1.0 stored), ``Ux`` panels:
    (nc × nr) ROW-major view = U rows (U11 upper incl. diagonal, then U12)."""

    S: SupernodalSymbolic
    Lx: np.ndarray
    Ux: np.ndarray
    minor: int

    @property
    def ok(self) -> bool:
        return self.minor == self.S.n

    def lpanel(self, s: int) -> np.ndarray:
        S = self.S
        nr, nc = S.nrows(s), S.ncols(s)
        return self.Lx[S.Lpx[s]:S.Lpx[s + 1]].reshape(nr, nc, order="F")

    def upanel(self, s: int) -> np.ndarray:
        S = self.S
        nr, nc = S.nrows(s), S.ncols(s)
        return self.Ux[S.Lpx[s]:S.Lpx[s + 1]].reshape(nc, nr, order="C")


def analyze_mflu(A: CSC, config: Config = DEFAULT,
                 perm: np.ndarray | None = None) -> SupernodalSymbolic:
    """Supernodal analysis of pattern(A+A') (UMFPACK symmetric strategy).

    If the diagonal has structural zeros, a maximum-transversal row
    pre-permutation first makes it zero-free (the static-pivoting pre-step,
    MC64-style but structural) — stored on the symbolic object and applied
    transparently by factorize/solve."""
    n = A.ncol
    if A.nrow != n:
        raise ValueError("multifrontal LU requires square A")
    Ag = A.to_full_storage()
    # zero-free diagonal?
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ag.indptr))
    has_diag = np.zeros(n, dtype=bool)
    has_diag[cols[Ag.indices == cols]] = True
    if has_diag.all():
        rowpre = np.arange(n, dtype=np.int64)
    else:
        nmatch, match = maxtrans(Ag)
        if nmatch != n:
            raise ValueError("structurally singular matrix")
        rowpre = match  # B = A(rowpre, :) has a zero-free diagonal
        Ag = Ag.permuted(rowpre, None)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ag.indptr))
    # symmetrized pattern, upper storage, unit values (+diagonal)
    r = np.concatenate([np.minimum(Ag.indices, cols), np.arange(n)])
    c = np.concatenate([np.maximum(Ag.indices, cols), np.arange(n)])
    P = from_triplets(n, n, r, c, np.ones(r.size), sym=1)
    if perm is None:
        perm = amd_order(P, config)
    S = analyze_supernodal(P, perm, config)
    S._rowpre = rowpre
    return S


def _perm_general(A: CSC, S: SupernodalSymbolic) -> CSC:
    Ag = A.to_full_storage() if A.sym != 0 else A
    rowpre = getattr(S, "_rowpre", None)
    if rowpre is not None and not np.array_equal(rowpre,
                                                 np.arange(Ag.nrow)):
        Ag = Ag.permuted(rowpre, None)
    return Ag.permuted(S.perm, S.perm)


def factorize_lu_host(A: CSC, S: SupernodalSymbolic,
                      config: Config = DEFAULT) -> MFLUFactor:
    """Numpy multifrontal LU with static diagonal pivoting (oracle path)."""
    C = _perm_general(A, S)
    Lx = np.zeros(S.lnz)
    Ux = np.zeros(S.lnz)
    updates: dict = {}
    minor = S.n
    for s in range(S.nsuper):
        rows = S.rows[s]
        nr = len(rows)
        nc = S.ncols(s)
        f = int(S.super_first[s])
        pos = {int(r): i for i, r in enumerate(rows)}
        Fm = np.zeros((nr, nr))
        # assemble A entries: columns of the supernode (all rows in pattern)
        for k, j in enumerate(range(f, f + nc)):
            lo, hi = C.indptr[j], C.indptr[j + 1]
            for rr, vv in zip(C.indices[lo:hi], C.data[lo:hi]):
                i = pos.get(int(rr))
                if i is not None:
                    Fm[i, k] += vv
        # and the supernode's ROWS (U12 region): entries (j, c) with c beyond
        CT = getattr(S, "_mflu_CT", None)
        if CT is None or getattr(S, "_mflu_CT_id", None) != id(C):
            CT = C.transpose()
            S._mflu_CT = CT
            S._mflu_CT_id = id(C)
        for i_local, j in enumerate(range(f, f + nc)):
            lo, hi = CT.indptr[j], CT.indptr[j + 1]
            for cc, vv in zip(CT.indices[lo:hi], CT.data[lo:hi]):
                i = pos.get(int(cc))
                if i is not None and i >= nc:
                    Fm[i_local, i] += vv
        for (rows_c, U) in updates.pop(s, []):
            idx = np.searchsorted(rows, rows_c)
            Fm[np.ix_(idx, idx)] += U
        F11 = Fm[:nc, :nc]
        # dense unpivoted LU: L11 unit lower, U11 upper
        L11 = np.eye(nc)
        U11 = F11.copy()
        ok = True
        for k in range(nc):
            piv = U11[k, k]
            if piv == 0.0 or not np.isfinite(piv):
                ok = False
                break
            m = U11[k + 1:, k] / piv
            L11[k + 1:, k] = m
            U11[k + 1:, k:] -= np.outer(m, U11[k, k:])
            U11[k + 1:, k] = 0.0
        if not ok:
            minor = f
            break
        L21 = np.linalg.solve(U11.T, Fm[nc:, :nc].T).T  # F21 U11^{-1}
        U12 = np.linalg.solve(L11, Fm[:nc, nc:])        # L11^{-1} F12
        Lx[S.Lpx[s]:S.Lpx[s + 1]] = np.concatenate(
            [L11, L21], axis=0).ravel(order="F")
        Ux[S.Lpx[s]:S.Lpx[s + 1]] = np.concatenate(
            [U11, U12], axis=1).ravel(order="C")
        p = S.sparent[s]
        if p != -1 and nr > nc:
            U = Fm[nc:, nc:] - L21 @ U12
            updates.setdefault(p, []).append((rows[nc:], U))
    return MFLUFactor(S=S, Lx=Lx, Ux=Ux, minor=minor)


def solve_mflu(F: MFLUFactor, b: np.ndarray) -> np.ndarray:
    """x = A \\ b: forward solve with L panels, backward with U panels."""
    if not F.ok:
        raise ValueError(f"multifrontal LU failed at column {F.minor}")
    S = F.S
    b = np.asarray(b, dtype=np.float64)
    rowpre = getattr(S, "_rowpre", None)
    if rowpre is not None:
        b = b[rowpre]
    y = b[S.perm].copy()
    # forward: L y' = y (supernodes ascending = children first)
    for s in range(S.nsuper):
        nc = S.ncols(s)
        f = int(S.super_first[s])
        P = F.lpanel(s)
        L11 = P[:nc, :]
        yc = np.linalg.solve(L11, y[f:f + nc]) if nc else y[f:f]
        # L11 unit lower: solve exact
        y[f:f + nc] = yc
        if P.shape[0] > nc:
            below = S.rows[s][nc:]
            y[below] -= P[nc:, :] @ yc
    # backward: U x = y (supernodes descending)
    for s in range(S.nsuper - 1, -1, -1):
        nc = S.ncols(s)
        f = int(S.super_first[s])
        Up = F.upanel(s)
        U11 = Up[:, :nc]
        rhs = y[f:f + nc]
        if Up.shape[1] > nc:
            below = S.rows[s][nc:]
            rhs = rhs - Up[:, nc:] @ y[below]
        y[f:f + nc] = np.linalg.solve(U11, rhs)
    x = np.empty_like(y)
    x[S.perm] = y
    return x


def mflusol(A: CSC, b: np.ndarray, config: Config = DEFAULT,
            device="cuda") -> np.ndarray:
    """One-call multifrontal-LU solve with iterative refinement.

    Strategy AUTO (the reference's ``umfpack_qsymbolic.c`` auto-select,
    ``umfpack.h:194-212``): the multifrontal symmetric-pattern path fits
    matrices with substantial structural symmetry and a mostly-nonzero
    diagonal, and runs on the host; strongly unsymmetric patterns route to
    the matched-front LU on ``device``
    (:func:`.mflu_unsym.mflusol_unsym`) — the same decision the reference
    makes between its SYMMETRIC and UNSYMMETRIC strategies.

    Complex input on the symmetric strategy runs it on the 2x2 real
    embedding, whose pattern is symmetric too (the reference's host
    factor is real and drops the imaginary part there); the unsymmetric
    strategy embeds in :func:`.mflu_unsym.mflusol_unsym`."""
    sym = A.symmetry() if A.sym == 0 else {"structural": 1.0,
                                           "nzdiag": A.ncol}
    if sym["structural"] < 0.5 or sym["nzdiag"] < 0.9 * A.ncol:
        return mflusol_unsym(A, b, config, device)
    if np.iscomplexobj(A.data) or np.iscomplexobj(b):
        from .complex_embed import embed_matrix, embed_vec, unembed_vec
        M = embed_matrix(A.to_full_storage())
        return unembed_vec(_mflusol_symmetric(M, embed_vec(b), config))
    return _mflusol_symmetric(A, b, config)


def _mflusol_symmetric(A: CSC, b: np.ndarray, config: Config) -> np.ndarray:
    """The SYMMETRIC strategy on the host for real A: the analysis, the
    static-pivot factor, the solve and ``config.ir_steps`` refinement
    steps."""
    S = analyze_mflu(A, config)
    F = factorize_lu_host(A, S, config)
    x = solve_mflu(F, b)
    Ag = A.to_full_storage()
    b = np.asarray(b, dtype=np.float64)
    prev = np.inf
    for _ in range(config.ir_steps):
        r = b - Ag.matvec(x)
        nrm = np.abs(r).max(initial=0.0)
        if nrm == 0.0 or nrm >= prev:
            break
        prev = nrm
        x = x + solve_mflu(F, r)
    return x
