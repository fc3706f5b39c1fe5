"""Factor modification: rank-1 update/downdate and partial refactorization
(the port's copy of the JAX package's ``numeric/modify.py``).

Reference analogs:
  * ``CHOLMOD/Modify/cholmod_updown.c`` / ``CSparse/Source/cs_updown.c`` —
    rank-1 update/downdate of a Cholesky factor (Carlson/Hager method) along
    the etree path of the update vector's pattern.
  * the fork's ``CSparse/Source/is_left_cholupdate.c`` + ``is_pre_update`` —
    PARTIAL re-factorization: after changing entries of A, recompute only the
    columns whose values can change (etree reach of the changed columns),
    reusing everything else. This is the fork's headline experiment (SURVEY
    §2.9) and the analyze-once/refactor-many workhorse for FEM updates.

Host implementations over the CSC factor layout (diagonal first per column,
rows sorted ascending — what chol_up produces).
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSC
from .simplicial import Factor, SymbolicChol

__all__ = ["updown", "updown_k", "updown_solve", "affected_columns",
           "refactor_partial", "refactor_full", "resymbol", "rowadd",
           "rowdel"]


def updown(F: Factor, sigma: float, w: np.ndarray) -> bool:
    """In-place rank-1 update (sigma=+1) / downdate (sigma=-1): L L' ± w w'.

    ``w`` is a dense vector in the PERMUTED ordering (w.r.t. F.perm) whose
    nonzero pattern must be contained in the pattern of L's column at w's
    first nonzero (the cs_updown contract). Returns False (factor left
    partially modified) if a downdate destroys positive-definiteness."""
    assert F.d is None, "updown operates on LL' factors"
    L = F.L
    n = L.ncol
    w = np.asarray(w, dtype=np.float64).copy()
    nz = np.flatnonzero(w)
    if nz.size == 0:
        return True
    j = int(nz[0])
    beta = 1.0
    Lp, Li, Lx = L.indptr, L.indices, L.data
    while j != -1 and j < n:
        p0, p1 = Lp[j], Lp[j + 1]
        djj = Lx[p0]
        alpha = w[j] / djj
        beta2 = beta * beta + sigma * alpha * alpha
        if beta2 <= 0.0:
            return False  # not positive definite
        beta2 = np.sqrt(beta2)
        gamma = sigma * alpha / (beta2 * beta)
        if sigma > 0:
            delta = beta / beta2
            Lx[p0] = delta * djj + gamma * w[j]
        else:
            delta = beta2 / beta
            Lx[p0] = delta * djj
        # update below-diagonal entries of column j and push w along the path;
        # the update form uses the OLD w values, the downdate form the NEW ones
        rows = Li[p0 + 1:p1]
        vals = Lx[p0 + 1:p1].copy()
        w_old = w[rows].copy()
        w[rows] = w_old - alpha * vals
        Lx[p0 + 1:p1] = delta * vals + gamma * (w_old if sigma > 0
                                                else w[rows])
        beta = beta2
        # next column on the path = row of the first below-diagonal entry,
        # i.e. the etree parent within the factor's pattern
        j = int(rows[0]) if rows.size else -1
    return True


def updown_k(F: Factor, sigma: float, W: np.ndarray,
             y: np.ndarray | None = None) -> bool:
    """Multiple-rank update/downdate: L L' ± W W' for W of shape (n, k) —
    the Davis-Hager multiple-rank method (reference
    ``CHOLMOD/Modify/cholmod_updown.c`` with ``maxrank`` blocking,
    ``t_cholmod_updown.c`` rank-unrolled templates): ONE ascending pass over
    the union of the k etree paths, every vector active at a column applies
    its rank-1 transform there (one pass over each column's data instead of
    k passes — the blocking the reference does for locality).

    If ``y`` is given (the solution of L y = b, permuted ordering), it is
    co-updated in the same pass so that L_new y_new = b still holds —
    the ``cholmod_updown_solve`` analog. Uses the telescoping identity
    acc[r] += L_old[r,j] y_old[j] - L_new[r,j] y_new[j] over path columns.

    Returns False if a downdate destroys positive definiteness (factor and y
    left partially modified, like the reference)."""
    assert F.d is None, "updown operates on LL' factors"
    L = F.L
    n = L.ncol
    W = np.asarray(W, dtype=np.float64)
    if W.ndim == 1:
        W = W[:, None]
    k = W.shape[1]
    Wc = W.copy()
    beta = np.ones(k)
    Lp, Li, Lx = L.indptr, L.indices, L.data
    # active vectors bucketed by current path column
    from collections import defaultdict
    at = defaultdict(list)
    for v in range(k):
        nz = np.flatnonzero(Wc[:, v])
        if nz.size:
            at[int(nz[0])].append(v)
    acc = np.zeros(n) if y is not None else None
    import heapq
    heap = sorted(at.keys())
    heapq.heapify(heap)
    while heap:
        j = heapq.heappop(heap)
        vecs = at.pop(j, [])
        if not vecs:
            continue
        p0, p1 = Lp[j], Lp[j + 1]
        rows = Li[p0 + 1:p1]
        if y is not None:
            dj_old = Lx[p0]
            vals_before = Lx[p0 + 1:p1].copy()
            yj_old = y[j]
        for v in vecs:
            djj = Lx[p0]
            alpha = Wc[j, v] / djj
            beta2 = beta[v] * beta[v] + sigma * alpha * alpha
            if beta2 <= 0.0:
                return False
            beta2 = np.sqrt(beta2)
            gamma = sigma * alpha / (beta2 * beta[v])
            if sigma > 0:
                delta = beta[v] / beta2
                Lx[p0] = delta * djj + gamma * Wc[j, v]
            else:
                delta = beta2 / beta[v]
                Lx[p0] = delta * djj
            vals = Lx[p0 + 1:p1].copy()
            w_old = Wc[rows, v].copy()
            Wc[rows, v] = w_old - alpha * vals
            Lx[p0 + 1:p1] = delta * vals + gamma * (
                w_old if sigma > 0 else Wc[rows, v])
            beta[v] = beta2
        if y is not None:
            y[j] = (dj_old * yj_old + acc[j]) / Lx[p0]
            acc[rows] += vals_before * yj_old - Lx[p0 + 1:p1] * y[j]
        if rows.size:
            nxt = int(rows[0])
            if nxt not in at:
                heapq.heappush(heap, nxt)
            at[nxt].extend(vecs)
    return True


def updown_solve(F: Factor, sigma: float, W: np.ndarray,
                 y: np.ndarray) -> bool:
    """Rank-k update/downdate with simultaneous solution co-update
    (cholmod_updown_solve analog): maintains L_new y_new = b for the y that
    solved L_old y = b. Modifies F and y in place."""
    return updown_k(F, sigma, W, y=y)


def affected_columns(S_parent: np.ndarray, changed_cols) -> np.ndarray:
    """Columns whose factor values can change when A's entries in
    ``changed_cols`` change: the union of etree paths to the root
    (is_pre_update analog)."""
    n = S_parent.size
    seen = np.zeros(n, dtype=bool)
    for c in np.atleast_1d(np.asarray(changed_cols, dtype=np.int64)):
        j = int(c)
        while j != -1 and not seen[j]:
            seen[j] = True
            j = int(S_parent[j])
    return np.flatnonzero(seen)


def refactor_partial(A: CSC, S: SymbolicChol, F: Factor,
                     changed_cols) -> Factor:
    """Left-looking recomputation of only the affected columns (in place).

    ``A`` is the NEW matrix (same pattern, upper-stored); entries may have
    changed only in ``changed_cols`` (and symmetrically their rows). The
    factor keeps its pattern; values of unaffected columns are reused — the
    fork's ``is_left_cholupdate`` design, driven by precomputed CSR row lists
    of L."""
    assert F.d is None, "partial refactor operates on LL' factors"
    n = S.n
    affected = affected_columns(S.parent, changed_cols)
    aff_mask = np.zeros(n, dtype=bool)
    aff_mask[affected] = True
    C = A.symperm(S.perm)
    C_low = C.transpose()
    L = F.L
    Lp, Li, Lx = L.indptr, L.indices, L.data
    # CSR row lists of the STRICT lower triangle of L (iss-style row pattern)
    LT = L.transpose()
    x = np.zeros(n)
    minor = n
    for j in affected:
        lo, hi = C_low.indptr[j], C_low.indptr[j + 1]
        x[C_low.indices[lo:hi]] = C_low.data[lo:hi]
        # cmod(j, i) for every i < j with L[j,i] != 0 (row list of j)
        rlo, rhi = LT.indptr[j], LT.indptr[j + 1]
        for t in range(rlo, rhi):
            i = LT.indices[t]
            if i >= j:
                continue
            # always read the LIVE value: affected columns i < j were already
            # recomputed this sweep (ascending order); LT values are a stale
            # snapshot used only for the row PATTERN
            lji = _entry(L, j, i)
            p0, p1 = Lp[i], Lp[i + 1]
            rows = Li[p0:p1]
            sel = rows >= j
            x[rows[sel]] -= Lx[p0:p1][sel] * lji
        d = x[j]
        if d <= 0.0 or not np.isfinite(d):
            minor = int(j)
            break
        p0, p1 = Lp[j], Lp[j + 1]
        Lx[p0] = np.sqrt(d)
        rows = Li[p0 + 1:p1]
        Lx[p0 + 1:p1] = x[rows] / Lx[p0]
        x[Li[p0:p1]] = 0.0
        x[j] = 0.0
    return Factor(L=L, perm=F.perm, d=None, minor=minor)


def _entry(L: CSC, i: int, j: int) -> float:
    """L[i, j] from sorted CSC column j (binary search)."""
    p0, p1 = L.indptr[j], L.indptr[j + 1]
    k = np.searchsorted(L.indices[p0:p1], i)
    if k < p1 - p0 and L.indices[p0 + k] == i:
        return float(L.data[p0 + k])
    return 0.0


def refactor_full(A: CSC, S: SymbolicChol, F: Factor) -> Factor:
    """Full numeric refactorization with the existing pattern (all columns)."""
    return refactor_partial(A, S, F, np.arange(S.n, dtype=np.int64))


def resymbol(A: CSC, F: Factor) -> Factor:
    """Recompute the factor's symbolic pattern for (possibly pruned) A and
    drop entries outside it, keeping values of surviving positions
    (cholmod_resymbol analog): after updates/rowdel leave explicit zeros or
    A lost entries, this shrinks the factor back to the tight pattern."""
    from .simplicial import symbolic_cholesky
    from ..sparse import CSC as _CSC

    S2 = symbolic_cholesky(A, F.perm)
    n = S2.n
    L = F.L
    # new row patterns via etree reach (cs_ereach row-of-L semantics), then
    # transpose into per-column lists
    from ..symbolic.etree import ereach
    C = A.symperm(F.perm)
    mark = np.full(n, -1, dtype=np.int64)
    buf = np.empty(n, dtype=np.int64)
    rows_of_col: list = [[j] for j in range(n)]
    for k in range(n):
        top = ereach(C, k, S2.parent, mark, buf)
        for j in buf[top:n]:
            rows_of_col[int(j)].append(k)
    indptr = np.zeros(n + 1, dtype=np.int64)
    nnz_new = sum(len(r) for r in rows_of_col)
    indices = np.empty(nnz_new, dtype=np.int64)
    data = np.zeros(nnz_new, dtype=L.data.dtype)
    pos = 0
    for j in range(n):
        rr = np.asarray(sorted(rows_of_col[j]), dtype=np.int64)
        indptr[j] = pos
        indices[pos:pos + rr.size] = rr
        # copy old values at positions that survive
        lo, hi = L.indptr[j], L.indptr[j + 1]
        old_rows = L.indices[lo:hi]
        where = np.searchsorted(old_rows, rr)
        where = np.clip(where, 0, max(hi - lo - 1, 0))
        hit = (hi > lo) and old_rows.size > 0
        if hit:
            match = old_rows[where] == rr
            data[pos:pos + rr.size] = np.where(match, L.data[lo:hi][where],
                                               0.0)
        pos += rr.size
    indptr[n] = pos
    L2 = _CSC(n, n, indptr, indices, data, 0)
    return Factor(L=L2, perm=F.perm, d=F.d, minor=F.minor)


def _zero_row_entries(L: CSC, k: int) -> None:
    """Zero L[k, j] for all j < k (in-place; O(k log) binary searches)."""
    Lp, Li, Lx = L.indptr, L.indices, L.data
    for j in range(k):
        p0, p1 = Lp[j], Lp[j + 1]
        t = np.searchsorted(Li[p0:p1], k)
        if t < p1 - p0 and Li[p0 + t] == k:
            Lx[p0 + t] = 0.0


def rowdel(F: Factor, k: int) -> bool:
    """Delete row/column k: the factored matrix becomes A with row/col k
    replaced by e_k (cholmod_rowdel analog, LL' variant).

    Column k's contribution to the trailing submatrix is removed by a rank-1
    UPDATE with w = L[k+1:, k]; the row/column itself becomes identity."""
    assert F.d is None, "rowdel operates on LL' factors"
    L = F.L
    n = L.ncol
    p0, p1 = L.indptr[k], L.indptr[k + 1]
    w = np.zeros(n)
    w[L.indices[p0 + 1:p1]] = L.data[p0 + 1:p1]
    # identity-ize column k and zero row k
    L.data[p0] = 1.0
    L.data[p0 + 1:p1] = 0.0
    _zero_row_entries(L, k)
    if not np.any(w):
        return True
    return updown(F, +1.0, w)


def rowadd(F: Factor, k: int, col: np.ndarray) -> bool:
    """Add row/column k (currently identity in the factor): the factored
    matrix gains row/col k with values ``col`` (dense, PERMUTED space, must be
    symmetric part: col[k] the diagonal; cholmod_rowadd analog, LL' variant).

    New column k solves against L[0:k,0:k]; the trailing submatrix gets a
    rank-1 DOWNDATE with the new below-diagonal part. Returns False if the
    result is not positive definite."""
    assert F.d is None, "rowadd operates on LL' factors"
    L = F.L
    n = L.ncol
    Lp, Li, Lx = L.indptr, L.indices, L.data
    col = np.asarray(col, dtype=np.float64)
    # forward solve for the new row k of L: L[0:k,0:k] y = col[0:k]
    x = col.copy()
    d = float(col[k])
    for j in range(k):
        # y_j = x[j] / L[j,j]; pattern walk over stored column j
        p0, p1 = Lp[j], Lp[j + 1]
        yj = x[j] / Lx[p0]
        if yj == 0.0:
            continue
        rows = Li[p0 + 1:p1]
        x[rows] -= Lx[p0 + 1:p1] * yj
        # write L[k, j] if the slot exists in the pattern
        t = np.searchsorted(rows, k)
        if t < rows.size and rows[t] == k:
            Lx[p0 + 1 + t] = yj
            d -= yj * yj
        else:
            assert yj == 0.0 or abs(yj) < 1e-300, \
                "rowadd fill outside the factor pattern"
    if d <= 0.0:
        return False
    # column k: diagonal + below part
    p0, p1 = Lp[k], Lp[k + 1]
    lkk = np.sqrt(d)
    Lx[p0] = lkk
    below = Li[p0 + 1:p1]
    w = x[below] / lkk
    Lx[p0 + 1:p1] = w
    # remove the new column's contribution from the trailing factor (it was
    # factored WITHOUT it): rank-1 downdate with w
    wfull = np.zeros(n)
    wfull[below] = w
    if not np.any(wfull):
        return True
    return updown(F, -1.0, wfull)
