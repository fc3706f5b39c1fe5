"""Sparse QR (Householder) on the host, and the least-squares / min-norm
router ``qrsol``.

Reference analog: SPQR (``SPQR/Source/spqr_1factor.cpp``) and its
teaching-scale version ``CSparse/Source/cs_qr.c`` with the symbolic
``cs_sqr.c`` and the solve ``cs_qrsol.c``. This module is the port's copy
of the JAX package's host QR: the column-at-a-time Householder algorithm
over the column elimination tree (the pattern of R(:,k) is the reach of the
leftmost columns of A(:,k)'s rows, Householder vectors stored sparse). It
takes the small problems and the underdetermined ones; least-squares
problems past a size go to the multifrontal QR on the device
(:mod:`.mfqr_device`). Complex problems take the same routes on the 2x2
real embedding (:mod:`.complex_embed`).

Solves (cs_qrsol parity):
  m >= n: least squares  min ||Ax-b||  via x = R \\ (Q'b)
  m <  n: minimum-norm solution of the underdetermined system via QR of A'.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DEFAULT, Config, Ordering
from ..device import resolve_device
from ..ordering.colamd import colamd_order
from ..sparse import CSC, invert_permutation
from ..symbolic.etree import col_counts, etree, postorder
from . import complex_embed, mfqr_device
from .simplicial import usolve, utsolve

__all__ = ["QRSymbolic", "QRFactor", "symbolic_qr", "qr_host", "apply_qt",
           "apply_q", "qr_solve", "qrsol", "DEVICE_MIN_CELLS"]

# least-squares problems with m * n at least this take the device
# multifrontal QR (reference ``numeric/qr.py:286``)
DEVICE_MIN_CELLS = 1 << 16


@dataclasses.dataclass
class QRSymbolic:
    """Column ordering + column etree analysis (cs_sqr analog)."""

    m: int
    n: int
    m2: int                 # rows incl. fictitious (max(m, n))
    q: np.ndarray           # column permutation (postorder folded)
    parent: np.ndarray      # column elimination tree of A(:,q)
    rcount: np.ndarray      # nnz(R(k,:)) upper bounds (= chol colcounts of A'A)
    pinv: np.ndarray        # row permutation: original row -> working row
    leftmost: np.ndarray    # leftmost column of each original row (in q order)


@dataclasses.dataclass
class QRFactor:
    """A(:, q) = Q R with Q = H_0 ... H_{n-1} (sparse Householder product).

    Householder k pivots at ORIGINAL row ``piv[k]`` (chosen during the
    factorization — the analog of cs_qr's working-row assignment, but kept as
    an explicit map instead of a row permutation); R is upper triangular in
    Householder indices: entry R[i,k] lives at row piv[i] of Q'A."""

    S: QRSymbolic
    Vrows: list             # Vrows[k]: original-row indices (pivot first)
    Vvals: list
    beta: np.ndarray
    piv: np.ndarray         # Householder k's pivot row (-1 if empty column)
    R: CSC                  # n x n upper triangular, diagonal LAST per column
    rank_est: int           # columns with |R[k,k]| > tol
    tol: float = 0.0        # the rank-detection tolerance actually used


def symbolic_qr(A: CSC, config: Config = DEFAULT,
                q: np.ndarray | None = None) -> QRSymbolic:
    m, n = A.shape
    if q is None:
        if config.ordering is Ordering.NATURAL:
            q = np.arange(n, dtype=np.int64)
        else:
            q = colamd_order(A, config)
    C = A.permuted(None, q)
    parent = etree(C, ata=True)
    post = postorder(parent)
    if not np.array_equal(post, np.arange(n)):
        q = q[post]
        C = A.permuted(None, q)
        parent = etree(C, ata=True)
    cc = col_counts(C, parent, np.arange(n, dtype=np.int64), ata=True)
    # leftmost column of each row; rows sorted stably by leftmost column so
    # the k-th Householder pivots at working row k (cs_qr's vcount/pinv role)
    CT = C.transpose(values=False)
    leftmost = np.full(m, n, dtype=np.int64)
    for i in range(m):
        lo, hi = CT.indptr[i], CT.indptr[i + 1]
        if hi > lo:
            leftmost[i] = CT.indices[lo:hi].min()
    order = np.argsort(leftmost, kind="stable")
    pinv = invert_permutation(order)
    return QRSymbolic(m=m, n=n, m2=max(m, n), q=q, parent=parent, rcount=cc,
                      pinv=pinv, leftmost=leftmost)


def _house(x: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Householder reflection (cs_house convention): returns (v, beta, s) with
    v[0] = 1, H x = s e_0, H = I - beta v v'."""
    s = np.linalg.norm(x)
    if s == 0.0:
        return np.zeros_like(x), 0.0, 0.0
    v = x.copy()
    if x[0] <= 0:
        v[0] = x[0] - s
    else:
        # stable form avoiding cancellation; H x = +s e0 in both branches
        v[0] = -(x[1:] @ x[1:]) / (x[0] + s)
    if v[0] == 0.0:
        return np.zeros_like(x), 0.0, s  # x is already s*e0
    beta = -1.0 / (s * v[0])
    vv = v / v[0]
    beta = beta * v[0] * v[0]
    return vv, beta, s


def qr_host(A: CSC, S: QRSymbolic, config: Config = DEFAULT) -> QRFactor:
    """Sparse Householder QR over the column etree.

    Pattern of R(:,k) = reach over the column etree from the leftmost columns
    of A(:,k)'s rows (cs_qr's symbolic step); Householders applied in
    ascending (= topological) order; the structural support of the remaining
    vector forms V_k. Correctness of the support/pattern interplay follows
    from George–Heath–Liu row-merge containment (nonpivot rows of V_i
    propagate to V_parent(i))."""
    m, n, m2 = S.m, S.n, S.m2
    C = A.permuted(None, S.q)
    x = np.zeros(max(m2, m))
    mark = np.full(n, -1, dtype=np.int64)
    Vrows: list = [None] * n
    Vvals: list = [None] * n
    beta = np.zeros(n)
    piv = np.full(n, -1, dtype=np.int64)
    Rp_cols: list = []
    Ri_cols: list = []
    Rx_cols: list = []
    leftmost = S.leftmost

    for k in range(n):
        lo, hi = C.indptr[k], C.indptr[k + 1]
        arows = C.indices[lo:hi]
        # R(:,k) pattern: reach over the column etree from leftmost cols
        pat = []
        for r in arows:
            i = leftmost[r]
            while i != -1 and i < k and mark[i] != k:
                pat.append(i)
                mark[i] = k
                i = S.parent[i]
        pat.sort()  # ascending = topological for an etree
        x[arows] = C.data[lo:hi]
        support = set(int(r) for r in arows)
        ri, rx = [], []
        for i in pat:
            vr = Vrows[i]
            if vr is None or vr.size == 0:
                continue
            vv = Vvals[i]
            tau = beta[i] * (vv @ x[vr])
            if tau != 0.0:
                x[vr] -= tau * vv
            support.update(vr.tolist())
            ri.append(i)
            rx.append(x[piv[i]])
            x[piv[i]] = 0.0
            support.discard(int(piv[i]))
        if support:
            # pivot = smallest remaining row; any distinct choice is valid
            rows_k = np.array(sorted(support), dtype=np.int64)
            v, bk, s = _house(x[rows_k])
            x[rows_k] = 0.0
            piv[k] = rows_k[0]
            Vrows[k] = rows_k
            Vvals[k] = v
            beta[k] = bk
        else:
            # structurally empty column: fictitious zero Householder
            rows_k = np.empty(0, dtype=np.int64)
            Vrows[k] = rows_k
            Vvals[k] = rows_k.astype(np.float64)
            beta[k] = 0.0
            s = 0.0
        ri.append(k)
        rx.append(s)
        Rp_cols.append(len(ri))
        Ri_cols.append(np.array(ri, dtype=np.int64))
        Rx_cols.append(np.array(rx))

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.array(Rp_cols, dtype=np.int64), out=indptr[1:])
    R = CSC(n, n, indptr, np.concatenate(Ri_cols), np.concatenate(Rx_cols), 0)
    tol = config.qr_tol
    if tol < 0:
        # SPQR's default: 20*(m+n)*eps*max column 2-norm (spqr_tol.cpp:23)
        maxnorm = 0.0
        for j in range(n):
            cv = C.vals_of(j)
            if cv.size:
                maxnorm = max(maxnorm, float(np.linalg.norm(cv)))
        tol = 20.0 * (m + n) * np.finfo(np.float64).eps * maxnorm
    diag = np.array([R.data[R.indptr[k + 1] - 1] for k in range(n)])
    rank_est = int(np.sum(np.abs(diag) > tol))
    return QRFactor(S=S, Vrows=Vrows, Vvals=Vvals, beta=beta, piv=piv, R=R,
                    rank_est=rank_est, tol=float(tol))


def apply_qt(F: QRFactor, b: np.ndarray) -> np.ndarray:
    """y = Q' b (apply Householders forward; original row space)."""
    y = np.array(b, dtype=np.float64, copy=True)
    for k in range(F.S.n):
        vr, vv = F.Vrows[k], F.Vvals[k]
        if vr.size == 0:
            continue
        tau = F.beta[k] * (vv @ y[vr])
        if tau != 0.0:
            y[vr] -= tau * vv
    return y


def apply_q(F: QRFactor, y: np.ndarray) -> np.ndarray:
    """z = Q y for y given in Householder-index space: y[k] sits at pivot row
    piv[k]; remaining rows zero. Returns an original-row-space vector."""
    z = np.zeros(F.S.m)
    n = F.S.n
    live = F.piv >= 0
    z[F.piv[live]] = np.asarray(y)[:n][live]
    for k in range(n - 1, -1, -1):
        vr, vv = F.Vrows[k], F.Vvals[k]
        if vr.size == 0:
            continue
        tau = F.beta[k] * (vv @ z[vr])
        if tau != 0.0:
            z[vr] -= tau * vv
    return z


def qr_solve(F: QRFactor, b: np.ndarray) -> np.ndarray:
    """Least-squares solve min ||Ax-b|| for m >= n (cs_qrsol upper path).

    Rank-deficient problems get the BASIC solution, the SuiteSparseQR
    contract: the x of each dead pivot (a column with |R[k,k]| <= tol) is
    fixed at zero and the live columns take their least-squares minimum
    (:func:`_usolve_basic`). A full-rank R is solved by back substitution,
    as the reference solves it."""
    S = F.S
    y = apply_qt(F, b)
    # row of R(i,:) in Q'A is the pivot row of Householder i
    yr = np.where(F.piv >= 0, y[np.maximum(F.piv, 0)], 0.0)
    if F.rank_est < S.n:
        z = _usolve_basic(F.R, yr, F.tol)
    else:
        z = usolve(F.R, yr)
    x = np.empty(S.n)
    x[S.q] = z
    return x


def _usolve_basic(U: CSC, b: np.ndarray, tol: float) -> np.ndarray:
    """x minimizing ||U[:, live] x[live] - b|| with x = 0 on the dead
    columns (|U[k,k]| <= tol): the basic least-squares solution of a
    rank-deficient R, since ||A x - b|| and ||R x - Q'b|| differ by the
    part of Q'b below R's rows, which no x reaches.

    A dead column's row of R keeps its entries right of the pivot, and the
    part of Q'b it carries, so dropping the row (the reference's upper
    solve) leaves x above the least-squares minimum. Here, as SPQR gives a
    dead column no row of R, each dead row, restricted to the live
    columns, is rotated into the live rows by Givens rotations, one for
    each entry it has left, leftmost first, against the row whose pivot
    that column is (fill stays right of that pivot, so the live rows stay
    upper triangular); the rotated live rows are then back-substituted.
    The rows are kept sparse: the work follows R's entries and their fill,
    and no dense block is formed."""
    n = U.ncol
    Up, Ui, Ux = U.indptr, U.indices, U.data
    diag = np.array([Ux[Up[j + 1] - 1] if Up[j + 1] > Up[j] else 0.0
                     for j in range(n)])
    dead = np.abs(diag) <= tol
    y = np.array(b, dtype=np.float64, copy=True)
    # the rows of U on the live columns, each sorted by column
    cols = np.repeat(np.arange(n), np.diff(Up))
    keep = ~dead[cols]
    r, c, v = Ui[keep], cols[keep], Ux[keep]
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    ptr = np.searchsorted(r, np.arange(n + 1))
    rc = [c[ptr[i]:ptr[i + 1]] for i in range(n)]
    rv = [v[ptr[i]:ptr[i + 1]] for i in range(n)]
    for i in np.flatnonzero(dead):
        ci, vi = rc[i], rv[i]
        while ci.size:
            j = ci[0]        # a live column right of i: row j is its pivot
            cj, vj = rc[j], rv[j]
            h = np.hypot(vj[0], vi[0])
            cs, sn = vj[0] / h, vi[0] / h
            u = np.union1d(cj, ci)
            wj = np.zeros(u.size)
            wj[np.searchsorted(u, cj)] = vj
            wi = np.zeros(u.size)
            wi[np.searchsorted(u, ci)] = vi
            rc[j], rv[j] = u, cs * wj + sn * wi
            ni = cs * wi - sn * wj
            ni[0] = 0.0
            nz = ni != 0.0
            ci, vi = u[nz], ni[nz]
            y[j], y[i] = cs * y[j] + sn * y[i], cs * y[i] - sn * y[j]
    x = np.zeros(n)
    for j in np.flatnonzero(~dead)[::-1]:
        cj, vj = rc[j], rv[j]
        x[j] = (y[j] - vj[1:] @ x[cj[1:]]) / vj[0]
    return x


def qrsol(A: CSC, b: np.ndarray, config: Config = DEFAULT,
          device="cuda") -> np.ndarray:
    """cs_qrsol analog: least squares (m >= n) or minimum norm (m < n).

    Least-squares problems with m * n >= ``DEVICE_MIN_CELLS`` run the
    multifrontal QR on ``device`` (SuiteSparseQR's default path) and raise
    :class:`.mfqr_device.NonFiniteFactor` where its panels or x come out
    non-finite; a caller who wants the host QR then passes
    ``device="cpu"``. Small problems use the host Householder QR; m < n
    the minimum-norm solution through the QR of A'.

    Complex A or b takes the same routes on the 2x2 real embedding, which
    keeps ||Ax - b||_2 and ||x||_2: the device QR of the embedded matrix
    past the size (:func:`.complex_embed.qrsol_complex_device`), the host
    QR of it below and for m < n (the reference runs its real host QR on
    complex input with m * n below the size and drops the imaginary
    part)."""
    dev = resolve_device(device)
    if A.sym != 0:
        # QR is a general-matrix factorization: expand symmetric storage
        # first (SuiteSparseQR converts stype != 0 the same way)
        A = A.to_full_storage()
    m, n = A.shape
    on_device = m >= n and m * n >= DEVICE_MIN_CELLS
    if np.iscomplexobj(A.data) or np.iscomplexobj(b):
        if on_device:
            return complex_embed.qrsol_complex_device(A, b, config, dev)
        z = _qrsol_host(complex_embed.embed_matrix(A),
                        complex_embed.embed_vec(b), config)
        return complex_embed.unembed_vec(z)
    if on_device:
        return mfqr_device.mfqrsol_device(A, b, config, device=dev)
    return _qrsol_host(A, b, config)


def _qrsol_host(A: CSC, b: np.ndarray, config: Config) -> np.ndarray:
    """The host Householder QR's least-squares (m >= n) or minimum-norm
    (m < n, through the QR of A') solution, real A and b (n,)."""
    m, n = A.shape
    if m >= n:
        S = symbolic_qr(A, config)
        F = qr_host(A, S, config)
        return qr_solve(F, b)
    At = A.transpose()
    S = symbolic_qr(At, config)
    F = qr_host(At, S, config)
    bq = np.asarray(b, dtype=np.float64)[S.q]
    y = utsolve(F.R, bq)
    # z = Q [y at pivot rows], already in original rows of A' (= columns of A)
    return apply_q(F, y)
