"""Multifrontal QR (SPQR-class path): the front-tree analysis that the
device path (:mod:`.mfqr_device`) runs on.

Reference analog: SPQR (``spqr_analyze.cpp`` front tree over the column etree
of A'A; ``spqr_kernel.cpp``/``spqr_front.cpp`` staircase Householder fronts;
``spqr_rhpack``/``spqr_cpack`` R and contribution-block packing); the port's
copy of the JAX package's ``numeric/multifrontal_qr.py``:

  * the front tree IS the supernodal structure of chol(A'A) (R = L'), from
    :func:`..symbolic.supernodes.analyze_supernodal` on the A'A pattern;
  * front s stacks (a) the original A rows whose LEFTMOST column lies in the
    supernode and (b) the children's contribution blocks (their R rows beyond
    their own pivot columns); one dense QR per front yields the final R rows
    of the supernode plus the contribution block for the parent. Every shape
    is STRUCTURAL (row counts do not depend on the values), so the device
    path (:mod:`.mfqr_device`) runs level-batched padded fronts;
  * Q is not stored (SPQR's Q-less economy mode): the right-hand side rides
    along as extra front columns and is transformed in place, and x = R \\ y
    is one backward substitution over the supernode tree.

:func:`factorize_qr_host`, :func:`qr_mf_solve` and :func:`mfqrsol` are the
reference's numpy multifrontal QR (its oracle and host path), one dense
Householder QR a front; no entry point of the port routes to them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DEFAULT, Config, Ordering
from ..ordering.colamd import colamd_order
from ..sparse import CSC, from_triplets
from ..symbolic.supernodes import SupernodalSymbolic, analyze_supernodal

__all__ = ["MFQRFactor", "QRSymbolicMF", "analyze_mfqr", "factorize_qr_host",
           "mfqrsol", "qr_mf_solve"]


@dataclasses.dataclass
class QRSymbolicMF:
    """Front-tree analysis for multifrontal QR of A (m x n, m >= n)."""

    S: SupernodalSymbolic          # supernodal structure of chol(A'A)
    q: np.ndarray                  # column permutation (== S.perm)
    row_front: np.ndarray          # original A row -> owning supernode (-1 none)
    front_arows: list              # per supernode: original A row ids
    front_m: np.ndarray            # structural row count of each front
    front_k: np.ndarray            # rows of R produced (min(m, ncols_front))
    cb_rows: np.ndarray            # contribution-block rows passed to parent


@dataclasses.dataclass
class MFQRFactor:
    """The host factor: R panels a supernode and the transformed
    right-hand side's rows."""

    SQ: QRSymbolicMF
    Rpanels: list                  # per supernode: (nc x nfcols) dense R rows
    Ypanels: list                  # per supernode: (nc x nrhs) Q'b rows
    rank_est: int


def _children(S: SupernodalSymbolic) -> list:
    """children[s]: the supernodes whose parent is s, ascending."""
    children: list = [[] for _ in range(S.nsuper)]
    for c in range(S.nsuper):
        if S.sparent[c] != -1:
            children[S.sparent[c]].append(c)
    return children


def analyze_mfqr(A: CSC, config: Config = DEFAULT,
                 q: np.ndarray | None = None) -> QRSymbolicMF:
    """Front tree of the multifrontal QR of A (m x n, m >= n): COLAMD (or
    the given ``q``), the supernodal analysis of A'A, each A row's front
    and the structural row counts. The reference's numbers, with the row
    assignment vectorized and each front's children listed once (its
    loops are quadratic in the number of supernodes)."""
    m, n = A.shape
    if m < n:
        raise ValueError("multifrontal QR expects m >= n (transpose for "
                         "the minimum-norm solution)")
    # column order + A'A pattern supernodal analysis
    if q is None:
        if config.ordering is Ordering.NATURAL:
            q = np.arange(n, dtype=np.int64)
        else:
            q = colamd_order(A, config)
    Aq = A.permuted(None, q)
    AtA = _ata_pattern_upper(Aq)
    S = analyze_supernodal(AtA, np.arange(n, dtype=np.int64), config)
    # fold the analysis postorder into q
    q = q[S.perm]
    Aq = A.permuted(None, q)
    # every A row goes to the supernode owning its leftmost column (the
    # first of its sorted columns in A(:, q)')
    AqT = Aq.transpose(values=False)
    row_front = np.full(m, -1, dtype=np.int64)
    live = np.diff(AqT.indptr) > 0
    row_front[live] = S.snode_of_col[AqT.indices[AqT.indptr[:-1][live]]]
    order = np.argsort(row_front, kind="stable")
    counts = np.bincount(row_front[live], minlength=S.nsuper)
    front_arows = np.split(order[m - int(live.sum()):],
                           np.cumsum(counts)[:-1])
    # structural row counts bottom-up (children have smaller ids)
    children = _children(S)
    front_m = np.zeros(S.nsuper, dtype=np.int64)
    front_k = np.zeros(S.nsuper, dtype=np.int64)
    cb_rows = np.zeros(S.nsuper, dtype=np.int64)
    for s in range(S.nsuper):
        nf = len(S.rows[s])
        nc = S.ncols(s)
        mrows = len(front_arows[s]) + sum(int(cb_rows[c])
                                          for c in children[s])
        front_m[s] = mrows
        front_k[s] = min(mrows, nf)
        cb_rows[s] = max(0, int(front_k[s]) - nc)
    return QRSymbolicMF(S=S, q=q, row_front=row_front,
                        front_arows=front_arows, front_m=front_m,
                        front_k=front_k, cb_rows=cb_rows)


def _ata_pattern_upper(A: CSC) -> CSC:
    """Pattern of A'A as upper-stored CSC with unit values (+ diagonal)."""
    n = A.ncol
    AT = A.transpose(values=False)
    rows_l, cols_l = [], []
    for i in range(A.nrow):
        lo, hi = AT.indptr[i], AT.indptr[i + 1]
        js = AT.indices[lo:hi]
        if js.size < 2:
            continue
        i0, i1 = np.triu_indices(js.size, 1)
        rows_l.append(js[i0])
        cols_l.append(js[i1])
    rows_l.append(np.arange(n, dtype=np.int64))
    cols_l.append(np.arange(n, dtype=np.int64))
    r = np.concatenate(rows_l)
    c = np.concatenate(cols_l)
    return from_triplets(n, n, r, c, np.ones(r.size), sym=1)


def _spqr_tol(A: CSC, Aq: CSC, config: Config = DEFAULT) -> float:
    """The rank tolerance: ``config.qr_tol`` where it is >= 0, else SPQR's
    default (``spqr_tol.cpp:23``): 20 (m + n) eps times the largest column
    2-norm."""
    if config.qr_tol >= 0:
        return float(config.qr_tol)
    maxnorm = max((float(np.linalg.norm(Aq.vals_of(j)))
                   for j in range(Aq.ncol)), default=0.0)
    return 20.0 * (A.nrow + A.ncol) * np.finfo(np.float64).eps * maxnorm


def factorize_qr_host(A: CSC, SQ: QRSymbolicMF, b: np.ndarray,
                      config: Config = DEFAULT) -> MFQRFactor:
    """Numpy multifrontal QR of A with b transformed alongside: each front
    (its A rows and its children's contribution rows) through one dense
    ``np.linalg.qr``; the supernode's R rows and Q'b rows kept, the rest
    handed to the parent. ``rank_est`` counts the pivots above
    ``config.qr_tol`` (SPQR's default tolerance where it is < 0)."""
    S = SQ.S
    Aq = A.permuted(None, SQ.q)
    AqT = Aq.transpose()
    b = np.asarray(b, dtype=np.float64)
    bb = b.reshape(-1, 1) if b.ndim == 1 else b
    nrhs = bb.shape[1]
    children = _children(S)
    Rpanels: list = [None] * S.nsuper
    Ypanels: list = [None] * S.nsuper
    cb_store: dict = {}
    tol = _spqr_tol(A, Aq, config)
    rank_est = 0
    for s in range(S.nsuper):
        cols = S.rows[s]               # front columns (permuted space)
        nf = len(cols)
        nc = S.ncols(s)
        blocks, yblocks = [], []
        for r in SQ.front_arows[s]:    # original A rows, spread over cols
            row = np.zeros(nf)
            lo, hi = AqT.indptr[r], AqT.indptr[r + 1]
            row[np.searchsorted(cols, AqT.indices[lo:hi])] = AqT.data[lo:hi]
            blocks.append(row)
            yblocks.append(bb[r])
        for c in children[s]:          # children's contribution blocks
            if int(SQ.cb_rows[c]) == 0:
                continue
            CB, CBy, cbcols = cb_store.pop(c)
            blk = np.zeros((CB.shape[0], nf))
            blk[:, np.searchsorted(cols, cbcols)] = CB
            blocks.append(blk)
            yblocks.append(CBy)
        F = np.vstack([np.atleast_2d(x) for x in blocks]) if blocks else \
            np.zeros((0, nf))
        Y = np.vstack([np.atleast_2d(y) for y in yblocks]) if yblocks else \
            np.zeros((0, nrhs))
        mloc = F.shape[0]
        if mloc:
            # dense Householder QR with the right-hand side: [R; 0], Q'Y
            Qf, Rf = np.linalg.qr(F, mode="complete")
            Yt = Qf.T @ Y
        else:
            Rf = np.zeros((0, nf))
            Yt = np.zeros((0, nrhs))
        # the supernode's R rows (zero-padded where the front is short)
        Rpanels[s] = (Rf[:nc, :] if mloc >= nc else
                      np.vstack([Rf[:mloc, :], np.zeros((nc - mloc, nf))]))
        Ypanels[s] = Yt[:nc, :] if mloc >= nc else \
            np.vstack([Yt[:mloc, :], np.zeros((nc - mloc, nrhs))])
        rank_est += int(np.sum(np.abs(np.diag(Rpanels[s][:, :nc])) > tol))
        mu = int(SQ.cb_rows[s])
        if mu > 0:
            cb_store[s] = (Rf[nc:nc + mu, nc:], Yt[nc:nc + mu, :],
                           cols[nc:])
    return MFQRFactor(SQ=SQ, Rpanels=Rpanels, Ypanels=Ypanels,
                      rank_est=rank_est)


def qr_mf_solve(F: MFQRFactor) -> np.ndarray:
    """x = R \\ y by backward substitution over the supernodes (root to
    leaves), (n, nrhs); a zero pivot gives a zero x (rank deficiency)."""
    SQ = F.SQ
    S = SQ.S
    nrhs = F.Ypanels[0].shape[1] if S.nsuper else 1
    x = np.zeros((S.n, nrhs))
    for s in range(S.nsuper - 1, -1, -1):
        cols = S.rows[s]
        nc = S.ncols(s)
        f = int(S.super_first[s])
        R = F.Rpanels[s]
        rhs = F.Ypanels[s].copy()
        if len(cols) > nc:
            rhs -= R[:, nc:] @ x[cols[nc:]]
        R11 = R[:nc, :nc]
        for kk in range(nc - 1, -1, -1):
            acc = rhs[kk] - R11[kk, kk + 1:nc] @ x[f + kk + 1:f + nc]
            d = R11[kk, kk]
            x[f + kk] = acc / d if d != 0.0 else 0.0
    xout = np.zeros_like(x)
    xout[SQ.q] = x
    return xout


def mfqrsol(A: CSC, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """Least squares min ||Ax - b|| by the host multifrontal QR (m >= n)."""
    SQ = analyze_mfqr(A, config)
    x = qr_mf_solve(factorize_qr_host(A, SQ, b, config))
    return x[:, 0] if np.asarray(b).ndim == 1 else x
