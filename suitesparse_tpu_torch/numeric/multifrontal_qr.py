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
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DEFAULT, Config, Ordering
from ..ordering.colamd import colamd_order
from ..sparse import CSC, from_triplets
from ..symbolic.supernodes import SupernodalSymbolic, analyze_supernodal

__all__ = ["QRSymbolicMF", "analyze_mfqr"]


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
