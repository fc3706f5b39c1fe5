"""Dulmage–Mendelsohn decomposition (the port's copy of the JAX package's
``ordering/dmperm.py``).

Reference analog: ``CSparse/Source/cs_dmperm.c`` (coarse decomposition via
maximum matching + alternating-path reachability, fine decomposition of the
well-determined square part via strongly connected components). Used for
block solves of rectangular/structurally singular systems and by MATLAB's
``dmperm``.

Coarse sets (cs convention): A(p,q) has the form

        [ A11 A12   .    .  ]   underdetermined rows (R1 x C1 horizontal part)
        [  .  A23   .    .  ]   square well-determined part (R2 x C2)
        [  .   .   A34   .  ]   overdetermined part (R3 x C3)

with the square part further permuted to block upper triangular (fine blocks).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse import CSC
from .btf import maxtrans, strongcomp

__all__ = ["DMPerm", "dmperm"]


@dataclasses.dataclass
class DMPerm:
    rowperm: np.ndarray     # p
    colperm: np.ndarray     # q
    rr: np.ndarray          # coarse row boundaries, size 4: [0,|R1|,+|R2|,m]
    cc: np.ndarray          # coarse col boundaries, size 4
    r: np.ndarray           # fine block row boundaries within the square part
    s: np.ndarray           # fine block col boundaries within the square part
    nblocks: int
    structural_rank: int


def dmperm(A: CSC) -> DMPerm:
    m, n = A.shape
    nmatch, match = maxtrans(A)  # match[j] = row matched to column j
    rowmatch = np.full(m, -1, dtype=np.int64)
    live = match >= 0
    rowmatch[match[live]] = np.flatnonzero(live)

    AT = A.transpose(values=False)

    # horizontal part: alternating BFS from unmatched COLUMNS
    colmark = np.zeros(n, dtype=bool)
    rowmark_h = np.zeros(m, dtype=bool)
    stack = [int(j) for j in np.flatnonzero(match < 0)]
    colmark[match < 0] = True
    while stack:
        j = stack.pop()
        for i in A.rows_of(j):
            if rowmark_h[i]:
                continue
            rowmark_h[i] = True
            jn = rowmatch[i]
            if jn >= 0 and not colmark[jn]:
                colmark[jn] = True
                stack.append(int(jn))
    C1 = np.flatnonzero(colmark)
    R1 = np.flatnonzero(rowmark_h)

    # vertical part: alternating BFS from unmatched ROWS
    rowmark_v = np.zeros(m, dtype=bool)
    colmark_v = np.zeros(n, dtype=bool)
    stack = [int(i) for i in np.flatnonzero(rowmatch < 0)]
    rowmark_v[rowmatch < 0] = True
    while stack:
        i = stack.pop()
        for j in AT.rows_of(i):
            if colmark_v[j]:
                continue
            colmark_v[j] = True
            inext = match[j]
            if inext >= 0 and not rowmark_v[inext]:
                rowmark_v[inext] = True
                stack.append(int(inext))
    R3 = np.flatnonzero(rowmark_v)
    C3 = np.flatnonzero(colmark_v)

    assert not np.any(rowmark_h & rowmark_v), "coarse row sets overlap"
    assert not np.any(colmark & colmark_v), "coarse col sets overlap"
    R2 = np.flatnonzero(~rowmark_h & ~rowmark_v)
    C2 = np.flatnonzero(~colmark & ~colmark_v)
    assert R2.size == C2.size, "square part not square"

    # fine decomposition of the square part: SCC of the matched submatrix
    if C2.size:
        k = C2.size
        cid = np.full(n, -1, dtype=np.int64)
        cid[C2] = np.arange(k)
        rid = np.full(m, -1, dtype=np.int64)
        rid[match[C2]] = np.arange(k)  # row matched to C2[t] gets local id t
        rows_l, cols_l = [], []
        for t, j in enumerate(C2):
            rr_ = A.rows_of(j)
            sel = rid[rr_] >= 0
            rows_l.append(rid[rr_[sel]])
            cols_l.append(np.full(int(sel.sum()), t, dtype=np.int64))
        from ..sparse import from_triplets
        B = from_triplets(k, k, np.concatenate(rows_l), np.concatenate(cols_l),
                          np.ones(sum(len(x) for x in rows_l)))
        nb, pf, rf = strongcomp(B)
        C2f = C2[pf]
        R2f = match[C2f]
    else:
        nb = 0
        rf = np.zeros(1, dtype=np.int64)
        C2f = C2
        R2f = np.empty(0, dtype=np.int64)

    rowperm = np.concatenate([R1, R2f, R3]).astype(np.int64)
    colperm = np.concatenate([C1, C2f, C3]).astype(np.int64)
    rr = np.array([0, R1.size, R1.size + R2f.size, m], dtype=np.int64)
    cc = np.array([0, C1.size, C1.size + C2f.size, n], dtype=np.int64)
    return DMPerm(rowperm=rowperm, colperm=colperm, rr=rr, cc=cc,
                  r=rf + rr[1], s=rf + cc[1], nblocks=nb,
                  structural_rank=nmatch)
