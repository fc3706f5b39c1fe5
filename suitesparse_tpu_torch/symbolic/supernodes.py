"""Supernodal symbolic analysis: fundamental supernodes, relaxed
amalgamation, row patterns and tree levels.

Reference analog: ``CHOLMOD/Supernodal/cholmod_super_symbolic.c``
(fundamental supernodes :155-:465, supernode etree :465, relaxed
amalgamation :475-560 with the nrelax/zrelax rule, patterns :775+). The
postorder is folded into the permutation up front, so supernodes are
contiguous column ranges of the factored matrix; the analysis itself runs
in the host C++ library (``native/src/super.cc``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC
from .etree import col_counts, etree, postorder

__all__ = ["SupernodalSymbolic", "Supernode", "analyze_supernodal"]


@dataclasses.dataclass
class SupernodalSymbolic:
    """Supernodal analysis result (cholmod supernodal-symbolic factor)."""

    n: int
    perm: np.ndarray          # fill-reducing permutation (postorder folded)
    parent: np.ndarray        # column etree of C = A(perm, perm)
    colcount: np.ndarray      # exact nnz(L(:,j)) BEFORE amalgamation
    nsuper: int
    super_first: np.ndarray   # first column of each supernode, size nsuper+1
    sparent: np.ndarray       # supernode etree
    rows: list                # rows[s]: global row ids of supernode s's panel
                              # (first ncols entries are its own columns)
    snode_of_col: np.ndarray  # column -> supernode
    levels: list              # levels[d] = supernodes at tree depth d
    level_of: np.ndarray
    lnz: int                  # nnz stored in panels (incl. amalgamation zeros)
    fl: float                 # factorization flops
    maxcsize: int             # largest child update matrix (rows)
    # flat panel layout (CHOLMOD px): panel s occupies Lpx[s] : Lpx[s+1] as a
    # dense (nrows, ncols) column-major block
    Lpx: np.ndarray

    def ncols(self, s: int) -> int:
        return int(self.super_first[s + 1] - self.super_first[s])

    def nrows(self, s: int) -> int:
        return len(self.rows[s])


Supernode = SupernodalSymbolic  # the reference's legacy alias


def analyze_supernodal(A: CSC, perm: np.ndarray | None = None,
                       config: Config = DEFAULT) -> SupernodalSymbolic:
    """Full supernodal analysis of A(p,p) for upper-stored symmetric A."""
    n = A.ncol
    if A.sym != 1:
        raise ValueError("analyze_supernodal expects upper-stored symmetric "
                         "input (sym=1)")
    if perm is None:
        perm = np.arange(n, dtype=np.int64)
    perm = np.asarray(perm, dtype=np.int64)

    # fold the etree postorder into the permutation so supernode columns are
    # contiguous (cholmod_analyze does the same via its postorder step)
    C = A.symperm(perm)
    perm = perm[postorder(etree(C))]
    C = A.symperm(perm)
    parent = etree(C)
    post2 = postorder(parent)
    if not np.array_equal(post2, np.arange(n)):
        perm = perm[post2]
        C = A.symperm(perm)
        parent = etree(C)
    cc = col_counts(C, parent, np.arange(n, dtype=np.int64))

    Clow = C.transpose(values=False)
    r = native.super_analyze(n, Clow.indptr, Clow.indices, parent, cc,
                             config.nrelax, config.zrelax)
    nsuper = len(r["super_first"]) - 1
    rows_ptr, rows_cat = r["rows_ptr"], r["rows"]
    rows = [rows_cat[rows_ptr[s]:rows_ptr[s + 1]] for s in range(nsuper)]
    level_of = r["level_of"]
    nlev = int(level_of.max()) + 1 if nsuper else 0
    levels = [np.flatnonzero(level_of == d) for d in range(nlev)]
    return SupernodalSymbolic(
        n=n, perm=perm, parent=parent, colcount=cc, nsuper=nsuper,
        super_first=r["super_first"], sparent=r["sparent"], rows=rows,
        snode_of_col=r["snode_of_col"], levels=levels, level_of=level_of,
        lnz=int(r["lpx"][-1]), fl=r["fl"], maxcsize=r["maxcsize"],
        Lpx=r["lpx"])
