"""Block-triangular-form permutation: maximum transversal + strong components.

Reference analog: the BTF package (``btf_maxtrans.c`` augmenting-path
maximum matching, ``btf_strongcomp.c`` Tarjan SCC, ``btf_order.c:35`` the
combined permutation to block upper triangular form); the port's copy of
the JAX package's ``ordering/btf.py``. Both kernels run in the host C++
library (``native/src/btf.cc``); the reference's Python fallbacks are not
copied, so without ``g++`` the first call raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..sparse import CSC

__all__ = ["maxtrans", "strongcomp", "btf_order", "BTF"]


def maxtrans(A: CSC, work_limit: float = -1.0) -> tuple[int, np.ndarray]:
    """Maximum transversal. Returns (nmatch, match) with ``match[j]`` = row
    matched to column j, or -1. ``nmatch`` is the structural rank.

    ``work_limit`` > 0 bounds augmenting-path work to ``work_limit * nnz``
    edge examinations (reference ``btf.h:206`` maxwork contract); past the
    budget, columns are matched by the cheap O(nnz) scan only and the
    matching may be suboptimal (structural rank under-reported)."""
    return native.maxtrans(A.nrow, A.ncol, A.indptr, A.indices, work_limit)


def strongcomp(A: CSC) -> tuple[int, np.ndarray, np.ndarray]:
    """Tarjan SCC of the digraph of square A. Returns (nblocks, p, r): A(p,p)
    is block upper triangular with block k spanning ``p[r[k]:r[k+1]]``."""
    if A.nrow != A.ncol:
        raise ValueError("strongcomp requires square A")
    return native.strongcomp(A.ncol, A.indptr, A.indices)


@dataclasses.dataclass
class BTF:
    """Block-upper-triangular permutation: A(rowperm, colperm) is block upper
    triangular with ``nblocks`` diagonal blocks at boundaries ``r``."""

    rowperm: np.ndarray
    colperm: np.ndarray
    r: np.ndarray          # block boundaries, size nblocks+1
    nblocks: int
    structural_rank: int


def btf_order(A: CSC, work_limit: float = -1.0) -> BTF:
    """Permutation to block upper triangular form (btf_order analog).

    First a maximum transversal puts a zero-free diagonal (if structurally
    nonsingular), then Tarjan SCC of the matched matrix finds the blocks."""
    n = A.ncol
    if A.nrow != n:
        raise ValueError("btf_order requires square A")
    nmatch, match = maxtrans(A, work_limit)
    if nmatch < n:
        # structurally singular: complete the matching arbitrarily
        used = np.zeros(n, dtype=bool)
        m = match.copy()
        used[m[m >= 0]] = True
        free_rows = np.flatnonzero(~used)
        m[m < 0] = free_rows[: np.count_nonzero(m < 0)]
        match = m
    # B = A(match, :) has the matching on its diagonal; its strong
    # components are A's diagonal blocks
    rowinv = np.empty(n, dtype=np.int64)
    rowinv[match] = np.arange(n, dtype=np.int64)
    B = CSC(n, n, A.indptr, rowinv[A.indices], A.data, 0)
    nb, p, r = strongcomp(B)
    return BTF(rowperm=match[p], colperm=p, r=r, nblocks=nb,
               structural_rank=nmatch)
