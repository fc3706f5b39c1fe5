"""Column ordering for QR: a fill-reducing order of A'A without forming A'A.

Reference analog: the COLAMD package (``COLAMD/Source/colamd.c``). The engine
is the row-list column approximate minimum degree of ``native/src/colamd.cc``
(Davis, Gilbert, Larimore and Ng, TOMS 2004: row-list set differences,
supercolumn hashing, aggressive row absorption, dense row and column
handling, constraint sets for CCOLAMD). ``colamd_order`` is native only;
``ccolamd_order`` keeps the reference's fallback (constrained AMD on the
pattern of A'A without dense rows) where the library cannot be built.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC, from_triplets
from .amd import amd_order

__all__ = ["colamd_order", "ccolamd_order", "symamd_order", "csymamd_order"]

def colamd_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    """Fill-reducing column permutation q for QR of A (colamd analog):
    q[k] = column ordered kth."""
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    Ag = A.to_full_storage() if A.sym != 0 else A
    return native.colamd(Ag.nrow, n, Ag.indptr, Ag.indices,
                         dense_row=config.colamd_dense_row,
                         dense_col=config.colamd_dense_col,
                         aggressive=config.amd_aggressive)


def _ata_pattern(A: CSC, config: Config) -> CSC:
    """Fallback-only: pattern of A'A with dense rows dropped."""
    m, n = A.nrow, A.ncol
    Ag = A.to_full_storage() if A.sym != 0 else A
    row_counts = np.bincount(Ag.indices, minlength=m)
    cut = max(16.0, config.colamd_dense_row * np.sqrt(max(n, 1)))
    keep_rows = row_counts < cut
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ag.indptr))
    sel = keep_rows[Ag.indices]
    Af = from_triplets(m, n, Ag.indices[sel], cols[sel], np.ones(int(sel.sum())))
    At = Af.transpose(values=False)
    rr, cc = [], []
    for i in range(m):
        lo, hi = At.indptr[i], At.indptr[i + 1]
        if hi - lo < 2:
            continue
        js = At.indices[lo:hi]
        k = js.size
        i0, i1 = np.triu_indices(k, 1)
        rr.append(js[i0])
        cc.append(js[i1])
    if rr:
        r = np.concatenate(rr + cc)
        c = np.concatenate(cc + rr)
        return from_triplets(n, n, r, c, np.ones(r.size))
    return from_triplets(n, n, [], [], [])


def ccolamd_order(A: CSC, cset: np.ndarray,
                  config: Config = DEFAULT) -> np.ndarray:
    """Constrained COLAMD (CCOLAMD analog, ``ccolamd.h``): column ordering for
    LU/QR where each output column block stays within one constraint set,
    sets emitted in ascending order — used by SPQR/NESDIS to post-order
    partitioned problems."""
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    Ag = A.to_full_storage() if A.sym != 0 else A
    if native.available():
        return native.colamd(Ag.nrow, n, Ag.indptr, Ag.indices,
                             dense_row=config.colamd_dense_row,
                             dense_col=config.colamd_dense_col,
                             aggressive=config.amd_aggressive,
                             cmember=np.asarray(cset, dtype=np.int64))
    from . import camd_order
    return camd_order(_ata_pattern(A, config), cset, config)


def symamd_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    """SYMAMD analog (``colamd.h`` symamd): ordering for a symmetric matrix
    via the column engine. The reference builds a skeleton M with one row per
    off-diagonal entry of tril(A) so that M'M has A's pattern, then runs
    colamd(M); here the AMD engine on pattern(A+A') plays that role directly
    (same quotient-graph objective, no skeleton materialization)."""
    return amd_order(A, config)


def csymamd_order(A: CSC, cset: np.ndarray,
                  config: Config = DEFAULT) -> np.ndarray:
    """CSYMAMD analog (``ccolamd.h`` csymamd): constrained symmetric ordering."""
    from . import camd_order
    return camd_order(A, cset, config)
