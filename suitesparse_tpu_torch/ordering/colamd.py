"""Column ordering for QR: a fill-reducing order of A'A without forming A'A.

Reference analog: the COLAMD package (``COLAMD/Source/colamd.c``). The engine
is the row-list column approximate minimum degree of ``native/src/colamd.cc``
(Davis, Gilbert, Larimore and Ng, TOMS 2004: row-list set differences,
supercolumn hashing, aggressive row absorption, dense row and column
handling).
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC

__all__ = ["colamd_order"]

# COLAMD's dense thresholds (colamd.h knobs, the reference's defaults): rows
# with more than max(16, DENSE_ROW * sqrt(n)) entries, and columns with more
# than max(16, DENSE_COL * sqrt(min(m, n))), are set aside
DENSE_ROW = 10.0
DENSE_COL = 10.0


def colamd_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    """Fill-reducing column permutation q for QR of A (colamd analog):
    q[k] = column ordered kth."""
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    Ag = A.to_full_storage() if A.sym != 0 else A
    return native.colamd(Ag.nrow, n, Ag.indptr, Ag.indices,
                         dense_row=DENSE_ROW, dense_col=DENSE_COL,
                         aggressive=config.amd_aggressive)
