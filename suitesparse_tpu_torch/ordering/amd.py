"""Approximate minimum degree ordering (reference ``AMD/Source/amd_2.c:43``;
the quotient-graph AMD of ``native/src/amd.cc``)."""

from __future__ import annotations

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC

__all__ = ["amd_order"]


def amd_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    """Fill-reducing permutation of the symmetric pattern of A + A'."""
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    S = A.aat_pattern()
    return native.amd(S.indptr, S.indices, n, dense=config.amd_dense,
                      aggressive=config.amd_aggressive)
