"""Nested dissection ordering (METIS_NodeND / NESDIS analog): the multilevel
vertex-separator bisection of ``native/src/nd.cc`` (heavy-edge matching,
BFS initial bisection, FM refinement, vertex-cover separators, AMD on the
leaves). Its large separator fronts near the root are the dense panels the
device factor batches."""

from __future__ import annotations

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC

__all__ = ["nested_dissection_order"]


def nested_dissection_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    S = A.aat_pattern()
    return native.nested_dissection(S.indptr, S.indices, n,
                                    nd_small=config.nd_small)
