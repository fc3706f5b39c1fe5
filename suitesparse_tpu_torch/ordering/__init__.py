"""Fill-reducing orderings of the port: AMD, constrained AMD and nested
dissection (with its NESDIS form) on the pattern of A + A', COLAMD and
CCOLAMD on the pattern of A'A (for QR), edge-cut and k-way partitions, and
the block triangular form of the LU path (:mod:`.btf`), all in the host C++
library."""

from __future__ import annotations

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC
from .amd import _amd_python, amd_order
from .colamd import ccolamd_order, colamd_order, csymamd_order, symamd_order
from .nested_dissection import _subgraph, nesdis_order, nested_dissection_order
from .partition import edge_cut, partition_kway

__all__ = ["amd_order", "colamd_order", "nested_dissection_order",
           "natural_order", "camd_order", "ccolamd_order", "symamd_order",
           "csymamd_order", "nesdis_order", "edge_cut", "partition_kway"]


def natural_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    return np.arange(A.ncol, dtype=np.int64)


def camd_order(A: CSC, cset: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """Constrained AMD (CAMD analog): fill-reducing order of pattern(A+A')
    keeping constraint sets contiguous in ascending set order — the NESDIS
    post-ordering primitive (reference camd.h camd_order). Without the
    library's ``sstpu_camd``, the reference's fallback: each set ordered by
    the Python minimum degree on its own, the sets concatenated."""
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    S = A.aat_pattern()
    if native.has("sstpu_camd"):
        return native.camd(S.indptr, S.indices, n, cset)
    cset = np.asarray(cset, dtype=np.int64)
    out = []
    for s in np.unique(cset):
        nodes = np.flatnonzero(cset == s)
        if nodes.size == 1:
            out.append(nodes)
            continue
        out.append(nodes[_amd_python(_subgraph(S, nodes))])
    return np.concatenate(out)
