"""Nested dissection ordering (METIS_NodeND / NESDIS analog): the multilevel
vertex-separator bisection of ``native/src/nd.cc`` (heavy-edge matching,
BFS initial bisection, FM refinement, vertex-cover separators, AMD on the
leaves). Its large separator fronts near the root are the dense panels the
device factor batches. ``nesdis_order`` adds the NESDIS post-pass
(constrained AMD over the dissection's blocks); its fallback without the
library's ``sstpu_nested_dissection_sets`` is the reference's BFS-level
bisection (``_nd_python``)."""

from __future__ import annotations

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC, from_triplets
from .amd import _amd_python

__all__ = ["nested_dissection_order", "nesdis_order"]


def nested_dissection_order(A: CSC, config: Config = DEFAULT) -> np.ndarray:
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64)
    S = A.aat_pattern()
    return native.nested_dissection(S.indptr, S.indices, n,
                                    nd_small=config.nd_small)


def nesdis_order(A: CSC, config: Config = DEFAULT
                 ) -> tuple[np.ndarray, np.ndarray]:
    """NESDIS analog (``CHOLMOD/Partition/cholmod_nesdis.c``): nested
    dissection down to nd_small leaves, then ONE constrained-AMD pass over
    the whole graph with the leaf-block/separator decomposition as the
    constraint sets (Cmember) — lets minimum degree re-order freely inside
    each region while keeping the separator tree's elimination structure.

    Returns (perm, cmember) with cmember in post-CAMD vertex order semantics
    (set ids ascending along perm)."""
    n = A.ncol
    if n == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    S = A.aat_pattern()
    if native.has("sstpu_nested_dissection_sets"):
        _, cmember = native.nested_dissection_sets(S.indptr, S.indices, n,
                                                   nd_small=config.nd_small)
    else:
        perm0 = _nd_python(S, config.nd_small)
        # fallback sets: contiguous nd_small-sized chunks of the ND order
        cmember = np.empty(n, dtype=np.int64)
        nblk = max(1, n // max(config.nd_small, 1))
        bounds = np.linspace(0, n, nblk + 1).astype(np.int64)
        for b in range(nblk):
            cmember[perm0[bounds[b]:bounds[b + 1]]] = b
    from . import camd_order
    perm = camd_order(A, cmember, config)
    return perm, cmember


def _nd_python(S: CSC, nd_small: int) -> np.ndarray:
    """BFS-level bisection fallback (quality below the multilevel path)."""
    n = S.ncol
    perm = np.empty(n, dtype=np.int64)

    def recurse(nodes: np.ndarray, lo: int, hi: int) -> None:
        k = nodes.size
        if k == 0:
            return
        if k <= nd_small:
            sub = _subgraph(S, nodes)
            p = _amd_python(sub)
            perm[lo:lo + k] = nodes[p]
            return
        # BFS levels from an arbitrary node; split at the median level
        sub = _subgraph(S, nodes)
        dist = np.full(k, -1, dtype=np.int64)
        dist[0] = 0
        frontier = [0]
        while frontier:
            nxt = []
            for v in frontier:
                for u in sub.rows_of(v):
                    if dist[u] == -1:
                        dist[u] = dist[v] + 1
                        nxt.append(int(u))
            frontier = nxt
        dist[dist == -1] = dist.max() + 1
        half = np.median(dist)
        side_a = dist < half
        side_s = dist == half
        side_b = ~side_a & ~side_s
        if not side_a.any() or not side_b.any():
            p = _amd_python(sub)
            perm[lo:lo + k] = nodes[p]
            return
        na, ns = int(side_a.sum()), int(side_s.sum())
        perm[hi - ns:hi] = nodes[side_s]
        recurse(nodes[side_a], lo, lo + na)
        recurse(nodes[side_b], lo + na, hi - ns)

    recurse(np.arange(n, dtype=np.int64), 0, n)
    return perm


def _subgraph(S: CSC, nodes: np.ndarray) -> CSC:
    id_of = np.full(S.ncol, -1, dtype=np.int64)
    id_of[nodes] = np.arange(nodes.size)
    cols = np.repeat(np.arange(S.ncol, dtype=np.int64), np.diff(S.indptr))
    sel = (id_of[S.indices] >= 0) & (id_of[cols] >= 0)
    return from_triplets(nodes.size, nodes.size, id_of[S.indices[sel]],
                         id_of[cols[sel]], np.ones(int(sel.sum())))
