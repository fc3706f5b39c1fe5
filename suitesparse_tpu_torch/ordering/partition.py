"""Graph partitioning: edge-cut bipartition and recursive k-way.

Reference analogs: Mongoose (``Mongoose.hpp:87-144`` — ``EdgeCut_Options``,
``EdgeCut``: multilevel heavy-edge matching + FM + community refinement) and
METIS ``METIS_PartGraphRecursive`` (``metis.h:221``). The native multilevel
machinery is shared with nested dissection (``native/src/nd.cc``); this module
is the user-facing partitioning API. The port's copy of the JAX package's
``ordering/partition.py``; without the library's ``sstpu_edgecut`` it takes
the reference's Python region growing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..config import DEFAULT, Config
from ..sparse import CSC
from .nested_dissection import _subgraph

__all__ = ["EdgeCut", "edge_cut", "partition_kway"]


@dataclasses.dataclass
class EdgeCut:
    """Result object (Mongoose EdgeCut analog)."""

    partition: np.ndarray   # {0,1}^n (or {0..k-1} for k-way)
    cut_size: int           # number (weight) of cut edges
    imbalance: float        # |w0/W - target|

    @property
    def w0(self) -> int:
        return int(np.count_nonzero(self.partition == 0))


def edge_cut(A: CSC, target_split: float = 0.5, tolerance: float = 0.05,
             seed: int = 1, config: Config = DEFAULT) -> EdgeCut:
    """Two-way edge-cut partition of A's adjacency graph (pattern of A+A',
    diagonal ignored)."""
    n = A.ncol
    if n == 0:
        return EdgeCut(np.empty(0, dtype=np.int64), 0, 0.0)
    S = A.aat_pattern()
    if native.has("sstpu_edgecut"):
        part, cut = native.edgecut(S.indptr, S.indices, n,
                                   target_split=target_split,
                                   tolerance=tolerance, seed=seed)
    else:
        part, cut = _edgecut_python(S, target_split, seed)
    w0 = int(np.count_nonzero(part == 0))
    return EdgeCut(part, cut, abs(w0 / max(n, 1) - target_split))


def _edgecut_python(S: CSC, target_split: float, seed: int):
    """BFS region growing + greedy boundary passes (toolchain-free fallback)."""
    n = S.ncol
    rng = np.random.default_rng(seed)
    part = np.ones(n, dtype=np.int64)
    start = int(rng.integers(n))
    goal = int(target_split * n)
    dist = np.full(n, -1)
    dist[start] = 0
    frontier = [start]
    grown = 0
    while frontier and grown < goal:
        v = frontier.pop()
        if part[v] == 0:
            continue
        part[v] = 0
        grown += 1
        for u in S.rows_of(v):
            if dist[u] == -1:
                dist[u] = dist[v] + 1
                frontier.insert(0, int(u))
    cut = 0
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    cut = int(np.count_nonzero(part[S.indices] != part[cols]) // 2)
    return part, cut


def partition_kway(A: CSC, k: int, tolerance: float = 0.05,
                   seed: int = 1, config: Config = DEFAULT) -> EdgeCut:
    """Recursive-bisection k-way partition (METIS_PartGraphRecursive analog).
    ``k`` need not be a power of two: each recursion splits proportionally."""
    n = A.ncol
    part = np.zeros(n, dtype=np.int64)
    S = A.aat_pattern()

    def sub(Sg: CSC, nodes: np.ndarray, k0: int, kn: int, seed: int):
        nk = kn - k0
        if nk <= 1 or nodes.size == 0:
            part[nodes] = k0
            return
        ka = nk // 2
        target = ka / nk
        if native.has("sstpu_edgecut"):
            p, _ = native.edgecut(Sg.indptr, Sg.indices, Sg.ncol,
                                  target_split=target, tolerance=tolerance,
                                  seed=seed)
        else:
            p, _ = _edgecut_python(Sg, target, seed)
        a_nodes = nodes[p == 0]
        b_nodes = nodes[p == 1]
        sub(_subgraph(S, a_nodes), a_nodes, k0, k0 + ka, seed + 1)
        sub(_subgraph(S, b_nodes), b_nodes, k0 + ka, kn, seed + 2)

    sub(S, np.arange(n, dtype=np.int64), 0, k, seed)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    cut = int(np.count_nonzero(part[S.indices] != part[cols]) // 2)
    sizes = np.bincount(part, minlength=k)
    imb = float(sizes.max() / max(n / k, 1) - 1.0)
    return EdgeCut(part, cut, imb)
