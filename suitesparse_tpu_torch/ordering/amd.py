"""Approximate minimum degree ordering (reference ``AMD/Source/amd_2.c:43``;
the quotient-graph AMD of ``native/src/amd.cc``). ``_amd_python`` is the
reference's pure-Python minimum degree, kept for the fallbacks of the
constrained orderings (``camd_order``, ``nesdis_order``) where the library
lacks their entry points; ``amd_order`` itself is native only."""

from __future__ import annotations

import heapq

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


def _amd_python(S: CSC, dense: float = 10.0) -> np.ndarray:
    """Quotient-graph minimum external degree with absorption.

    State per the quotient-graph formulation: an uneliminated variable i has
    variable-neighbors ``adj[i]`` and element-neighbors ``elem[i]``; an element
    e covers variable set ``ev[e]``. Eliminating v creates element v with
    ev[v] = adj[v] ∪ (∪_{e∈elem[v]} ev[e]) − {v}, absorbing its elements.
    Approximate degree = |adj| + |∪ ev| upper-bounded by sums (AMD's trick);
    here with Python sets the exact union is affordable, giving exact external
    degrees (≥ AMD quality). Dense rows (deg > dense·sqrt(n)) are postponed to
    the end (reference amd_2.c dense-row handling).
    """
    n = S.ncol
    adj = [set(S.rows_of(j).tolist()) - {j} for j in range(n)]
    elem: list[set] = [set() for _ in range(n)]
    ev: dict[int, set] = {}
    alive = np.ones(n, dtype=bool)
    weight = np.ones(n, dtype=np.int64)  # supervariable sizes
    merged_into = np.full(n, -1, dtype=np.int64)
    members: list[list[int]] = [[i] for i in range(n)]

    dense_cut = max(16.0, dense * np.sqrt(n)) if dense > 0 else np.inf
    postponed = []
    heap: list[tuple[int, int]] = []
    degree = np.zeros(n, dtype=np.int64)
    for i in range(n):
        degree[i] = len(adj[i])
        if degree[i] >= dense_cut:
            postponed.append(i)
            alive[i] = False
        else:
            heapq.heappush(heap, (degree[i], i))

    order: list[int] = []

    def current_neighbors(v: int) -> set:
        s = set(adj[v])
        for e in elem[v]:
            s |= ev[e]
        s.discard(v)
        return {u for u in s if alive[u]}

    while heap:
        d, v = heapq.heappop(heap)
        if not alive[v]:
            continue
        if d != degree[v]:
            continue  # stale heap entry
        # eliminate supervariable v
        alive[v] = False
        order.extend(members[v])
        nbrs = current_neighbors(v)
        # absorb v's elements into new element v
        for e in elem[v]:
            ev.pop(e, None)
        ev[v] = nbrs
        # update neighbors
        for u in nbrs:
            adj[u].discard(v)
            adj[u] -= nbrs  # edges now covered by element v
            # drop absorbed elements
            elem[u] = {e for e in elem[u] if e in ev}
            elem[u].add(v)
        # indistinguishable-variable detection within the new element's pivot
        # row (mass elimination): group by (adj, elem) signature
        sig: dict[tuple, int] = {}
        for u in sorted(nbrs):
            if not alive[u]:
                continue
            key = (frozenset(adj[u]), frozenset(elem[u]))
            if key in sig:
                w = sig[key]
                # merge u into w
                alive[u] = False
                merged_into[u] = w
                weight[w] += weight[u]
                members[w].extend(members[u])
                for e in elem[u]:
                    ev[e].discard(u)
                for t in adj[u]:
                    adj[t].discard(u)
            else:
                sig[key] = u
        # recompute degrees of the surviving neighbors
        for u in nbrs:
            if not alive[u]:
                continue
            s = set(adj[u])
            for e in elem[u]:
                s |= ev[e]
            s.discard(u)
            degree[u] = sum(weight[t] for t in s if alive[t])
            heapq.heappush(heap, (int(degree[u]), u))

    # postponed dense variables last, by original degree
    for i in sorted(postponed, key=lambda i: int(np.count_nonzero(alive) + degree[i])):
        order.append(i)

    assert len(order) == n, f"AMD produced {len(order)} of {n}"
    return np.array(order, dtype=np.int64)
