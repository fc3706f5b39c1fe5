"""Sparse right-hand-side triangular solves and subset solves (the port's
copy of the JAX package's ``numeric/spsolve.py``).

Reference analogs: ``CSparse/Source/cs_spsolve.c`` (sparse-RHS triangular
solve over the reach, via ``cs_reach.c``/``cs_dfs.c``) and CHOLMOD's
``cholmod_solve2`` with a ``Bset`` (solve for a sparse subset of the solution,
reference ``Cholesky/cholmod_solve.c:1018-1028``) — the workhorse for
computing selected entries/columns of A^{-1}.
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSC
from .simplicial import Factor

__all__ = ["reach", "spsolve_lower", "solve_subset"]


def reach(L: CSC, bpattern: np.ndarray) -> np.ndarray:
    """Nonzero pattern of L^{-1} b for sparse b, in topological order.

    DFS over the graph of L (edge j -> rows of column j), starting from b's
    pattern (cs_reach analog; iterative)."""
    n = L.ncol
    marked = np.zeros(n, dtype=bool)
    topo: list[int] = []
    Lp, Li = L.indptr, L.indices
    for r0 in bpattern:
        r0 = int(r0)
        if marked[r0]:
            continue
        stack = [(r0, int(Lp[r0]))]
        marked[r0] = True
        while stack:
            j, p = stack[-1]
            descended = False
            hi = int(Lp[j + 1])
            while p < hi:
                r = int(Li[p])
                p += 1
                if r != j and not marked[r]:
                    stack[-1] = (j, p)
                    stack.append((r, int(Lp[r])))
                    marked[r] = True
                    descended = True
                    break
            if not descended:
                stack.pop()
                topo.append(j)
        # topo gets reverse-topological (children of the DAG first is wrong
        # direction for the solve); reversed at the end
    return np.array(topo[::-1], dtype=np.int64)


def spsolve_lower(L: CSC, bi: np.ndarray, bx: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """x = L \\ b for sparse b given as (indices bi, values bx); L lower
    triangular CSC with diagonal first per column. Returns (xi, xx) with xi in
    topological order (cs_spsolve analog). Work is O(flops(pattern)), not O(n).
    """
    n = L.ncol
    order = reach(L, bi)
    x = {}
    for i, v in zip(bi, bx):
        x[int(i)] = x.get(int(i), 0.0) + v
    Lp, Li, Lx = L.indptr, L.indices, L.data
    xx = np.zeros(order.size, dtype=np.result_type(L.data, bx))
    for t, j in enumerate(order):
        xj = x.get(int(j), 0.0) / Lx[Lp[j]]
        xx[t] = xj
        if xj != 0.0:
            for p in range(Lp[j] + 1, Lp[j + 1]):
                r = int(Li[p])
                x[r] = x.get(r, 0.0) - Lx[p] * xj
    return order, xx


def solve_subset(F: Factor, bi: np.ndarray, bx: np.ndarray,
                 want: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """x = A^{-1} b for SPARSE b through a Cholesky factor; optionally restrict
    the returned entries to ``want`` (cholmod_solve2 Bset analog).

    The forward pass costs only the reach of b's pattern; the backward pass is
    dense in the reach's ancestor closure (like the reference, which solves the
    full upper system and extracts the subset)."""
    assert F.ok
    pinv = np.empty(F.perm.size, dtype=np.int64)
    pinv[F.perm] = np.arange(F.perm.size)
    bi_p = pinv[np.asarray(bi, dtype=np.int64)]
    xi, xx = spsolve_lower(F.L, bi_p, np.asarray(bx, dtype=np.float64))
    if F.d is not None:
        xx = xx / F.d[xi]
    # backward (L') solve: dense over the full range (entries outside the
    # closure are zero and stay zero)
    n = F.L.ncol
    y = np.zeros(n)
    y[xi] = xx
    from .simplicial import ltsolve
    z = ltsolve(F.L, y)
    x = np.empty(n)
    x[F.perm] = z
    if want is None:
        nz = np.flatnonzero(x)
        return nz, x[nz]
    want = np.asarray(want, dtype=np.int64)
    return want, x[want]
