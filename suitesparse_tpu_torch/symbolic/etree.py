"""Elimination-tree machinery: etree, postorder, column counts, ereach.

Reference analogs: ``cholmod_etree.c:81`` / ``cs_etree.c`` (Liu's algorithm),
``cholmod_postorder.c`` / ``cs_post.c``, ``cholmod_rowcolcounts.c:184`` /
``cs_counts.c`` (Gilbert–Ng–Peyton), ``cs_ereach.c``. The first three run in
the host C++ library; ``ereach`` is the simplicial factor's per-row step.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..sparse import CSC

__all__ = ["etree", "postorder", "col_counts", "ereach",
           "first_descendants", "tree_levels", "tree_depth"]


def etree(A: CSC, ata: bool = False) -> np.ndarray:
    """Elimination tree of symmetric A from its upper triangle, or with
    ``ata=True`` the column elimination tree of A'A (A'A never formed);
    parent[root] = -1."""
    return native.etree(A.ncol, A.indptr, A.indices,
                        nrow=A.nrow if ata else None)


def postorder(parent: np.ndarray) -> np.ndarray:
    """post[k] = node visited k-th; children in ascending node order."""
    return native.postorder(parent)


def col_counts(A: CSC, parent: np.ndarray, post: np.ndarray,
               ata: bool = False) -> np.ndarray:
    """nnz per column of the Cholesky factor of A, or with ``ata=True`` of
    A'A (diagonal included)."""
    if ata:
        return native.col_counts(A.ncol, A.indptr, A.indices, parent, post,
                                 nrow=A.nrow)
    Alow = A.transpose(values=False) if A.sym == 1 else A
    return native.col_counts(A.ncol, Alow.indptr, Alow.indices, parent,
                             post)


def ereach(A: CSC, k: int, parent: np.ndarray, mark: np.ndarray,
           out: np.ndarray) -> int:
    """Pattern of row k of L (nonzeros of L[k, :k]) in topological order.

    ``mark`` is an int workspace (size n, holding the current column number
    when visited); ``out`` a size-n int64 output buffer. Returns ``top`` such
    that ``out[top:]`` holds the pattern (cs_ereach.c analog)."""
    n = A.ncol
    top = n
    mark[k] = k
    for t in range(A.indptr[k], A.indptr[k + 1]):
        i = A.indices[t]
        if i > k:
            continue
        path_len = 0
        while mark[i] != k:
            out[path_len] = i
            path_len += 1
            mark[i] = k
            i = parent[i]
        for s in range(path_len - 1, -1, -1):
            top -= 1
            out[top] = out[s]
    return top


def first_descendants(parent: np.ndarray, post: np.ndarray) -> np.ndarray:
    """first[j] = smallest postorder index among descendants of j."""
    n = parent.size
    first = np.full(n, -1, dtype=np.int64)
    for k in range(n):
        j = post[k]
        while j != -1 and first[j] == -1:
            first[j] = k
            j = parent[j]
    return first


def tree_levels(parent: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]]:
    """Level schedule: level[j] = 1 + max level of children (leaves = 0).

    Returns (level, levels) where levels[d] is the sorted array of nodes at
    depth d — every node in levels[d] depends only on nodes in levels[<d], so
    each level can execute as one batched device step (the device factors'
    analog of the reference's sequential supernode loop / OpenMP
    sections)."""
    n = parent.size
    level = np.zeros(n, dtype=np.int64)
    # children finish before parents in any topological order of the tree; node
    # ids are NOT topological in general, so process in postorder
    post = postorder(parent)
    for k in range(n):
        j = post[k]
        p = parent[j]
        if p != -1:
            level[p] = max(level[p], level[j] + 1)
    nlev = int(level.max()) + 1 if n else 0
    levels = [np.sort(np.nonzero(level == d)[0]) for d in range(nlev)]
    return level, levels


def tree_depth(parent: np.ndarray) -> int:
    level, _ = tree_levels(parent)
    return int(level.max()) + 1 if parent.size else 0
