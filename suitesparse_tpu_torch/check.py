"""Deep structural validation and debug printing: a copy of the JAX
package's ``check.py``.

Reference analog: ``CHOLMOD/Check/cholmod_check.c`` (invariant checks +
``cholmod_print_*``), ``AMD/Source/amd_valid.c``. Every check raises
``AssertionError`` with a specific message. :func:`check_factor` takes every
Cholesky factor the port makes: the simplicial ``Factor``, a
``SupernodalFactorAdapter`` over a host, device or loaded factor, and a bare
supernodal factor (host, device or px device), all read through its CSC
``L`` (``to_csc`` of the px panels, ``lx_host()``).
"""

from __future__ import annotations

import numpy as np

from .sparse import CSC

__all__ = ["check_sparse", "check_perm", "check_factor", "check_symbolic",
           "sprint"]


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_sparse(A: CSC) -> None:
    A.check()


def check_perm(p: np.ndarray, n: int) -> None:
    p = np.asarray(p)
    _require(p.shape == (n,), f"perm shape {p.shape} != ({n},)")
    _require(np.array_equal(np.sort(p), np.arange(n)), "not a permutation")


def check_factor(F) -> None:
    """Validate a simplicial or supernodal Cholesky factor: a permutation,
    every column non-empty with its diagonal first and only rows below it,
    and a positive diagonal for a successful LL' factor."""
    if hasattr(F, "L"):
        L = F.L
    else:
        from .numeric.supernodal import to_csc
        L = to_csc(F)
    n = L.ncol
    check_perm(F.perm, n)
    _require(L.nrow == n, f"L is {L.nrow}-by-{n}")
    lens = np.diff(L.indptr)
    empty = np.flatnonzero(lens == 0)
    _require(empty.size == 0, f"column {empty[0] if empty.size else -1} empty")
    first = L.indptr[:-1]
    off = np.flatnonzero(L.indices[first] != np.arange(n))
    _require(off.size == 0,
             f"column {off[0] if off.size else -1}: diagonal not first")
    cols = np.repeat(np.arange(n, dtype=np.int64), lens)
    below = L.indices > cols
    below[first] = True
    up = np.flatnonzero(~below)
    _require(up.size == 0,
             f"column {cols[up[0]] if up.size else -1}: upper entries")
    if getattr(F, "d", None) is None and F.ok:
        _require(np.all(L.data[first] > 0),
                 "LL' factor with non-positive diagonal")


def check_symbolic(S) -> None:
    n = S.n
    check_perm(S.perm, n)
    parent = S.parent
    _require(parent.shape == (n,), f"parent shape {parent.shape}")
    _require(np.all((parent == -1) | (parent > np.arange(n))),
             "etree parent must exceed child")
    cc = S.colcount
    _require(np.all(cc >= 1) and np.all(cc <= n - np.arange(n)),
             "column counts out of range")


def sprint(A: CSC, name: str = "A", max_entries: int = 20) -> str:
    """Compact printable summary (cholmod_print_sparse analog, print level
    3)."""
    lines = [f"{name}: {A.nrow}-by-{A.ncol}, nnz {A.nnz}, "
             f"sym {A.sym}, dtype {A.data.dtype}"]
    cols = np.repeat(np.arange(A.ncol, dtype=np.int64), np.diff(A.indptr))
    for t in range(min(A.nnz, max_entries)):
        lines.append(f"  ({A.indices[t]}, {cols[t]}) {A.data[t]:.6g}")
    if A.nnz > max_entries:
        lines.append(f"  ... {A.nnz - max_entries} more")
    return "\n".join(lines)
