"""Exact rational sparse LU (roundoff-free solve), the port's copy of the
JAX package's ``numeric/exact.py``.

Reference analog: SLIP_LU (``SLIP_LU/Include/SLIP_LU.h:552-606`` —
``SLIP_backslash``: left-looking sparse LU over GMP rationals, producing
EXACT solutions of integer/rational systems). This implementation uses
Python's arbitrary-precision ``fractions.Fraction`` instead of GMP: the same
roundoff-free contract, host-only by nature (exact arithmetic has no
device mapping), with the KLU-style structural pipeline (BTF + per-block AMD) reused
for fill control.

Entry values are converted exactly: integers stay integers; floats convert via
``Fraction(float)`` which is exact for IEEE doubles.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..config import Config, DEFAULT
from ..sparse import CSC

__all__ = ["exact_lusol"]


def exact_lusol(A: CSC, b, config: Config = DEFAULT) -> list:
    """Exact solve of A x = b over the rationals (SLIP_backslash analog).

    Returns a list of ``Fraction``. Raises ``ZeroDivisionError``-derived
    ``AssertionError`` if A is exactly singular."""
    n = A.ncol
    assert A.nrow == n, "exact solve requires square A"
    Ag = A.to_full_storage() if A.sym != 0 else A
    # fill-reducing structural pipeline (values ignored)
    from .lu import analyze_lu
    S = analyze_lu(Ag, config.replace(lu_scale=0))
    rowperm, colperm = S.rowperm, S.colperm
    # dense-column representation in exact arithmetic
    cols: list[dict] = [dict() for _ in range(n)]
    pinv = np.empty(n, dtype=np.int64)
    pinv[rowperm] = np.arange(n)
    ccols = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ag.indptr))
    # build permuted columns with exact values
    cinv = np.empty(n, dtype=np.int64)
    cinv[colperm] = np.arange(n)
    for r, c, v in zip(Ag.indices, ccols, Ag.data):
        cols[int(cinv[c])][int(pinv[r])] = Fraction(float(v))

    bperm = [Fraction(float(np.asarray(b, dtype=np.float64)[rowperm[i]]))
             for i in range(n)]

    # left-looking exact LU with partial pivoting (dict-of-dict columns)
    Lcols: list[dict] = [dict() for _ in range(n)]
    Ucols: list[dict] = [dict() for _ in range(n)]
    prow = np.full(n, -1, dtype=np.int64)  # pivot row of step k
    rowused = np.zeros(n, dtype=bool)
    for k in range(n):
        x = dict(cols[k])
        # apply previous columns in order
        for j in range(k):
            pj = int(prow[j])
            if pj in x:
                xj = x.pop(pj)
                Ucols[k][j] = xj
                if xj:
                    for r, lv in Lcols[j].items():
                        x[r] = x.get(r, Fraction(0)) - lv * xj
        # pivot: largest magnitude among unused rows (exact compare)
        cand = [(abs(v), r) for r, v in x.items()
                if not rowused[r] and v != 0]
        assert cand, f"matrix is exactly singular at column {k}"
        _, pr = max(cand)
        pv = x[pr]
        prow[k] = pr
        rowused[pr] = True
        Ucols[k][k] = pv
        for r, v in x.items():
            if r != pr and not rowused[r] and v != 0:
                Lcols[k][r] = v / pv
    # forward: y = L^{-1} P b
    y = list(bperm)
    z = [Fraction(0)] * n
    for k in range(n):
        pr = int(prow[k])
        zk = y[pr]
        z[k] = zk
        if zk:
            for r, lv in Lcols[k].items():
                y[r] -= lv * zk
    # backward: U x = z, column-oriented (Ucols[k] = column k of U: U[j, k])
    xsol = [Fraction(0)] * n
    for k in range(n - 1, -1, -1):
        xk = z[k] / Ucols[k][k]
        xsol[k] = xk
        if xk:
            for j, uv in Ucols[k].items():
                if j != k:
                    z[j] -= uv * xk
    x_final = [Fraction(0)] * n
    for i in range(n):
        x_final[int(colperm[i])] = xsol[i]
    return x_final
