"""Plain PyTorch reference for a symmetric positive definite solve.

It takes the raw arrays the benchmark made (an upper-stored CSC pattern,
its values, the right-hand sides) and works x out again by conjugate
gradients in float64 with a Jacobi preconditioner: another algorithm than
the direct factor under test, sharing none of its code, permutation or
factor. It then judges the program's x by two numbers, each worked out in
float64 from the reference's own matrix:

- ``x_err``: max |x - x_ref| / max |x_ref| (the forward error);
- ``berr``: max |b - A x| / (||A||_inf max |x| + max |b|) (the normwise
  backward error, which needs no x_ref).

Imports numpy and torch only.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

CG_TOL = 1e-13          # relative residual the reference solve reaches
CG_MAX_ITER = 20000
_CHECK_EVERY = 25


class Matrix:
    """The full symmetric matrix of an upper-stored CSC, as a float64
    CSR tensor on ``device``, with its diagonal and infinity norm."""

    def __init__(self, indptr, indices, data, device):
        n = len(indptr) - 1
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        rows = np.asarray(indices, dtype=np.int64)
        vals = np.asarray(data, dtype=np.float64)
        off = rows != cols
        r = np.concatenate([rows, cols[off]])
        c = np.concatenate([cols, rows[off]])
        v = np.concatenate([vals, vals[off]])
        order = np.lexsort((c, r))
        crow = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(r, minlength=n), out=crow[1:])
        self.n = n
        self.device = torch.device(device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # CSR is "beta"
            self.A = torch.sparse_csr_tensor(
                torch.from_numpy(crow), torch.from_numpy(c[order]),
                torch.from_numpy(v[order]), size=(n, n), dtype=torch.float64,
                check_invariants=False).to(self.device)
        diag = np.zeros(n)
        diag[rows[~off]] = vals[~off]
        self.diag = torch.from_numpy(diag).to(self.device)
        self.norm_inf = float(np.max(np.bincount(r, weights=np.abs(v),
                                                 minlength=n)))

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        return self.A @ X


def cg(M: Matrix, B: torch.Tensor) -> tuple[torch.Tensor, int, float]:
    """X with M X = B (columns solved together, float64), the iterations
    taken and the largest relative residual reached."""
    X = torch.zeros_like(B)
    R = B.clone()
    dinv = (1.0 / M.diag).unsqueeze(1)
    Z = dinv * R
    P = Z.clone()
    rz = (R * Z).sum(0)
    bnorm = torch.linalg.vector_norm(B, dim=0).clamp_min(1e-300)
    rel = float("inf")
    it = 0
    while it < CG_MAX_ITER:
        AP = M.matvec(P)
        alpha = rz / (P * AP).sum(0)
        X += alpha * P
        R -= alpha * AP
        Z = dinv * R
        rz_new = (R * Z).sum(0)
        P = Z + (rz_new / rz) * P
        rz = rz_new
        it += 1
        if it % _CHECK_EVERY == 0:
            rel = float((torch.linalg.vector_norm(R, dim=0) / bnorm).max())
            if rel <= CG_TOL:
                break
    # the true residual of the answer, not the recurrence's
    rel = float((torch.linalg.vector_norm(B - M.matvec(X), dim=0)
                 / bnorm).max())
    return X, it, rel


def judge(indptr, indices, data, b: np.ndarray, x: np.ndarray,
          device) -> dict:
    """The reference's x for A x = b and the two numbers that judge the
    program's ``x``: ``x_err``, ``berr``; with ``cg_iters`` and
    ``cg_rel`` (the reference's own residual)."""
    M = Matrix(indptr, indices, data, device)
    B = torch.from_numpy(np.asarray(b, dtype=np.float64).reshape(M.n, -1))
    B = B.to(M.device)
    X = torch.from_numpy(np.asarray(x, dtype=np.float64).reshape(M.n, -1))
    X = X.to(M.device)
    Xref, iters, rel = cg(M, B)
    x_err = float((X - Xref).abs().max() / Xref.abs().max())
    res = (B - M.matvec(X)).abs().max()
    berr = float(res / (M.norm_inf * X.abs().max() + B.abs().max()))
    if not (np.isfinite(x_err) and np.isfinite(berr)):
        x_err = berr = float("inf")
    return {"x_err": x_err, "berr": berr, "cg_iters": iters, "cg_rel": rel}
