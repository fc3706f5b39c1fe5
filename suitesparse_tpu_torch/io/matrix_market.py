"""Matrix Market I/O of the port: a copy of the JAX package's
``io/matrix_market.py`` (the ``cholmod_read.c`` / ``cholmod_write.c``
analog, built from the MM format spec).

Coordinate and array files; real, integer, complex and pattern fields;
general, symmetric, skew-symmetric and Hermitian storage; ``.gz`` paths
through gzip. A symmetric file comes back upper-stored (``sym=1``), the
convention :func:`suitesparse_tpu_torch.analyze` expects.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..sparse import CSC, from_triplets

__all__ = ["read_matrix_market", "write_matrix_market"]


def _open(path_or_file, mode="rt"):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    p = str(path_or_file)
    if p.endswith(".gz"):
        return gzip.open(p, mode), True
    return open(p, mode), True


def read_matrix_market(path_or_file) -> CSC:
    """Read an MM coordinate or array file into CSC.

    Symmetric/skew/hermitian files are returned with ``sym`` set and only the
    stored (lower, per MM convention → we flip to upper) triangle kept.
    """
    f, should_close = _open(path_or_file, "rt")
    try:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        parts = header.strip().split()
        _, obj, fmt, field, symmetry = [p.lower() for p in parts[:5]]
        if obj != "matrix":
            raise ValueError(f"unsupported object {obj}")
        line = f.readline()
        while line.startswith("%") or line.strip() == "":
            line = f.readline()
        dims = line.split()
        if fmt == "coordinate":
            nrow, ncol, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            body = f.read()
            arr = np.fromiter((float(tok) for tok in body.split()),
                              dtype=np.float64)
            if field == "pattern":
                arr = arr.reshape(nnz, 2)
                r = arr[:, 0].astype(np.int64) - 1
                c = arr[:, 1].astype(np.int64) - 1
                x = np.ones(nnz)
            elif field == "complex":
                arr = arr.reshape(nnz, 4)
                r = arr[:, 0].astype(np.int64) - 1
                c = arr[:, 1].astype(np.int64) - 1
                x = arr[:, 2] + 1j * arr[:, 3]
            else:
                arr = arr.reshape(nnz, 3)
                r = arr[:, 0].astype(np.int64) - 1
                c = arr[:, 1].astype(np.int64) - 1
                x = arr[:, 2]
        elif fmt == "array":
            nrow, ncol = int(dims[0]), int(dims[1])
            body = f.read()
            vals = np.fromiter((float(tok) for tok in body.split()),
                               dtype=np.float64)
            if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
                r_list, c_list = [], []
                for j in range(ncol):
                    start = j + (1 if symmetry == "skew-symmetric" else 0)
                    rr = np.arange(start, nrow, dtype=np.int64)
                    r_list.append(rr)
                    c_list.append(np.full(rr.size, j, dtype=np.int64))
                r = np.concatenate(r_list)
                c = np.concatenate(c_list)
                x = vals
            else:
                r = np.tile(np.arange(nrow, dtype=np.int64), ncol)
                c = np.repeat(np.arange(ncol, dtype=np.int64), nrow)
                x = vals
        else:
            raise ValueError(f"unsupported format {fmt}")

        if symmetry == "general":
            return from_triplets(nrow, ncol, r, c, x, sym=0)
        if symmetry == "symmetric":
            # MM stores lower; our convention is upper-stored (sym=1): swap
            return from_triplets(nrow, ncol, np.minimum(r, c), np.maximum(r, c),
                                 x, sym=1)
        if symmetry == "skew-symmetric":
            # expand explicitly (rarely used here)
            r2 = np.concatenate([r, c])
            c2 = np.concatenate([c, r])
            x2 = np.concatenate([x, -x])
            return from_triplets(nrow, ncol, r2, c2, x2, sym=0)
        if symmetry == "hermitian":
            off = r != c
            r2 = np.concatenate([r, c[off]])
            c2 = np.concatenate([c, r[off]])
            x2 = np.concatenate([x, np.conj(x[off])])
            return from_triplets(nrow, ncol, r2, c2, x2, sym=0)
        raise ValueError(f"unsupported symmetry {symmetry}")
    finally:
        if should_close:
            f.close()


def write_matrix_market(path_or_file, A: CSC, comment: str = "") -> None:
    f, should_close = _open(path_or_file, "wt")
    try:
        symmetry = "symmetric" if A.sym != 0 else "general"
        f.write(f"%%MatrixMarket matrix coordinate real {symmetry}\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        M = A
        if A.sym == 1:
            # MM symmetric stores the lower triangle: transpose our upper storage
            M = CSC(A.ncol, A.nrow, A.indptr, A.indices, A.data, 0)
            # entries (i,j) i<=j become (j,i) lower entries via swap below
            cols = np.repeat(np.arange(A.ncol, dtype=np.int64), np.diff(A.indptr))
            f.write(f"{A.nrow} {A.ncol} {A.nnz}\n")
            for i, j, v in zip(cols + 1, A.indices + 1, A.data):
                f.write(f"{i} {j} {v:.17g}\n")
            return
        cols = np.repeat(np.arange(M.ncol, dtype=np.int64), np.diff(M.indptr))
        f.write(f"{M.nrow} {M.ncol} {M.nnz}\n")
        for i, j, v in zip(M.indices + 1, cols + 1, M.data):
            f.write(f"{i} {j} {v:.17g}\n")
    finally:
        if should_close:
            f.close()
