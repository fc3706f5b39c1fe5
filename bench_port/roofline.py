"""The card's peaks and the work of a factor, for the roofline shares.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity): 67 TFLOP/s in float32 outside the tensor cores (TF32 off, as
the configurations state), 67 TFLOP/s in float64 on the FP64 tensor cores,
3.35 TB/s of HBM3.

The work of a Cholesky factor is what the matrix and the ordering need,
not what the program's route does: CHOLMOD's flop count ``fl = sum_j
cc_j^2`` over the column counts of ``L`` (diagonal included), and the
bytes of A's values read once plus L's written once, at the
configuration's item size. The column counts come from the benchmark's
own copy of the etree and column-count code (``native/counts.cc``, built
by ``g++`` into ``.cache/`` at first use).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "counts.cc")
CACHE_DIR = os.path.join(_HERE, ".cache")
_LIB = os.path.join(CACHE_DIR, "libbench_counts.so")
_STAMP = os.path.join(CACHE_DIR, "libbench_counts.stamp")
_lib = None


def _digest() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _stamp_ok(digest: str) -> bool:
    try:
        with open(_STAMP) as f:
            return f.read() == digest and os.path.exists(_LIB)
    except FileNotFoundError:
        return False


def _load():
    """The counts library, built at first use (under a lock, written under
    per-process names and renamed into place)."""
    global _lib
    if _lib is not None:
        return _lib
    os.makedirs(CACHE_DIR, exist_ok=True)
    digest = _digest()
    if not _stamp_ok(digest):
        with open(os.path.join(CACHE_DIR, "counts.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stamp_ok(digest):
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                subprocess.run(["g++", "-O2", "-std=c++17", "-shared",
                                "-fPIC", "-o", tmp, _SRC], check=True)
                os.replace(tmp, _LIB)
                with open(f"{_STAMP}.{os.getpid()}.tmp", "w") as f:
                    f.write(digest)
                os.replace(f"{_STAMP}.{os.getpid()}.tmp", _STAMP)
    lib = ctypes.CDLL(_LIB)
    p = ctypes.c_void_p
    i = ctypes.c_int64
    lib.bench_etree.argtypes = [i, p, p, p]
    lib.bench_postorder.argtypes = [i, p, p]
    lib.bench_col_counts.argtypes = [i, p, p, p, p, p]
    for fn in (lib.bench_etree, lib.bench_postorder, lib.bench_col_counts):
        fn.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def permuted_triangles(indptr: np.ndarray, indices: np.ndarray,
                       perm: np.ndarray) -> tuple:
    """The upper and the lower triangle (CSC, int64, sorted rows) of the
    pattern of P A P' for an upper-stored pattern A, where column k of
    P A P' is column ``perm[k]`` of A."""
    n = len(indptr) - 1
    pinv = np.empty(n, dtype=np.int64)
    pinv[np.asarray(perm, dtype=np.int64)] = np.arange(n, dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    i, j = pinv[indices], pinv[cols]
    lo, hi = np.minimum(i, j), np.maximum(i, j)

    def csc(rows, cols_):
        order = np.lexsort((rows, cols_))
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(cols_, minlength=n), out=ptr[1:])
        return ptr, np.ascontiguousarray(rows[order])

    return csc(lo, hi), csc(hi, lo)


def column_counts(indptr: np.ndarray, indices: np.ndarray,
                  perm: np.ndarray) -> np.ndarray:
    """nnz of each column of the Cholesky factor of P A P' (diagonal
    included) for the upper-stored pattern A."""
    lib = _load()
    (up, ui), (lp, li) = permuted_triangles(indptr, indices, perm)
    n = len(up) - 1
    parent = np.empty(n, dtype=np.int64)
    post = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    lib.bench_etree(n, _ptr(up), _ptr(ui), _ptr(parent))
    lib.bench_postorder(n, _ptr(parent), _ptr(post))
    lib.bench_col_counts(n, _ptr(lp), _ptr(li), _ptr(parent), _ptr(post),
                         _ptr(counts))
    return counts


def factor_work(indptr: np.ndarray, indices: np.ndarray, perm: np.ndarray,
                dtype: str) -> dict:
    """The flops and bytes a factor of P A P' needs, and the least time
    the card takes for them (``bound_s``, with which of the two bounds
    it)."""
    cc = column_counts(indptr, indices, perm).astype(np.float64)
    fl = float(np.sum(cc * cc))
    lnz = float(np.sum(cc))
    byt = (float(indptr[-1]) + lnz) * ITEMSIZE[dtype]
    t_fl, t_by = fl / PEAK_FLOP_S[dtype], byt / PEAK_BYTES_S
    return {"fl": fl, "lnz": lnz, "bytes": byt, "bound_s": max(t_fl, t_by),
            "bound_by": "flops" if t_fl >= t_by else "bytes"}
