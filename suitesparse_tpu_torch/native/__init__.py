"""Host C++ kernels of the port: orderings, symbolic analysis, host sweeps.

``src/*.cc`` (nested dissection with its constraint sets, edge-cut
partitioning, AMD, constrained AMD, COLAMD and CCOLAMD, etree/postorder/column counts
(of A or of A'A), the supernodal symbolic analysis, A+A', symmetric
permutation, transpose, the four host triangular sweeps, and the LU path's
weighted matching, maximum transversal, strong components, Gilbert-Peierls
factor and refactor, permutation maps and off-diagonal update) is compiled by
``g++`` at first use into ``lib/libsst_host.so`` and bound with ctypes. A
content hash of the sources in ``lib/build.stamp`` rebuilds the library when
a source changes. The library is built with ``-march=native``: delete
``lib/`` when the checkout comes from another host. Without ``g++`` the
first call raises; the orderings that keep the reference's Python fallback
(``camd_order``, ``nesdis_order``, ``ccolamd_order``, ``edge_cut``) take it
only where :func:`has` finds no entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
LIB_DIR = os.path.join(_HERE, "lib")
LIB_PATH = os.path.join(LIB_DIR, "libsst_host.so")
STAMP_PATH = os.path.join(LIB_DIR, "build.stamp")

_lock = threading.Lock()
_dll = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_c = ctypes.c_int64
_d = ctypes.c_double
_vp = ctypes.c_void_p

# entry point -> (restype, argtypes)
_SIGNATURES = {
    "sstpu_amd": (_c, [_c, _i64p, _i64p, _i64p, _d, _c]),
    "sstpu_nested_dissection": (_c, [_c, _i64p, _i64p, _i64p, _c, _c]),
    "sstpu_nested_dissection_sets": (_c, [_c, _i64p, _i64p, _i64p, _c, _c,
                                          _i64p]),
    "sstpu_camd": (_c, [_c, _i64p, _i64p, _i64p, _i64p, _c]),
    "sstpu_edgecut": (_c, [_c, _i64p, _i64p, _i64p, _d, _d, _c, _i64p]),
    "sstpu_etree": (None, [_c, _i64p, _i64p, _i64p, _c]),
    "sstpu_postorder": (None, [_c, _i64p, _i64p]),
    "sstpu_col_counts": (None, [_c, _c, _i64p, _i64p, _i64p, _i64p, _i64p,
                                _c]),
    "sstpu_aat": (_c, [_c, _i64p, _i64p, _i64p, _i64p]),
    "sstpu_symperm": (None, [_c, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p]),
    "sstpu_transpose": (None, [_c, _c, _i64p, _i64p, _i64p, _i64p, _i64p]),
    "sstpu_super_analyze": (_vp, [_c, _i64p, _i64p, _i64p, _i64p, _c, _c, _c,
                                  _d, _d, _d]),
    "sstpu_super_result": (_c, [_vp, _c, _i64p]),
    "sstpu_super_fl": (_d, [_vp]),
    "sstpu_super_maxcsize": (_c, [_vp]),
    "sstpu_super_free": (None, [_vp]),
    "sstpu_lsolve": (_c, [_c, _i64p, _i64p, _f64p, _f64p]),
    "sstpu_ltsolve": (_c, [_c, _i64p, _i64p, _f64p, _f64p]),
    "sstpu_usolve": (_c, [_c, _i64p, _i64p, _f64p, _f64p]),
    "sstpu_utsolve": (_c, [_c, _i64p, _i64p, _f64p, _f64p]),
    "sstpu_colamd": (_c, [_c, _c, _i64p, _i64p, _d, _d, _c, _i64p, _i64p]),
    "sstpu_wmatch": (_c, [_c, _c, _i64p, _i64p, _f64p, _i64p]),
    "sstpu_maxtrans": (_c, [_c, _c, _i64p, _i64p, _i64p, _d]),
    "sstpu_strongcomp": (_c, [_c, _i64p, _i64p, _i64p, _i64p]),
    # n, Ap, Ai, Ax, tol, capacity, Lp, Li, Lx, Up, Ui, Ux, P
    "sstpu_lu_factor": (_c, [_c, _i64p, _i64p, _f64p, _d, _c, _i64p, _i64p,
                             _f64p, _i64p, _i64p, _f64p, _i64p]),
    # n, Ap, Ai, Ax, Lp, Li, Lx, Up, Ui, Ux, P
    "sstpu_lu_refactor": (_c, [_c, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p,
                               _i64p, _i64p, _f64p, _i64p]),
    "sstpu_lu_prep": (None, [_c] + [_i64p] * 5 + [_c] + [_i64p] * 13),
    "sstpu_offupdate": (_c, [_c, _c, _i64p, _i64p, _f64p, _f64p]),
}


def source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(SRC_DIR)):
        if name.endswith((".cc", ".h")):
            with open(os.path.join(SRC_DIR, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()


def build_command(out: str = LIB_PATH) -> list[str]:
    sources = sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                     if f.endswith(".cc"))
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
            "-funroll-loops", "-o", out, *sources]


def _build() -> None:
    """Compile unless the stamp matches the sources. The library and its
    stamp are written under temporary names and renamed into place, so
    processes that build at the same time never load a partial file."""
    want = source_hash()
    if os.path.exists(LIB_PATH) and os.path.exists(STAMP_PATH):
        with open(STAMP_PATH) as f:
            if f.read().strip() == want:
                return
    os.makedirs(LIB_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(build_command(tmp), capture_output=True,
                             text=True, timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host library of "
                           "suitesparse_tpu_torch cannot be built") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    with open(f"{STAMP_PATH}.{os.getpid()}.tmp", "w") as f:
        f.write(want)
    os.replace(f"{STAMP_PATH}.{os.getpid()}.tmp", STAMP_PATH)


def _load() -> ctypes.CDLL:
    """The bound host library (built on first use)."""
    global _dll
    with _lock:
        if _dll is None:
            _build()
            dll = ctypes.CDLL(LIB_PATH)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _dll = dll
        return _dll


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def has(name: str) -> bool:
    """Whether the library builds, loads and exposes entry point ``name``."""
    return available() and hasattr(_load(), name)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _p(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def amd(indptr, indices, n: int, dense: float = 10.0,
        aggressive: bool = True) -> np.ndarray:
    """AMD over the off-diagonal pattern of A+A' given in CSC (general)."""
    indptr, indices = _i64(indptr), _i64(indices)
    perm = np.empty(n, dtype=np.int64)
    rc = _load().sstpu_amd(n, _p(indptr), _p(indices), _p(perm),
                           ctypes.c_double(dense), 1 if aggressive else 0)
    if rc != 0:
        raise RuntimeError(f"native amd failed rc={rc}")
    return perm


def nested_dissection(indptr, indices, n: int, nd_small: int = 200,
                      seed: int = 1) -> np.ndarray:
    """Multilevel ND over the off-diagonal pattern of A+A' in CSC."""
    indptr, indices = _i64(indptr), _i64(indices)
    perm = np.empty(n, dtype=np.int64)
    rc = _load().sstpu_nested_dissection(n, _p(indptr), _p(indices),
                                         _p(perm), nd_small, seed)
    if rc == -3:
        raise ValueError("pattern exceeds int32 ND internals "
                         "(n or nnz >= 2^31)")
    if rc != 0:
        raise RuntimeError(f"native nested dissection failed rc={rc}")
    return perm


def camd(indptr, indices, n: int, cset, aggressive: bool = True
         ) -> np.ndarray:
    """Constrained AMD: like :func:`amd` but the output keeps constraint
    sets contiguous in ascending set order (CAMD analog)."""
    indptr, indices, cset = _i64(indptr), _i64(indices), _i64(cset)
    perm = np.empty(n, dtype=np.int64)
    rc = _load().sstpu_camd(n, _p(indptr), _p(indices), _p(perm), _p(cset),
                            1 if aggressive else 0)
    if rc != 0:
        raise RuntimeError(f"native camd failed rc={rc}")
    return perm


def nested_dissection_sets(indptr, indices, n: int, nd_small: int = 200,
                           seed: int = 1) -> tuple:
    """ND returning (perm, cmember): per-vertex constraint-set ids of the
    leaf-block/separator decomposition (NESDIS Cmember analog)."""
    indptr, indices = _i64(indptr), _i64(indices)
    perm = np.empty(n, dtype=np.int64)
    cmember = np.empty(n, dtype=np.int64)
    rc = _load().sstpu_nested_dissection_sets(
        n, _p(indptr), _p(indices), _p(perm), nd_small, seed, _p(cmember))
    if rc == -3:
        raise ValueError("pattern exceeds int32 ND internals "
                         "(n or nnz >= 2^31)")
    if rc != 0:
        raise RuntimeError(f"native nested dissection failed rc={rc}")
    return perm, cmember


def edgecut(indptr, indices, n: int, target_split: float = 0.5,
            tolerance: float = 0.05, seed: int = 1) -> tuple:
    """Multilevel two-way edge-cut partition (Mongoose EdgeCut analog).
    Returns (part in {0,1}^n, cut weight)."""
    indptr, indices = _i64(indptr), _i64(indices)
    part = np.empty(n, dtype=np.int64)
    out = np.zeros(2, dtype=np.int64)
    rc = _load().sstpu_edgecut(n, _p(indptr), _p(indices), _p(part),
                               ctypes.c_double(target_split),
                               ctypes.c_double(tolerance), seed, _p(out))
    if rc == -3:
        raise ValueError("pattern exceeds int32 ND internals "
                         "(n or nnz >= 2^31)")
    if rc != 0:
        raise RuntimeError(f"native edgecut failed rc={rc}")
    return part, int(out[0])


def colamd(nrow: int, ncol: int, indptr, indices, dense_row: float = 10.0,
           dense_col: float = 10.0, aggressive: bool = True,
           cmember=None) -> np.ndarray:
    """Row-list column approximate minimum degree (COLAMD; CCOLAMD when
    ``cmember`` is given) of the general CSC pattern. Returns q with q[k] =
    kth column."""
    indptr, indices = _i64(indptr), _i64(indices)
    perm = np.empty(ncol, dtype=np.int64)
    cm = None if cmember is None else _i64(cmember)
    rc = _load().sstpu_colamd(nrow, ncol, _p(indptr), _p(indices),
                              ctypes.c_double(dense_row),
                              ctypes.c_double(dense_col),
                              1 if aggressive else 0,
                              None if cm is None else _p(cm), _p(perm))
    if rc != 0:
        raise RuntimeError(f"native colamd failed rc={rc}")
    return perm


def etree(n: int, indptr, indices, nrow: int | None = None) -> np.ndarray:
    """Elimination tree of symmetric A from its upper triangle, or, given
    ``nrow``, the column elimination tree of A'A for the ``nrow``-row A."""
    indptr, indices = _i64(indptr), _i64(indices)
    parent = np.empty(n, dtype=np.int64)
    _load().sstpu_etree(n, _p(indptr), _p(indices), _p(parent),
                        -1 if nrow is None else nrow)
    return parent


def postorder(parent) -> np.ndarray:
    parent = _i64(parent)
    post = np.empty(parent.size, dtype=np.int64)
    _load().sstpu_postorder(parent.size, _p(parent), _p(post))
    return post


def col_counts(n: int, indptr, indices, parent, post,
               nrow: int | None = None) -> np.ndarray:
    """nnz per column of L from the lower-triangle pattern by columns, or,
    given ``nrow``, of the Cholesky factor of A'A from A's own pattern."""
    indptr, indices = _i64(indptr), _i64(indices)
    parent, post = _i64(parent), _i64(post)
    counts = np.empty(n, dtype=np.int64)
    _load().sstpu_col_counts(n, n if nrow is None else nrow, _p(indptr),
                             _p(indices), _p(parent), _p(post), _p(counts),
                             0 if nrow is None else 1)
    return counts


def super_analyze(n: int, Cp, Ci, parent, cc, nrelax, zrelax) -> dict:
    """Supernodal symbolic analysis (cholmod_super_symbolic analog).

    ``Cp/Ci`` = LOWER-triangle pattern by columns of the postordered
    permuted matrix. Returns the analysis as numpy arrays."""
    dll = _load()
    Cp, Ci, parent, cc = _i64(Cp), _i64(Ci), _i64(parent), _i64(cc)
    h = dll.sstpu_super_analyze(
        n, _p(Cp), _p(Ci), _p(parent), _p(cc),
        int(nrelax[0]), int(nrelax[1]), int(nrelax[2]),
        ctypes.c_double(zrelax[0]), ctypes.c_double(zrelax[1]),
        ctypes.c_double(zrelax[2]))
    if not h:
        raise RuntimeError("native super_analyze failed")
    try:
        out = {}
        names = ["super_first", "snode_of_col", "sparent", "level_of",
                 "rows_ptr", "rows", "lpx"]
        for what, name in enumerate(names):
            ln = dll.sstpu_super_result(h, what, None)
            arr = np.empty(ln, dtype=np.int64)
            dll.sstpu_super_result(h, what, _p(arr))
            out[name] = arr
        out["fl"] = float(dll.sstpu_super_fl(h))
        out["maxcsize"] = int(dll.sstpu_super_maxcsize(h))
    finally:
        dll.sstpu_super_free(h)
    return out


def aat(n: int, indptr, indices) -> tuple:
    """Pattern of A + A' minus the diagonal (amd_aat analog), sorted and
    deduplicated; input may be the full pattern or one stored triangle."""
    dll = _load()
    indptr, indices = _i64(indptr), _i64(indices)
    tmp = np.zeros(n + 1, dtype=np.int64)
    cap = dll.sstpu_aat(n, _p(indptr), _p(indices), _p(tmp), None)
    outp = np.zeros(n + 1, dtype=np.int64)
    outi = np.empty(cap, dtype=np.int64)
    nnz = dll.sstpu_aat(n, _p(indptr), _p(indices), _p(outp), _p(outi))
    return outp, outi[:nnz]


def symperm(n: int, indptr, indices, pinv) -> tuple:
    """Sorted upper pattern of P A P' for upper-stored A plus a position map
    into the input entries (``~pos`` marks entries that changed triangle).
    O(nnz), cs_symperm.c analog."""
    indptr, indices, pinv = _i64(indptr), _i64(indices), _i64(pinv)
    nnz = int(indptr[n])
    outp = np.empty(n + 1, dtype=np.int64)
    outi = np.empty(nnz, dtype=np.int64)
    outpos = np.empty(nnz, dtype=np.int64)
    _load().sstpu_symperm(n, _p(indptr), _p(indices), _p(pinv), _p(outp),
                          _p(outi), _p(outpos))
    return outp, outi, outpos


def transpose(nrow: int, ncol: int, indptr, indices) -> tuple:
    """Sorted transpose pattern plus position map, one counting pass
    (cs_transpose.c analog)."""
    indptr, indices = _i64(indptr), _i64(indices)
    nnz = int(indptr[ncol])
    outp = np.empty(nrow + 1, dtype=np.int64)
    outi = np.empty(nnz, dtype=np.int64)
    outpos = np.empty(nnz, dtype=np.int64)
    _load().sstpu_transpose(nrow, ncol, _p(indptr), _p(indices), _p(outp),
                            _p(outi), _p(outpos))
    return outp, outi, outpos


def lsolve(n: int, indptr, indices, data, x: np.ndarray) -> None:
    """In place x = L \\ x (diagonal first per column; cs_lsolve analog)."""
    _tri("sstpu_lsolve", n, indptr, indices, data, x)


def ltsolve(n: int, indptr, indices, data, x: np.ndarray) -> None:
    """In place x = L' \\ x."""
    _tri("sstpu_ltsolve", n, indptr, indices, data, x)


def usolve(n: int, indptr, indices, data, x: np.ndarray) -> None:
    """In place x = U \\ x (diagonal last per column; cs_usolve analog)."""
    _tri("sstpu_usolve", n, indptr, indices, data, x)


def utsolve(n: int, indptr, indices, data, x: np.ndarray) -> None:
    """In place x = U' \\ x."""
    _tri("sstpu_utsolve", n, indptr, indices, data, x)


def _tri(name: str, n: int, indptr, indices, data, x: np.ndarray) -> None:
    if x.dtype != np.float64 or not x.flags.c_contiguous:
        raise ValueError(f"{name}: x must be a contiguous float64 vector")
    indptr, indices = _i64(indptr), _i64(indices)
    data = np.ascontiguousarray(data, dtype=np.float64)
    getattr(_load(), name)(n, _p(indptr), _p(indices),
                           data.ctypes.data_as(_f64p),
                           x.ctypes.data_as(_f64p))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _pd(a: np.ndarray):
    return a.ctypes.data_as(_f64p)


def wmatch(nrow: int, ncol: int, indptr, indices, data) -> tuple:
    """Weighted maximum-product transversal (MC64 job-5 analog): (nmatch,
    match) with match[j] the row matched to column j, maximizing the
    product of |A[match[j], j]|; -1 where a column is unmatched (stored
    zeros are no edges)."""
    indptr, indices = _i64(indptr), _i64(indices)
    data = _f64(np.abs(data))
    match = np.empty(ncol, dtype=np.int64)
    nm = _load().sstpu_wmatch(nrow, ncol, _p(indptr), _p(indices), _pd(data),
                              _p(match))
    return int(nm), match


def maxtrans(nrow: int, ncol: int, indptr, indices,
             work_limit: float = -1.0) -> tuple:
    """Maximum transversal (btf_maxtrans analog): (nmatch, match), -1 where
    a column is unmatched. ``work_limit`` > 0 caps the augmenting-path work
    at work_limit * nnz (btf.h's maxwork)."""
    indptr, indices = _i64(indptr), _i64(indices)
    match = np.empty(ncol, dtype=np.int64)
    nm = _load().sstpu_maxtrans(nrow, ncol, _p(indptr), _p(indices),
                                _p(match), ctypes.c_double(work_limit))
    return int(nm), match


def strongcomp(n: int, indptr, indices) -> tuple:
    """Tarjan strong components of the square pattern's digraph: (nblocks,
    p, r), A(p, p) block upper triangular with block k at p[r[k]:r[k+1]]."""
    indptr, indices = _i64(indptr), _i64(indices)
    p = np.empty(n, dtype=np.int64)
    r = np.empty(n + 1, dtype=np.int64)
    nb = _load().sstpu_strongcomp(n, _p(indptr), _p(indices), _p(p), _p(r))
    return int(nb), p, r[:nb + 1].copy()


def lu_factor(n: int, indptr, indices, data, tol: float) -> tuple:
    """Gilbert-Peierls LU with threshold partial pivoting of one square
    block (klu_kernel analog): (status, factors), status 0 with factors =
    (Lp, Li, Lx, Up, Ui, Ux, P), or k + 1 (singular at column k) with
    factors None. L has its unit diagonal first per column, U its diagonal
    last, both in pivot space; P[k] is the row of pivot k."""
    indptr, indices, data = _i64(indptr), _i64(indices), _f64(data)
    capacity = max(4 * int(indptr[n]) + n, 1024)
    dll = _load()
    while True:
        Lp = np.empty(n + 1, dtype=np.int64)
        Li = np.empty(capacity, dtype=np.int64)
        Lx = np.empty(capacity, dtype=np.float64)
        Up = np.empty(n + 1, dtype=np.int64)
        Ui = np.empty(capacity, dtype=np.int64)
        Ux = np.empty(capacity, dtype=np.float64)
        P = np.empty(n, dtype=np.int64)
        rc = dll.sstpu_lu_factor(n, _p(indptr), _p(indices), _pd(data),
                                 ctypes.c_double(tol), capacity, _p(Lp),
                                 _p(Li), _pd(Lx), _p(Up), _p(Ui), _pd(Ux),
                                 _p(P))
        if rc == -1:                      # the factors outgrew the arrays
            capacity *= 2
            continue
        if rc != 0:
            return int(rc), None
        lnz, unz = int(Lp[n]), int(Up[n])
        # shrink in place (no copy of the kept part)
        for arr, size in ((Li, lnz), (Lx, lnz), (Ui, unz), (Ux, unz)):
            arr.resize(size, refcheck=False)
        return 0, (Lp, Li, Lx, Up, Ui, Ux, P)


def lu_refactor(n: int, indptr, indices, data, Lp, Li, Lx, Up, Ui, Ux,
                P) -> int:
    """New values of an earlier :func:`lu_factor`'s L and U (written into
    ``Lx`` and ``Ux``) for a block of the same pattern whose rows are in
    the factor's pivot order when P is the identity (klu_refactor analog).
    Returns 0, or k + 1 where pivot k came out exactly zero."""
    indptr, indices, data = _i64(indptr), _i64(indices), _f64(data)
    for a, dt in ((Lx, np.float64), (Ux, np.float64)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError("lu_refactor: Lx and Ux must be contiguous "
                             "float64 arrays")
    Lp, Li, Up, Ui, P = (_i64(a) for a in (Lp, Li, Up, Ui, P))
    return int(_load().sstpu_lu_refactor(
        n, _p(indptr), _p(indices), _pd(data), _p(Lp), _p(Li), _pd(Lx),
        _p(Up), _p(Ui), _pd(Ux), _p(P)))


def lu_prep(n: int, indptr, indices, pinv, q, r) -> tuple:
    """Permutation and BTF block maps of the KLU-path factor (see
    ``sstpu_lu_prep`` in symbolic.cc): (ip, ii, pos, diag_pos, blocks,
    off), the permuted pattern with C.data = A.data[pos]; blocks[k] is None
    for a 1x1 block, else (bip, bi, bpos) of the local diagonal block;
    off = (oip, oi, opos) the entries above the diagonal blocks. All
    positions index the PERMUTED data."""
    indptr, indices = _i64(indptr), _i64(indices)
    pinv, q, r = _i64(pinv), _i64(q), _i64(r)
    nblocks = r.size - 1
    nnz = int(indptr[n])
    ip = np.empty(n + 1, dtype=np.int64)
    ii = np.empty(nnz, dtype=np.int64)
    pos = np.empty(nnz, dtype=np.int64)
    diag_pos = np.empty(n, dtype=np.int64)
    bo = np.empty(nblocks + 1, dtype=np.int64)
    bip_off = np.empty(nblocks + 1, dtype=np.int64)
    nk = np.diff(r)
    bip_cat = np.empty(int(((nk > 1) * (nk + 1)).sum()), dtype=np.int64)
    bi_cat = np.empty(nnz, dtype=np.int64)
    bpos_cat = np.empty(nnz, dtype=np.int64)
    oip = np.empty(n + 1, dtype=np.int64)
    oi = np.empty(nnz, dtype=np.int64)
    opos = np.empty(nnz, dtype=np.int64)
    counts = np.zeros(2, dtype=np.int64)
    _load().sstpu_lu_prep(n, _p(indptr), _p(indices), _p(pinv), _p(q), _p(r),
                          nblocks, _p(ip), _p(ii), _p(pos), _p(diag_pos),
                          _p(bo), _p(bip_off), _p(bip_cat), _p(bi_cat),
                          _p(bpos_cat), _p(oip), _p(oi), _p(opos),
                          _p(counts))
    bn, on = int(counts[0]), int(counts[1])
    bi_cat, bpos_cat = bi_cat[:bn], bpos_cat[:bn]
    blocks = []
    for k in range(nblocks):
        if r[k + 1] - r[k] <= 1:
            blocks.append(None)
        else:
            blocks.append((bip_cat[bip_off[k]:bip_off[k + 1]],
                           bi_cat[bo[k]:bo[k + 1]],
                           bpos_cat[bo[k]:bo[k + 1]]))
    return ip, ii, pos, diag_pos, blocks, (oip, oi[:on].copy(),
                                           opos[:on].copy())


def offupdate(k1: int, k2: int, indptr, indices, data, x: np.ndarray) -> None:
    """In place x[Offi] -= Offx * x[j] for the columns j in [k1, k2) (the
    off-diagonal update of klu_solve)."""
    if x.dtype != np.float64 or not x.flags.c_contiguous:
        raise ValueError("offupdate: x must be a contiguous float64 vector")
    indptr, indices, data = _i64(indptr), _i64(indices), _f64(data)
    _load().sstpu_offupdate(k1, k2, _p(indptr), _p(indices), _pd(data),
                            x.ctypes.data_as(_f64p))
