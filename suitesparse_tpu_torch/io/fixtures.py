"""Synthetic test matrices: the SPD generators (upper-stored) of the JAX
package's ``io/fixtures.py``, its ``random_sparse`` and the least-squares
fixture of ``demos/bench_qr.py``: the same functions give the same matrices,
so the port and the reference can be fed identical problems. Plus
``grid_gradient_3d``, the 3-D gradient least-squares problem of the QR
smoke run, and the unsymmetric LU problems ``fem_unsym`` (the fixture of
``demos/bench_unsym.py``) and ``upwind_unsym``.

The reference's demo matrices (the cs_demo triplet files of a SuiteSparse
source tree) load through :func:`load_demo` from ``REFERENCE_ROOT``, which
is ``$SUITESPARSE_REFERENCE``; unset, there is no tree and
:func:`have_reference` is False (the JAX package falls back to a fixed
mount path; the port reads only what it is pointed at)."""

from __future__ import annotations

import os

import numpy as np

from ..sparse import CSC, from_triplets

REFERENCE_ROOT = os.environ.get("SUITESPARSE_REFERENCE")

__all__ = ["REFERENCE_ROOT", "have_reference", "load_triplet_file",
           "load_demo", "laplacian_2d", "laplacian_3d",
           "anisotropic_laplacian_3d", "fem_mesh_spd", "pattern_amplifier",
           "random_sparse", "random_spd", "banded_spd", "arrow_spd",
           "local_coupling_ls", "grid_gradient_3d", "fem_unsym",
           "upwind_unsym"]


def have_reference() -> bool:
    """Whether ``REFERENCE_ROOT`` holds the demo matrices."""
    return REFERENCE_ROOT is not None and os.path.isdir(
        os.path.join(REFERENCE_ROOT, "CSparse", "Matrix"))


def load_triplet_file(path: str, sym: int = 0) -> CSC:
    """Read a 0-based ``row col value`` triplet text file (cs_load format).
    Four-column lines are complex ``row col re im`` (the cxsparse demo
    format, ``CXSparse/Demo/cs_demo.c`` czload)."""
    rows, cols, vals = [], [], []
    cplx = False
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            rows.append(int(parts[0]))
            cols.append(int(parts[1]))
            if len(parts) >= 4:
                cplx = True
                vals.append(complex(float(parts[2]), float(parts[3])))
            else:
                vals.append(float(parts[2]) if len(parts) > 2 else 1.0)
    r = np.array(rows, dtype=np.int64)
    c = np.array(cols, dtype=np.int64)
    x = np.array(vals, dtype=complex if cplx else np.float64)
    nrow = int(r.max()) + 1 if r.size else 0
    ncol = int(c.max()) + 1 if c.size else 0
    if sym == 1:
        return from_triplets(max(nrow, ncol), max(nrow, ncol),
                             np.minimum(r, c), np.maximum(r, c), x, sym=1)
    return from_triplets(nrow, ncol, r, c, x, sym=0)


# The cs_demo matrices and how cs_demo2/cs_demo3 treat them (t1 general;
# bcsstk01/bcsstk16 symmetric lower-stored; west0067/ibm32a general)
_DEMO_SYM = {
    "t1": 0, "ash219": 0, "bcsstk01": 1, "bcsstk16": 1, "fs_183_1": 0,
    "grid3x5": 0, "ibm32a": 0, "ibm32b": 0, "lp_afiro": 0, "mbeacxc": 0,
    "west0067": 0,
}


def load_demo(name: str) -> CSC:
    """A CSparse/CXSparse demo matrix of ``REFERENCE_ROOT`` by name; the
    complex demos (``c4``, ``c_ibm32a``, ...) live under CXSparse/Matrix in
    the 4-column format. Raises FileNotFoundError without the tree."""
    if REFERENCE_ROOT is None:
        raise FileNotFoundError(f"load_demo({name!r}): no reference tree "
                                f"(set SUITESPARSE_REFERENCE)")
    path = os.path.join(REFERENCE_ROOT, "CSparse", "Matrix", name)
    if not os.path.exists(path):
        path = os.path.join(REFERENCE_ROOT, "CXSparse", "Matrix", name)
    sym = _DEMO_SYM.get(name, 1 if name in ("c4", "mhd1280b") else 0)
    A = load_triplet_file(path, sym=0)
    if sym == 1:
        # the files store the lower triangle of a symmetric (complex:
        # Hermitian) matrix; to the upper-stored convention, conjugating
        # the entries that change triangle
        cols = np.repeat(np.arange(A.ncol, dtype=np.int64), np.diff(A.indptr))
        data = A.data
        if np.iscomplexobj(data):
            data = np.where(A.indices > cols, np.conj(data), data)
        return from_triplets(max(A.nrow, A.ncol), max(A.nrow, A.ncol),
                             np.minimum(A.indices, cols),
                             np.maximum(A.indices, cols), data, sym=1)
    return A


def laplacian_2d(nx: int, ny: int | None = None, shift: float = 0.0) -> CSC:
    """5-point 2D Laplacian (SPD), upper-stored. n = nx*ny."""
    ny = ny if ny is not None else nx
    idx = np.arange(nx * ny, dtype=np.int64).reshape(nx, ny)
    rows = [idx.ravel()]
    cols = [idx.ravel()]
    vals = [np.full(nx * ny, 4.0 + shift)]
    # +x neighbor
    r = idx[:-1, :].ravel(); c = idx[1:, :].ravel()
    rows.append(r); cols.append(c); vals.append(np.full(r.size, -1.0))
    # +y neighbor
    r = idx[:, :-1].ravel(); c = idx[:, 1:].ravel()
    rows.append(r); cols.append(c); vals.append(np.full(r.size, -1.0))
    return from_triplets(nx * ny, nx * ny, np.concatenate(rows),
                         np.concatenate(cols), np.concatenate(vals), sym=1)


def laplacian_3d(nx: int, ny: int | None = None, nz: int | None = None,
                 shift: float = 0.0) -> CSC:
    """7-point 3D Laplacian (SPD), upper-stored — the nd3k/nd24k-style workload."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    idx = np.arange(nx * ny * nz, dtype=np.int64).reshape(nx, ny, nz)
    rows = [idx.ravel()]
    cols = [idx.ravel()]
    vals = [np.full(idx.size, 6.0 + shift)]
    for sl_r, sl_c in (((slice(None, -1), slice(None), slice(None)),
                        (slice(1, None), slice(None), slice(None))),
                       ((slice(None), slice(None, -1), slice(None)),
                        (slice(None), slice(1, None), slice(None))),
                       ((slice(None), slice(None), slice(None, -1)),
                        (slice(None), slice(None), slice(1, None)))):
        r = idx[sl_r].ravel(); c = idx[sl_c].ravel()
        rows.append(r); cols.append(c); vals.append(np.full(r.size, -1.0))
    n = nx * ny * nz
    return from_triplets(n, n, np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), sym=1)


def _edges_to_spd(n: int, ei: np.ndarray, ej: np.ndarray, w: np.ndarray,
                  shift: float = 1e-3) -> CSC:
    """Weighted graph Laplacian + diagonal shift, upper-stored (SPD by
    construction: sum of positive-semidefinite edge terms + shift*I)."""
    lo = np.minimum(ei, ej)
    hi = np.maximum(ei, ej)
    keep = lo != hi
    lo, hi, w = lo[keep], hi[keep], w[keep]
    diag = np.full(n, shift)
    np.add.at(diag, lo, w)
    np.add.at(diag, hi, w)
    rows = np.concatenate([lo, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([hi, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([-w, diag])
    return from_triplets(n, n, rows, cols, vals, sym=1)


def anisotropic_laplacian_3d(nx: int, ny: int | None = None,
                             nz: int | None = None,
                             eps: tuple = (1.0, 1e-2, 1e-4),
                             grade: float = 0.0,
                             drop_tol: float = 0.0) -> CSC:
    """Anisotropic (and optionally graded) 7-point 3-D Laplacian.

    Direction-dependent edge coefficients ``eps`` plus exponential grading
    ``exp(grade * x / nx)`` along the first axis. With ``drop_tol`` > 0,
    edges weaker than ``drop_tol * max(eps)`` are removed STRUCTURALLY
    (strength-of-connection dropping): combined with grading, which
    direction survives then varies with position, so nested-dissection
    separators and supernode shapes become genuinely IRREGULAR — the
    fill/shape regime of FEM matrices rather than the model problem.
    Assembled from positive edge terms, so SPD for any eps/grade/drop."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    idx = np.arange(nx * ny * nz, dtype=np.int64).reshape(nx, ny, nz)
    eis, ejs, ws = [], [], []
    # x-edges
    r = idx[:-1, :, :]; c = idx[1:, :, :]
    w = np.full(r.shape, eps[0])
    if grade:
        xs = np.arange(nx - 1, dtype=np.float64).reshape(-1, 1, 1)
        w = w * np.exp(grade * xs / max(nx, 1))
    eis.append(r.ravel()); ejs.append(c.ravel()); ws.append(w.ravel())
    # y-edges
    r = idx[:, :-1, :]; c = idx[:, 1:, :]
    w = np.full(r.shape, eps[1])
    if grade:
        xs = np.arange(nx, dtype=np.float64).reshape(-1, 1, 1)
        w = w * np.exp(grade * xs / max(nx, 1))
    eis.append(r.ravel()); ejs.append(c.ravel()); ws.append(w.ravel())
    # z-edges
    r = idx[:, :, :-1]; c = idx[:, :, 1:]
    w = np.full(r.shape, eps[2])
    eis.append(r.ravel()); ejs.append(c.ravel()); ws.append(w.ravel())
    ei, ej, w = (np.concatenate(eis), np.concatenate(ejs),
                 np.concatenate(ws))
    if drop_tol > 0.0:
        keep = w >= drop_tol * max(eps)
        ei, ej, w = ei[keep], ej[keep], w[keep]
    return _edges_to_spd(nx * ny * nz, ei, ej, w)


def fem_mesh_spd(n: int, seed: int = 0, radius: float | None = None,
                 dim: int = 3) -> CSC:
    """Random geometric-graph 'FEM mesh' SPD matrix.

    ``n`` random points in the unit cube, edges between pairs within
    ``radius`` (found via grid buckets — no scipy), random positive edge
    weights, assembled as a graph Laplacian + shift. Node degrees vary
    (Poisson-like), giving the irregular row-count / supernode-shape zoo of
    unstructured FEM discretizations."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, dim))
    if radius is None:
        # target ~14 neighbors on average: volume of d-ball * n = 14
        from math import gamma, pi
        vball = pi ** (dim / 2) / gamma(dim / 2 + 1)
        radius = (14.0 / (n * vball)) ** (1.0 / dim)
    ncell = max(1, int(1.0 / radius))
    cell = np.floor(pts * ncell).astype(np.int64)
    cell = np.minimum(cell, ncell - 1)
    key = cell[:, 0]
    for d in range(1, dim):
        key = key * ncell + cell[:, d]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    # bucket boundaries
    starts = np.flatnonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))
    bkey = key_s[starts]
    bptr = np.concatenate([starts, [n]])
    bucket_of = {int(k): i for i, k in enumerate(bkey)}
    # neighbor cell offsets (half-space to avoid duplicates)
    offs = []
    rng_off = range(-1, 2)
    for dx in rng_off:
        for dy in (rng_off if dim >= 2 else [0]):
            for dz in (rng_off if dim >= 3 else [0]):
                if (dx, dy, dz) > (0, 0, 0) or (dx, dy, dz) == (0, 0, 0):
                    offs.append((dx, dy, dz))
    eis, ejs = [], []
    r2 = radius * radius
    for bi in range(bkey.size):
        ids_a = order[bptr[bi]:bptr[bi + 1]]
        ca = cell[ids_a[0]]
        for off in offs:
            cb = ca + np.array(off[:dim])
            if np.any(cb < 0) or np.any(cb >= ncell):
                continue
            k2 = cb[0]
            for d in range(1, dim):
                k2 = k2 * ncell + cb[d]
            bj = bucket_of.get(int(k2))
            if bj is None:
                continue
            ids_b = order[bptr[bj]:bptr[bj + 1]]
            da = pts[ids_a][:, None, :] - pts[ids_b][None, :, :]
            d2 = np.einsum('ijk,ijk->ij', da, da)
            ii, jj = np.nonzero(d2 <= r2)
            if bj == bi:
                keep = ii < jj
                ii, jj = ii[keep], jj[keep]
            eis.append(ids_a[ii])
            ejs.append(ids_b[jj])
    ei = np.concatenate(eis) if eis else np.empty(0, np.int64)
    ej = np.concatenate(ejs) if ejs else np.empty(0, np.int64)
    w = rng.uniform(0.5, 2.0, size=ei.size)
    return _edges_to_spd(n, ei, ej, w)


def pattern_amplifier(A: CSC, block: int = 8, seed: int = 0) -> CSC:
    """A small symmetric pattern (a bcsstk demo matrix, say) amplified into
    a large SPD matrix with the same coarse connectivity: each node of A's
    graph becomes a path of ``block`` nodes, and each edge (i, j) couples
    a random subset of the two paths' nodes with random positive weights
    (the capacity rows' stand-in for the big FEM matrices of the
    collection)."""
    rng = np.random.default_rng(seed)
    n0 = A.ncol
    n = n0 * block
    cols0 = np.repeat(np.arange(n0, dtype=np.int64), np.diff(A.indptr))
    rows0 = A.indices
    off = rows0 != cols0
    ei0, ej0 = rows0[off], cols0[off]
    # intra-node path edges
    base = np.arange(n0, dtype=np.int64) * block
    pi = (base[:, None] + np.arange(block - 1)).ravel()
    eis = [pi]
    ejs = [pi + 1]
    ws = [rng.uniform(0.5, 2.0, size=pi.size)]
    # inter-node couplings: 1..block/2 random pairs a coarse edge
    kmax = max(1, block // 2)
    kcnt = rng.integers(1, kmax + 1, size=ei0.size)
    tot = int(kcnt.sum())
    src_node = np.repeat(ei0, kcnt)
    dst_node = np.repeat(ej0, kcnt)
    eis.append(src_node * block + rng.integers(0, block, size=tot))
    ejs.append(dst_node * block + rng.integers(0, block, size=tot))
    ws.append(rng.uniform(0.5, 2.0, size=tot))
    return _edges_to_spd(n, np.concatenate(eis), np.concatenate(ejs),
                         np.concatenate(ws))


def random_sparse(nrow: int, ncol: int, density: float = 0.05, seed: int = 0,
                  ensure_full_diag: bool = True) -> CSC:
    """Random unsymmetric matrix (for LU/QR paths)."""
    rng = np.random.default_rng(seed)
    m = max(1, int(density * nrow * ncol))
    r = rng.integers(0, nrow, size=m)
    c = rng.integers(0, ncol, size=m)
    x = rng.standard_normal(m)
    if ensure_full_diag and nrow == ncol:
        d = np.arange(nrow, dtype=np.int64)
        r = np.concatenate([r, d]); c = np.concatenate([c, d])
        x = np.concatenate([x, np.full(nrow, 4.0 + density * nrow)])
    return from_triplets(nrow, ncol, r, c, x, sym=0)


def random_spd(n: int, density: float = 0.01, seed: int = 0) -> CSC:
    """Random SPD: random sparse pattern + diagonal dominance, upper-stored."""
    rng = np.random.default_rng(seed)
    m = max(1, int(density * n * n / 2))
    r = rng.integers(0, n, size=m)
    c = rng.integers(0, n, size=m)
    lo = np.minimum(r, c); hi = np.maximum(r, c)
    off = lo != hi
    vals = rng.standard_normal(off.sum())
    rows = np.concatenate([lo[off], np.arange(n)])
    cols = np.concatenate([hi[off], np.arange(n)])
    # diagonal dominance: diag = 1 + sum |offdiag| bound
    diag = np.full(n, 1.0)
    np.add.at(diag, lo[off], np.abs(vals))
    np.add.at(diag, hi[off], np.abs(vals))
    data = np.concatenate([vals, diag + 1.0])
    return from_triplets(n, n, rows, cols, data, sym=1)


def banded_spd(n: int, bandwidth: int, seed: int = 0) -> CSC:
    """Banded SPD (diagonally dominant), upper-stored."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [np.arange(n, dtype=np.int64)], \
        [np.arange(n, dtype=np.int64)], [np.full(n, 2.0 * bandwidth + 1.0)]
    for k in range(1, bandwidth + 1):
        r = np.arange(n - k, dtype=np.int64)
        rows.append(r)
        cols.append(r + k)
        vals.append(rng.uniform(-1.0, 1.0, size=n - k))
    return from_triplets(n, n, np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), sym=1)


def arrow_spd(n: int, heads: int = 1) -> CSC:
    """Arrowhead SPD: worst-case fill for the natural order, none for AMD."""
    rows = [np.arange(n, dtype=np.int64)]
    cols = [np.arange(n, dtype=np.int64)]
    vals = [np.full(n, float(n))]
    for h in range(heads):
        r = np.arange(heads, n, dtype=np.int64)
        rows.append(np.full(r.size, h, dtype=np.int64))
        cols.append(r)
        vals.append(np.full(r.size, -1.0))
    return from_triplets(n, n, np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), sym=1)


def local_coupling_ls(m: int, n: int, k: int = 6, seed: int = 3) -> CSC:
    """m x n least-squares matrix of ``demos/bench_qr.py``: m - n rows each
    coupling k consecutive columns at a random offset (the pattern of
    mesh and collocation least squares), then n unit anchor rows, so A has
    full column rank."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m - n):
        j0 = rng.integers(0, n - k)
        rows.append(np.full(k, i))
        cols.append(j0 + np.arange(k))
        vals.append(rng.standard_normal(k))
    rows.append(m - n + np.arange(n))
    cols.append(np.arange(n))
    vals.append(np.ones(n))
    return from_triplets(m, n, np.concatenate(rows), np.concatenate(cols),
                         np.concatenate(vals), sym=0)


def grid_gradient_3d(k: int, seed: int = 0) -> CSC:
    """Weighted gradient of a k x k x k grid, as least squares: one row per
    grid edge, edges along axis 0, then 1, then 2, each in C order of its
    lower node, with -w at the lower node and +w at the upper one, w ~
    U[0.5, 2); then unit rows at k^3 // 100 distinct nodes (at least one)
    drawn by the same generator, which fix the constant and give A full
    column rank. A'A is a weighted 3-D Laplacian plus those anchors: the
    normal equations of gradient-domain reconstruction, surface-from-normal
    integration and phase unwrapping."""
    rng = np.random.default_rng(seed)
    n = k ** 3
    idx = np.arange(n, dtype=np.int64).reshape(k, k, k)
    lo = np.concatenate([idx[:-1, :, :].ravel(), idx[:, :-1, :].ravel(),
                         idx[:, :, :-1].ravel()])
    hi = np.concatenate([idx[1:, :, :].ravel(), idx[:, 1:, :].ravel(),
                         idx[:, :, 1:].ravel()])
    ne = lo.size
    w = rng.uniform(0.5, 2.0, ne)
    anchors = np.sort(rng.choice(n, size=max(1, n // 100), replace=False))
    na = anchors.size
    edge = np.arange(ne, dtype=np.int64)
    rows = np.concatenate([edge, edge, ne + np.arange(na, dtype=np.int64)])
    cols = np.concatenate([lo, hi, anchors])
    vals = np.concatenate([-w, w, np.ones(na)])
    return from_triplets(ne + na, n, rows, cols, vals, sym=0)


def fem_unsym(nx: int, seed: int = 1) -> CSC:
    """The unsymmetric FEM-pattern matrix of ``demos/bench_unsym.py``:
    ``laplacian_3d(nx)`` in full storage plus 0.2 N(0, 1) on every value
    (seed 1). n = nx^3; the pattern is symmetric, the values are not."""
    rng = np.random.default_rng(seed)
    M = laplacian_3d(nx).to_full_storage()
    return CSC(M.nrow, M.ncol, M.indptr, M.indices,
               M.data + 0.2 * rng.standard_normal(M.nnz), 0)


def upwind_unsym(nx: int, drop: float = 0.75, seed: int = 2) -> CSC:
    """``fem_unsym(nx)`` with each strictly upper entry dropped with
    probability ``drop`` (one draw per stored entry, seed 2): a
    structurally unsymmetric pattern, as an upwinded convection-diffusion
    operator has (structural symmetry 0.40 at nx = 30)."""
    A = fem_unsym(nx)
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(A.ncol, dtype=np.int64), np.diff(A.indptr))
    keep = ~((A.indices < cols) & (rng.random(A.nnz) < drop))
    return from_triplets(A.nrow, A.ncol, A.indices[keep], cols[keep],
                         A.data[keep])
