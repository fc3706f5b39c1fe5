"""Host-side sparse matrix container and the structural ops the port uses.

``CSC`` mirrors the JAX package's container (the ``cholmod_sparse`` CSC
struct, reference ``cholmod_core.h:1214-1263``): int64 indices, sorted
unique rows per column, ``sym`` as cholmod's ``stype`` (0 general, 1 upper
stored symmetric). Values are real or complex; a stored triangle of complex
values is Hermitian (its reflection is conjugated), and an explicit zero
stays in the pattern. The structural kernels run in the port's host C++
library (:mod:`.native`).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from . import native

__all__ = ["CSC", "eye", "from_dense", "from_triplets", "horzcat",
           "invert_permutation", "residual_norm", "vertcat"]


def _as_index(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _col_ids(indptr: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(indptr.size - 1, dtype=np.int64),
                     np.diff(indptr))


@dataclasses.dataclass
class CSC:
    """Compressed sparse column matrix, ``nrow x ncol``.

    ``indices[indptr[j]:indptr[j+1]]`` are the row indices of column j,
    sorted ascending with no duplicates; ``data`` holds matching values."""

    nrow: int
    ncol: int
    indptr: np.ndarray   # int64, size ncol+1
    indices: np.ndarray  # int64, size nnz
    data: np.ndarray     # float or complex, size nnz
    sym: int = 0

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrow, self.ncol)

    def copy(self) -> "CSC":
        return CSC(self.nrow, self.ncol, self.indptr.copy(),
                   self.indices.copy(), self.data.copy(), self.sym)

    def pattern_key(self) -> tuple:
        """(nnz, sym, crc32(indptr||indices)): the cache key of the
        analyze-once/factor-many value maps, memoized per indices array."""
        memo = getattr(self, "_pat_key", None)
        if memo is None or memo[0] is not self.indices:
            crc = zlib.crc32(np.ascontiguousarray(self.indptr))
            crc = zlib.crc32(np.ascontiguousarray(self.indices), crc)
            memo = (self.indices, (self.nnz, self.sym, crc))
            self._pat_key = memo
        return memo[1]

    def col_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def rows_of(self, j: int) -> np.ndarray:
        return self.indices[self.indptr[j]:self.indptr[j + 1]]

    def vals_of(self, j: int) -> np.ndarray:
        return self.data[self.indptr[j]:self.indptr[j + 1]]

    def check(self) -> None:
        """Structural invariants (cholmod_check_sparse analog): raises
        ``AssertionError`` naming the first one that fails."""
        def require(ok, what):
            if not ok:
                raise AssertionError(what)

        require(self.indptr.ndim == 1 and self.indptr.size == self.ncol + 1,
                "indptr must have ncol + 1 entries")
        require(self.indptr[0] == 0, "indptr must start at 0")
        require(np.all(np.diff(self.indptr) >= 0), "indptr not monotone")
        nnz = self.nnz
        require(self.indices.size == nnz and self.data.size == nnz,
                "indices and data must hold nnz entries")
        if nnz:
            require(self.indices.min() >= 0
                    and self.indices.max() < self.nrow, "row out of range")
        cols = _col_ids(self.indptr)
        bad = np.flatnonzero((cols[1:] == cols[:-1])
                             & (np.diff(self.indices) <= 0))
        require(bad.size == 0, f"col {cols[bad[0] + 1] if bad.size else -1} "
                "unsorted or duplicated")

    def to_dense(self) -> np.ndarray:
        A = np.zeros((self.nrow, self.ncol), dtype=self.data.dtype)
        A[self.indices, _col_ids(self.indptr)] = self.data
        if self.sym != 0:
            full = A + A.conj().T
            d = np.arange(min(self.nrow, self.ncol))
            full[d, d] = A[d, d]
            return full
        return A

    def transpose(self, values: bool = True) -> "CSC":
        """A' in CSC form (cs_transpose.c analog), one counting pass."""
        outp, outi, pos = native.transpose(self.nrow, self.ncol,
                                           self.indptr, self.indices)
        data = (self.data[pos] if values
                else np.zeros(len(outi), self.data.dtype))
        return CSC(self.ncol, self.nrow, outp, outi, data, -self.sym)

    def permuted(self, p: np.ndarray | None, q: np.ndarray | None) -> "CSC":
        """C = P A Q', i.e. C[i, j] = A[p[i], q[j]], for general storage
        (cs_permute.c / cholmod_ptranspose analog); None is the identity.
        Rows come out sorted (two counting transposes when p reorders
        them)."""
        indptr, indices, pos = self.permuted_map(p, q)
        return CSC(self.nrow, self.ncol, indptr, indices, self.data[pos], 0)

    def permuted_map(self, p: np.ndarray | None, q: np.ndarray | None):
        """(indptr, indices, pos) of C = P A Q': its pattern and the map
        of its values, C.data = A.data[pos] (cached once per pattern, a
        refactorization's permutation is one gather)."""
        if self.sym != 0:
            raise ValueError("permuted expects general storage (sym=0); "
                             "use symperm")
        m, n = self.nrow, self.ncol
        q = (_as_index(q) if q is not None
             else np.arange(n, dtype=np.int64))
        starts = self.indptr[q]
        lens = self.indptr[q + 1] - starts
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        gather = _concat_ranges(starts, lens)
        rows = self.indices[gather]
        if p is None:
            return indptr, rows, gather
        rows = invert_permutation(p)[rows]
        tp, ti, tpos = native.transpose(m, n, indptr, rows)
        _op, oi, opos = native.transpose(n, m, tp, ti)
        return indptr, oi, gather[tpos][opos]

    def symperm(self, p: np.ndarray) -> "CSC":
        """C = P A P' keeping only the upper triangle, for symmetric A stored
        upper (``sym=1``); cs_symperm.c analog. An entry that moves to the
        other triangle is conjugated (Hermitian storage)."""
        if self.sym != 1:
            raise ValueError("symperm expects upper-stored symmetric (sym=1)")
        outp, outi, pos = native.symperm(self.ncol, self.indptr,
                                         self.indices, invert_permutation(p))
        flip = pos < 0
        data = self.data[np.where(flip, ~pos, pos)]
        if np.iscomplexobj(data):
            data = np.where(flip, np.conj(data), data)
        return CSC(self.ncol, self.ncol, outp, outi, data, 1)

    def drop_zeros(self, tol: float = 0.0) -> "CSC":
        """Drop stored entries with |x| <= tol (cholmod_drop analog)."""
        return self._filter(np.abs(self.data) > tol)

    def band(self, k1: int, k2: int) -> "CSC":
        """Entries within diagonals k1..k2 inclusive (cholmod_band
        analog), in general storage for a symmetric-stored A."""
        A = self.to_full_storage()
        d = _col_ids(A.indptr) - A.indices
        return A._filter((d >= k1) & (d <= k2))

    def tril(self, k: int = 0) -> "CSC":
        """The entries on and below diagonal -k of the stored pattern."""
        return self._filter(self.indices >= _col_ids(self.indptr) + k)

    def triu(self, k: int = 0) -> "CSC":
        """The entries on and above diagonal k of the stored pattern."""
        return self._filter(self.indices <= _col_ids(self.indptr) - k)

    def _filter(self, keep: np.ndarray) -> "CSC":
        counts = np.bincount(_col_ids(self.indptr)[keep], minlength=self.ncol)
        indptr = np.zeros(self.ncol + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSC(self.nrow, self.ncol, indptr, self.indices[keep],
                   self.data[keep], self.sym)

    def to_full_storage(self) -> "CSC":
        """Symmetric-stored (sym=1) -> general storage, both triangles (the
        reflection conjugated for complex values)."""
        if self.sym == 0:
            return self
        cols = _col_ids(self.indptr)
        off = self.indices != cols
        return from_triplets(
            self.nrow, self.ncol,
            np.concatenate([self.indices, cols[off]]),
            np.concatenate([cols, self.indices[off]]),
            np.concatenate([self.data, np.conj(self.data[off])]), sym=0)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x for dense x (n,) or (n, k); cholmod_sdmult analog."""
        A = self.to_full_storage()
        x = np.asarray(x)
        cols = _col_ids(A.indptr)
        y = np.zeros((A.nrow,) + x.shape[1:],
                     dtype=np.result_type(A.data, x))
        vals = A.data if x.ndim == 1 else A.data[:, None]
        np.add.at(y, A.indices, vals * x[cols])
        return y

    def rmatvec(self, x: np.ndarray) -> np.ndarray:
        """y = A' @ x."""
        if self.sym != 0:
            return self.matvec(x)
        return self.transpose().matvec(x)

    def add(self, other: "CSC", alpha: float = 1.0,
            beta: float = 1.0) -> "CSC":
        """alpha*A + beta*B in A's storage (cholmod_add analog); both of one
        shape and storage."""
        if self.shape != other.shape or self.sym != other.sym:
            raise ValueError("add: the matrices differ in shape or storage")
        return from_triplets(
            self.nrow, self.ncol,
            np.concatenate([self.indices, other.indices]),
            np.concatenate([_col_ids(self.indptr), _col_ids(other.indptr)]),
            np.concatenate([alpha * self.data, beta * other.data]),
            sym=self.sym)

    def matmat(self, other: "CSC") -> "CSC":
        """C = A @ B, sparse times sparse, in general storage
        (cholmod_ssmult / cs_multiply analog): a column at a time, the
        products of each column summed in B's then A's storage order."""
        A = self.to_full_storage()
        B = other.to_full_storage()
        if A.ncol != B.nrow:
            raise ValueError(f"matmat: {A.ncol} columns against {B.nrow} "
                             f"rows")
        rows_out, cols_out, vals_out = [], [], []
        for j in range(B.ncol):
            acc: dict = {}
            for t in range(B.indptr[j], B.indptr[j + 1]):
                k, bv = B.indices[t], B.data[t]
                lo, hi = A.indptr[k], A.indptr[k + 1]
                for i, av in zip(A.indices[lo:hi], A.data[lo:hi]):
                    acc[i] = acc.get(i, 0.0) + av * bv
            rows_out.extend(acc.keys())
            cols_out.extend([j] * len(acc))
            vals_out.extend(acc.values())
        return from_triplets(A.nrow, B.ncol,
                             np.array(rows_out, dtype=np.int64),
                             np.array(cols_out, dtype=np.int64),
                             np.array(vals_out, dtype=A.data.dtype))

    def norm1(self) -> float:
        """max column sum of |A| (cholmod_norm analog)."""
        A = self.to_full_storage()
        if A.nnz == 0:
            return 0.0
        sums = np.bincount(_col_ids(A.indptr), weights=np.abs(A.data),
                           minlength=A.ncol)
        return float(sums.max())

    def norm_inf(self) -> float:
        """max row sum of |A| (cholmod_norm analog)."""
        A = self.to_full_storage()
        if A.nnz == 0:
            return 0.0
        sums = np.bincount(A.indices, weights=np.abs(A.data),
                           minlength=A.nrow)
        return float(sums.max())

    def norm_fro(self) -> float:
        """The Frobenius norm (cholmod_norm analog)."""
        return float(np.sqrt(np.sum(np.abs(self.to_full_storage().data)
                                    ** 2)))

    def scale(self, left: np.ndarray | None = None,
              right: np.ndarray | None = None) -> "CSC":
        """diag(left) @ A @ diag(right) (cholmod_scale analog; either side
        may be None); a symmetric-stored A takes left == right."""
        if self.sym != 0 and left is not None and right is not None \
                and not np.array_equal(left, right):
            raise ValueError("scale: a symmetric matrix takes left == right")
        data = self.data.copy()
        if left is not None:
            data *= np.asarray(left)[self.indices]
        if right is not None:
            data *= np.asarray(right)[_col_ids(self.indptr)]
        return CSC(self.nrow, self.ncol, self.indptr.copy(),
                   self.indices.copy(), data, self.sym)

    def submatrix(self, rows: np.ndarray | None,
                  cols: np.ndarray | None) -> "CSC":
        """A[rows, cols] for index lists that may permute and repeat
        (cholmod_submatrix analog); None takes all, in order."""
        A = self.to_full_storage()
        rsel = (np.arange(A.nrow, dtype=np.int64) if rows is None
                else _as_index(rows))
        csel = (np.arange(A.ncol, dtype=np.int64) if cols is None
                else _as_index(cols))
        # each row of A to the positions it takes in rsel (repeats too)
        rr, cc, xx = [], [], []
        order = np.argsort(rsel, kind="stable")
        rsorted = rsel[order]
        for out_j, j in enumerate(csel):
            lo, hi = A.indptr[j], A.indptr[j + 1]
            ridx = A.indices[lo:hi]
            loi = np.searchsorted(rsorted, ridx, side="left")
            hii = np.searchsorted(rsorted, ridx, side="right")
            for t in range(ridx.size):
                for k in range(loi[t], hii[t]):
                    rr.append(order[k])
                    cc.append(out_j)
                    xx.append(A.data[lo + t])
        return from_triplets(rsel.size, csel.size, rr, cc,
                             np.asarray(xx, dtype=A.data.dtype))

    def symmetry(self, tol: float = 0.0) -> dict:
        """Structural/numeric symmetry report (cholmod_symmetry analog):
        {'structural': frac, 'numeric': frac, 'hermitian': frac, 'nzdiag':
        count}, the fractions over the off-diagonal pattern."""
        A = self.to_full_storage()
        if A.nrow != A.ncol:
            raise ValueError("symmetry needs a square matrix")
        cols = _col_ids(A.indptr)
        diag = A.indices == cols
        nzdiag = int(np.count_nonzero(diag))
        off = ~diag
        r, c, x = A.indices[off], cols[off], A.data[off]
        if r.size == 0:
            return {"structural": 1.0, "numeric": 1.0, "hermitian": 1.0,
                    "nzdiag": nzdiag}
        key = r * A.ncol + c
        keyT = c * A.ncol + r
        order = np.argsort(key)
        pos = np.clip(np.searchsorted(key[order], keyT), 0, key.size - 1)
        hit = key[order][pos] == keyT
        xv = x[order][pos]
        num_ok = hit & (np.abs(xv - x) <= tol + tol * np.abs(x))
        herm_ok = hit & (np.abs(np.conj(xv) - x) <= tol + tol * np.abs(x))
        return {"structural": float(np.count_nonzero(hit)) / r.size,
                "numeric": float(np.count_nonzero(num_ok)) / r.size,
                "hermitian": float(np.count_nonzero(herm_ok)) / r.size,
                "nzdiag": nzdiag}

    def aat_pattern(self) -> "CSC":
        """Pattern of A + A' minus the diagonal, general CSC with data=1
        (the ordering input, reference ``AMD/Source/amd_aat.c``)."""
        n = self.ncol
        if self.nrow != n:
            raise ValueError("aat_pattern needs a square matrix")
        outp, outi = native.aat(n, self.indptr, self.indices)
        return CSC(n, n, outp, outi, np.ones(outi.size), 0)

    def ata_pattern(self) -> "CSC":
        """A'A, formed explicitly (small host-side uses; COLAMD orders A's
        columns without it)."""
        return self.transpose().matmat(self)

    def to_csr_arrays(self):
        """(indptr, indices, data) of the CSR view of A (the CSC of A')."""
        T = self.transpose()
        return T.indptr, T.indices, T.data


def from_triplets(nrow: int, ncol: int, rows, cols, vals, sym: int = 0) -> CSC:
    """Triplet -> CSC with duplicates summed (cs_compress + cs_dupl analog);
    zero values stay in the pattern."""
    rows = _as_index(rows)
    cols = _as_index(cols)
    vals = np.asarray(vals)
    if vals.dtype.kind not in "fc":
        vals = vals.astype(np.float64)
    if not rows.size == cols.size == vals.size:
        raise ValueError("from_triplets: rows, cols and vals differ in size")
    if rows.size == 0:
        return CSC(nrow, ncol, np.zeros(ncol + 1, np.int64),
                   np.empty(0, np.int64), np.empty(0, vals.dtype), sym)
    if rows.min() < 0 or rows.max() >= nrow or cols.min() < 0 \
            or cols.max() >= ncol:
        raise ValueError("from_triplets: index out of range")
    order = np.lexsort((rows, cols))
    r, c, x = rows[order], cols[order], vals[order]
    new_grp = np.ones(r.size, dtype=bool)
    new_grp[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    grp = np.cumsum(new_grp) - 1
    x_sum = np.bincount(grp, weights=x.real)
    if np.iscomplexobj(x):
        x_sum = x_sum + 1j * np.bincount(grp, weights=x.imag)
    counts = np.bincount(c[new_grp], minlength=ncol)
    indptr = np.zeros(ncol + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSC(nrow, ncol, indptr, r[new_grp], x_sum.astype(vals.dtype), sym)


def from_dense(A: np.ndarray, sym: int = 0, tol: float = 0.0) -> CSC:
    """The entries of dense A with |a| > tol as CSC; ``sym`` = 1 keeps the
    upper triangle (upper-stored symmetric), -1 the lower."""
    A = np.asarray(A)
    mask = np.abs(A) > tol
    if sym == 1:
        mask &= np.arange(A.shape[0])[:, None] <= np.arange(A.shape[1])
    elif sym == -1:
        mask &= np.arange(A.shape[0])[:, None] >= np.arange(A.shape[1])
    r, c = np.nonzero(mask)
    return from_triplets(A.shape[0], A.shape[1], r, c, A[r, c], sym=sym)


def eye(n: int, dtype=np.float64) -> CSC:
    """The n x n identity."""
    idx = np.arange(n, dtype=np.int64)
    return CSC(n, n, np.arange(n + 1, dtype=np.int64), idx,
               np.ones(n, dtype=dtype), 0)


def horzcat(A: CSC, B: CSC) -> CSC:
    """[A B] (cholmod_horzcat analog), in general storage."""
    A = A.to_full_storage() if A.sym != 0 else A
    B = B.to_full_storage() if B.sym != 0 else B
    if A.nrow != B.nrow:
        raise ValueError(f"horzcat: {A.nrow} and {B.nrow} rows")
    indptr = np.concatenate([A.indptr, A.nnz + B.indptr[1:]])
    return CSC(A.nrow, A.ncol + B.ncol, indptr,
               np.concatenate([A.indices, B.indices]),
               np.concatenate([A.data, B.data]), 0)


def vertcat(A: CSC, B: CSC) -> CSC:
    """[A ; B] (cholmod_vertcat analog), in general storage."""
    A = A.to_full_storage() if A.sym != 0 else A
    B = B.to_full_storage() if B.sym != 0 else B
    if A.ncol != B.ncol:
        raise ValueError(f"vertcat: {A.ncol} and {B.ncol} columns")
    ca = np.repeat(np.arange(A.ncol, dtype=np.int64), np.diff(A.indptr))
    cb = np.repeat(np.arange(B.ncol, dtype=np.int64), np.diff(B.indptr))
    return from_triplets(A.nrow + B.nrow, A.ncol,
                         np.concatenate([A.indices, A.nrow + B.indices]),
                         np.concatenate([ca, cb]),
                         np.concatenate([A.data, B.data]))


def _concat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The ranges [starts[i], starts[i] + lens[i]) one after another."""
    nonzero = lens > 0
    if not nonzero.any():
        return np.empty(0, dtype=np.int64)
    srt, lns = starts[nonzero], lens[nonzero]
    out = np.ones(int(lns.sum()), dtype=np.int64)
    out[0] = srt[0]
    out[np.cumsum(lns)[:-1]] = srt[1:] - (srt[:-1] + lns[:-1] - 1)
    return np.cumsum(out)


def invert_permutation(p) -> np.ndarray:
    p = _as_index(p)
    pinv = np.empty_like(p)
    pinv[p] = np.arange(p.size, dtype=np.int64)
    return pinv


def residual_norm(A: CSC, x: np.ndarray, b: np.ndarray) -> float:
    """norm(Ax-b,inf) / (norm(A,1)*norm(x,inf) + norm(b,inf)), the
    reference acceptance criterion (``CSparse/Demo/cs_demo.c:52``)."""
    r = A.matvec(x) - b
    denom = A.norm1() * np.abs(x).max(initial=0.0) + np.abs(b).max(initial=0.0)
    if denom == 0.0:
        return float(np.abs(r).max(initial=0.0))
    return float(np.abs(r).max(initial=0.0) / denom)
