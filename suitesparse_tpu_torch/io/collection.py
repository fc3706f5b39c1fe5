"""Local SuiteSparse-Matrix-Collection manager (ssget analog).

Reference analog: ``ssget/`` (MATLAB ``ssget.m`` + Java GUI + index
``files/ssstats.csv``) — a client for sparse.tamu.edu that keeps a local
cache ``<root>/<format>/<group>/<name>.<ext>`` and a statistics index.

The manager is cache-only by design: ``fetch`` is a pluggable callable (a
deployment with network access passes an HTTP fetcher; without one it stays
None and misses raise). The cache layout, index
format (ssstats.csv columns: group, name, nrow, ncol, nnz, isReal, isBinary,
isND, posdef, psym, nsym, kind) and lookup semantics (by id or "Group/Name")
match the reference so a populated mirror drops in unchanged. The port's
copy of the JAX package's ``io/collection.py``; its default cache is the
reference's, without the reference's look at a fixed mirror path.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from ..sparse import CSC

__all__ = ["MatrixEntry", "Collection", "default_collection", "ssget"]


@dataclasses.dataclass
class MatrixEntry:
    id: int
    group: str
    name: str
    nrow: int
    ncol: int
    nnz: int
    is_real: bool
    is_binary: bool
    is_2d3d: bool
    posdef: bool
    psym: float
    nsym: float
    kind: str

    @property
    def full_name(self) -> str:
        return f"{self.group}/{self.name}"


class Collection:
    """A local matrix-collection cache with the ssget directory layout."""

    def __init__(self, root: str, fetch=None):
        self.root = root
        self.fetch = fetch          # callable(entry, dest_path) -> None
        self._index: list[MatrixEntry] | None = None

    # ---------------- index ----------------

    @property
    def index_path(self) -> str:
        return os.path.join(self.root, "files", "ssstats.csv")

    def index(self) -> list[MatrixEntry]:
        """Parse the ssstats.csv index (reference format: 2 header lines —
        matrix count and date — then one row per matrix, id = line order)."""
        if self._index is not None:
            return self._index
        entries = []
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                rows = list(csv.reader(f))
            body = rows[2:] if len(rows) > 2 and len(rows[0]) == 1 else rows
            for i, r in enumerate(body):
                if len(r) < 12:
                    continue
                entries.append(MatrixEntry(
                    id=i + 1, group=r[0], name=r[1], nrow=int(r[2]),
                    ncol=int(r[3]), nnz=int(r[4]), is_real=r[5] == "1",
                    is_binary=r[6] == "1", is_2d3d=r[7] == "1",
                    posdef=r[8] == "1", psym=float(r[9]), nsym=float(r[10]),
                    kind=r[11]))
        self._index = entries
        return entries

    def lookup(self, key) -> MatrixEntry:
        """Entry by numeric id, 'Group/Name', or bare name (first match)."""
        idx = self.index()
        if isinstance(key, (int, np.integer)):
            for e in idx:
                if e.id == int(key):
                    return e
            raise KeyError(f"no matrix with id {key}")
        key = str(key)
        for e in idx:
            if e.full_name == key or e.name == key:
                return e
        raise KeyError(f"no matrix named {key!r}")

    def search(self, *, kind: str | None = None, posdef: bool | None = None,
               max_n: int | None = None, min_n: int | None = None
               ) -> list[MatrixEntry]:
        out = []
        for e in self.index():
            if kind is not None and kind not in e.kind:
                continue
            if posdef is not None and e.posdef != posdef:
                continue
            n = max(e.nrow, e.ncol)
            if max_n is not None and n > max_n:
                continue
            if min_n is not None and n < min_n:
                continue
            out.append(e)
        return out

    # ---------------- retrieval ----------------

    def path_of(self, entry: MatrixEntry, fmt: str = "MM") -> str:
        ext = {"MM": ".mtx", "RB": ".rb"}[fmt]
        return os.path.join(self.root, fmt, entry.group, entry.name + ext)

    def get(self, key, fmt: str = "MM") -> CSC:
        """Load a matrix from the cache (fetching on miss if a fetcher was
        configured — the ssget contract)."""
        entry = self.lookup(key)
        path = self.path_of(entry, fmt)
        if not os.path.exists(path):
            if self.fetch is None:
                raise FileNotFoundError(
                    f"{entry.full_name} not in local cache at {path} and no "
                    f"fetcher configured (zero-egress environment)")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self.fetch(entry, path)
        if fmt == "MM":
            from .matrix_market import read_matrix_market
            return read_matrix_market(path)
        from .rutherford_boeing import read_rb
        return read_rb(path)

    def put(self, group: str, name: str, A: CSC, kind: str = "synthetic",
            posdef: bool = False, fmt: str = "MM") -> MatrixEntry:
        """Add a matrix to the cache and index (mirror-population helper)."""
        os.makedirs(os.path.join(self.root, fmt, group), exist_ok=True)
        os.makedirs(os.path.join(self.root, "files"), exist_ok=True)
        entry = MatrixEntry(
            id=len(self.index()) + 1, group=group, name=name, nrow=A.nrow,
            ncol=A.ncol, nnz=A.nnz, is_real=not np.iscomplexobj(A.data),
            is_binary=False, is_2d3d=False, posdef=posdef,
            psym=1.0 if A.sym else 0.0, nsym=1.0 if A.sym else 0.0, kind=kind)
        path = self.path_of(entry, fmt)
        if fmt == "MM":
            from .matrix_market import write_matrix_market
            write_matrix_market(path, A)
        else:
            from .rutherford_boeing import write_rb
            write_rb(path, A)
        header_needed = not os.path.exists(self.index_path)
        with open(self.index_path, "a", newline="") as f:
            w = csv.writer(f)
            if header_needed:
                f.write("0\nlocal\n")
            w.writerow([entry.group, entry.name, entry.nrow, entry.ncol,
                        entry.nnz, int(entry.is_real), int(entry.is_binary),
                        int(entry.is_2d3d), int(entry.posdef), entry.psym,
                        entry.nsym, entry.kind, entry.nnz])
        self._index = None
        return entry


def default_collection() -> Collection:
    """The default cache, the JAX package's: $SSTPU_COLLECTION, else
    ~/.suitesparse_tpu/ssget (so both packages share one mirror)."""
    root = os.environ.get("SSTPU_COLLECTION")
    if root is None:
        root = os.path.expanduser("~/.suitesparse_tpu/ssget")
    return Collection(root)


def ssget(key, fmt: str = "MM") -> CSC:
    """One-call retrieval from the default collection (ssget.m analog)."""
    return default_collection().get(key, fmt)
