"""Symmetric stencil matrices on a 3-D grid, in numpy (frozen yardstick code).

A matrix generator of ``matrices/`` names its stencil (the neighbour
offsets of one grid point) and its published values; this module turns that
into the upper-stored CSC arrays the benchmark hands to the program and to
the reference, and into the weighted values of the traffic.

Points are numbered ``i = (x * ny + y) * nz + z``. Every edge of the grid
extended by one layer of boundary points (Dirichlet) carries a weight ``w``:
an off-diagonal entry is ``-w`` of an edge between two grid points, and a
diagonal is the sum of the weights of all the point's edges, those to
boundary points included. With every weight 1 that is the published matrix
(the 7-point Poisson's 6 / -1, HPCG's 26 / -1, both at the boundary rows
too), and any weights keep its diagonal dominance.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def half_offsets(points: int) -> list[tuple[int, int, int]]:
    """The lexicographically positive neighbour offsets of a 7- or
    27-point stencil (3 or 13 of them); their negatives are the others."""
    if points == 7:
        return [(0, 0, 1), (0, 1, 0), (1, 0, 0)]
    if points == 27:
        return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]
    raise ValueError(f"no {points}-point stencil")


@dataclasses.dataclass
class Stencil:
    """The pattern of an upper-stored stencil matrix and where its values
    come from: ``indptr``/``indices`` (int64, rows ascending in each
    column), ``diag_pos`` (the diagonal's position in each column) and, for
    each stored off-diagonal entry, the edge whose weight it takes."""

    grid: tuple[int, int, int]
    offsets: list
    indptr: np.ndarray
    indices: np.ndarray
    diag_pos: np.ndarray
    off_pos: np.ndarray      # positions of the off-diagonal entries
    off_edge: np.ndarray     # their edges: flat index into the weight array

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def weight_shape(self) -> tuple[int, int, int, int]:
        """One weight per (half offset, point of the extended grid): edge
        (p, p + d) of half offset d from extended point p."""
        nx, ny, nz = self.grid
        return (len(self.offsets), nx + 2, ny + 2, nz + 2)

    def values(self, weights: np.ndarray) -> np.ndarray:
        """The matrix's values (float64, CSC order) under ``weights`` of
        :meth:`weight_shape`."""
        nx, ny, nz = self.grid
        W = weights.reshape(self.weight_shape())
        diag = np.zeros((nx, ny, nz))
        for k, (dx, dy, dz) in enumerate(self.offsets):
            # edge (p, p + d) from p, and edge (p - d, p) ending at p
            diag += W[k, 1:nx + 1, 1:ny + 1, 1:nz + 1]
            diag += W[k, 1 - dx:nx + 1 - dx, 1 - dy:ny + 1 - dy,
                      1 - dz:nz + 1 - dz]
        data = np.empty(self.nnz)
        data[self.diag_pos] = diag.ravel()
        data[self.off_pos] = -weights.ravel()[self.off_edge]
        return data


def build(grid: tuple[int, int, int], points: int) -> Stencil:
    """The upper-stored pattern of the ``points``-point stencil on
    ``grid``."""
    nx, ny, nz = (int(v) for v in grid)
    offs = half_offsets(points)
    n = nx * ny * nz
    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    x, y, z = x.ravel(), y.ravel(), z.ravel()
    ext = (nx + 2, ny + 2, nz + 2)
    # column j = point q; its upper entries are rows q - d for each half
    # offset d (a smaller index), then the diagonal; ascending row order is
    # descending linear offset
    lin = [(dx * ny + dy) * nz + dz for dx, dy, dz in offs]
    order = np.argsort(lin)[::-1]
    rows, edges, valid = [], [], []
    for k in order:
        dx, dy, dz = offs[k]
        px, py, pz = x - dx, y - dy, z - dz
        ok = ((px >= 0) & (px < nx) & (py >= 0) & (py < ny) & (pz >= 0)
              & (pz < nz))
        rows.append((px * ny + py) * nz + pz)
        # the edge (p, p + d) with p = q - d, in extended coordinates
        edges.append(np.ravel_multi_index(
            (np.full(n, k), np.clip(px + 1, 0, nx + 1),
             np.clip(py + 1, 0, ny + 1), np.clip(pz + 1, 0, nz + 1)),
            (len(offs),) + ext))
        valid.append(ok)
    rows.append(np.arange(n))
    edges.append(np.full(n, -1))
    valid.append(np.ones(n, dtype=bool))
    R = np.stack(rows, axis=1)          # (n, half + 1), ascending per row
    E = np.stack(edges, axis=1)
    V = np.stack(valid, axis=1)
    counts = V.sum(axis=1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = R[V].astype(np.int64)
    edge = E[V]
    is_diag = edge < 0
    pos = np.arange(len(indices), dtype=np.int64)
    return Stencil(grid=(nx, ny, nz), offsets=offs, indptr=indptr,
                   indices=indices, diag_pos=pos[is_diag],
                   off_pos=pos[~is_diag], off_edge=edge[~is_diag])
