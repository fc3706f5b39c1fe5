"""HPCG's matrix: the 27-point stencil on an nx x ny x nz local grid.

As HPCG 3.1's GenerateProblem builds it: diagonal 26 in every row, -1 to
each of the up to 26 neighbours inside the grid (boundary rows have fewer,
so they are strictly diagonally dominant). Published values are every edge
weight 1.
"""

from bench_port import stencil

POINTS = 27


def build(config: dict) -> stencil.Stencil:
    return stencil.build((config["nx"], config["ny"], config["nz"]), POINTS)
