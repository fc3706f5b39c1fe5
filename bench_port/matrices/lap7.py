"""The 7-point finite-difference Poisson matrix on an nx x ny x nz grid.

Diagonal 6, couplings -1 to the six face neighbours, Dirichlet boundary
(the boundary rows keep the diagonal 6): hypre's ``ij -laplacian``
(``BuildParLaplacian``), the nested-dissection model problem. Published
values are every edge weight 1.
"""

from bench_port import stencil

POINTS = 7


def build(config: dict) -> stencil.Stencil:
    return stencil.build((config["nx"], config["ny"], config["nz"]), POINTS)
