"""Multi-device distribution of the supernodal Cholesky on
``torch.distributed``.

Port of :mod:`suitesparse_tpu.parallel`: the elimination tree is the
distribution structure (subtree-per-rank tree parallelism, a separator
crown summed once and factored on every rank), in a flat schedule or a
(host, chip) one. :mod:`.schedule` cuts the tree, :mod:`.dist2` runs the
factor and the solve, :mod:`.multihost` launches the ranks, :mod:`.diag`
counts the sums. The reference's ``dist.py`` (GSPMD sharding hints on the
single-chip plan, numerically the single-device path) is not ported; the
flat topology's entry point is :func:`.multihost.global_solver_mesh`.
"""

from .diag import collective_census
from .dist2 import build_dist_plan, dist_factorize_v2, dist_solve_v2
from .multihost import (Topology, factorize, global_solver_mesh,
                        host_chip_mesh, initialize, solve)
from .schedule import (TreePartition, model_scaling, partition_tree,
                       partition_tree_topology)

__all__ = ["Topology", "TreePartition", "build_dist_plan",
           "collective_census", "dist_factorize_v2", "dist_solve_v2",
           "factorize", "global_solver_mesh", "host_chip_mesh",
           "initialize", "model_scaling", "partition_tree",
           "partition_tree_topology", "solve"]
