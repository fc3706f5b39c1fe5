"""Multi-device distribution of the supernodal Cholesky on
``torch.distributed``.

Port of :mod:`suitesparse_tpu.parallel`, in two designs, both SPMD by
rank:

* the elimination tree as the distribution structure (subtree-per-rank
  tree parallelism, a separator crown summed once and factored on every
  rank), in a flat schedule or a (host, chip) one: :mod:`.schedule` cuts
  the tree, :mod:`.dist2` runs the factor and the solve, :mod:`.multihost`
  launches the ranks (:func:`.multihost.global_solver_mesh` is the flat
  topology's entry point);
* the single-card plan sharded over a (tree, panel) mesh (:mod:`.dist`):
  groups of many fronts split by slots over the tree axis, the big root
  fronts split by rows over the panel axis, the rest replicated.

:mod:`.diag` counts the sums of both.
"""

from .diag import collective_census
from .dist import SolverMesh, dist_factorize_device, make_solver_mesh
from .dist2 import build_dist_plan, dist_factorize_v2, dist_solve_v2
from .multihost import (Topology, factorize, global_solver_mesh,
                        host_chip_mesh, initialize, solve)
from .schedule import (TreePartition, model_scaling, partition_tree,
                       partition_tree_topology)

__all__ = ["SolverMesh", "Topology", "TreePartition", "build_dist_plan",
           "collective_census", "dist_factorize_device", "dist_factorize_v2",
           "dist_solve_v2", "factorize", "global_solver_mesh",
           "host_chip_mesh", "initialize", "make_solver_mesh",
           "model_scaling", "partition_tree", "partition_tree_topology",
           "solve"]
