"""The port's surface against the JAX package's, read from the sources.

An AST walk over both packages, no imports: every module of
``suitesparse_tpu`` has a module at the mirror path of
``suitesparse_tpu_torch``, and every public top-level function and class
of it, every public method and attribute of such a class, every field of
such a dataclass, and every public parameter of those functions and
methods exists there too. A name the port binds by an import (a
re-export) or by an assignment counts as there. What the port leaves out
by design is listed in ``NOT_PORTED``, one reason a line; an entry that no
longer names a gap fails the test too, so the list stays true.
"""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "suitesparse_tpu")
PORT = os.path.join(REPO, "suitesparse_tpu_torch")

_UNREAD = "a reference Config field that no code of the reference reads"
_LAYOUT = ("a TPU layout helper (lane-major padding, a VMEM budget); each "
           "CUDA kernel has its own launch plan and gate")
_INTERPRET = ("Pallas interpret mode; the port's wrapper takes its plain "
              "version on a CPU tensor")
_FP32_GATE = ("a VMEM budget by element size; the CUDA kernel is fp32 only "
              "and its caller gates the dtype")
_TORCH_DIST = ("a jax mesh or device list; torch.distributed ranks and "
               "multihost.Topology take its place")
_PX_FIELDS = ("a px-layout field of the reference's one solve plan; the "
              "port's px plan is PxPlan")
_PLACEMENT = ("the reference's per-class placement routes (one-hot "
              "matmuls); K7 places every class on the card")

NOT_PORTED = {
    **{f"config.py:Config.{f}": _UNREAD for f in (
        "accum_dtype", "grow_ratio", "leaf_batch", "lu_memgrow",
        "nd_components", "nd_oksep", "panel_pad", "sublane_pad",
        "umf_block_size", "umf_pivot_tol", "umf_sym_pivot_tol",
        "use_pallas")},
    "symbolic/etree.py:postorder(weights)": "the reference ignores it",
    "sparse.py:CSC.permuted(values)":
        "the reference ignores it: C carries A's values either way",
    "native/__init__.py:etree(ata)":
        "the column etree of A'A takes the port's nrow argument",
    "native/__init__.py:col_counts(ata)":
        "the column counts of A'A take the port's nrow argument",
    "kernels/bmatvec.py:bmv_fits(B)": _FP32_GATE,
    "kernels/bmatvec.py:bmv_fits(itemsize)": _FP32_GATE,
    "kernels/bmatvec.py:bmv_pad": _LAYOUT,
    "kernels/bmatvec.py:bmv_group_geom": _LAYOUT,
    "kernels/bmatvec.py:bmatvec_t": "renamed: bmatvec(..., transpose=True)",
    "kernels/extend_add.py:extend_add(child)":
        "renamed U: K7 reads the child update block, with src in the "
        "factor's form",
    "kernels/extend_add.py:extend_add(interpret)": _INTERPRET,
    "kernels/extend_add_tiles.py:extend_add_tiles(interpret)": _INTERPRET,
    "kernels/pmatvec.py:pmv_pad": _LAYOUT,
    "kernels/pmatvec.py:pmv_fits": _LAYOUT,
    "kernels/pmatvec.py:pmatvec_t(interpret)": _INTERPRET,
    "kernels/potrf.py:lane_block": _LAYOUT,
    "kernels/potrf.py:kernel_fits": _LAYOUT,
    "kernels/potrf.py:batched_potrf_trsm": "renamed: potrf.potrf_trsm",
    "kernels/potrf.py:batched_potrf": "renamed: potrf.potrf_trsm",
    "kernels/solve_step.py:step_fits(itemsize)": _FP32_GATE,
    "kernels/solve_step.py:solve_step_fwd(interpret)": _INTERPRET,
    "kernels/solve_step.py:solve_step_bwd(interpret)": _INTERPRET,
    "kernels/trisolve.py:trisolve_fits(dtype)": _FP32_GATE,
    "kernels/trisolve.py:batched_trisolve(interpret)": _INTERPRET,
    "parallel/diag.py:census_from_hlo":
        "parses XLA's HLO; collective_census reads the port's own record "
        "of each sum",
    "parallel/diag.py:collective_census(S)":
        "the census reads the factor's record of its sums, not a compiled "
        "program",
    "parallel/diag.py:collective_census(A)":
        "the census reads the factor's record of its sums, not a compiled "
        "program",
    "parallel/diag.py:collective_census(mesh)": _TORCH_DIST,
    "parallel/dist.py:make_solver_mesh(devices)": _TORCH_DIST,
    "parallel/dist2.py:dist_factorize_v2(mesh)": _TORCH_DIST,
    "parallel/dist2.py:dist_factorize_v2(topology)": _TORCH_DIST,
    "parallel/multihost.py:initialize(coordinator_address)":
        "jax.distributed's; torch.distributed takes init_method",
    "parallel/multihost.py:initialize(num_processes)":
        "jax.distributed's; torch.distributed takes world_size",
    "parallel/multihost.py:initialize(process_id)":
        "jax.distributed's; torch.distributed takes rank",
    "parallel/multihost.py:initialize(kw)":
        "jax.distributed's extra arguments; the port takes backend and "
        "timeout",
    "parallel/multihost.py:host_chip_mesh(devices)": _TORCH_DIST,
    "parallel/multihost.py:global_solver_mesh(tree)":
        "the flat topology of all ranks; the (tree, panel) mesh is "
        "dist.make_solver_mesh",
    "parallel/multihost.py:global_solver_mesh(panel)":
        "the flat topology of all ranks; the (tree, panel) mesh is "
        "dist.make_solver_mesh",
    "parallel/multihost.py:factorize(mesh)": _TORCH_DIST,
    "numeric/mfqr_device.py:QRGroupPlan.rhs_onehot":
        "a one-hot matmul placement; the port gathers",
    "numeric/segmented.py:estimate_qr_group_cells":
        "the reference's cell-count switch; the port's counts bytes "
        "(segmented.segments)",
    "numeric/segmented.py:qrplan_total_cells":
        "the reference's cell-count switch; the port's counts bytes "
        "(segmented.segments)",
    "numeric/segmented.py:run_qrplan_segmented":
        "the reference's cell-count switch; the port's counts bytes "
        "(segmented.segments)",
    "numeric/supernodal.py:SupernodalFactor.layout":
        "one class per layout: SupernodalFactor (host px), "
        "TorchSupernodalFactor, TorchPxFactor",
    "numeric/supernodal_device.py:PairClass.strategy": _PLACEMENT,
    "numeric/supernodal_device.py:PairClass.T": _PLACEMENT,
    "numeric/supernodal_device.py:PairClass.B_c": _PLACEMENT,
    "numeric/supernodal_device.py:plan_arrays":
        "flattened the index arrays into one jitted program's arguments",
    "numeric/supernodal_solve.py:build_winv(nrhs)":
        "W2 is build_w2's and W build_winv's, one state for every nrhs; "
        "w2_route and inv_route pick the code per call",
    "numeric/supernodal_solve.py:build_winv(w2)":
        "W2 is build_w2's and W build_winv's, one state for every nrhs; "
        "w2_route and inv_route pick the code per call",
    "numeric/supernodal_solve.py:SolveGroup.panel_src": _PX_FIELDS,
    "numeric/supernodal_solve.py:SolveGroup.below_idx": _PX_FIELDS,
    "numeric/supernodal_solve.py:SolvePlan.n": _PX_FIELDS,
    "numeric/supernodal_solve.py:SolvePlan.lx_size": _PX_FIELDS,
    "numeric/supernodal_solve.py:SolvePlan.layout": _PX_FIELDS,
    "numeric/supernodal_solve.py:build_solve_plan(layout)": _PX_FIELDS,
    "numeric/supernodal_solve.py:solve_refined":
        "renamed: the top-level suitesparse_tpu_torch.solve_refined",
}


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [p for p in names if not p.startswith("_")]


def _is_dataclass(cls) -> bool:
    return any("dataclass" in ast.unparse(d) for d in cls.decorator_list)


def _bound(nodes) -> set:
    """Names a block of statements binds: assignments and imports."""
    out = set()
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                out.add(n.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                out.update((a.asname or a.name).split(".")[0]
                           for a in n.names)
    return out


def _surface(path):
    """({name: params} of the top-level functions, {name: (methods
    {name: params}, fields, other bound names)} of the classes, every
    name the module binds at its top level)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    funcs, classes = {}, {}
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, defs):
            funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            body = node.body
            methods = {b.name: _params(b) for b in body
                       if isinstance(b, defs)}
            fields = [b.target.id for b in body
                      if isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)
                      and _is_dataclass(node)]
            others = _bound(b for b in body if not isinstance(b, defs))
            classes[node.name] = (methods, fields, others)
    top = set(funcs) | set(classes) | _bound(
        n for n in tree.body
        if not isinstance(n, defs + (ast.ClassDef,)))
    return funcs, classes, top


def _public(name) -> bool:
    return not name.startswith("_")


def _gaps() -> set:
    gaps = set()
    for root, _dirs, files in os.walk(REF):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), REF)
            port_path = os.path.join(PORT, rel)
            if not os.path.exists(port_path):
                gaps.add(rel)
                continue
            rfuncs, rclasses, _ = _surface(os.path.join(root, f))
            pfuncs, pclasses, ptop = _surface(port_path)
            for name, params in rfuncs.items():
                if not _public(name):
                    continue
                if name not in pfuncs:
                    if name not in ptop:
                        gaps.add(f"{rel}:{name}")
                    continue
                gaps.update(f"{rel}:{name}({p})" for p in params
                            if p not in pfuncs[name])
            for name, (methods, fields, _o) in rclasses.items():
                if not _public(name):
                    continue
                if name not in pclasses:
                    if name not in ptop:
                        gaps.add(f"{rel}:{name}")
                    continue
                pmethods, pfields, pothers = pclasses[name]
                members = set(pmethods) | set(pfields) | pothers
                for m, params in methods.items():
                    if not _public(m):
                        continue
                    if m not in members:
                        gaps.add(f"{rel}:{name}.{m}")
                    elif m in pmethods:
                        gaps.update(f"{rel}:{name}.{m}({p})" for p in params
                                    if p not in pmethods[m])
                gaps.update(f"{rel}:{name}.{fl}" for fl in fields
                            if _public(fl) and fl not in members)
    return gaps


def test_port_has_the_reference_surface():
    gaps = _gaps()
    missing = sorted(gaps - set(NOT_PORTED))
    stale = sorted(set(NOT_PORTED) - gaps)
    assert not missing, f"the port lacks {missing}"
    assert not stale, f"NOT_PORTED names what the port has: {stale}"
    assert all(isinstance(r, str) and r for r in NOT_PORTED.values())
