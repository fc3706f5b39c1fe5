"""The port's sharded (tree, panel) factor (``parallel/dist.py``) against
the JAX package's ``parallel/dist.py``.

Without spawning: the mesh's default split, each group's axis (the
reference's ``_make_cstr`` choice, read through a patched
``with_sharding_constraint``) and the tree ranges. With ranks: four gloo
ranks run as subprocesses of a worker script (the idiom of
``tests/test_torch_dist2.py``), which keeps JAX out of them; they factor
``laplacian_3d(16)`` in fp64 at (2, 2), (4, 1) and (1, 4), and an
indefinite copy at (2, 2). The reference runs once, at (2, 2) on the
8-device virtual CPU mesh of ``tests/conftest.py``; its factor is the
reference's single-card factor bit for bit, so it serves all three."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import suitesparse_tpu as sst
from suitesparse_tpu.parallel import dist as ref_dist
from suitesparse_tpu.symbolic.supernodes import \
    analyze_supernodal as ref_analyze
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal_device
from suitesparse_tpu_torch.parallel import dist
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = 16            # the smallest Laplacian whose plan has panel-axis groups
NEG = -50.0        # the diagonal entry that makes the indefinite matrix
MESHES = [(2, 2), (4, 1), (1, 4)]
LX_TOL = 1e-12     # fp64, relative to max|Lx|
RESID_TOL = 1e-12


def _perm(A):
    return sstt.ordering.nested_dissection_order(A, sstt.DEFAULT)


@pytest.fixture(scope="module")
def problem():
    A = sstt.fixtures.laplacian_3d(NX)
    S = analyze_supernodal(A, _perm(A))
    return A, S


def _plan(A, S):
    return supernodal_device.device_plan(A, S, "cpu").plan


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8])
def test_default_split_equals_the_reference(world):
    shape = ref_dist.make_solver_mesh(jax.devices()[:world]).shape
    assert dist._split(world) == (shape["tree"], shape["panel"])
    assert dist._split(world, 1, world) == (1, world)
    with pytest.raises(ValueError):
        dist._split(world, world + 1, 1)


def test_mesh_without_process_group():
    m = dist.make_solver_mesh(device="cpu")
    assert (m.tree, m.panel, m.rank, m.t, m.p, m.world) == (1, 1, 0, 0, 0, 1)
    assert m.tree_group is None and m.panel_group is None
    with pytest.raises(ValueError):
        dist.make_solver_mesh(2, 1, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_mesh_defaults_to_cuda():
    """No device named: the rank's card, which raises without one."""
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.make_solver_mesh()


@pytest.mark.parametrize("rows", [dist.PANEL_ROWS, 64])
def test_group_axes_equal_make_cstr(problem, monkeypatch, rows):
    A, S = problem
    seen = []

    def constraint(F, sharding):
        seen.append(tuple(sharding.spec))
        return F

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", constraint)
    cstr = ref_dist._make_cstr(ref_dist.make_solver_mesh(jax.devices()[:4]),
                               rows)
    want = {("tree", None, None): "tree", (None, "panel", None): "panel"}
    axes = []
    for g in (g for gl in _plan(A, S).groups for g in gl):
        n = len(seen)
        cstr(g, None)
        ref = want[seen[-1]] if len(seen) > n else None
        assert dist._axis(g, rows) == ref
        axes.append(ref)
    assert axes.count("tree") and axes.count("panel") and axes.count(None)


@pytest.mark.parametrize("tree", [1, 2, 3, 4, 8])
def test_tree_ranges_cover_each_group_once(problem, tree):
    A, S = problem
    for g in (g for gl in _plan(A, S).groups for g in gl):
        hits = np.zeros(g.B, np.int64)
        for t in range(tree):
            lo, hi = dist._range(g.B, tree, t)
            assert 0 <= lo <= hi <= g.B
            hits[lo:hi] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("tree,panel", [(2, 2), (1, 4), (4, 1)])
def test_share_arrays_rebuild_the_group(problem, tree, panel):
    """Every tree group's shares hold each of its A entries and each of
    its pairs exactly once, renumbered to the share's slots."""
    A, S = problem
    for g in (g for gl in _plan(A, S).groups for g in gl):
        if dist._axis(g, dist.PANEL_ROWS) != "tree":
            continue
        adst, npairs = [], 0
        for t in range(tree):
            lo, hi = dist._range(g.B, tree, t)
            if hi == lo:
                continue
            ix = dist._share_arrays(g, lo, hi)
            assert ix.nc.flatten().tolist() == g.nc[lo:hi].tolist()
            adst.append(ix.adst.numpy() + lo * g.R * g.R)
            if ix.k7_all is not None:
                assert ix.k7_all.B == hi - lo
                npairs += ix.k7_all.dst.size
        assert np.array_equal(np.concatenate(adst), g.adst)
        assert npairs == sum(pc.npairs for pc in g.pairs)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

_WORKER = r'''
import json, sys
import numpy as np
import torch
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal_solve
from suitesparse_tpu_torch.parallel import diag, dist, multihost as mh
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

rank, world, store, out, neg = sys.argv[1:6]
rank, world, neg = int(rank), int(world), int(neg)
torch.set_num_threads(1)
mh.initialize("file://" + store, world, rank, "gloo")
A = sstt.fixtures.laplacian_3d(NX)
S = analyze_supernodal(A, sstt.ordering.nested_dissection_order(
    A, sstt.DEFAULT))
f64 = sstt.DEFAULT.replace(compute_dtype="float64")
b = 1.0 + np.arange(A.ncol) / A.ncol
res, meta = {}, {}
for tree, panel in MESHES:
    name = f"{tree}x{panel}"
    mesh = dist.make_solver_mesh(tree, panel, device="cpu")
    F = dist.dist_factorize_device(A, S, mesh, f64)
    res[name + "_lx"] = F.Lx.numpy()
    res[name + "_x"] = supernodal_solve.solve_device(F, b, f64)
    meta[name] = {"minor": int(F.minor), "tp": [mesh.t, mesh.p],
                  "census": diag.collective_census(F)["factor"],
                  "axes": [st.axis for st in F.dist.plan.steps]}
lo, hi = A.indptr[neg], A.indptr[neg + 1]
data = A.data.copy()
data[lo + int(np.flatnonzero(A.indices[lo:hi] == neg)[0])] = NEG
Ai = sstt.sparse.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, A.sym)
meta["neg_minor"] = int(dist.dist_factorize_device(
    Ai, S, dist.make_solver_mesh(2, 2, device="cpu")).minor)
np.savez(f"{out}/rank{rank}.npz", **res)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(meta, f)
print("RANK_OK", rank, flush=True)
'''


def _neg_column(S) -> int:
    """An original column in a slot that rank (1, 0) of a (2, 2) mesh
    factors: the first tree-sharded group's last slot."""
    plan_groups = [(d, g) for d, gl in enumerate(
        supernodal_device.device_plan(sstt.fixtures.laplacian_3d(NX), S,
                                      "cpu").plan.groups) for g in gl]
    _d, g = next((d, g) for d, g in plan_groups
                 if dist._axis(g, dist.PANEL_ROWS) == "tree")
    s = int(g.snodes[g.B - 1])
    return int(S.perm[S.super_first[s]])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, problem):
    """Four gloo ranks of the worker; each rank's (arrays, meta)."""
    _A, S = problem
    tmp = tmp_path_factory.mktemp("mesh")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER.replace("(NX)", f"({NX})")
                      .replace("= NEG", f"= {NEG}")
                      .replace("in MESHES", f"in {MESHES}"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "4", str(tmp / "store"),
         str(tmp), str(_neg_column(S))], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp))
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, \
            f"rank {r} failed:\n{out[-3000:]}"
    out = []
    for r in range(4):
        with open(tmp / f"rank{r}.json") as f:
            out.append((dict(np.load(tmp / f"rank{r}.npz")), json.load(f)))
    return out


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's sharded factor (fp64) at (2, 2) on the virtual
    mesh, from the port's permutation."""
    A, S = problem
    Aj = sst.io.fixtures.laplacian_3d(NX)
    Sj = ref_analyze(Aj, S.perm)
    mesh = ref_dist.make_solver_mesh(jax.devices()[:4], 2, 2)
    Fj = ref_dist.dist_factorize_device(
        Aj, Sj, mesh, sst.DEFAULT.replace(compute_dtype="float64"))
    return np.asarray(Fj.Lx), Fj.minor


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_factor_matches_the_reference(ranks, reference, problem, mesh):
    A, S = problem
    lx_ref, minor_ref = reference
    assert minor_ref == S.n
    name = f"{mesh[0]}x{mesh[1]}"
    r0 = ranks[0][0][name + "_lx"]
    b = 1.0 + np.arange(A.ncol) / A.ncol
    tps = set()
    for arrays, meta in ranks:
        lx = arrays[name + "_lx"]
        assert lx.shape == lx_ref.shape
        assert np.abs(lx - lx_ref).max() <= LX_TOL * np.abs(lx_ref).max()
        assert np.array_equal(lx, r0)                  # every rank
        assert meta[name]["minor"] == S.n
        assert sstt.residual_norm(A, arrays[name + "_x"], b) < RESID_TOL
        tps.add(tuple(meta[name]["tp"]))
        assert meta[name]["axes"].count("panel") > 0
    assert tps == {(t, p) for t in range(mesh[0]) for p in range(mesh[1])}


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_census(ranks, problem, mesh):
    """The sums each rank made: a tree gather a tree group with a parent
    (not at tree 1), an L21 and a U gather a panel group (not at panel
    1), one world assembly sum."""
    A, S = problem
    name = f"{mesh[0]}x{mesh[1]}"
    axes = ranks[0][1][name]["axes"]
    plan = _plan(A, S)
    groups = [g for gl in plan.groups for g in gl]
    n_tree = sum(ax == "tree" and g.R > g.C
                 for ax, g in zip(axes, groups))
    n_panel = sum(ax == "panel" and g.R > g.C
                  for ax, g in zip(axes, groups))
    for _arrays, meta in ranks:
        got = {k: (v["group"], v["ranks"], v["count"])
               for k, v in meta[name]["census"].items()}
        want = {"assembly": ("world", 4, 1),
                "tree_u": ("tree", mesh[0], n_tree),
                "panel_l21": ("panel", mesh[1], n_panel),
                "panel_u": ("panel", mesh[1], n_panel)}
        assert got == want


def test_mesh_indefinite_minor(ranks, problem):
    A, S = problem
    col = _neg_column(S)
    lo, hi = A.indptr[col], A.indptr[col + 1]
    data = A.data.copy()
    data[lo + int(np.flatnonzero(A.indices[lo:hi] == col)[0])] = NEG
    Ai = sstt.sparse.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, A.sym)
    single = supernodal_device.factorize_device(Ai, S, device="cpu").minor
    assert single < S.n
    assert [meta["neg_minor"] for _a, meta in ranks] == [single] * 4
