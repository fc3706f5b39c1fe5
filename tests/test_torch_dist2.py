"""The port's distributed Cholesky (``parallel/``) against the JAX
package's.

Without spawning: the tree partitions, the modeled scaling table (the
reference's rates passed in), the split plan and every array of the
distributed plan equal the reference's. With ranks: gloo ranks run as
subprocesses of a worker script (the reference's own idiom,
``tests/test_multihost.py``), which keeps JAX out of them; the reference
runs on the 8-device virtual CPU mesh of ``tests/conftest.py``. Both
analyses are built from one permutation."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.parallel import dist as ref_dist
from suitesparse_tpu.parallel import dist2 as ref_dist2
from suitesparse_tpu.parallel import multihost as ref_mh
from suitesparse_tpu.parallel import schedule as ref_schedule
from suitesparse_tpu.symbolic.supernodes import \
    analyze_supernodal as ref_analyze
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal
from suitesparse_tpu_torch.numeric import supernodal_device
from suitesparse_tpu_torch.parallel import dist2, schedule
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_RATES = {"rate_flops": 9.0e11, "ici_bw": 4.5e10, "dcn_bw": 2.5e9}
NX = 7            # laplacian_3d(7) for the ranks
NEG = -50.0       # the diagonal entry that makes the indefinite matrix


def _banded(pkg):
    """The irregular banded matrix of ``tests/test_dist2.py:67-88``."""
    rng = np.random.default_rng(0)
    n = 600
    M = np.diag(4.0 + rng.random(n))
    for k in (1, 7, 30):
        d = rng.random(n - k)
        M += np.diag(d, k) + np.diag(d, -k)
    return pkg.sparse.from_dense(np.triu(M), sym=1)


def _pair(name):
    """(reference matrix and analysis, port matrix and analysis), both from
    the port's permutation."""
    if name == "laplacian_3d_16":
        Aj, A = (pkg.io.fixtures.laplacian_3d(16) for pkg in (sst, sstt))
        p = sstt.ordering.nested_dissection_order(A, sstt.DEFAULT)
    elif name == "banded":
        Aj, A = _banded(sst), _banded(sstt)
        p = sstt.ordering.amd_order(A)
    else:
        nx = int(name.rsplit("_", 1)[1])
        Aj, A = (pkg.io.fixtures.laplacian_3d(nx) for pkg in (sst, sstt))
        p = sstt.ordering.amd_order(A)
    return (Aj, ref_analyze(Aj, p)), (A, analyze_supernodal(A, p))


def _same(a, b, path="") -> None:
    """Deep equality of the plan builders' outputs (arrays exactly; a pair
    class by its four fields)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif hasattr(a, "src_gi"):
        assert (a.src_level, a.src_gi, a.RU_c, a.npairs) == \
            (b.src_level, b.src_gi, b.RU_c, b.npairs), path
    else:
        assert a == b, path


def _same_partition(p, pj) -> None:
    for f in ("own", "top", "dev_fl", "mid_host", "host_fl", "split_key"):
        _same(getattr(p, f), getattr(pj, f), f)
    assert (p.ndev, p.top_fl, p.nhost, p.nchip, p.mid_fl) == \
        (pj.ndev, pj.top_fl, pj.nhost, pj.nchip, pj.mid_fl)


def _same_groups(plan, plan_j) -> None:
    groups = [g for gl in plan.groups for g in gl]
    groups_j = [g for gl in plan_j.groups for g in gl]
    assert [len(gl) for gl in plan.groups] == \
        [len(gl) for gl in plan_j.groups]
    assert plan.dev_size == plan_j.dev_size
    for g, gj in zip(groups, groups_j):
        assert (g.R, g.C, g.B, g.panel_base) == (gj.R, gj.C, gj.B,
                                                 gj.panel_base)
        for f in ("snodes", "asrc", "adst", "nc"):
            _same(getattr(g, f), getattr(gj, f), f)
        _same(g.pairs, gj.pairs, "pairs")
        _same(g._pair_arrays, gj._pair_arrays, "pair arrays")


@pytest.mark.parametrize("name", ["laplacian_3d_16", "banded"])
def test_partitions_equal_the_reference(name):
    (Aj, Sj), (A, S) = _pair(name)
    for nd in (2, 4, 8):
        _same_partition(schedule.partition_tree(S, nd),
                        ref_schedule.partition_tree(Sj, nd))
    for nh, nc in ((2, 2), (2, 4), (4, 2), (1, 4)):
        _same_partition(schedule.partition_tree_topology(S, nh, nc),
                        ref_schedule.partition_tree_topology(Sj, nh, nc))


@pytest.mark.parametrize("name", ["laplacian_3d_16", "banded"])
def test_model_scaling_equals_the_reference_at_its_rates(name):
    (Aj, Sj), (A, S) = _pair(name)
    tops = [(1, 8), (2, 4), (4, 2)]
    assert schedule.model_scaling(S, tops, **REF_RATES) == \
        ref_schedule.model_scaling(Sj, tops, **REF_RATES)
    with pytest.raises(TypeError):
        schedule.model_scaling(S, tops)       # the port states no rate


@pytest.mark.parametrize("topo", [None, (2, 2)])
def test_split_plan_equals_the_reference(topo):
    (Aj, Sj), (A, S) = _pair("laplacian_3d_16")
    if topo is None:
        split = schedule.partition_tree(S, 4).top
    else:
        split = schedule.partition_tree_topology(S, *topo).split_key
    plan = supernodal_device.build_plan(S, A.symperm(S.perm).transpose(),
                                        split_mask=split)
    plan_j = ref_device.build_plan(Sj, Aj.symperm(Sj.perm).transpose(),
                                   split_mask=split)
    _same_groups(plan, plan_j)
    # the default plan is the one without a mask, bit for bit
    base = supernodal_device.build_plan(S, A.symperm(S.perm).transpose())
    zero = supernodal_device.build_plan(
        S, A.symperm(S.perm).transpose(),
        split_mask=np.zeros(S.nsuper, np.int64))
    _same_groups(zero, base)


@pytest.mark.parametrize("name,ndev,topo", [
    ("laplacian_3d_8", 4, None), ("laplacian_3d_8", 4, (2, 2)),
    ("laplacian_3d_8", 8, (2, 4)), ("banded", 4, None)])
def test_dist_plan_arrays_equal_the_reference(name, ndev, topo):
    (Aj, Sj), (A, S) = _pair(name)
    plan, part, dist = dist2.build_dist_plan(
        S, A.symperm(S.perm).transpose(), ndev, topo=topo)
    plan_j, part_j, dist_j = ref_dist2.build_dist_plan(
        Sj, Aj.symperm(Sj.perm).transpose(), ndev, topo=topo)
    _same_groups(plan, plan_j)
    _same_partition(part, part_j)
    _same(dist, dist_j, "dist")
    assert ("v3" in dist) == (topo is not None)


def test_topology_engages_mid_phase():
    """The reference's MID-phase assertions (``tests/test_multihost.py:
    51-71``) on the port's plan: a real host-local phase, and fewer cells
    in the one world sum than the flat schedule's."""
    _ref, (A, S) = _pair("laplacian_3d_8")
    C_low = A.symperm(S.perm).transpose()
    _, _, dist = dist2.build_dist_plan(S, C_low, 8, topo=(2, 4))
    v3 = dist["v3"]
    assert len(v3["mid_dist"]) > 0
    assert v3["f1_cells"] > 0
    _, _, dist_flat = dist2.build_dist_plan(S, C_low, 8)
    assert v3["f0_cells"] < dist_flat["f0_cells"]


def test_topology_partition_invariants():
    """``tests/test_multihost.py:74-92``: a MID snode's children stay on
    its host, and leaf units never cross chips."""
    _ref, (A, S) = _pair("laplacian_3d_12")
    for nh, nc in ((2, 4), (4, 2)):
        p = schedule.partition_tree_topology(S, nh, nc)
        for s in range(S.nsuper):
            pa = int(S.sparent[s])
            if pa < 0:
                continue
            if p.mid_host[pa] >= 0:
                if p.mid_host[s] >= 0:
                    assert p.mid_host[s] == p.mid_host[pa]
                else:
                    assert not p.top[s]
                    assert p.own[s] // p.nchip == p.mid_host[pa]
            if p.own[s] >= 0 and not p.top[pa] and p.mid_host[pa] < 0:
                assert p.own[s] == p.own[pa]


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

_WORKER = r'''
import json, sys
import numpy as np
import torch
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal_device, supernodal_solve
from suitesparse_tpu_torch.parallel import diag, dist2, multihost as mh
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

rank, world, store, out, scenario = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mh.initialize("file://" + store, world, rank, "gloo")
A = sstt.fixtures.laplacian_3d(NX)
S = analyze_supernodal(A, sstt.ordering.amd_order(A))
n = A.ncol
b = 1.0 + np.arange(n) / n
B4 = np.random.default_rng(1).standard_normal((n, 4))
f64 = sstt.DEFAULT.replace(compute_dtype="float64")
res, meta = {}, {}
if scenario == "four":
    for name, (nh, nc) in (("flat", (1, 4)), ("topo", (2, 2))):
        topo = mh.host_chip_mesh(nh, nc, device="cpu")
        F = dist2.dist_factorize_v2(A, S, topo, f64)
        res[name + "_lx"] = F.Lx.numpy()
        res[name + "_lxh"] = F.lx_host()
        res[name + "_x1"] = dist2.dist_solve_v2(F, b, f64)
        res[name + "_x4"] = dist2.dist_solve_v2(F, B4, f64)
        meta[name] = diag.collective_census(F)
        F32 = dist2.dist_factorize_v2(A, S, topo)
        res[name + "_lx32"] = F32.lx_host()
        res[name + "_x32"] = dist2.dist_solve_v2(F32, b)
        meta[name + "_minor"] = int(F.minor)
else:
    neg = int(scenario)
    topo = mh.host_chip_mesh(device="cpu")      # the hostnames: one host
    meta["layout"] = [topo.nhost, topo.nchip]
    F0 = supernodal_device.factorize_device(A, S, device="cpu")
    F = dist2.dist_factorize_v2(A, S, topo)
    res["xd"] = supernodal_solve.solve_device(F, b)
    res["x"] = dist2.dist_solve_v2(F, b)
    seg = sstt.DEFAULT.replace(segment_bytes=200_000)
    F1 = supernodal_device.factorize_device(A, S, seg, device="cpu")
    meta["single_unchanged"] = bool(torch.equal(F0.Lx, F1.Lx)) and \
        F1.dplan.plan is F0.dplan.plan and F.dplan.plan is not F0.dplan.plan
    meta["segments"] = F1.segments
    res["x1"] = supernodal_solve.solve_device(F1, b)
    lo, hi = A.indptr[neg], A.indptr[neg + 1]
    data = A.data.copy()
    data[lo + int(np.flatnonzero(A.indices[lo:hi] == neg)[0])] = NEG
    Ai = sstt.sparse.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, A.sym)
    Fi = dist2.dist_factorize_v2(Ai, S, topo)
    meta["minor"] = int(Fi.minor)
np.savez(f"{out}/rank{rank}.npz", **res)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(meta, f)
print("RANK_OK", rank, flush=True)
'''


def _run_ranks(tmp, world: int, scenario: str) -> list:
    """Run ``world`` gloo ranks of the worker; each rank's (arrays, meta).
    A failing rank fails the test with its output."""
    worker = tmp / "worker.py"
    worker.write_text(_WORKER.replace("NX)", f"{NX})").replace(
        "= NEG", f"= {NEG}"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(store),
         str(tmp), scenario], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp))
        for r in range(world)]
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
    ranks = []
    for r in range(world):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append((dict(np.load(tmp / f"rank{r}.npz")), json.load(f)))
    return ranks


def _ref_mesh(nd, topo=None):
    devs = jax.devices()
    assert len(devs) >= nd
    if topo is None:
        return ref_dist.make_solver_mesh(devs[:nd])
    return ref_mh.host_chip_mesh(devs[:nd], *topo)


@pytest.fixture(scope="module")
def problem():
    return _pair(f"laplacian_3d_{NX}")


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's distributed factor (fp64) and solves, flat 4 and
    (2, 2), on the virtual mesh."""
    (Aj, _), (A, S) = problem
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    B4 = np.random.default_rng(1).standard_normal((n, 4))
    f64 = sst.DEFAULT.replace(compute_dtype="float64")
    out = {}
    for name, topo in (("flat", None), ("topo", (2, 2))):
        Sj = ref_analyze(Aj, S.perm)
        Fj = ref_dist2.dist_factorize_v2(Aj, Sj, _ref_mesh(4, topo), f64)
        out[name] = (np.asarray(Fj.Lx), ref_dist2.dist_solve_v2(Fj, b, f64),
                     ref_dist2.dist_solve_v2(Fj, B4, f64))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("four"), 4, "four")


def _neg_column(S) -> int:
    """An original column in a leaf subtree of rank 1 (two ranks)."""
    part = schedule.partition_tree(S, 2)
    s = int(np.flatnonzero(part.own == 1)[0])
    return int(S.perm[S.super_first[s]])


def _indefinite(pkg, nx: int, col: int):
    A = pkg.io.fixtures.laplacian_3d(nx)
    lo, hi = A.indptr[col], A.indptr[col + 1]
    data = A.data.copy()
    data[lo + int(np.flatnonzero(A.indices[lo:hi] == col)[0])] = NEG
    return pkg.sparse.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, A.sym)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, problem):
    _ref, (A, S) = problem
    return _run_ranks(tmp_path_factory.mktemp("two"), 2,
                      str(_neg_column(S)))


@pytest.mark.parametrize("name", ["flat", "topo"])
def test_four_rank_factor_matches_the_reference(four_ranks, reference,
                                                problem, name):
    _ref, (A, S) = problem
    lx_ref, x1_ref, x4_ref = reference[name]
    host = supernodal.factorize_host(A, S).Lx
    r0 = four_ranks[0][0]
    for arrays, meta in four_ranks:
        # fp64: the reference's distributed factor, the host factor
        lx = arrays[f"{name}_lx"]
        assert lx.shape == lx_ref.shape
        assert np.abs(lx - lx_ref).max() <= 1e-10 * np.abs(lx_ref).max()
        assert np.array_equal(lx, r0[f"{name}_lx"])       # every rank
        assert np.abs(arrays[f"{name}_lxh"] - host).max() <= \
            1e-10 * np.abs(host).max()
        assert meta[f"{name}_minor"] == S.n
        # the solve at nrhs 1 and 4
        for got, ref in ((arrays[f"{name}_x1"], x1_ref),
                         (arrays[f"{name}_x4"], x4_ref)):
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
        assert np.array_equal(arrays[f"{name}_x1"], r0[f"{name}_x1"])
        # fp32 at the default config
        assert np.abs(arrays[f"{name}_lx32"] - host).max() <= \
            1e-5 * np.abs(host).max()
        b = 1.0 + np.arange(A.ncol) / A.ncol
        assert sstt.residual_norm(A, arrays[f"{name}_x32"], b) < 1e-5


def test_four_rank_census(four_ranks):
    for _arrays, meta in four_ranks:
        flat, topo = meta["flat"], meta["topo"]
        assert {k: (v["group"], v["ranks"], v["count"])
                for k, v in flat["factor"].items()} == \
            {"halo": ("world", 4, 1), "assembly": ("world", 4, 1)}
        assert {k: (v["group"], v["ranks"], v["count"])
                for k, v in topo["factor"].items()} == \
            {"mid_halo": ("host", 2, 1), "crown_halo": ("world", 4, 1),
             "assembly": ("world", 4, 1)}
        for c in (flat, topo):
            assert {k: (v["group"], v["count"])
                    for k, v in c["solve"].items()} == \
                {"solve_up": ("world", 1), "solve_x": ("world", 1)}
        # the (host, chip) schedule sums fewer cells over the world
        assert topo["factor"]["crown_halo"]["bytes"] < \
            flat["factor"]["halo"]["bytes"]


def test_two_ranks_solve_device_and_single_card_factor(two_ranks, problem):
    _ref, (A, S) = problem
    b = 1.0 + np.arange(A.ncol) / A.ncol
    for arrays, meta in two_ranks:
        assert meta["layout"] == [1, 2]          # both ranks on one host
        assert sstt.residual_norm(A, arrays["xd"], b) < 1e-5
        assert sstt.residual_norm(A, arrays["x"], b) < 1e-5
        assert np.abs(arrays["x"] - arrays["xd"]).max() <= \
            1e-5 * np.abs(arrays["xd"]).max()
        # a single-card factor of the same S after the distributed one:
        # its own plan, the same bits (in segments), a good solve
        assert meta["single_unchanged"] and meta["segments"] > 1
        assert sstt.residual_norm(A, arrays["x1"], b) < 1e-5


def test_two_ranks_indefinite_minor(two_ranks, problem):
    (Aj, _Sj), (A, S) = problem
    col = _neg_column(S)
    Sj = ref_analyze(Aj, S.perm)
    Fj = ref_dist2.dist_factorize_v2(_indefinite(sst, NX, col), Sj,
                                     _ref_mesh(2))
    Fh = supernodal.factorize_host(_indefinite(sstt, NX, col), S)
    assert Fj.minor == Fh.minor < S.n
    assert [meta["minor"] for _a, meta in two_ranks] == [Fj.minor] * 2
