"""The port's constrained and partition orderings, Dulmage-Mendelsohn,
the collection cache, the coverage tracker, and the etree and sparse
helpers against the JAX package's.

Where both packages run their C++ libraries (the same sources), the
permutations, constraint sets and partitions must be equal; the numpy
helpers must give equal arrays. The reference's native library is loaded
first (``_reference_native``: a pytest-xdist worker can lose its build
race and would otherwise compare the reference's Python orderings)."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import suitesparse_tpu as sst
import suitesparse_tpu.ordering as ref_ordering
from suitesparse_tpu import coverage as ref_coverage
from suitesparse_tpu import sparse as ref_sparse
from suitesparse_tpu.io import collection as ref_collection
from suitesparse_tpu.ordering import dmperm as ref_dmperm
import suitesparse_tpu_torch as sstt
import suitesparse_tpu_torch.ordering as ordering
from suitesparse_tpu_torch import coverage, native, sparse
from suitesparse_tpu_torch.io import collection
from suitesparse_tpu_torch.ordering import dmperm

# the modules (each package's symbolic/__init__ exports a function etree)
ref_etree = importlib.import_module("suitesparse_tpu.symbolic.etree")
etree = importlib.import_module("suitesparse_tpu_torch.symbolic.etree")

from test_torch_host import REPO, _reference_native

PROBLEMS = {
    "lap3d_8": lambda pkg: pkg.io.fixtures.laplacian_3d(8),
    "lap2d_20": lambda pkg: pkg.io.fixtures.laplacian_2d(20),
    "fem_400": lambda pkg: pkg.io.fixtures.fem_mesh_spd(400, seed=3),
}


@pytest.fixture(params=sorted(PROBLEMS))
def pair(request):
    _reference_native()
    make = PROBLEMS[request.param]
    return make(sstt), make(sst)


def _is_perm(p, n):
    return np.array_equal(np.sort(p), np.arange(n))


def test_symmetric_orderings_equal_the_reference(pair):
    A, Aj = pair
    n = A.ncol
    cset = (np.arange(n) * 7 // n).astype(np.int64)
    for name, args in (("natural_order", ()), ("symamd_order", ()),
                       ("camd_order", (cset,)), ("csymamd_order", (cset,))):
        p = getattr(ordering, name)(A, *args)
        pj = getattr(ref_ordering, name)(Aj, *args)
        assert _is_perm(p, n) and np.array_equal(p, pj), name
        if args:                  # the sets stay contiguous and ascending
            assert np.all(np.diff(cset[p]) >= 0)
    perm, cm = ordering.nesdis_order(A)
    permj, cmj = ref_ordering.nesdis_order(Aj)
    assert np.array_equal(perm, permj) and np.array_equal(cm, cmj)
    assert _is_perm(perm, n) and np.all(np.diff(cm[perm]) >= 0)


@pytest.mark.parametrize("m,n,seed", [(120, 80, 1), (300, 300, 2)])
def test_ccolamd_equals_the_reference(m, n, seed):
    _reference_native()
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.05)
    D[np.arange(n), np.arange(n)] += 3.0
    r, c = np.nonzero(D)
    A = sstt.from_triplets(m, n, r, c, D[r, c])
    Aj = sst.from_triplets(m, n, r, c, D[r, c])
    for cset in (np.arange(n) % 4, np.zeros(n, dtype=np.int64)):
        q = ordering.ccolamd_order(A, cset)
        assert np.array_equal(q, ref_ordering.ccolamd_order(Aj, cset))
        assert _is_perm(q, n) and np.all(np.diff(cset[q]) >= 0)
    assert np.array_equal(ordering.ccolamd_order(A, np.zeros(n, np.int64)),
                          ordering.colamd_order(A))


def test_partitions_equal_the_reference(pair):
    A, Aj = pair
    for split in (0.5, 0.25):
        ec = ordering.edge_cut(A, target_split=split)
        ecj = ref_ordering.edge_cut(Aj, target_split=split)
        assert np.array_equal(ec.partition, ecj.partition)
        assert (ec.cut_size, ec.imbalance) == (ecj.cut_size, ecj.imbalance)
    for k in (3, 4):
        pk = ordering.partition_kway(A, k)
        pkj = ref_ordering.partition_kway(Aj, k)
        assert np.array_equal(pk.partition, pkj.partition)
        assert np.bincount(pk.partition, minlength=k).min() > 0


def test_python_fallbacks_equal_the_reference(monkeypatch):
    """Without the library's entry points the constrained orderings and the
    edge cut take the reference's Python fallbacks, with its results."""
    from suitesparse_tpu import native as ref_native

    A, Aj = (pkg.io.fixtures.laplacian_2d(9) for pkg in (sstt, sst))
    cset = (np.arange(A.ncol) >= 40).astype(np.int64)
    monkeypatch.setattr(native, "has", lambda name: False)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(ref_native, "has", lambda name: False)
    monkeypatch.setattr(ref_native, "available", lambda: False)
    p = ordering.camd_order(A, cset)
    assert np.array_equal(p, ref_ordering.camd_order(Aj, cset))
    assert np.all(np.diff(cset[p]) >= 0)
    perm, cm = ordering.nesdis_order(A, sstt.DEFAULT.replace(nd_small=20))
    permj, cmj = ref_ordering.nesdis_order(Aj, sst.DEFAULT.replace(
        nd_small=20))
    assert np.array_equal(perm, permj) and np.array_equal(cm, cmj)
    ec, ecj = ordering.edge_cut(A), ref_ordering.edge_cut(Aj)
    assert np.array_equal(ec.partition, ecj.partition)
    assert np.array_equal(ordering.ccolamd_order(A, cset),
                          ref_ordering.ccolamd_order(Aj, cset))


def test_native_entry_points_are_built_and_rebuilt_on_a_source_change(
        tmp_path):
    """``sstpu_camd``, ``sstpu_nested_dissection_sets`` and
    ``sstpu_edgecut`` are in the port's library, and the build's stamp is
    the hash of the sources: a copy of the sources with one byte more
    hashes differently, so the library is rebuilt."""
    for name in ("sstpu_camd", "sstpu_nested_dissection_sets",
                 "sstpu_edgecut", "sstpu_nested_dissection"):
        assert native.has(name)
    with open(native.STAMP_PATH) as f:
        assert f.read().strip() == native.source_hash()
    src = native.SRC_DIR
    import shutil
    copy = tmp_path / "src"
    shutil.copytree(src, copy)
    with open(copy / "nd.cc", "a") as f:
        f.write("\n")
    saved = native.SRC_DIR
    try:
        native.SRC_DIR = str(copy)
        assert native.source_hash() != open(native.STAMP_PATH).read().strip()
    finally:
        native.SRC_DIR = saved


@pytest.mark.parametrize("seed", range(4))
def test_dmperm_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(6, 20)), int(rng.integers(6, 20))
    D = (rng.random((m, n)) < 0.2).astype(float)
    dm, dmj = dmperm.dmperm(sstt.from_dense(D)), \
        ref_dmperm.dmperm(sst.from_dense(D))
    for f in ("rowperm", "colperm", "r", "s", "rr", "cc"):
        assert np.array_equal(getattr(dm, f), getattr(dmj, f)), f
    assert (dm.nblocks, dm.structural_rank) == \
        (dmj.nblocks, dmj.structural_rank)
    P = D[np.ix_(dm.rowperm, dm.colperm)]
    assert not P[dm.rr[1]:, :dm.cc[1]].any()
    assert not P[dm.rr[2]:, :dm.cc[2]].any()


def test_collection_round_trip_as_the_reference(tmp_path):
    """The port's cache writes what the reference's reads and back."""
    c = collection.Collection(str(tmp_path / "port"))
    A = sstt.fixtures.laplacian_2d(6)
    e = c.put("LOCAL", "lap2d_6", A, kind="model problem", posdef=True)
    assert e.full_name == "LOCAL/lap2d_6" and c.lookup(1).name == "lap2d_6"
    c.put("G", "r", sstt.fixtures.random_sparse(10, 8, seed=1), kind="rect")
    assert [x.name for x in c.search(posdef=True)] == ["lap2d_6"]
    assert [x.name for x in c.search(kind="rect")] == ["r"]
    cj = ref_collection.Collection(str(tmp_path / "port"))
    for key in ("LOCAL/lap2d_6", "G/r"):
        B, Bj = c.get(key), cj.get(key)
        assert np.array_equal(B.to_dense(), Bj.to_dense())
    os.remove(c.path_of(c.lookup("G/r")))
    with pytest.raises(FileNotFoundError):
        c.get("G/r")
    assert sstt.io.ssget is collection.ssget
    assert sstt.io.default_collection is collection.default_collection


def test_default_collection_is_the_reference_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("SSTPU_COLLECTION", str(tmp_path))
    assert collection.default_collection().root == \
        ref_collection.default_collection().root == str(tmp_path)
    monkeypatch.delenv("SSTPU_COLLECTION")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert collection.default_collection().root == \
        os.path.join(str(tmp_path), ".suitesparse_tpu", "ssget")


def test_coverage_tracker_counts_as_the_reference():
    path = os.path.join(REPO, "suitesparse_tpu_torch", "ordering",
                        "dmperm.py")
    assert coverage.executable_lines(path) == \
        ref_coverage.executable_lines(path)
    mod, nested = coverage.executable_lines(path, split=True)
    assert mod and nested and not (mod & nested)
    cov = coverage.LineCoverage([path])
    with cov:
        dmperm.dmperm(sstt.from_dense(np.eye(4)))
    hit, total, frac, missed = cov.report()[path]
    assert 0 < hit < total == len(nested) and 0 < frac < 1
    assert set(missed) < nested and cov.hit[path]


def test_etree_and_sparse_helpers_equal_the_reference():
    A = sstt.fixtures.laplacian_3d(5)
    Aj = sst.io.fixtures.laplacian_3d(5)
    parent = etree.etree(A)
    post = etree.postorder(parent)
    assert np.array_equal(parent, ref_etree.etree(Aj))
    assert np.array_equal(etree.first_descendants(parent, post),
                          ref_etree.first_descendants(parent, post))
    lv, levels = etree.tree_levels(parent)
    lvj, levelsj = ref_etree.tree_levels(parent)
    assert np.array_equal(lv, lvj)
    assert all(np.array_equal(a, b) for a, b in zip(levels, levelsj,
                                                     strict=True))
    assert etree.tree_depth(parent) == ref_etree.tree_depth(parent)
    assert etree.tree_depth(np.empty(0, np.int64)) == 0
    R = sstt.fixtures.random_sparse(7, 5, seed=2)
    Rj = sst.io.fixtures.random_sparse(7, 5, seed=2)
    for mine, ref in ((sparse.eye(6), ref_sparse.eye(6)),
                      (sparse.horzcat(A, sparse.eye(A.ncol)),
                       ref_sparse.horzcat(Aj, ref_sparse.eye(Aj.ncol))),
                      (sparse.vertcat(R, sparse.eye(5)),
                       ref_sparse.vertcat(Rj, ref_sparse.eye(5)))):
        assert mine.shape == ref.shape and mine.sym == ref.sym == 0
        assert np.array_equal(mine.to_dense(), ref.to_dense())
    with pytest.raises(ValueError):
        sparse.horzcat(R, sparse.eye(5))


def test_top_level_names_hold_every_name_of_the_reference():
    assert set(sst.__all__) <= set(sstt.__all__)
    for name in sstt.__all__:
        assert hasattr(sstt, name), name
    assert sstt.Factor is sstt.numeric.simplicial.Factor
    assert sstt.from_dense is sstt.sparse.from_dense


def test_new_modules_run_with_jax_and_the_jax_package_blocked():
    """The modules this slice adds import and run with ``jax`` and the JAX
    package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['suitesparse_tpu'] = None\n"
        "import numpy as np, suitesparse_tpu_torch as sstt\n"
        "from suitesparse_tpu_torch import coverage, ordering\n"
        "from suitesparse_tpu_torch.io import collection\n"
        "from suitesparse_tpu_torch.numeric import (exact, mflu_device,\n"
        "    modify, multifrontal_lu, simplicial, spsolve, supernodal_solve)\n"
        "from suitesparse_tpu_torch.ordering import dmperm, partition\n"
        "A = sstt.fixtures.laplacian_3d(6)\n"
        "p, cm = ordering.nesdis_order(A)\n"
        "assert ordering.edge_cut(A).cut_size > 0\n"
        "S = simplicial.symbolic_cholesky(A, ordering.amd_order(A))\n"
        "F = simplicial.chol_up(A, S)\n"
        "w = np.zeros(A.ncol); w[S.perm[0]] = 0.5\n"
        "assert modify.updown(F, 1.0, F.L.to_dense()[:, 0] * 0 + w)\n"
        "M = sstt.fixtures.random_sparse(60, 60, 0.08, seed=3)\n"
        "Sm = multifrontal_lu.analyze_mflu(M)\n"
        "Fm = mflu_device.factorize_lu_device(M, Sm, device='cpu')\n"
        "x = mflu_device.solve_mflu_device(Fm, np.ones(60))\n"
        "assert sstt.residual_norm(M, x, np.ones(60)) < 1e-4\n"
        "B = sstt.fixtures.laplacian_3d(12)\n"
        "G = sstt.factorize(B, sstt.analyze(B), device='cpu')\n"
        "cfg = sstt.DEFAULT.replace(solve_mode='inv', solve_bmv=True)\n"
        "b = np.ones(B.ncol)\n"
        "x = sstt.solve(G, b, cfg)\n"
        "assert sstt.residual_norm(B, x, b) < 1e-5\n"
        "assert exact.exact_lusol(sstt.from_dense(np.eye(2) * 2),\n"
        "                         np.ones(2))[0] == 0.5\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and\n"
        "          m.split('.')[0] in ('jax', 'jaxlib', 'suitesparse_tpu')]\n"
        "assert loaded == [], loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
