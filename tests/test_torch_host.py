"""The port's host side is its own: no import of JAX or of the JAX package,
and its own copies of the orderings, the supernodal analysis, the device
plan and the tile manifests give what the JAX package's give.

The equality checks analyze the same matrix with each package's own code
(ordering included) and compare the results exactly; the reference builds
its tile manifests as its tests do off the TPU (``SSTPU_PLACE=tile``,
``SSTPU_TILE_RMIN=32``), the port with ``tile_rmin=32``."""

import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import native
from suitesparse_tpu_torch.numeric import supernodal_device
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "suitesparse_tpu_torch")


def forest(pkg, k: int, nx: int):
    """k independent copies of laplacian_3d(nx) on the block diagonal."""
    A = pkg.io.fixtures.laplacian_3d(nx)
    n = A.ncol
    cols = np.repeat(np.arange(n), np.diff(A.indptr))
    return pkg.from_triplets(
        k * n, k * n, np.concatenate([A.indices + i * n for i in range(k)]),
        np.concatenate([cols + i * n for i in range(k)]), np.tile(A.data, k),
        sym=1)


PROBLEMS = {
    "laplacian_3d_12": lambda pkg: pkg.io.fixtures.laplacian_3d(12),
    "forest_40x6": lambda pkg: forest(pkg, 40, 6),
}


def _reference_native():
    """The reference's native library, loaded in this worker, or fail.

    The reference links ``suitesparse_tpu/native/lib/libsstpu.so`` straight
    to its final name, and under pytest-xdist every worker builds it while
    collecting ``tests/test_native.py``. A worker that loaded a half-written
    file, or whose own link failed, keeps ``_build_failed`` set and runs the
    Python orderings from then on, which are not the C++ orderings the port
    runs. Once another worker has finished the file (its stamp then matches
    the sources), clearing the flag and loading again gives the worker the
    library; a few tries cover a link still in flight."""
    from suitesparse_tpu import native as ref_native

    for attempt in range(5):
        if ref_native._dll is None and ref_native._build_failed:
            ref_native._build_failed = False
        if ref_native.available():
            return ref_native
        time.sleep(1.0 + attempt)
    pytest.fail("the reference's native library does not load in this "
                "worker: its C++ orderings cannot be compared with the "
                "port's")


def _imports(path):
    """Every absolute module name ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "lx_digest.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "suitesparse_tpu")]
    assert bad == []


def test_cholsol_runs_with_jax_and_the_jax_package_blocked():
    """cholsol, qrsol, the LU router's device strategy and lusol."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['suitesparse_tpu'] = None\n"
        "import numpy as np, suitesparse_tpu_torch as sstt\n"
        "for nx, mode in ((12, 'auto'), (12, 'classic'), (5, 'auto')):\n"
        "    A = sstt.fixtures.laplacian_3d(nx)\n"
        "    b = 1.0 + np.arange(A.ncol) / A.ncol\n"
        "    cfg = sstt.DEFAULT.replace(solve_mode=mode)\n"
        "    S = sstt.analyze(A, cfg)\n"
        "    x = sstt.cholsol(A, b, cfg, device='cpu')\n"
        "    r = sstt.residual_norm(A, x, b)\n"
        "    assert r < 1e-5, r\n"
        "    print(nx, mode, S.fl >= 5e6, r)\n"
        "from suitesparse_tpu_torch.numeric import mfqr_device\n"
        "for A in (sstt.fixtures.local_coupling_ls(600, 200),\n"
        "          sstt.fixtures.local_coupling_ls(120, 40)):\n"
        "    b = np.random.default_rng(7).standard_normal(A.nrow)\n"
        "    calls = mfqr_device.device_factors\n"
        "    x = sstt.qrsol(A, b, device='cpu')\n"
        "    r = b - A.matvec(x)\n"
        "    ne = np.abs(A.rmatvec(r)).max() / (np.abs(A.data).max()\n"
        "                                        * np.abs(r).max())\n"
        "    assert ne < 1e-4, ne\n"
        "    print('qr', A.nrow, mfqr_device.device_factors - calls, ne)\n"
        "from suitesparse_tpu_torch.numeric import mflu_unsym, multifrontal_lu\n"
        "A = sstt.fixtures.upwind_unsym(6)\n"
        "b = np.ones(A.ncol)\n"
        "calls = mflu_unsym.device_factors\n"
        "x = multifrontal_lu.mflusol(A, b, device='cpu')\n"
        "r = sstt.residual_norm(A, x, b)\n"
        "assert r < 1e-10, r\n"
        "print('lu', mflu_unsym.device_factors - calls > 0, r)\n"
        "x = sstt.lusol(A, b)\n"
        "r = sstt.residual_norm(A, x, b)\n"
        "assert r < 1e-12, r\n"
        "print('klu', r)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and\n"
        "          m.split('.')[0] in ('jax', 'jaxlib', 'suitesparse_tpu')]\n"
        "assert loaded == [], loaded\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.split("\n")
    assert lines[0].startswith("12 auto True")       # the device path
    assert lines[1].startswith("12 classic True")
    assert lines[2].startswith("5 auto False")       # the host path
    assert lines[3].startswith("qr 600 1")           # the device QR
    assert lines[4].startswith("qr 120 0")           # the host QR
    assert lines[5].startswith("lu True")            # the device LU
    assert lines[6].startswith("klu ")               # the host LU


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_ordering_analysis_plan_and_manifests_equal_the_reference(
        name, monkeypatch):
    _reference_native()
    monkeypatch.setenv("SSTPU_PLACE", "tile")
    monkeypatch.setenv("SSTPU_TILE_RMIN", "32")
    Aj, A = PROBLEMS[name](sst), PROBLEMS[name](sstt)
    pj = nested_dissection_order(Aj, sst.DEFAULT)
    p = sstt.ordering.nested_dissection_order(A, sstt.DEFAULT)
    assert np.array_equal(p, pj)
    Sj, S = analyze_supernodal(Aj, pj), port_analyze_supernodal(A, p)
    assert np.array_equal(S.perm, Sj.perm)
    assert np.array_equal(S.super_first, Sj.super_first)
    assert len(S.rows) == len(Sj.rows) and all(
        np.array_equal(r, rj) for r, rj in zip(S.rows, Sj.rows))
    assert len(S.levels) == len(Sj.levels) and all(
        np.array_equal(v, vj) for v, vj in zip(S.levels, Sj.levels))
    assert (S.lnz, S.fl) == (Sj.lnz, Sj.fl)

    Pj = ref_device.build_plan(Sj, Aj.symperm(Sj.perm).transpose())
    P = supernodal_device.build_plan(S, A.symperm(S.perm).transpose(),
                                     tile_rmin=32)
    groups_j = [g for gl in Pj.groups for g in gl]
    groups = [g for gl in P.groups for g in gl]
    assert [len(gl) for gl in P.groups] == [len(gl) for gl in Pj.groups]
    assert [(g.R, g.C, g.B, g.panel_base) for g in groups] == \
        [(g.R, g.C, g.B, g.panel_base) for g in groups_j]
    assert P.dev_size == Pj.dev_size
    n_tiles = 0
    for g, gj in zip(groups, groups_j):
        assert (g._tile is None) == (gj._tile is None)
        if g._tile is None:
            continue
        n_tiles += 1
        for field in ("man", "rowmap", "colmap"):
            assert np.array_equal(getattr(g._tile, field),
                                  getattr(gj._tile, field))
        assert g._tile.folded == gj._tile.folded
        assert (g._tile.RUp, g._tile.nslots) == (gj._tile.RUp,
                                                  gj._tile.nslots)
        assert g._symm_u == gj._symm_u
    assert n_tiles >= 2


def test_amd_and_best_orderings_equal_the_reference():
    _reference_native()
    Aj = sst.io.fixtures.fem_mesh_spd(800)
    A = sstt.fixtures.fem_mesh_spd(800)
    assert np.array_equal(sstt.analyze(A).perm, sst.analyze(Aj).perm)
    best = sstt.Ordering.BEST
    assert np.array_equal(
        sstt.analyze(A, sstt.DEFAULT.replace(ordering=best)).perm,
        sst.analyze(Aj, sst.DEFAULT.replace(ordering=sst.Ordering.BEST)).perm)


@pytest.mark.parametrize("make", [lambda fx: fx.laplacian_2d(12),
                                  lambda fx: fx.fem_mesh_spd(600)],
                         ids=["laplacian_2d_12", "fem_600"])
def test_colamd_ordering_equals_the_reference(make):
    """``analyze`` under ``Ordering.COLAMD`` orders by COLAMD of A's
    pattern, as the reference's does: the same perm and nnz(L)."""
    _reference_native()
    A, Aj = make(sstt.fixtures), make(sst.io.fixtures)
    S = sstt.analyze(A, sstt.DEFAULT.replace(ordering=sstt.Ordering.COLAMD))
    Sj = sst.analyze(Aj, sst.DEFAULT.replace(ordering=sst.Ordering.COLAMD))
    assert np.array_equal(S.perm, Sj.perm)
    assert S.lnz == Sj.lnz
    assert not np.array_equal(S.perm, sstt.analyze(A).perm)


def test_reference_native_recovers_a_worker_that_lost_the_build_race(
        monkeypatch):
    """A worker whose load of the reference's library failed (the flag set,
    no library) gets the library back from the helper, and with it the
    C++ orderings: the reference's AMD ordering equals the port's again."""
    ref_native = _reference_native()
    monkeypatch.setattr(ref_native, "_dll", None)
    monkeypatch.setattr(ref_native, "_build_failed", True)
    assert not ref_native.available()     # the lost race, as a worker sees it
    assert _reference_native() is ref_native
    assert ref_native._dll is not None and ref_native.has("sstpu_amd")
    Aj = sst.io.fixtures.fem_mesh_spd(400)
    A = sstt.fixtures.fem_mesh_spd(400)
    assert np.array_equal(sstt.analyze(A).perm, sst.analyze(Aj).perm)


def test_host_library_builds_into_the_ignored_lib_dir():
    cmd = native.build_command()
    assert cmd[0] == "g++" and "-march=native" in cmd and "-shared" in cmd
    assert cmd[cmd.index("-o") + 1] == os.path.join(PORT, "native", "lib",
                                                    "libsst_host.so")
    assert sorted(os.path.basename(c) for c in cmd if c.endswith(".cc")) == [
        "amd.cc", "btf.cc", "colamd.cc", "hsolve.cc", "lu.cc", "nd.cc",
        "super.cc", "symbolic.cc", "wmatch.cc"]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "suitesparse_tpu_torch/native/lib/" in f.read().split()
