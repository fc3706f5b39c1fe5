"""Class-sorted pass-up buffers in the port's multifrontal solve sweeps.

The reference's "sorted" route of the w2 and inv sweeps (the sweeps take
``supernodal_solve.ROUTE``; the private ``_mf_dispatch`` reaches this
one) moves the pass-up vectors through the class-sorted buffers of
``_sorted_route``, after the reference's: one gather a child group lays
them out in consuming-class order, each class reads a slice. The classic
sweep routes by levels whatever the route.

- **Maps.** On ``laplacian_3d(9)``, a forest of 6 ``laplacian_3d(4)``
  blocks and the embedded plan of a magnetic Laplacian (k = 5): each
  child group's ``cat`` is unique and ``ncat`` long, ``inv[cat]`` is the
  range and every other slot points at the pad row, the classes' spans
  partition ``[0, ncat)`` in plan order and each holds its class's
  ``src``; the sorted routing's heap spans (one a class) hold the slots
  in that order, and the slots no class reads lie past the data. On
  ``laplacian_3d(9)`` the maps equal the reference's ``_sorted_route`` on
  its plan of the same analysis.
- **Against the px sweep.** The w2, classic and inv sweeps at nrhs 1, 8
  and 64, in fp64 on the same factor values, against the px sweep (its own
  plan, one supernode a row, no pair classes): x within 1e-10 * max|x|.
- **The map fixtures solved.** The port's fp64 factor of each map fixture
  (the forest has child slots no class reads, the embedded plan is the
  complex route's) solves 3 right-hand sides to 1e-10 of dense numpy.
- **The reference's default.** The port's default solve against the
  reference's sweep on its accelerator's default route (w2,
  ``SSTPU_SOLVE_SORT=1``) on the same factor values: x within 1e-4 *
  max|x| (fp32 sums in other orders), residual below 1e-5.
- ``_sorted_route`` raising on classes that share a child slot.
"""

import types

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.numeric import supernodal_solve as ref_solve
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import prof
from suitesparse_tpu_torch.numeric import complex_embed, supernodal_device
from suitesparse_tpu_torch.numeric import supernodal_solve as ss
from suitesparse_tpu_torch.numeric.supernodal import (TorchPxFactor,
                                                     factor_from_arrays)
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

X_TOL = 1e-4
X64_TOL = 1e-10     # fp64 sweeps on the same values, and dense numpy
RESID_TOL = 1e-5
CPU = torch.device("cpu")


def _forest(k, nx):
    A = sstt.fixtures.laplacian_3d(nx)
    n = A.ncol
    cols = np.repeat(np.arange(n), np.diff(A.indptr))
    return sstt.from_triplets(
        k * n, k * n, np.concatenate([A.indices + i * n for i in range(k)]),
        np.concatenate([cols + i * n for i in range(k)]), np.tile(A.data, k),
        sym=1)


def _plan(name):
    """(A, analysis, device plan on the CPU) of one of the map fixtures."""
    if name == "complex_embedded":
        H = prof.magnetic_laplacian(5)
        S = complex_embed.embedded_analysis(H)
        A = complex_embed.embed_matrix(H)
    else:
        A = sstt.fixtures.laplacian_3d(9) if name == "laplacian_3d_9" \
            else _forest(6, 4)
        S = port_analyze_supernodal(
            A, sstt.ordering.nested_dissection_order(A, sstt.DEFAULT))
    return A, S, supernodal_device.device_plan(A, S, CPU, 32)


def _solve_sorted(F, b, cfg):
    """x of ``solve_device(F, b, cfg)`` with the w2 and inv sweeps on the
    sorted route."""
    bb, one_d = ss._rhs(b)
    fn, args = ss._mf_dispatch(F, bb, cfg, "sorted")
    return ss._finish(F, fn(*args), one_d)


@pytest.mark.parametrize("name", ["laplacian_3d_9", "forest_6x4",
                                  "complex_embedded"])
def test_sorted_route_maps(name):
    A, S, dp = _plan(name)
    plan = dp.plan
    smap, cmap = ss._sorted_route(plan)
    assert smap and len(cmap) == sum(len(g.pairs) for gl in plan.groups
                                     for g in gl)
    readers: dict = {}
    for d, gl in enumerate(plan.groups):
        for gi, g in enumerate(gl):
            for ci, (pc, (src, _dst, _idx)) in enumerate(
                    zip(g.pairs, g._pair_arrays)):
                readers.setdefault((pc.src_level, pc.src_gi), []).append(
                    ((d, gi, ci), src))
    assert set(readers) == set(smap)
    for key, (cat, inv, ncat) in smap.items():
        B = plan.groups[key[0]][key[1]].B
        assert cat.size == ncat == np.unique(cat).size
        assert inv.shape == (B,)
        assert np.array_equal(inv[cat], np.arange(ncat))
        rest = np.setdiff1d(np.arange(B), cat)
        assert (inv[rest] == ncat).all()
        off = 0
        for pk, src in readers[key]:
            lo, hi = cmap[pk]
            assert lo == off and np.array_equal(cat[lo:hi], src)
            off = hi
        assert off == ncat
    # the sorted routing on the heap: one placement a class, whose span
    # holds its child slots in the maps' order, and the rows no class reads
    # past the data, as the maps' pad row
    rt = ss._routing(S, dp, "sorted")
    for d, gl in enumerate(plan.groups):
        for gi, g in enumerate(gl):
            assert len(rt.places[d][gi]) == len(g.pairs)
            for ci, (lo, hi, _rows) in enumerate(rt.places[d][gi]):
                pc = g.pairs[ci]
                key = (pc.src_level, pc.src_gi)
                cg = plan.groups[key[0]][key[1]]
                h = rt.hrows[key].numpy().reshape(cg.B, cg.R - cg.C)
                cat = smap[key][0]
                off, end = cmap[(d, gi, ci)]
                assert np.array_equal(h[cat[off:end]].ravel(),
                                      np.arange(lo, hi))
    for key, (cat, inv, ncat) in smap.items():
        h = rt.hrows[key].numpy().reshape(len(inv), -1)
        assert (h[inv == ncat] >= rt.ndata).all()
        assert (h[cat] < rt.ndata).all()


@pytest.mark.parametrize("name", ["laplacian_3d_9", "forest_6x4",
                                  "complex_embedded"])
def test_sorted_sweep_solves_the_map_fixtures(name):
    A, S, _dp = _plan(name)
    F = supernodal_device.factorize_device(
        A, S, sstt.DEFAULT.replace(compute_dtype="float64"), "cpu")
    assert F.ok
    b = np.random.default_rng(3).standard_normal((A.ncol, 3))
    x = _solve_sorted(F, b, sstt.DEFAULT.replace(compute_dtype="float64"))
    xd = np.linalg.solve(A.to_dense(), b)
    assert np.abs(x - xd).max() <= X64_TOL * np.abs(xd).max()


@pytest.fixture(scope="module")
def problem():
    """laplacian_3d(9) analysed once by the reference; its fp32 factor on
    the accelerator's default solve route, and the port's factor carried
    from it."""
    mp = pytest.MonkeyPatch()
    for k, v in (("SSTPU_PLACE", "tile"), ("SSTPU_TILE_RMIN", "32"),
                 ("SSTPU_SOLVE_INV", "1"), ("SSTPU_SOLVE_W2", "1"),
                 ("SSTPU_SOLVE_SORT", "1")):
        mp.setenv(k, v)
    A = sst.io.fixtures.laplacian_3d(9)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(A, S, sst.DEFAULT)
    At = sstt.fixtures.laplacian_3d(9)
    St = port_analyze_supernodal(At, S.perm)
    Ft = factor_from_arrays(At, St, np.asarray(Fj.Lx), Fj.minor, "cpu",
                            tile_rmin=32)
    yield At, Fj, Ft
    mp.undo()


def _rhs(n, nrhs):
    b = 1.0 + np.arange(n) / n
    return b if nrhs == 1 else \
        np.tile(b.reshape(-1, 1), (1, nrhs)) * (1.0 + np.arange(nrhs) / nrhs)


def test_maps_equal_the_references(problem):
    _A, Fj, Ft = problem
    rmap, rcls = ref_solve._sorted_route(Fj.S._device_plan)
    smap, cmap = ss._sorted_route(Ft.dplan.plan)
    assert cmap == rcls and set(smap) == set(rmap)
    for key, (cat, inv, ncat) in smap.items():
        rc, ri, rn = rmap[key]
        assert ncat == rn and np.array_equal(cat, rc) \
            and np.array_equal(inv, ri)


@pytest.mark.parametrize("nrhs", [1, 8, 64])
@pytest.mark.parametrize("mode", ["auto", "classic", "inv"])
def test_sorted_sweep_matches_the_px_sweep(problem, mode, nrhs):
    A, _Fj, F = problem
    cfg = sstt.DEFAULT.replace(solve_mode=mode, compute_dtype="float64")
    Fp = TorchPxFactor(S=F.S, Lx=torch.as_tensor(F.lx_host()),
                       minor=F.minor)
    b = _rhs(A.ncol, nrhs)
    x = _solve_sorted(F, b, cfg)
    xp = ss.solve_device(Fp, b, cfg)
    assert ss.solve_mode(F, cfg) == ("w2" if mode == "auto" else mode)
    assert np.abs(x - xp).max() <= X64_TOL * np.abs(xp).max()
    col = (lambda v: v) if nrhs == 1 else (lambda v: v[:, -1])
    assert sstt.residual_norm(A, col(x), col(b)) < RESID_TOL


def test_default_matches_the_references_sorted_solve(problem):
    A, Fj, Ft = problem
    b = _rhs(A.ncol, 1)
    xj = ref_solve.solve_device(Fj, b, sst.DEFAULT)
    xt = ss.solve_device(Ft, b, sstt.DEFAULT)
    assert ss.solve_mode(Ft, sstt.DEFAULT) == "w2"
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
    assert sstt.residual_norm(A, xt, b) < RESID_TOL


def test_sorted_route_refuses_overlapping_classes():
    """Two classes of one parent group that read slot 1 of the same child
    group: the sorted buffers cannot hold both, and the maps raise."""
    def pair(src):
        return (types.SimpleNamespace(src_level=0, src_gi=0),
                (np.asarray(src), np.zeros(len(src), np.int64),
                 np.zeros((len(src), 2), np.int64)))

    child = types.SimpleNamespace(B=4, pairs=[], _pair_arrays=[])
    classes = [pair([0, 1]), pair([1, 2])]
    parent = types.SimpleNamespace(B=2, pairs=[pc for pc, _ in classes],
                                   _pair_arrays=[a for _, a in classes])
    plan = types.SimpleNamespace(groups=[[child], [parent]])
    with pytest.raises(ValueError, match="share slots"):
        ss._sorted_route(plan)
    parent._pair_arrays[1] = pair([2, 3])[1]
    smap, cmap = ss._sorted_route(plan)
    assert np.array_equal(smap[(0, 0)][0], [0, 1, 2, 3])
    assert cmap == {(1, 0, 0): (0, 2), (1, 0, 1): (2, 4)}
