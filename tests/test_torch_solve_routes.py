"""The fused and merged solve routes against the reference's.

The port's w2 and inv sweeps take the "fused" pass-up routing
(``supernodal_solve.ROUTE``: one placement a parent group, the
reference's ``SSTPU_SOLVE_FUSE_ROUTE``). The reference's two other
routings (``supernodal_solve.ROUTES``) lie on the same heap and are
reached through the private ``_mf_dispatch``: "merged" (one placement an
exact-RU_c bucket and one gather of the right-hand side a sweep, the
reference's ``SSTPU_SOLVE_MERGE``, which it takes only with
``SSTPU_SOLVE_SORT=0``) and "sorted" (one placement a class, the
reference's class-sorted route).

- **Builders.** ``_fused_route``, ``_merged_route`` and ``_pb_pregather``
  equal the reference's arrays on the factor plan and the coarse solve
  plan of the same analysis.
- **Routings.** On those plans the fused routing has one forward
  placement per parent group with classes, the merged one per bucket, the
  sorted one per class, and the placements' heap spans cover each pass-up
  row exactly once; each
  route's routing is cached on the device plan apart (F3), over the one
  route-independent part that every sweep reads, and the sweeps' states
  do not depend on the route.
- **Against the reference.** ``laplacian_3d(10)``, the reference's fp64
  factor carried into the port's layout; the reference's ``solve_device``
  on the same route and plan (``SSTPU_SOLVE_COARSE=1``, the port's coarse
  solve plan) in w2 and inv mode, fp32 and fp64 (the fp32 sweep reads the
  fp64 factor rounded, on both sides), once at 64 right-hand sides; the
  port at 1, 8 and 64 against its first columns: x within 1e-5 * max|x| in
  fp32, 1e-10 in fp64. The public ``solve_device`` takes the fused route
  and gives its x.
- ``_heap_route`` refusing classes that share a child slot.
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
from suitesparse_tpu_torch.numeric import supernodal_solve as ss
from suitesparse_tpu_torch.numeric.supernodal import factor_from_arrays
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

NX = 10
NRHS = (1, 8, 64)
X_TOL = {"float32": 1e-5, "float64": 1e-10}
ROUTE_ENV = {"fused": {"SSTPU_SOLVE_FUSE_ROUTE": "1", "SSTPU_SOLVE_MERGE": "0"},
             "merged": {"SSTPU_SOLVE_FUSE_ROUTE": "0",
                        "SSTPU_SOLVE_MERGE": "1"}}
MODE_ENV = {"auto": {"SSTPU_SOLVE_W2": "1", "SSTPU_SOLVE_INV": "1"},
            "inv": {"SSTPU_SOLVE_W2": "0", "SSTPU_SOLVE_INV": "1"}}


@pytest.fixture(scope="module")
def problem():
    """laplacian_3d(10) analysed once by the reference; its fp64 factor,
    and the port's factor carried from it."""
    mp = pytest.MonkeyPatch()
    for k, v in (("SSTPU_SOLVE_COARSE", "1"), ("SSTPU_SOLVE_SORT", "0"),
                 ("SSTPU_SOLVE_BMV", "0"), ("SSTPU_SOLVE_PMV", "0")):
        mp.setenv(k, v)
    A = sst.io.fixtures.laplacian_3d(NX)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(
        A, S, sst.DEFAULT.replace(compute_dtype="float64"))
    At = sstt.fixtures.laplacian_3d(NX)
    St = port_analyze_supernodal(At, S.perm)
    Ft = factor_from_arrays(At, St, np.asarray(Fj.Lx), Fj.minor, "cpu")
    yield At, Fj, Ft
    mp.undo()


def _rhs(n):
    return np.random.default_rng(5).standard_normal((n, max(NRHS)))


def _solve(F, b, cfg, route):
    """x of ``solve_device(F, b, cfg)`` with the w2 and inv sweeps on
    ``route``."""
    bb, one_d = ss._rhs(b)
    fn, args = ss._mf_dispatch(F, bb, cfg, route)
    return ss._finish(F, fn(*args), one_d)


def _plans(Fj, Ft):
    """(reference plan, port plan) pairs: the factor plan and the coarse
    solve plan of the same analysis."""
    return [(Fj.S._device_plan, Ft.dplan.plan),
            (ref_solve._coarse_plan(Fj.S), ss._coarse_plan(Ft.S))]


def test_route_builders_equal_the_references(problem):
    _A, Fj, Ft = problem
    for pj, pt in _plans(Fj, Ft):
        gj = [g for gl in pj.groups for g in gl]
        gt = [g for gl in pt.groups for g in gl]
        assert [(g.B, g.R, g.C) for g in gj] == [(g.B, g.R, g.C) for g in gt]
        for a, b in zip(gj, gt):
            fa, fb = ref_solve._fused_route(a), ss._fused_route(b)
            assert (fa is None) == (fb is None) == (not b.pairs)
            if fb is not None:
                assert np.array_equal(fa[0], fb[0]) and \
                    np.array_equal(fa[1], fb[1]) and fa[3] == fb[3]
                assert [m[:2] + m[3:] for m in fa[2]] == \
                    [m[:2] + m[3:] for m in fb[2]]
                assert all(np.array_equal(x[2], y[2])
                           for x, y in zip(fa[2], fb[2]))
            ma, mb = ref_solve._merged_route(a), ss._merged_route(b)
            assert len(ma) == len(mb)
            for (ia, da, ka), (ib, db, kb) in zip(ma, mb):
                assert np.array_equal(ia, ib) and np.array_equal(da, db)
                assert [m[:2] + m[3:] for m in ka] == \
                    [m[:2] + m[3:] for m in kb]
        spj = ref_solve.build_solve_plan(Fj.S, "device", plan=pj)
        spt = ss.build_solve_plan(Ft.S, pt)
        (ij, oj), (it, ot) = ref_solve._pb_pregather(spj), \
            ss._pb_pregather(spt)
        assert np.array_equal(ij, it) and oj == ot
        assert ss._pb_pregather(spt)[0] is it          # cached on the plan


@pytest.mark.parametrize("ladder", ["fine", "coarse"])
def test_routings_place_once_a_group_or_a_bucket(problem, ladder):
    _A, _Fj, Ft = problem
    dp = Ft.dplan if ladder == "fine" else \
        ss._coarse_entry(Ft.S, Ft.dplan)[0]
    plan = dp.plan
    rts = {r: ss._routing(Ft.S, dp, r) for r in ss.ROUTES}
    assert set(dp.solve) == set(ss.ROUTES)
    assert all(ss._routing(Ft.S, dp, r) is rts[r] for r in ss.ROUTES)
    with pytest.raises(ValueError, match="route"):
        ss._routing(Ft.S, dp, "padded")
    for route in ss.ROUTES:
        rt = rts[route]
        assert rt.route == route and rt.splan is dp.solve_base.splan
        assert (rt.pregather is not None) == (route == "merged")
        seen = np.zeros(rt.ndata, dtype=np.int64)
        for d, gl in enumerate(plan.groups):
            for gi, g in enumerate(gl):
                n_place = len(rt.places[d][gi])
                want = 0 if not g.pairs else \
                    1 if route == "fused" else len(g.pairs) \
                    if route == "sorted" else len(ss._merged_route(g))
                assert n_place == want
                for lo, hi, rows in rt.places[d][gi]:
                    assert rows.numel() == hi - lo
                    assert int(rows.max()) <= g.B * g.R
                    seen[lo:hi] += 1
        assert (seen == 1).all()
        # each child group's rows land on distinct heap rows, its rows no
        # class reads past the data
        rows = torch.cat(list(rt.hrows.values())).numpy()
        assert np.unique(rows).size == rows.size and rows.max() < rt.nheap
        assert np.isin(np.arange(rt.ndata), rows).all()
    n = {r: sum(len(p) for row in rts[r].places for p in row)
         for r in ss.ROUTES}
    assert n["fused"] <= n["merged"] <= n["sorted"] and \
        n["fused"] < n["sorted"] == sum(len(g.pairs) for gl in plan.groups
                                        for g in gl)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["auto", "inv"])
@pytest.mark.parametrize("route", ["fused", "merged"])
def test_routes_match_the_reference(problem, route, mode, dtype,
                                    monkeypatch):
    A, Fj, Ft = problem
    for k, v in {**ROUTE_ENV[route], **MODE_ENV[mode]}.items():
        monkeypatch.setenv(k, v)
    b = _rhs(A.ncol)
    xj = ref_solve.solve_device(Fj, b, sst.DEFAULT.replace(compute_dtype=dtype))
    cfg = sstt.DEFAULT.replace(compute_dtype=dtype, solve_mode=mode)
    assert ss.solve_mode(Ft, cfg) == ("w2" if mode == "auto" else "inv")
    for nr in NRHS:
        x = _solve(Ft, b[:, :nr], cfg, route)
        ref = xj[:, :nr]
        assert x.shape == ref.shape and np.isfinite(x).all()
        assert np.abs(x - ref).max() <= X_TOL[dtype] * np.abs(ref).max(), \
            (route, mode, dtype, nr)
    assert ss.solve_ladder(Ft) == "coarse"


def test_route_is_not_part_of_the_sweep_state(problem):
    """The three routes read one W2 and one inv state a factor. On the CPU
    fused gives sorted's bits (each row's sums in the same order), merged
    its x up to the order of the sums (a group's classes bucket by
    bucket); the public solve takes ``ROUTE`` and gives its bits."""
    A, _Fj, Ft = problem
    b = _rhs(A.ncol)[:, :8]
    assert ss.ROUTE == "fused"
    for mode in ("auto", "inv"):
        cfg = sstt.DEFAULT.replace(solve_mode=mode)
        xs = _solve(Ft, b, cfg, "sorted")
        keys = set(Ft._solve)
        xf = _solve(Ft, b, cfg, "fused")
        xm = _solve(Ft, b, cfg, "merged")
        assert set(Ft._solve) == keys
        assert np.array_equal(xf, xs)
        assert np.abs(xm - xs).max() <= 1e-6 * np.abs(xs).max()
        assert np.array_equal(ss.solve_device(Ft, b, cfg), xf)


def test_heap_route_refuses_overlapping_classes():
    """Two classes of one parent group that read slot 1 of the same child
    group: one heap span cannot hold both, and the route raises."""
    def pair(src, RU=2):
        return (types.SimpleNamespace(src_level=0, src_gi=0, RU_c=RU),
                (np.asarray(src), np.zeros(len(src), np.int64),
                 np.zeros((len(src), RU), np.int64)))

    child = types.SimpleNamespace(B=4, R=3, C=1, pairs=[], _pair_arrays=[])
    classes = [pair([0, 1]), pair([1, 2])]
    parent = types.SimpleNamespace(B=2, R=4, C=2,
                                   pairs=[pc for pc, _ in classes],
                                   _pair_arrays=[a for _, a in classes])
    plan = types.SimpleNamespace(groups=[[child], [parent]])
    for route in ("fused", "merged"):
        with pytest.raises(ValueError, match="share slots"):
            ss._heap_route(plan, route)
    parent._pair_arrays[1] = pair([2, 3])[1]
    for name in ("_solve_fused", "_solve_merged"):
        if hasattr(parent, name):
            delattr(parent, name)
    places, hrows, ndata, nheap = ss._heap_route(plan, "fused")
    assert ndata == nheap == 8 and len(places[1][0]) == 1
    assert np.array_equal(hrows[(0, 0)], np.arange(8))
