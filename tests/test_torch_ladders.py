"""The step-count plans of the port against the JAX package's: the plan
builder on the reference's other ladders (``build_plan(ladders=)``), the
coarse solve plan with the relayout of ``Lx`` that every sweep takes
where its copy fits, and the classic sweep's level routing (the
reference's mf2 sweep, ``build_mf2_plan``).

The reference's switches are environment variables, set with
``monkeypatch.setenv`` (``SSTPU_SOLVE_COARSE``, ``SSTPU_SOLVE_LADDER``,
``SSTPU_SOLVE_INV``, ``SSTPU_SOLVE_W2``, ``SSTPU_SOLVE_MF2``). Both sides
analyse the same matrix on the reference's ordering; the port's solves
run on the reference's factor values carried into its layout, so x is
held to 1e-5 * max|x| of the reference's (fp32, sums in other orders),
the residual to 1e-5 and ``solve_refined`` to the reference's 1e-14
(``tests/test_supernodal.py:519-548``)."""

import dataclasses
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
from suitesparse_tpu_torch.numeric import supernodal_device, supernodal_solve
from suitesparse_tpu_torch.numeric.supernodal import factor_from_arrays
from suitesparse_tpu_torch.parallel import dist2
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

NX = 7
X_TOL = 1e-5
RESID_TOL = 1e-5
REFINED_TOL = 1e-14
# the reference's rungs: its SSTPU_LADDER=coarse factor ladder
# (suitesparse_tpu/numeric/supernodal_device.py:58-60), its pow4 and pow2
# solve ladders
RUNGS = {"coarse": ([8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192],
                    [8, 16, 32, 64, 128, 256, 512]),
         "pow4": (ref_solve._SOLVE_R_LADDER, ref_solve._SOLVE_C_LADDER),
         "pow2": (ref_solve._SOLVE_R_POW2, ref_solve._SOLVE_C_POW2)}


@pytest.fixture(scope="module")
def problem():
    """laplacian_3d(NX) on the reference's ordering: the reference's
    analysis and fp32 factor, the port's analysis and the port's factor
    carried from the reference's values."""
    A = sst.io.fixtures.laplacian_3d(NX)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(A, S)
    At = sstt.fixtures.laplacian_3d(NX)
    St = port_analyze_supernodal(At, S.perm)
    Ft = factor_from_arrays(At, St, np.asarray(Fj.Lx), Fj.minor, "cpu")
    return A, S, Fj, At, St, Ft


def _rhs(n):
    return 1.0 + np.arange(n) / n


def _same_plan(p, q, a_scatter=True):
    """Group shapes, slots, panel bases and pair classes equal (and A's
    scatter, where both plans were built from A)."""
    assert p.dev_size == q.dev_size
    assert [len(gl) for gl in p.groups] == [len(gl) for gl in q.groups]
    for gp, gq in zip((g for gl in p.groups for g in gl),
                      (g for gl in q.groups for g in gl)):
        assert (gp.R, gp.C, gp.B, gp.panel_base) == \
            (gq.R, gq.C, gq.B, gq.panel_base)
        assert np.array_equal(gp.snodes, gq.snodes)
        assert np.array_equal(gp.nc, gq.nc)
        if a_scatter:
            assert np.array_equal(gp.asrc, gq.asrc)
            assert np.array_equal(gp.adst, gq.adst)
        assert [(c.src_level, c.src_gi, c.RU_c, c.npairs) for c in gp.pairs] \
            == [(c.src_level, c.src_gi, c.RU_c, c.npairs) for c in gq.pairs]
        for ap, aq in zip(gp._pair_arrays, gq._pair_arrays):
            assert all(np.array_equal(x, y) for x, y in zip(ap, aq))


def _ref_plan(A, S, ladder):
    R, C = RUNGS[ladder]
    return ref_device.build_plan(S, A.symperm(S.perm).transpose(),
                                 ladders=(list(R), list(C)))


@pytest.mark.parametrize("ladder", ["coarse", "pow4", "pow2"])
def test_plans_equal_the_reference(problem, ladder):
    A, S, _Fj, At, St, _Ft = problem
    ref = _ref_plan(A, S, ladder)
    port = supernodal_device.build_plan(
        St, At.symperm(St.perm).transpose(), ladders=RUNGS[ladder])
    _same_plan(port, ref)
    fine = supernodal_device.build_plan(St, At.symperm(St.perm).transpose())
    assert sum(map(len, port.groups)) < sum(map(len, fine.groups))
    if ladder == "pow4":
        # the solve's own plan: the same groups, no A scatter, no tiles
        assert (supernodal_solve._SOLVE_R_LADDER,
                supernodal_solve._SOLVE_C_LADDER) == RUNGS["pow4"]
        coarse = supernodal_solve._coarse_plan(St)
        _same_plan(coarse, ref, a_scatter=False)
        assert supernodal_solve._coarse_plan(St) is coarse
        assert all(g._tile is None for gl in coarse.groups for g in gl)


@pytest.mark.parametrize("ladder", ["pow4", "pow2"])
def test_relayout_equals_the_reference_map(problem, ladder):
    A, S, _Fj, At, St, Ft = problem
    ref2 = _ref_plan(A, S, ladder)
    m_ref = ref_solve.relayout_map(S, S._device_plan, ref2)
    plan1 = Ft.dplan.plan
    plan2 = supernodal_device.build_plan(
        St, At.symperm(St.perm).transpose(), ladders=RUNGS[ladder])
    m = supernodal_solve.relayout_map(St, plan1, plan2)
    assert m.dtype == np.int32 and np.array_equal(m, m_ref)
    want = torch.cat([Ft.Lx, Ft.Lx.new_zeros(1)])[torch.as_tensor(
        m.astype(np.int64))]
    got = supernodal_solve.relayout_fn(St, plan1, plan2)(Ft.Lx)
    assert torch.equal(got, want)
    # and back: the fine factor out of its coarse copy, bit for bit
    back = supernodal_solve.relayout_fn(St, plan2, plan1)(got)
    assert torch.equal(back, Ft.Lx)


def _reference_x(monkeypatch, S, Fj, b, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    S._solve_cache = None
    Fj._winv = None
    return ref_solve.solve_device(Fj, b)


# (reference SSTPU_SOLVE_INV, SSTPU_SOLVE_W2, SSTPU_SOLVE_MF2) -> the port's
# solve_mode; the reference's classic sweep on its fine plan is the mf2 one,
# whose routing the port's classic sweep takes
MODES = {"w2": ("1", "1", "0", "auto"), "inv": ("1", "0", "0", "inv"),
         "classic": ("0", "0", "1", "classic")}


@pytest.mark.parametrize("sweep", sorted(MODES))
def test_coarse_solve_matches_reference(problem, sweep, monkeypatch):
    A, S, Fj, At, _St, Ft = problem
    inv, w2, _mf2, mode = MODES[sweep]
    b = _rhs(A.ncol)
    xj = _reference_x(monkeypatch, S, Fj, b, SSTPU_SOLVE_COARSE="1",
                      SSTPU_SOLVE_LADDER="pow4", SSTPU_SOLVE_INV=inv,
                      SSTPU_SOLVE_W2=w2)
    cfg = sstt.DEFAULT.replace(solve_mode=mode)
    assert supernodal_solve.solve_ladder(Ft) == "coarse"
    assert supernodal_solve.solve_mode(Ft, cfg) == sweep
    x = supernodal_solve.solve_device(Ft, b, cfg)
    assert np.isfinite(x).all()
    assert np.abs(x - xj).max() <= X_TOL * np.abs(xj).max()
    assert sstt.residual_norm(At, x, b) < RESID_TOL
    # the state sits beside the relayouted copy, on the coarse plan's keys
    dtype = torch.float32
    key = {"w2": ("w2", dtype), "classic": ("classic", dtype),
           "inv": supernodal_solve._inv_key(dtype, cfg)}[sweep]
    lx2 = Ft._solve[("relayout",)][2]
    assert Ft._solve[key][0] is lx2
    assert lx2.numel() == supernodal_solve._coarse_plan(Ft.S).dev_size
    # solve_dispatch's sweep gives the solve's x
    fn, args = supernodal_solve.solve_dispatch(Ft, b, cfg)
    y = fn(*args).numpy()[:, 0]
    assert np.abs(y - x[Ft.S.perm]).max() <= 1e-6 * np.abs(x).max()
    if sweep == "w2":
        assert sstt.residual_norm(
            At, sstt.solve_refined(Ft, At, b, config=cfg), b) < REFINED_TOL


@pytest.mark.parametrize("sweep", sorted(MODES))
def test_fine_fallback_matches_reference(problem, sweep, monkeypatch):
    """Where the copy does not fit, every sweep runs on the factor's own
    plan: the reference's fine plan (its mf2 sweep for classic)."""
    A, S, Fj, At, St, _Ft = problem
    inv, w2, mf2, mode = MODES[sweep]
    b = _rhs(A.ncol)
    B = np.stack([b, -2.0 * b], axis=1)
    xj = _reference_x(monkeypatch, S, Fj, B, SSTPU_SOLVE_COARSE="0",
                      SSTPU_SOLVE_INV=inv, SSTPU_SOLVE_W2=w2,
                      SSTPU_SOLVE_MF2=mf2)
    Ft = factor_from_arrays(At, St, np.asarray(Fj.Lx), Fj.minor, "cpu")
    monkeypatch.setattr(supernodal_solve, "solve_ladder", lambda F: "fine")
    cfg = sstt.DEFAULT.replace(solve_mode=mode)
    X = supernodal_solve.solve_device(Ft, B, cfg)
    assert np.abs(X - xj).max() <= X_TOL * np.abs(xj).max()
    for k in range(2):
        assert sstt.residual_norm(At, X[:, k], B[:, k]) < RESID_TOL
    # no copy; the state on the fine plan's keys, built from Lx itself
    assert ("relayout",) not in Ft._solve
    dtype = torch.float32
    key = {"w2": ("w2", dtype, "fine"), "classic": ("classic", dtype, "fine"),
           "inv": supernodal_solve._inv_key(dtype, cfg, "fine")}[sweep]
    assert Ft._solve[key][0] is Ft.Lx


@pytest.mark.parametrize("ladder", ["fine", "pow4"])
def test_heap_routing_equals_the_reference(problem, ladder):
    """The classic sweep's level routing: the port's ``build_mf2_plan``
    equal to the reference's, on the factor's plan and on the coarse
    one."""
    A, S, _Fj, _At, St, Ft = problem
    if ladder == "fine":
        pj, pt = S._device_plan, Ft.dplan.plan
    else:
        pj, pt = _ref_plan(A, S, "pow4"), supernodal_solve._coarse_plan(St)
    m2j = ref_solve.build_mf2_plan(S, pj)
    m2 = supernodal_solve.build_mf2_plan(St, pt)
    for f in dataclasses.fields(m2):
        a, r = getattr(m2, f.name), getattr(m2j, f.name)
        if f.name == "lv_route":
            assert len(a) == len(r)
            for ra, rr in zip(a, r):
                for x, y in zip(ra, rr):
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert all(np.array_equal(u, v)
                                   for u, v in zip(x, y))
        elif f.name == "xpos":
            assert sorted(a) == sorted(r)
            assert all(np.array_equal(a[k], r[k]) for k in a)
        else:
            assert a == r, f.name


def test_coarse_inv_solve_after_segmented_factor(problem):
    """The port's counterpart of the reference's
    ``test_coarse_inv_solve_after_segmented_factorize``."""
    _A, _S, _Fj, At, St, _Ft = problem
    cfg = sstt.DEFAULT.replace(solve_mode="inv", segment_bytes=20000)
    F = supernodal_device.factorize_device(At, St, cfg, "cpu")
    assert F.ok and F.segments > 1
    b = _rhs(At.ncol)
    x = supernodal_solve.solve_device(F, b, cfg)
    assert ("relayout",) in F._solve
    assert sstt.residual_norm(At, x, b) < RESID_TOL
    assert sstt.residual_norm(
        At, sstt.solve_refined(F, At, b, config=cfg), b) < REFINED_TOL


def test_coarse_copy_follows_the_factor_and_its_plan(problem):
    _A, _S, _Fj, At, St, _Ft = problem
    b = _rhs(At.ncol)
    cfg = sstt.DEFAULT.replace(solve_mode="classic")
    key = ("relayout",)
    F1 = supernodal_device.factorize_device(At, St, sstt.DEFAULT, "cpu")
    x1 = supernodal_solve.solve_device(F1, b, cfg)
    lx2 = F1._solve[key][2]
    supernodal_solve.solve_device(F1, b, cfg)
    assert F1._solve[key][2] is lx2                  # kept
    # a second factor builds its own copy
    F2 = supernodal_device.factorize_device(At, St, sstt.DEFAULT, "cpu")
    supernodal_solve.solve_device(F2, b, cfg)
    assert F2._solve[key][2] is not lx2 and F1._solve[key][2] is lx2
    # another device plan of the same layout: the copy is rebuilt
    F1.dplan = supernodal_device.device_plan(At, St, "cpu", tile_rmin=32)
    supernodal_solve.solve_device(F1, b, cfg)
    assert F1._solve[key][2] is not lx2
    assert torch.equal(F1._solve[key][2], lx2)
    # the distributed factor's split plan swapped in, with its values
    C_low = At.symperm(St.perm).transpose()
    split = dist2.build_dist_plan(St, C_low, 2)[0]
    dps = supernodal_device.DevicePlan(plan=split, device=F1.dplan.device,
                                       groups=None)
    Lxs = supernodal_solve.relayout_fn(St, F1.dplan.plan, split)(F1.Lx)
    F1.Lx, F1.dplan = Lxs, dps
    xs = supernodal_solve.solve_device(F1, b, cfg)
    assert F1._solve[key][1] is dps and F1._solve[key][0] is Lxs
    assert sstt.residual_norm(At, xs, b) < RESID_TOL
    assert np.abs(xs - x1).max() <= 1e-6 * np.abs(x1).max()


def test_solve_ladder_gates_on_the_cards_free_memory(problem, monkeypatch):
    """The coarse plan where its copy of the factor fits in the card's free
    memory (cached blocks included) or is built, else the factor's own
    plan; W2's gate counts the copy with the coarse plan's W2."""
    _A, _S, _Fj, _At, St, Ft = problem
    need = supernodal_solve._coarse_plan(St).dev_size * 4
    card = types.SimpleNamespace(
        Lx=types.SimpleNamespace(device=torch.device("cuda", 0),
                                 element_size=lambda: 4),
        S=St, dplan=Ft.dplan, _solve={})
    free = {"free": need - 1}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free["free"], 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    assert supernodal_solve.solve_ladder(card) == "coarse"   # one cached B
    free["free"] = need - 2
    assert supernodal_solve.solve_ladder(card) == "fine"
    # W2 on the factor's plan is larger than the copy: no room for it
    assert not supernodal_solve._w2_fits(card, torch.float32, sstt.DEFAULT)
    # room for the copy: W2 is the coarse plan's, counted with the copy
    w2 = supernodal_solve._w2_need(supernodal_solve._coarse_plan(St),
                                   torch.float32, sstt.DEFAULT)
    free["free"] = w2 + need - 1
    assert supernodal_solve.solve_ladder(card) == "coarse"
    assert supernodal_solve._w2_fits(card, torch.float32, sstt.DEFAULT)
    free["free"] = w2 + need - 2
    assert not supernodal_solve._w2_fits(card, torch.float32, sstt.DEFAULT)
    # a copy already built for this Lx and plan: coarse, whatever is free,
    # and W2 alone asks for room
    card._solve[("relayout",)] = (card.Lx, card.dplan, object())
    free["free"] = 0
    assert supernodal_solve.solve_ladder(card) == "coarse"
    free["free"] = w2 - 1
    assert supernodal_solve._w2_fits(card, torch.float32, sstt.DEFAULT)
