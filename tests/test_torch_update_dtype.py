"""bfloat16 child updates (``Config.update_dtype``) and the reference's QR
and COLAMD knobs in the port, against the JAX package on the CPU.

- **The factor.** Each side analyzes the same matrix; the port takes the
  reference's ordering and builds its plan at ``tile_rmin=32`` (so it has
  tile manifests, which a bfloat16 factor must not read), and both factor
  with ``update_dtype="bfloat16"``. The reference runs off the TPU as its
  tests run it (``SSTPU_PALLAS=1``, ``SSTPU_TILE_RMIN=32``) and turns its
  tiled kernel off for bfloat16 updates, so it places every class by one
  of its three routes, forced by ``SSTPU_PLACE``: scan on
  ``laplacian_3d(12)`` (the fixture whose classes reach the scan route;
  the others take the cost model's), gather on ``fem_mesh_spd(1500)``
  (fp32 fronts), mm on ``laplacian_3d(8)`` with fp64 fronts. The port
  places every class by K7's plain version. Both sides round U to
  bfloat16 at the same point, but their fp32 sums run in other orders and
  can land a U entry on the other side of a bfloat16 rounding, so ``Lx``
  and ``lx_host()`` are held within 2^-6 * max|Lx|; fp64 fronts too.
- **Refinement.** Each factor is solved once and refined by the port's
  sweep (``solve_refined``; the reference's factor brought over by
  ``factor_from_arrays``: its jitted sweep costs about 8 s a fixture on
  the CPU, and the sweep is held to the reference's elsewhere). Both meet
  the reference test's gates (``tests/test_supernodal.py:160-179``): one
  solve below 1e-1, refined below 1e-5 and no worse than one solve; the
  refined x within 1e-6 (relative) of the reference's. The gates are read
  after 2 steps, the reference test's count, except on ``fem_1500``, where
  the bfloat16 factor cuts the error about 3x a step and 2 steps leave
  3.0e-5 on both packages (held there within 1e-3 of each other): its
  gates are read after 4 steps.
- **Exactness, the port alone.** K7's plain version (and the library
  scatter) on a bfloat16 U equals it on U widened to fp32 (fp64), bit for
  bit; ``_group_compute``'s bfloat16 U equals its fp32 U rounded; a
  bfloat16 factor reads no tile arrays and never calls K2; forced into at
  least 4 segments it equals the one-piece bfloat16 factor bit for bit.
- **Complex.** The embedded factor of a magnetic Laplacian (k = 6) with
  bfloat16 updates through ``cholsol_complex_device`` against the
  reference's, each refined twice: one solve below 1e-1 and refined below
  1e-5 (max|Hx - b| / max|b|), the refined x within 1e-6 of the
  reference's.
- **Knobs.** ``qr_tol`` changes ``rank_est`` and x alike in both
  packages (host QR, host multifrontal QR; x bit-equal at full rank, and
  at the reduced rank the port's host x least squares on the live columns,
  F17), and the device QR's tolerance follows it; non-default COLAMD dense cuts give the reference's
  permutation. The port's ``Config`` lacks exactly the reference's fields
  that no reference code reads. The roofline's bytes under bfloat16
  updates fall below the fp32 report's by exactly the update cells.
"""

import dataclasses

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu import config as ref_config
from suitesparse_tpu.io import fixtures
from suitesparse_tpu.numeric import complex_embed as ref_ce
from suitesparse_tpu.numeric import multifrontal_qr as ref_mfqr
from suitesparse_tpu.numeric import qr as ref_qr
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.ordering import colamd as ref_colamd
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import config as port_config
from suitesparse_tpu_torch.kernels import extend_add as k7
from suitesparse_tpu_torch.numeric import complex_embed as ce
from suitesparse_tpu_torch.numeric import mfqr_device as md
from suitesparse_tpu_torch.numeric import multifrontal_qr as mfqr
from suitesparse_tpu_torch.numeric import qr, supernodal, supernodal_solve
from suitesparse_tpu_torch.numeric import supernodal_device as sd
from suitesparse_tpu_torch.ordering import colamd
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal
from test_torch_host import _reference_native

CPU = torch.device("cpu")
BF16 = torch.bfloat16
LX_TOL = 2.0 ** -6      # Lx against the reference's, times max|Lx|
ONE_SOLVE = 1e-1        # the reference test's gates
REFINED = 1e-5
X_TOL = 1e-6            # refined x against the reference's, relative

# (fixture, front dtype, the reference's placement route, refinement steps)
CASES = {
    "laplacian_3d_12-float32-scan": (lambda fx: fx.laplacian_3d(12),
                                     "float32", "scan", 2),
    "fem_1500-float32-gather": (lambda fx: fx.fem_mesh_spd(1500),
                                "float32", "gather", 4),
    "laplacian_3d_8-float64-mm": (lambda fx: fx.laplacian_3d(8),
                                  "float64", "mm", 2),
}


def _port_cfg(dtype="float32", **kw):
    return sstt.DEFAULT.replace(compute_dtype=dtype,
                                update_dtype="bfloat16", **kw)


def _iterates(F, A, b, steps):
    """x after 0, 1, ..., ``steps`` refinement steps with the port's device
    factor F, as ``solve_refined`` takes them."""
    xs = [supernodal_solve.solve_device(F, b)]
    for _ in range(steps):
        xs.append(xs[-1] + supernodal_solve.solve_device(
            F, b - A.matvec(xs[-1])))
    return xs


def _gates(A, b, x0, x):
    r0 = sstt.residual_norm(A, x0, b)
    r = sstt.residual_norm(A, x, b)
    assert r0 < ONE_SOLVE and r < REFINED and r <= r0, (r0, r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_factor_matches_reference(case, monkeypatch):
    make, dtype, route, steps = CASES[case]
    monkeypatch.setenv("SSTPU_PALLAS", "1")
    monkeypatch.setenv("SSTPU_TILE_RMIN", "32")
    monkeypatch.setenv("SSTPU_PLACE", route)
    if route == "gather":
        # the one-hot matmul loses the reference's cost model
        monkeypatch.setattr(ref_device, "_PLACE_MM", 1.0)
    A = make(fixtures)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(
        A, S, sst.DEFAULT.replace(compute_dtype=dtype,
                                  update_dtype="bfloat16"))
    routes = {pc.strategy for gl in S._device_plan.groups for g in gl
              for pc in g.pairs}
    assert route in routes, routes
    At = make(sstt.fixtures)
    St = port_analyze_supernodal(At, S.perm)
    Ft = sd.factorize_device(At, St, _port_cfg(dtype), CPU, tile_rmin=32)
    assert Fj.ok and Ft.ok and Ft.segments == 1
    assert Ft.Lx.dtype == getattr(torch, dtype)
    assert any(g._tile is not None for gl in Ft.dplan.plan.groups
               for g in gl)
    lj = np.asarray(Fj.Lx, dtype=np.float64)
    lt = Ft.Lx.numpy().astype(np.float64)
    tol = LX_TOL * np.abs(lj).max()
    assert lj.shape == lt.shape and np.abs(lt - lj).max() <= tol
    assert np.abs(Ft.lx_host() - Fj.lx_host()).max() <= tol
    # the rounding is real: the fp32-update factor differs from it
    F32 = sd.factorize_device(At, St, sstt.DEFAULT.replace(
        compute_dtype=dtype), CPU, tile_rmin=32)
    assert not torch.equal(F32.Lx, Ft.Lx)

    n = At.ncol
    b = 1.0 + np.arange(n) / n
    Fr = supernodal.factor_from_arrays(At, St, np.asarray(Fj.Lx), Fj.minor,
                                       device=CPU, tile_rmin=32)
    xs, xsj = _iterates(Ft, At, b, steps), _iterates(Fr, At, b, steps)
    assert np.array_equal(xs[-1], sstt.solve_refined(
        supernodal.SupernodalFactorAdapter(Ft), At, b, iters=steps))
    _gates(At, b, xs[0], xs[-1])
    _gates(At, b, xsj[0], xsj[-1])
    assert np.abs(xs[-1] - xsj[-1]).max() <= X_TOL * np.abs(xsj[-1]).max()
    if steps != 2:
        # the reference test's 2 steps: the same residual on both packages
        r2 = sstt.residual_norm(At, xs[2], b)
        r2j = sstt.residual_norm(At, xsj[2], b)
        assert abs(r2 - r2j) <= 1e-3 * r2j and r2 > REFINED


def test_cholsol_takes_the_bf16_factor(monkeypatch):
    """``cholsol`` and ``factorize`` pass the config through: the device
    factor holds its updates in bfloat16, and the one-call x is the split
    calls' x."""
    udt = []

    def group_spy(F, Us, work):
        udt.extend(U.dtype for U in Us)
        return k7.extend_add_group(F, Us, work)

    monkeypatch.setattr(sd, "extend_add_group", group_spy)
    A = sstt.fixtures.laplacian_3d(12)
    b = 1.0 + np.arange(A.ncol) / A.ncol
    cfg = _port_cfg()
    x = sstt.cholsol(A, b, cfg, device="cpu")
    assert udt and set(udt) == {BF16}
    F = sstt.factorize(A, sstt.analyze(A, cfg), cfg, device="cpu")
    assert isinstance(F.F, supernodal.TorchSupernodalFactor)
    assert np.array_equal(x, sstt.solve(F, b, cfg))
    r0 = sstt.residual_norm(A, x, b)
    r = sstt.residual_norm(A, sstt.solve_refined(F, A, b, config=cfg), b)
    assert r0 < ONE_SOLVE and r < REFINED and r <= r0


@pytest.mark.parametrize("fdtype", [torch.float32, torch.float64])
def test_plain_k7_widens_bf16_exactly(fdtype):
    """K7's plain version, one class and a group, and the library scatter:
    a bfloat16 U gives the bits of U widened to F's dtype."""
    rng = np.random.default_rng(0)
    B, R, B_c = 4, 40, 9
    classes, Us = [], []
    for k, RU in enumerate((16, 12)):
        idx = np.full((6, RU), -1, np.int32)
        for p, nv in enumerate(rng.integers(RU // 2, RU + 1, 6)):
            idx[p, :nv] = np.sort(rng.choice(R, nv, replace=False))
        dst = np.sort(rng.integers(0, B, 6)).astype(np.int32)
        src = rng.permutation(B_c)[:6].astype(np.int32)
        classes.append(((0, k), src, dst, idx))
        Us.append(torch.as_tensor(rng.standard_normal((B_c, RU, RU)))
                  .to(BF16))
    work = k7.build_work(B, R, classes).to(CPU)
    F0 = torch.as_tensor(rng.standard_normal((B, R, R))).to(fdtype)
    got = k7.extend_add_group(F0.clone(), Us, work)
    want = k7.extend_add_group(F0.clone(), [U.to(fdtype) for U in Us], work)
    assert got.dtype == fdtype and torch.equal(got, want)
    idx, dst, src = k7.class_maps(work, 0)
    assert torch.equal(k7.extend_add(F0.clone(), Us[0], idx, dst, src),
                       k7.extend_add_plain(F0.clone(), Us[0].to(fdtype),
                                           idx, dst, src))
    Fl = torch.cat([F0.reshape(-1), F0.new_zeros(1)])
    lib = k7.extend_add_library(Fl.clone(), Us[0], idx, dst, R, src)
    assert lib.dtype == fdtype and torch.equal(
        lib, k7.extend_add_library(Fl.clone(), Us[0].to(fdtype), idx, dst,
                                   R, src))


def test_group_compute_rounds_u_once():
    """One group with children, fed bfloat16 children and the same
    children widened: the same panel, and U equal to the fp32 U rounded."""
    A = sstt.fixtures.laplacian_3d(8)
    S = port_analyze_supernodal(A, sstt.ordering.nested_dissection_order(
        A, sstt.DEFAULT))
    dp = sd.device_plan(A, S, CPU)
    Cdata = torch.as_tensor(sd._clow_data(A, S)).float()
    walk = [(g, ix) for gl, il in zip(dp.plan.groups, dp.groups)
            for g, ix in zip(gl, il) if g.pairs and g.R > g.C]
    g, ix = max(walk, key=lambda gi: len(gi[0].pairs))
    rng = np.random.default_rng(1)
    up16 = {}
    for pc in g.pairs:
        B_c = dp.plan.groups[pc.src_level][pc.src_gi].B
        u = rng.standard_normal((B_c, pc.RU_c, pc.RU_c)) * 1e-2
        up16[pc.src_level, pc.src_gi] = torch.as_tensor(u + u.transpose(
            0, 2, 1)).to(BF16)
    up32 = {k: v.float() for k, v in up16.items()}
    ix = sd._select(ix, torch.float32, BF16)
    P16, U16 = sd._group_compute(g, ix, Cdata, up16, torch.float32,
                                 udtype=BF16)
    P32, U32 = sd._group_compute(g, ix, Cdata, up32, torch.float32)
    assert torch.isfinite(P32).all() and U32.dtype == torch.float32
    assert torch.equal(P16, P32)
    assert U16.dtype == BF16 and torch.equal(U16, U32.to(BF16))


def test_bf16_factor_reads_no_tile_arrays(monkeypatch):
    """At tile_rmin=32 the plan has manifests: the fp32 factor runs K2 on
    them, a bfloat16 factor (fp32 or fp64 fronts) never calls K2 and
    places every class of every group through K7 in one call a group, its
    updates all bfloat16; ``_select`` drops the tile arrays."""
    tiles, groups = [], []

    def tile_spy(F, Ucat, *rest):
        tiles.append(Ucat.dtype)
        return F

    def group_spy(F, Us, work):
        groups.append(({U.dtype for U in Us}, len(Us)))
        return k7.extend_add_group(F, Us, work)

    monkeypatch.setattr(sd, "extend_add_tiles", tile_spy)
    monkeypatch.setattr(sd, "extend_add_group", group_spy)
    A = sstt.fixtures.laplacian_3d(12)
    S = port_analyze_supernodal(A, sstt.ordering.nested_dissection_order(
        A, sstt.DEFAULT))
    dp = sd.device_plan(A, S, CPU, 32)
    plan_groups = [g for gl in dp.plan.groups for g in gl]
    assert sum(g._tile is not None for g in plan_groups) >= 2
    for ix in dp.host:
        for dt in (torch.float32, torch.float64):
            sel = sd._select(ix, dt, BF16)
            assert sel.tile is None and sel.uslices == [] and sel.k7 is None
            assert (sel.k7_all is None) == (ix.k7_all is None)
    n_classes = sum(len(g.pairs) for g in plan_groups)
    with_classes = sum(bool(g.pairs) for g in plan_groups)
    for dtype in ("float32", "float64"):
        tiles.clear()
        groups.clear()
        F = sd.factorize_device(A, S, _port_cfg(dtype), CPU, tile_rmin=32)
        assert F.ok and not tiles
        assert len(groups) == with_classes
        assert sum(n for _d, n in groups) == n_classes
        assert all(d == {BF16} for d, _n in groups)
    groups.clear()
    sd.factorize_device(A, S, sstt.DEFAULT, CPU, tile_rmin=32)
    assert tiles and all(d == {torch.float32} for d, _n in groups)


def test_bf16_factor_keeps_the_failed_tile_nan():
    """F5 under bfloat16 updates: an indefinite matrix leaves NaN in the
    factor, and the minor is the fp32-update factor's (which
    ``test_torch_supernodal.py`` holds to the reference's)."""
    A = sstt.fixtures.laplacian_3d(8, shift=-3.0)
    S = port_analyze_supernodal(A, sstt.ordering.nested_dissection_order(
        A, sstt.DEFAULT))
    F = sd.factorize_device(A, S, _port_cfg(), CPU)
    F32 = sd.factorize_device(A, S, sstt.DEFAULT, CPU)
    assert not torch.isfinite(F.Lx).all()
    assert F.minor == F32.minor < A.ncol


def test_segmented_bf16_factor_is_bit_equal():
    """A bfloat16 factor forced into at least 4 segments equals the
    one-piece bfloat16 factor; the cost lists and the schedule are kept per
    (compute dtype, update dtype), the update at 2 bytes."""
    A = sstt.fixtures.laplacian_3d(6)
    S = port_analyze_supernodal(A, sstt.ordering.nested_dissection_order(
        A, sstt.DEFAULT))
    for dtype in ("float32", "float64"):
        one = sd.factorize_device(A, S, _port_cfg(dtype), CPU)
        seg = sd.factorize_device(
            A, S, _port_cfg(dtype, segment_bytes=20_000), CPU)
        assert one.segments == 1 and seg.segments >= 4
        assert torch.equal(one.Lx, seg.Lx)
    sd.factorize_device(A, S, sstt.DEFAULT.replace(segment_bytes=20_000),
                        CPU)
    dp = next(iter(S._torch_plan.values()))
    f32, f64 = torch.float32, torch.float64
    assert {(f32, BF16), (f64, BF16), (f32, f32)} <= set(dp.costs)
    assert dp.schedule[0][2] == str(f32)    # the last factor's update dtype
    groups = [g for gl in dp.plan.groups for g in gl]
    for (i16, w16), (i32, w32), g in zip(dp.costs[f32, BF16],
                                         dp.costs[f32, f32], groups):
        assert i16 <= i32
        assert w32 - w16 == 2 * g.B * (g.R - g.C) ** 2


def _magnetic(k, seed):
    """``laplacian_3d(k)`` with each strictly-upper entry times e^{i theta}
    (``tests/test_torch_complex.py``'s), in both packages."""
    A = sstt.fixtures.laplacian_3d(k)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    off = A.indices < cols
    theta = np.random.default_rng(seed).uniform(-np.pi, np.pi,
                                                int(off.sum()))
    data = A.data.astype(np.complex128)
    data[off] *= np.exp(1j * theta)
    return (sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, data, 1),
            sst.CSC(A.nrow, A.ncol, A.indptr.copy(), A.indices.copy(),
                    data.copy(), 1))


def test_complex_embedding_with_bf16_updates(monkeypatch):
    H, Hj = _magnetic(6, seed=3)
    Hd = H.to_dense()
    b = 1 + 1j * np.arange(H.ncol) / H.ncol
    udt = []

    def group_spy(F, Us, work):
        udt.extend(U.dtype for U in Us)
        return k7.extend_add_group(F, Us, work)

    monkeypatch.setattr(sd, "extend_add_group", group_spy)
    cfg = _port_cfg()
    cfgj = sst.DEFAULT.replace(update_dtype="bfloat16")

    def refined(solve):
        x0 = solve(b)
        x = x0
        for _ in range(2):
            x = x + solve(b - Hd @ x)
        return x0, x

    x0, x = refined(lambda r: ce.cholsol_complex_device(H, r, cfg,
                                                        device="cpu"))
    x0j, xj = refined(lambda r: ref_ce.cholsol_complex_device(Hj, r, cfgj))
    assert udt and set(udt) == {BF16}
    for y0, y in ((x0, x), (x0j, xj)):
        g0 = np.abs(Hd @ y0 - b).max() / np.abs(b).max()
        g = np.abs(Hd @ y - b).max() / np.abs(b).max()
        assert g0 < ONE_SOLVE and g < REFINED and g <= g0, (g0, g)
    assert np.abs(x - xj).max() <= X_TOL * np.abs(xj).max()


def _near_duplicate(m=120, n=60, seed=5):
    """A random m x n matrix (strong diagonal, 5% fill) whose column 7 is
    column 5 plus 1e-9 noise: full rank at SPQR's tolerance, rank n - 1
    at 1e-6. As (port CSC, reference CSC)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.05)
    D[np.arange(n), np.arange(n)] += 3.0
    D[:, 7] = D[:, 5] + 1e-9 * (D[:, 5] != 0) * rng.standard_normal(m)
    r, c = np.nonzero(D)
    return (sstt.from_triplets(m, n, r, c, D[r, c]),
            sst.from_triplets(m, n, r, c, D[r, c]))


def test_qr_tol_changes_rank_and_x_alike():
    _reference_native()
    A, Aj = _near_duplicate()
    n = A.ncol
    b = np.random.default_rng(5).standard_normal(A.nrow)
    xs = {}
    for tol, rank in ((-1.0, n), (1e-6, n - 1)):
        cfg = sstt.DEFAULT.replace(qr_tol=tol)
        cfgj = sst.DEFAULT.replace(qr_tol=tol)
        F = qr.qr_host(A, qr.symbolic_qr(A, cfg), cfg)
        Fj = ref_qr.qr_host(Aj, ref_qr.symbolic_qr(Aj, cfgj), cfgj)
        assert F.rank_est == Fj.rank_est == rank
        assert F.tol == Fj.tol and (tol < 0 or F.tol == tol)
        xs[tol] = x = sstt.qrsol(A, b, cfg, device="cpu")
        xj = sst.qrsol(Aj, b, cfgj)
        if rank == n:
            assert np.array_equal(x, xj)
        else:
            # F17: the same dead column, and the port's x is least squares
            # on the live ones where the reference's drops the dead
            # pivot's row of R
            D = A.to_dense()
            live = x != 0.0
            assert np.array_equal(live, xj != 0.0) and live.sum() == rank
            xl = np.linalg.lstsq(D[:, live], b, rcond=None)[0]
            rl = np.linalg.norm(D[:, live] @ xl - b)
            r = np.linalg.norm(D @ x - b)
            assert abs(r - rl) <= 1e-10 * rl
            assert r <= np.linalg.norm(D @ xj - b) * (1 + 1e-12)
        SQ = mfqr.analyze_mfqr(A, cfg)
        SQj = ref_mfqr.analyze_mfqr(Aj, cfgj)
        Fm = mfqr.factorize_qr_host(A, SQ, b, cfg)
        Fmj = ref_mfqr.factorize_qr_host(Aj, SQj, b, cfgj)
        assert Fm.rank_est == Fmj.rank_est == rank
        Fd = md.factorize_qr_device(A, SQ, b, cfg.replace(
            compute_dtype="float64"), "cpu")
        assert Fd.rank_est == rank
        assert Fd.tol == (tol if tol >= 0 else md.rank_tol(A, torch.float64))
    assert not np.array_equal(xs[-1.0], xs[1e-6])
    assert xs[1e-6][5] == 0.0 or xs[1e-6][7] == 0.0


def test_colamd_dense_cuts_match_reference():
    """One dense row and one dense column: the default cuts set both
    aside; other cuts keep them (and change the order) or set more
    aside, with the reference's permutation each time; the fallback's
    A'A pattern drops the rows its cut names."""
    _reference_native()
    rng = np.random.default_rng(3)
    m, n = 300, 200
    D = (rng.random((m, n)) < 0.02) * rng.standard_normal((m, n))
    D[np.arange(n), np.arange(n)] += 3.0
    D[17, :] = 1.0
    D[:, 29] = 1.0
    r, c = np.nonzero(D)
    A = sstt.from_triplets(m, n, r, c, D[r, c])
    Aj = sst.from_triplets(m, n, r, c, D[r, c])
    cset = np.arange(n) % 3
    orders = {}
    for cuts in ((10.0, 10.0), (100.0, 100.0), (0.5, 0.5), (100.0, 0.5)):
        kw = dict(colamd_dense_row=cuts[0], colamd_dense_col=cuts[1])
        cfg, cfgj = sstt.DEFAULT.replace(**kw), sst.DEFAULT.replace(**kw)
        orders[cuts] = q = colamd.colamd_order(A, cfg)
        assert np.array_equal(q, ref_colamd.colamd_order(Aj, cfgj))
        assert np.array_equal(colamd.ccolamd_order(A, cset, cfg),
                              ref_colamd.ccolamd_order(Aj, cset, cfgj))
        P = colamd._ata_pattern(A, cfg)
        Pj = ref_colamd._ata_pattern(Aj, cfgj)
        assert np.array_equal(P.indptr, Pj.indptr)
        assert np.array_equal(P.indices, Pj.indices)
    assert not np.array_equal(orders[10.0, 10.0], orders[100.0, 100.0])
    kept = colamd._ata_pattern(A, sstt.DEFAULT.replace(
        colamd_dense_row=100.0))
    assert kept.indptr[-1] > colamd._ata_pattern(A, sstt.DEFAULT).indptr[-1]


def test_config_lacks_only_the_unread_reference_fields():
    """The port's Config holds every field of the reference's that some
    reference code reads; the rest are the twelve unread ones, and the
    port adds only its own knobs. Each shared field has the reference's
    default."""
    ref = {f.name: f for f in dataclasses.fields(ref_config.Config)}
    port = {f.name: f for f in dataclasses.fields(port_config.Config)}
    unread = {"accum_dtype", "grow_ratio", "leaf_batch", "lu_memgrow",
              "nd_components", "nd_oksep", "panel_pad", "sublane_pad",
              "umf_block_size", "umf_pivot_tol", "umf_sym_pivot_tol",
              "use_pallas"}
    own = {"solve_mode", "tile_pair", "solve_pmv", "solve_bmv",
           "segment_bytes"}
    assert set(ref) - set(port) == unread
    assert set(port) - set(ref) == own
    for name in {"update_dtype", "qr_tol", "colamd_dense_row",
                 "colamd_dense_col"}:
        assert port[name].default == ref[name].default
    for name in set(ref) & set(port):
        if not isinstance(ref[name].default, dataclasses._MISSING_TYPE):
            dr, dp = ref[name].default, port[name].default
            assert getattr(dr, "value", dr) == getattr(dp, "value", dp), name
    assert sd.update_dtype(sstt.DEFAULT, torch.float64) == torch.float64
    assert sd.update_dtype(_port_cfg(), torch.float64) == BF16
    assert sd.update_dtype(sstt.DEFAULT.replace(update_dtype="float16"),
                           torch.float32) == torch.float32


def test_roofline_counts_bf16_updates_at_two_bytes():
    A = sstt.fixtures.laplacian_3d(8)
    S = port_analyze_supernodal(A, sstt.ordering.nested_dissection_order(
        A, sstt.DEFAULT))
    plan = sd.device_plan(A, S, CPU).plan
    r32 = sd._roofline_rows(plan, 4)
    r16 = sd._roofline_rows(plan, 4, 2)
    assert sd._roofline_rows(plan, 4, 4) == r32
    cells = 0
    for g, a, c in zip((g for gl in plan.groups for g in gl), r32, r16):
        assert a[:5] == c[:5]                    # flops unchanged
        upd = g.B * (g.R - g.C) ** 2 + sum(
            int(((idx >= 0).sum(1).astype(np.int64) ** 2).sum())
            for _s, _d, idx in g._pair_arrays)
        assert a[5] - c[5] == 2 * upd
        cells += upd
    assert cells > 0
    rep = sd.roofline_report(S, 4, 2)
    assert "16-bit updates" in rep.splitlines()[0]
    tot32 = float(sd.roofline_report(S).splitlines()[-1].split()[2])
    tot16 = float(rep.splitlines()[-1].split()[2])
    assert tot32 - tot16 == pytest.approx(2 * cells / 1e6, abs=0.11)
