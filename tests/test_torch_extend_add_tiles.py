"""Port's tiled extend-add (plain version on the CPU) vs the Pallas kernel.

Real manifests from the port's ``build_plan`` on its own analysis
(``tile_rmin=32`` so small problems have tile groups), seeded fronts and
child updates with NaN in some upper child cells. The reference kernel runs
in Pallas interpret mode. Both add the same child cells into the same parent
cells; only the order of the additions differs (the reference adds piece by
piece into F, the port sums the pieces first), so lower tiles inside R are
held to 1e-6 relative.

Off the plans (``synthetic_group``): an odd R (the kernel's 4-byte F
path), a front that takes five children (runs of five steps) and a
manifest of a few tiles, both forms, held against the Pallas kernel the
same way. The kernel's launch plan (``tile_geometry``) is walked on every
test-plan manifest at every split: each row of a visited tile belongs to
exactly one warp of one slab, and shared memory stays within the card's.

The two-piece form (``tile_pair``): the port's manifests equal the
reference's ``build_group_manifest(..., npiece=2)`` bit for bit, its plain
extend-add equals the one-piece one, and the port's factor with
``tile_pair=True`` matches the reference's with ``SSTPU_TILE_PAIR=1``
within 2e-6 * max|Lx|, the reference's own tolerance for that form
(``tests/test_extend_add_tiles.py``).

256-wide tiles (``build_plan(..., tile_big=, tile_frac=)``, the
reference's ``SSTPU_TILE_BIG`` and ``SSTPU_TILE_FRAC``): the manifests equal
the reference's at T = 256 in both forms and two fold fractions; the plain
version matches the Pallas kernel at T = 256 (1e-6, both forms, off the
plans); the port's factor matches the reference's under its switches
(1e-5 * max|Lx|) and, where a 256-wide group hands its update to a class
no manifest folds, the factor without tiles; the launch plan at T = 256
covers every row once; maps of another width raise."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.kernels.extend_add_tiles import \
    build_group_manifest as build_group_manifest_ref
from suitesparse_tpu.kernels.extend_add_tiles import \
    extend_add_tiles as extend_add_tiles_pallas
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.ordering import \
    nested_dissection_order as ref_nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import \
    analyze_supernodal as ref_analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.ordering import nested_dissection_order
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal
from suitesparse_tpu_torch.kernels.extend_add_tiles import (
    FILL_BLOCKS, SPLITS, TILE, WIDE_SPLITS, build_group_manifest,
    extend_add_tiles, extend_add_tiles_plain, manifest_work, run_ptr,
    synthetic_group, tile_geometry)
from suitesparse_tpu_torch.kernels.trisolve import SMEM_BYTES
from suitesparse_tpu_torch.numeric import supernodal_device
from suitesparse_tpu_torch.numeric.supernodal_device import build_plan

RTOL = 1e-6
PAIR_TOL = 2e-6


def _tile_groups(nx, tile_pair=False):
    A = sstt.fixtures.laplacian_3d(nx)
    S = analyze_supernodal(A, nested_dissection_order(A, sstt.DEFAULT))
    plan = build_plan(S, A.symperm(S.perm).transpose(), tile_rmin=32,
                      tile_pair=tile_pair)
    return [g for gl in plan.groups for g in gl if g._tile is not None]


def _picked(nx):
    """The groups with the most steps, the largest front and the widest
    child block (RUp = 256 exercises the second child block row/col)."""
    gs = _tile_groups(nx)
    picks = {id(max(gs, key=lambda g: g._tile.man.shape[0])): None,
             id(max(gs, key=lambda g: g.R)): None,
             id(max(gs, key=lambda g: (g._tile.RUp, g.R))): None}
    return [g for g in gs if id(g) in picks]


def _inputs(g, seed):
    tm = g._tile
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((g.B, g.R, g.R)).astype(np.float32)
    U = rng.standard_normal((max(tm.nslots, 1), tm.RUp, tm.RUp)) \
        .astype(np.float32)
    upper = np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)
    U[(rng.random(U.shape) < 0.05) & upper] = np.nan
    return F, U


def _lower_tiles(R):
    t = np.arange(R) // TILE
    return t[:, None] >= t[None, :]


@pytest.mark.parametrize("nx", [10, 12])
def test_plain_matches_pallas_on_real_manifests(nx):
    groups = _picked(nx)
    assert groups
    for k, g in enumerate(groups):
        tm = g._tile
        F, U = _inputs(g, seed=100 * nx + k)
        assert np.isnan(U).any()
        ref = np.asarray(extend_add_tiles_pallas(
            jnp.asarray(F), jnp.asarray(U), tm.man, tm.rowmap, tm.colmap,
            interpret=True))
        got = extend_add_tiles_plain(
            torch.from_numpy(F.copy()), torch.from_numpy(U),
            torch.from_numpy(tm.man), torch.from_numpy(tm.rowmap),
            torch.from_numpy(tm.colmap)).numpy()
        low = _lower_tiles(g.R)[None].repeat(g.B, 0)
        assert np.isfinite(got[low]).all()
        scale = np.abs(ref[low]).max()
        assert np.abs(got[low] - ref[low]).max() <= RTOL * scale
        # tiles no step visits keep their content
        assert np.array_equal(got[~low], F[~low])


def test_wrapper_takes_plain_version_on_cpu():
    g = _picked(10)[0]
    tm = g._tile
    F, U = _inputs(g, seed=1)
    args = [torch.from_numpy(a) for a in (U, tm.man, tm.rowmap, tm.colmap)]
    before = extend_add_tiles.launches
    Ft = torch.from_numpy(F.copy())
    out = extend_add_tiles(Ft, *args, torch.from_numpy(g._tile_runs))
    assert out is Ft                                   # in place
    ref = extend_add_tiles_plain(torch.from_numpy(F.copy()), *args)
    assert torch.equal(out, ref)
    assert extend_add_tiles.launches == before


@pytest.mark.parametrize("nx", [10, 12])
def test_run_ptr_marks_each_tile_run(nx):
    for g in _tile_groups(nx):
        man = g._tile.man
        rp = run_ptr(man)
        assert np.array_equal(g._tile_runs, rp)
        assert rp.dtype == np.int32 and rp[0] == 0 and rp[-1] == len(man)
        assert np.array_equal(rp[:-1], np.flatnonzero(man[:, 3] == 1))
        for a, b in zip(rp[:-1], rp[1:]):
            tiles = {tuple(r) for r in man[a:b, :3]}
            assert len(tiles) == 1                     # one tile per run
        starts = man[rp[:-1], :3]
        assert len({tuple(r) for r in starts}) == len(starts)  # disjoint
        assert (man[:, 2] <= man[:, 1]).all()          # lower tiles only


@pytest.mark.parametrize("nx", [10, 12])
def test_pair_manifests_equal_the_reference(nx):
    groups = _tile_groups(nx, tile_pair=True)
    assert groups
    for g in groups:
        tm = g._tile
        ref = build_group_manifest_ref(g, T=TILE, ru_min_frac=0.0, npiece=2)
        assert tm.man.shape[1] == 14 and tm.rowmap.shape[1] == 2
        for field in ("man", "rowmap", "colmap"):
            got, want = getattr(tm, field), getattr(ref, field)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (tm.RUp, tm.nslots, tm.folded) == (ref.RUp, ref.nslots,
                                                  ref.folded)
        assert np.array_equal(g._tile_runs, run_ptr(tm.man))


@pytest.mark.parametrize("nx", [10, 12])
def test_plain_pair_equals_plain_one_piece(nx):
    one = {(g.R, g.B, g.panel_base): g for g in _tile_groups(nx)}
    for k, g2 in enumerate(_tile_groups(nx, tile_pair=True)):
        g1 = one[(g2.R, g2.B, g2.panel_base)]
        assert g2._tile.man.shape[0] < g1._tile.man.shape[0] or \
            g1._tile.man.shape[0] == 1
        F, U = _inputs(g1, seed=7 * nx + k)
        got = [extend_add_tiles_plain(
            torch.from_numpy(F.copy()), torch.from_numpy(U),
            *(torch.from_numpy(a) for a in (g._tile.man, g._tile.rowmap,
                                            g._tile.colmap))).numpy()
            for g in (g1, g2)]
        low = _lower_tiles(g1.R)[None].repeat(g1.B, 0)
        scale = np.abs(got[0][low]).max()
        assert np.abs(got[1] - got[0]).max() <= RTOL * scale
        assert np.array_equal(got[1][~low], F[~low])


def test_pair_wrapper_takes_plain_version_on_cpu():
    g = _tile_groups(10, tile_pair=True)[0]
    tm = g._tile
    F, U = _inputs(g, seed=3)
    args = [torch.from_numpy(a) for a in (U, tm.man, tm.rowmap, tm.colmap)]
    before = (extend_add_tiles.launches, extend_add_tiles.pair_launches)
    Ft = torch.from_numpy(F.copy())
    out = extend_add_tiles(Ft, *args, torch.from_numpy(g._tile_runs))
    assert out is Ft
    assert torch.equal(out, extend_add_tiles_plain(torch.from_numpy(F.copy()),
                                                   *args))
    assert (extend_add_tiles.launches,
            extend_add_tiles.pair_launches) == before


def test_pair_factor_matches_reference(monkeypatch):
    for k, v in (("SSTPU_PALLAS", "1"), ("SSTPU_PLACE", "tile"),
                 ("SSTPU_TILE_RMIN", "32"), ("SSTPU_TILE_PAIR", "1")):
        monkeypatch.setenv(k, v)
    Aj = sst.io.fixtures.laplacian_3d(12)
    Sj = ref_analyze_supernodal(Aj, ref_nested_dissection_order(
        Aj, sst.DEFAULT))
    Fj = ref_device.factorize_device(Aj, Sj, sst.DEFAULT)
    A = sstt.fixtures.laplacian_3d(12)
    S = analyze_supernodal(A, Sj.perm)
    cfg = sstt.DEFAULT.replace(tile_pair=True)
    F = supernodal_device.factorize_device(A, S, cfg, "cpu", tile_rmin=32)
    groups = [g for gl in F.dplan.plan.groups for g in gl
              if g._tile is not None]
    assert groups and all(g._tile.man.shape[1] == 14 for g in groups)
    assert Fj.ok and F.ok
    lj = np.asarray(Fj.Lx, dtype=np.float64)
    lt = F.Lx.numpy().astype(np.float64)
    assert lt.shape == lj.shape
    assert np.abs(lt - lj).max() <= PAIR_TOL * np.abs(lj).max()


@pytest.mark.parametrize("tile_pair", [False, True])
@pytest.mark.parametrize("nx", [10, 12])
def test_tile_geometry_covers_every_row_once(nx, tile_pair):
    for g in _tile_groups(nx, tile_pair):
        tm = g._tile
        nruns = len(g._tile_runs) - 1
        npiece = tm.rowmap.shape[1]
        plan = tile_geometry(nruns, g.R, tm.RUp, npiece)
        assert plan.split in SPLITS
        for geo in [plan] + [tile_geometry(nruns, g.R, tm.RUp, npiece, s)
                             for s in SPLITS]:
            owner = np.zeros(TILE, int)
            for b in range(geo.split):
                for w in range(geo.warps):
                    r0 = (b * geo.warps + w) * geo.rows
                    owner[r0:r0 + geo.rows] += 1
            assert (owner == 1).all(), geo
            assert geo.smem == 4 * geo.warps * geo.rows * TILE <= SMEM_BYTES
            assert geo.blocks == nruns * geo.split
            assert geo.threads == 32 * geo.warps
            assert geo.vec == (g.R % 4 == 0)


def test_tile_geometry_plan_and_checks():
    # the least split that gives the grid FILL_BLOCKS blocks, the most
    # where none does
    assert tile_geometry(5000, 2712, 2048, 1).split == SPLITS[0]
    assert tile_geometry(6, 264, 256, 1).split == SPLITS[-1]
    ns = range(1, 2000, 37)
    splits = [tile_geometry(n, 280, 256, 2).split for n in ns]
    assert splits == sorted(splits, reverse=True)
    for n, s in zip(ns, splits):
        assert s == SPLITS[0] or n * (s // 2) < FILL_BLOCKS
        assert s == SPLITS[-1] or n * s >= FILL_BLOCKS
    assert tile_geometry(7, 301, 128, 1).vec == 0
    for bad in ((10, 280, 256, 3), (10, 280, 200, 1),
                (10, 280, 256, 1, 2)):
        with pytest.raises(ValueError):
            tile_geometry(*bad)


# (B, R, classes): an odd R; one front taking five children; few tiles
OFF_PLAN = [(3, 301, ((6, 120), (4, 60))), (1, 384, ((5, 200),)),
            (2, 200, ((3, 90),))]


@pytest.mark.parametrize("npiece", [1, 2])
@pytest.mark.parametrize("B,R,classes", OFF_PLAN)
def test_plain_matches_pallas_off_the_plans(B, R, classes, npiece):
    rng = np.random.default_rng(R + npiece)
    g = synthetic_group(rng, B, R, classes)
    tm = build_group_manifest(g, T=TILE, ru_min_frac=0.0, npiece=npiece)
    runs = run_ptr(tm.man)
    if R == 384:
        assert np.diff(runs).max() * npiece >= 4   # pieces in a run
    if R == 200:
        assert len(runs) - 1 < 10
    F = rng.standard_normal((B, R, R)).astype(np.float32)
    U = rng.standard_normal((tm.nslots, tm.RUp, tm.RUp)).astype(np.float32)
    upper = np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)
    U[(rng.random(U.shape) < 0.05) & upper] = np.nan
    ref = np.asarray(extend_add_tiles_pallas(
        jnp.asarray(F), jnp.asarray(U), tm.man, tm.rowmap, tm.colmap,
        interpret=True))
    args = [torch.from_numpy(a) for a in (U, tm.man, tm.rowmap, tm.colmap)]
    got = extend_add_tiles(torch.from_numpy(F.copy()), *args,
                           torch.from_numpy(runs)).numpy()
    low = _lower_tiles(R)[None].repeat(B, 0)
    assert np.isfinite(got[low]).all()
    assert np.abs(got[low] - ref[low]).max() <= RTOL * np.abs(ref[low]).max()
    assert np.array_equal(got[~low], F[~low])
    # with every child cell 1 and F 0 the manifest adds exactly the cells
    # manifest_work counts
    ones = extend_add_tiles_plain(torch.zeros(B, R, R),
                                  torch.ones(U.shape), *args[1:])
    assert ones.sum().item() == manifest_work(tm, runs, R)[1]


WIDE = 256
WIDE_BIG = 96      # tile_big of the small plans: their largest groups


def _wide_groups(nx, frac, tile_pair=False):
    A = sstt.fixtures.laplacian_3d(nx)
    S = analyze_supernodal(A, nested_dissection_order(A, sstt.DEFAULT))
    plan = build_plan(S, A.symperm(S.perm).transpose(), tile_rmin=32,
                      tile_pair=tile_pair, tile_big=WIDE_BIG, tile_frac=frac)
    return [g for gl in plan.groups for g in gl if g.R >= 32]


@pytest.mark.parametrize("tile_pair", [False, True])
@pytest.mark.parametrize("frac", [0.0, 0.6])
def test_wide_manifests_equal_the_reference(frac, tile_pair):
    groups = _wide_groups(12, frac, tile_pair)
    assert any(g.R >= WIDE_BIG and g._tile is not None for g in groups)
    for g in groups:
        T = WIDE if g.R >= WIDE_BIG else TILE
        ref = build_group_manifest_ref(g, T=T, ru_min_frac=frac,
                                       npiece=2 if tile_pair else 1)
        tm = g._tile
        assert (tm is None) == (ref is None)
        if tm is None:
            continue
        assert tm.rowmap.shape[1:] == (2 if tile_pair else 1, T)
        for field in ("man", "rowmap", "colmap"):
            got, want = getattr(tm, field), getattr(ref, field)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert (tm.RUp, tm.nslots, tm.folded) == (ref.RUp, ref.nslots,
                                                  ref.folded)
        assert tm.RUp % T == 0


@pytest.mark.parametrize("npiece", [1, 2])
def test_wide_plain_matches_pallas(npiece):
    """An odd R over two 256-wide tile rows, a class wider than a tile:
    pieces that span two child blocks."""
    rng = np.random.default_rng(256 + npiece)
    B, R = 2, 301
    g = synthetic_group(rng, B, R, ((3, 290), (2, 40)))
    tm = build_group_manifest(g, T=WIDE, ru_min_frac=0.0, npiece=npiece)
    runs = run_ptr(tm.man)
    assert tm.RUp == 2 * WIDE and (tm.man[:, 1] == 1).any()
    F = rng.standard_normal((B, R, R)).astype(np.float32)
    U = rng.standard_normal((tm.nslots, tm.RUp, tm.RUp)).astype(np.float32)
    upper = np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)
    U[(rng.random(U.shape) < 0.05) & upper] = np.nan
    ref = np.asarray(extend_add_tiles_pallas(
        jnp.asarray(F), jnp.asarray(U), tm.man, tm.rowmap, tm.colmap,
        interpret=True))
    args = [torch.from_numpy(a) for a in (U, tm.man, tm.rowmap, tm.colmap)]
    before = (extend_add_tiles.wide_launches,
              extend_add_tiles.wide_pair_launches)
    got = extend_add_tiles(torch.from_numpy(F.copy()), *args,
                           torch.from_numpy(runs)).numpy()
    assert (extend_add_tiles.wide_launches,
            extend_add_tiles.wide_pair_launches) == before
    t = np.arange(R) // WIDE
    low = (t[:, None] >= t[None, :])[None].repeat(B, 0)
    assert np.isfinite(got[low]).all()
    assert np.abs(got[low] - ref[low]).max() <= RTOL * np.abs(ref[low]).max()
    assert np.array_equal(got[~low], F[~low])
    ones = extend_add_tiles_plain(torch.zeros(B, R, R),
                                  torch.ones(U.shape), *args[1:])
    assert ones.sum().item() == manifest_work(tm, runs, R)[1]


def test_wrapper_refuses_other_widths():
    rng = np.random.default_rng(3)
    g = synthetic_group(rng, 1, 100, ((2, 50),))
    tm = build_group_manifest(g, T=64, ru_min_frac=0.0)
    F = torch.zeros(1, 100, 100)
    U = torch.zeros(tm.nslots, tm.RUp, tm.RUp)
    args = [torch.from_numpy(a) for a in (tm.man, tm.rowmap, tm.colmap,
                                          run_ptr(tm.man))]
    with pytest.raises(ValueError, match="width 64"):
        extend_add_tiles(F, U, *args)


def test_wide_factor_matches_reference(monkeypatch):
    for k, v in (("SSTPU_PALLAS", "1"), ("SSTPU_PLACE", "tile"),
                 ("SSTPU_TILE_RMIN", "32"), ("SSTPU_TILE_BIG", "96"),
                 ("SSTPU_TILE_FRAC", "0.3")):
        monkeypatch.setenv(k, v)
    Aj = sst.io.fixtures.laplacian_3d(10)
    Sj = ref_analyze_supernodal(Aj, ref_nested_dissection_order(
        Aj, sst.DEFAULT))
    Fj = ref_device.factorize_device(Aj, Sj, sst.DEFAULT)
    A = sstt.fixtures.laplacian_3d(10)
    S = analyze_supernodal(A, Sj.perm)
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu",
                                           tile_rmin=32, tile_big=96,
                                           tile_frac=0.3)
    groups = [g for gl in F.dplan.plan.groups for g in gl
              if g._tile is not None]
    widths = {g._tile.rowmap.shape[-1] for g in groups}
    assert widths == {TILE, WIDE}
    assert any(len(g._tile.folded) < len(g.pairs) for g in groups)
    assert Fj.ok and F.ok
    lj = np.asarray(Fj.Lx, dtype=np.float64)
    lt = F.Lx.numpy().astype(np.float64)
    assert lt.shape == lj.shape
    assert np.abs(lt - lj).max() <= 1e-5 * np.abs(lj).max()


def test_wide_tiles_symmetrize_for_full_readers():
    """F8 at T = 256: ``_mark_symmetrize`` flags a 256-wide group whose
    update a class outside its parent's manifest reads whole, and the
    factor with those manifests equals the one without tiles."""
    A = sstt.fixtures.laplacian_3d(12)
    S = analyze_supernodal(A, nested_dissection_order(A, sstt.DEFAULT))
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu",
                                           tile_rmin=32, tile_big=WIDE_BIG,
                                           tile_frac=0.6)
    wide = [g for gl in F.dplan.plan.groups for g in gl
            if g._tile is not None and g._tile.rowmap.shape[-1] == WIDE]
    assert any(g._symm_u for g in wide)
    F0 = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu",
                                            tile_rmin=1 << 40)
    assert F.ok and F0.ok
    l0 = F0.Lx.double()
    assert (F.Lx.double() - l0).abs().max() <= 1e-5 * l0.abs().max()


def test_wide_tile_geometry():
    rng = np.random.default_rng(7)
    g = synthetic_group(rng, 3, 600, ((4, 300), (3, 100)))
    tm = build_group_manifest(g, T=WIDE, ru_min_frac=0.0)
    nruns = len(run_ptr(tm.man)) - 1
    plan = tile_geometry(nruns, g.R, tm.RUp, 1, T=WIDE)
    assert plan.split in WIDE_SPLITS and plan.T == WIDE
    for geo in [plan] + [tile_geometry(nruns, g.R, tm.RUp, 1, s, T=WIDE)
                         for s in WIDE_SPLITS]:
        owner = np.zeros(WIDE, int)
        for b in range(geo.split):
            for w in range(geo.warps):
                r0 = (b * geo.warps + w) * geo.rows
                owner[r0:r0 + geo.rows] += 1
        assert (owner == 1).all(), geo
        assert geo.rows in (8, 4, 2)
        assert geo.smem == 4 * geo.warps * geo.rows * WIDE <= SMEM_BYTES
        assert geo.blocks == nruns * geo.split
    assert tile_geometry(5000, 2712, 2048, 1, T=WIDE).split == WIDE_SPLITS[0]
    assert tile_geometry(6, 600, 512, 2, T=WIDE).split == WIDE_SPLITS[-1]
    for bad in ((10, 600, 512, 1, None, 192), (10, 600, 384, 1, None, WIDE),
                (10, 600, 512, 1, 4, WIDE)):
        with pytest.raises(ValueError):
            tile_geometry(*bad)
