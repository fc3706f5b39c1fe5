"""Port's tiled extend-add (plain version on the CPU) vs the Pallas kernel.

Real manifests from the port's ``build_plan`` on its own analysis
(``tile_rmin=32`` so small problems have tile groups), seeded fronts and child updates with NaN in some
upper child cells. The reference kernel runs in Pallas interpret mode. Both
add the same child cells into the same parent cells; only the order of the
additions differs (the reference adds piece by piece into F, the port sums
the pieces first), so lower tiles inside R are held to 1e-6 relative."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from suitesparse_tpu.kernels.extend_add_tiles import \
    extend_add_tiles as extend_add_tiles_pallas
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.ordering import nested_dissection_order
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal
from suitesparse_tpu_torch.kernels.extend_add_tiles import (
    TILE, extend_add_tiles, extend_add_tiles_plain, run_ptr)
from suitesparse_tpu_torch.numeric.supernodal_device import build_plan

RTOL = 1e-6


def _tile_groups(nx):
    A = sstt.fixtures.laplacian_3d(nx)
    S = analyze_supernodal(A, nested_dissection_order(A, sstt.DEFAULT))
    plan = build_plan(S, A.symperm(S.perm).transpose(), tile_rmin=32)
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
