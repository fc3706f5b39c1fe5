"""Port's batched potrf+trsm (plain version on the CPU) vs the Pallas kernel.

The reference kernel runs in Pallas interpret mode, as its own tests run it
off the TPU. Both compute the same right-looking column loop in fp32; only
rounding (fused multiply-adds, operation order inside XLA) differs, so L11
and L21 are held to 1e-5 relative to their largest entry."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from suitesparse_tpu.kernels.potrf import batched_potrf_trsm
from suitesparse_tpu_torch.kernels.potrf import (
    FILL_BLOCKS, FILL_WARPS, INSTANCES, MAX_C, MAX_WARPS, SEG_WARPS,
    potrf_geometry, potrf_trsm, potrf_trsm_plain, row_stride, team_floats)
from suitesparse_tpu_torch.kernels.potrf_sweep import K1_GROUPS
from suitesparse_tpu_torch.kernels.trisolve import SMEM_BYTES, SMS

RTOL = 1e-5


def _tiles(B, C, RU, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, C, C))
    F11 = (M @ np.swapaxes(M, 1, 2) + C * np.eye(C)).astype(np.float32)
    F21 = rng.standard_normal((B, RU, C)).astype(np.float32)
    return F11, F21


def _reference(F11, F21):
    L11, L21 = batched_potrf_trsm(
        jnp.asarray(F11), jnp.asarray(F21) if F21.shape[1] else None,
        interpret=True)
    return np.asarray(L11), (None if L21 is None else np.asarray(L21))


@pytest.mark.parametrize("B,C,RU", [(3, 8, 0), (7, 12, 20), (40, 16, 8),
                                    (33, 96, 40), (45, 48, 384),
                                    (40, 32, 256), (37, 8, 8), (33, 96, 0)])
def test_plain_matches_pallas(B, C, RU):
    F11, F21 = _tiles(B, C, RU, seed=B * 1000 + C)
    R11, R21 = _reference(F11, F21)
    L11, L21 = potrf_trsm_plain(torch.from_numpy(F11),
                                torch.from_numpy(F21) if RU else None)
    L11 = L11.numpy()
    assert np.abs(L11 - R11).max() <= RTOL * np.abs(R11).max()
    assert np.triu(L11, 1).max() == 0.0 and np.triu(L11, 1).min() == 0.0
    if RU:
        L21 = L21.numpy()
        assert np.abs(L21 - R21).max() <= RTOL * np.abs(R21).max()
    else:
        assert L21 is None and R21 is None


def test_non_spd_tile_gives_nan_in_the_same_tile():
    F11, F21 = _tiles(6, 12, 10, seed=7)
    F11[2] -= 40.0 * np.eye(12, dtype=np.float32)   # tile 2 is indefinite
    R11, R21 = _reference(F11, F21)
    L11, L21 = potrf_trsm_plain(torch.from_numpy(F11), torch.from_numpy(F21))
    for ref, got in ((R11, L11.numpy()), (R21, L21.numpy())):
        bad_ref = ~np.isfinite(ref).reshape(6, -1).all(axis=1)
        bad_got = ~np.isfinite(got).reshape(6, -1).all(axis=1)
        assert bad_ref.tolist() == bad_got.tolist() == [i == 2
                                                        for i in range(6)]


def test_wrapper_takes_plain_version_on_cpu():
    F11, F21 = _tiles(5, 8, 4, seed=3)
    before = potrf_trsm.launches
    L11, L21 = potrf_trsm(torch.from_numpy(F11), torch.from_numpy(F21))
    P11, P21 = potrf_trsm_plain(torch.from_numpy(F11), torch.from_numpy(F21))
    assert torch.equal(L11, P11) and torch.equal(L21, P21)
    assert potrf_trsm.launches == before     # no kernel launch on the CPU


@pytest.mark.parametrize("C,RU,bad", [(8, 8, 4), (12, 20, 2), (16, 24, 9),
                                      (48, 100, 0), (96, 10, 3)])
def test_packed_tiles_nan_stays_in_its_tile(C, RU, bad):
    """Many tiles, one indefinite among its neighbours (the kernel packs 4
    or 2 tiles of C <= 16 into a warp, each in its own segment): only that
    tile turns non-finite, in the plain version as in the Pallas kernel."""
    B = 11
    F11, F21 = _tiles(B, C, RU, seed=C * 10 + RU)
    F11[bad] -= 4.0 * C * np.eye(C, dtype=np.float32)
    R11, R21 = _reference(F11, F21)
    L11, L21 = potrf_trsm_plain(torch.from_numpy(F11), torch.from_numpy(F21))
    want = [i == bad for i in range(B)]
    for ref, got in ((R11, L11.numpy()), (R21, L21.numpy())):
        for a in (ref, got):
            assert (~np.isfinite(a).reshape(B, -1).all(axis=1)).tolist() \
                == want


# shapes off the plan: C = 1, 12, 96; B not a multiple of the tiles a warp;
# RU = 0, 1, 500; a part staged in several chunks; C > 32 not a multiple of 4
EDGE_SHAPES = ((5, 1, 3), (3, 1, 500), (7, 12, 20), (5, 12, 1), (9, 8, 0),
               (33, 96, 0), (7, 96, 500), (1, 96, 4000), (37, 8, 8),
               (2, 37, 101), (3, 45, 13), (1, 64, 1), (10, 16, 500),
               (3, 24, 1))
FORCED = ({"split": 1}, {"split": 2}, {"split": 4}, {"split": 8},
          {"split": 16}, {"tpw": 1}, {"tpw": 2}, {"tpw": 4}, {"wpt": 2},
          {"wpt": 3}, {"wpt": 4}, {"wpt": 8})


def _plans(B, C, RU):
    """The plan and every forced plan the geometry takes for the shape."""
    plans = [potrf_geometry(B, C, RU)]
    for kw in FORCED:
        try:
            plans.append(potrf_geometry(B, C, RU, **kw))
        except ValueError:
            pass
    return plans


def _walk(g, B, C, RU):
    """What the kernel's threads write under plan g, by its indexing:
    (count of writes of each L21 row (B, RU), of each L11 (B,)). A team
    takes unit blockIdx * teams + team; a live unit is (tile, part); part
    0's threads t < C write L11's rows; the part's rows go in chunks of
    crow, thread t taking the chunk's rows t, t + lanes, ..."""
    teams = 1 if g.inst > 32 else g.warps * g.tpw
    rows = np.zeros((B, RU), np.int64)
    l11 = np.zeros(B, np.int64)
    for unit in range(g.blocks * teams):
        if unit >= B * g.split:
            continue
        b, part = divmod(unit, g.split)
        if part == 0:
            l11[b] += 1
        r0 = part * g.prow
        nrows = max(0, min(g.prow, RU - r0))
        for c0 in range(0, nrows, max(g.crow, 1)):
            n = min(g.crow, nrows - c0)
            got = np.concatenate([np.arange(t, n, g.lanes)
                                  for t in range(g.lanes)])
            np.add.at(rows[b], r0 + c0 + got, 1)
    return rows, l11


@pytest.mark.parametrize("B,C,RU", K1_GROUPS + EDGE_SHAPES)
def test_geometry_covers_every_row_once(B, C, RU):
    """Under the plan and every forced plan, each L21 row of each tile is
    written by exactly one thread, each L11 by exactly one team, whose
    threads hold all C rows of the factor."""
    for g in _plans(B, C, RU):
        rows, l11 = _walk(g, B, C, RU)
        assert (rows == 1).all() and (l11 == 1).all(), g
        factor_threads = g.lanes if g.inst <= 32 else 32 * -(-g.inst // 32)
        assert C <= g.inst <= factor_threads and g.lanes <= g.threads, g


@pytest.mark.parametrize("B,C,RU", K1_GROUPS + EDGE_SHAPES)
def test_geometry_limits(B, C, RU):
    """The least instance that holds C; teams as the kernel's entry point
    checks them; shared memory as the kernel lays it out, within the
    card's 227 KB; whole warps, at most MAX_WARPS a block."""
    for g in _plans(B, C, RU):
        assert g.inst == min(i for i in INSTANCES if i >= C)
        if g.inst <= 32:
            assert g.wpt == 1 and g.lanes in (8, 16, 32) and \
                g.lanes >= g.inst and g.tpw == 32 // g.lanes
            assert 1 <= g.warps <= SEG_WARPS
            teams = g.warps * g.tpw
        else:
            assert g.tpw == 1 and g.lanes == 32 * g.wpt == 32 * g.warps
            assert -(-g.inst // 32) <= g.wpt <= MAX_WARPS
            teams = 1
        assert g.threads == 32 * g.warps <= 32 * MAX_WARPS
        assert g.smem == 4 * teams * team_floats(g.inst, g.lanes, g.crow, C)
        assert g.smem <= SMEM_BYTES
        assert g.blocks == -(-B * g.split // teams)
        if RU == 0:
            assert (g.split, g.prow, g.crow) == (1, 0, 0)
        else:
            assert 1 <= g.crow <= g.prow and g.split == -(-RU // g.prow)
        # staged rows at an odd number of 16-byte words; segments of a warp
        # lanes banks apart
        assert row_stride(C) % 4 == 0 and (row_stride(C) // 4) % 2 == 1
        tf = team_floats(g.inst, g.lanes, g.crow, C)
        assert tf % 4 == 0 and (g.lanes >= 32 or tf % 32 == g.lanes)


@pytest.mark.parametrize("B,C,RU", K1_GROUPS)
def test_geometry_fills_the_card(B, C, RU):
    """The plan's own rule: RU is split until the grid has FILL_WARPS
    warps of segments (FILL_BLOCKS blocks for C > 32), unless a part is
    already down to one row a thread; a block of segments packs more warps
    only while the grid keeps 4 blocks an SM."""
    g = potrf_geometry(B, C, RU)
    if g.inst <= 32:
        teams, fill = -(-B * g.split // g.tpw), FILL_WARPS
    else:
        teams, fill = B * g.split, FILL_BLOCKS
    assert teams >= fill or g.prow <= g.lanes
    if g.inst > 32:   # the warps that hold L11's rows
        assert g.wpt == -(-g.inst // 32)
    # no more parts than that asks for, none of fewer rows than threads
    per_team = fill * g.tpw if g.inst <= 32 else fill
    assert g.split <= max(1, -(-per_team // B))
    assert g.split <= max(1, -(-RU // g.lanes))
    if g.inst <= 32 and g.warps > 1:
        assert g.blocks >= 4 * SMS


def test_geometry_on_the_plan():
    """The plan's 24 K1 groups take the instances 8, 16, 32 and 48 (the
    ones whose registers the build log is read for), and every group with
    RU > 0 is split until the grid has a row a thread or fills the card."""
    insts = {potrf_geometry(*s).inst for s in K1_GROUPS}
    assert insts == {8, 16, 32, 48}
    for B, C, RU in K1_GROUPS:
        g = potrf_geometry(B, C, RU)
        assert g.split > 1 or B * RU >= FILL_WARPS * 32, (B, C, RU, g)


@pytest.mark.parametrize("B,C,RU,kw", [
    (4, 0, 8, {}), (4, MAX_C + 1, 8, {}), (4, 8, -1, {}), (-1, 8, 8, {}),
    (4, 12, 8, {"tpw": 4}), (4, 8, 8, {"tpw": 3}), (4, 40, 8, {"tpw": 2}),
    (4, 48, 8, {"wpt": 1}), (4, 96, 8, {"wpt": 2}), (4, 48, 8, {"wpt": 9}),
    (4, 8, 8, {"wpt": 2}), (4, 8, 0, {"split": 2}), (4, 8, 8, {"split": 0})])
def test_geometry_refuses(B, C, RU, kw):
    """Shapes the kernel does not take, and forced plans that are not one."""
    with pytest.raises(ValueError):
        potrf_geometry(B, C, RU, **kw)
