"""Port's fused solve steps (K3, plain versions on the CPU) vs the Pallas
kernels.

The reference kernels run in Pallas interpret mode at shapes their TPU
VMEM budget takes (``step_fits``); the wider shapes of the card run against
an fp64 numpy solve instead. Inputs are seeded and well conditioned (unit-
ish lower L11, diagonal in [1, 2]). The forward step sums in the kernel's
order; the backward one forms y - L21^T xb as one batched product, in
another order than the TPU kernel's per-column dots (up to 720 terms), so
outputs are held to 1e-5 relative to their largest entry."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from suitesparse_tpu.kernels import solve_step as ref_step
from suitesparse_tpu_torch.kernels.solve_step import (
    FILL_WARPS, MAX_SPLIT, MIN_ROWS, fwd_rows, slab_stride, solve_step_bwd,
    solve_step_bwd_plain, solve_step_fwd, solve_step_fwd_plain,
    solve_step_geometry, step_fits)
from suitesparse_tpu_torch.kernels.step_sweep import K3_GROUPS
from suitesparse_tpu_torch.kernels.trisolve import (SMEM_BYTES, SMS,
                                                    batched_trisolve_plain)

RTOL = 1e-5

# (B, C, RU, NR) inside the reference's VMEM budget, RU = 0 included
SHAPES = [(9, 8, 8, 1), (12, 24, 0, 3), (5, 48, 64, 3), (10, 16, 16, 64),
          (3, 32, 160, 1)]
# the widest groups of the n = 125k plan (C = 96, RU = 720)
WIDE = [(2, 96, 720, 1), (2, 96, 720, 64)]


def _inputs(B, C, RU, NR, seed):
    rng = np.random.default_rng(seed)
    L11 = np.tril(rng.uniform(-1.0, 1.0, (B, C, C)) / C, -1)
    L11 += np.eye(C) * rng.uniform(1.0, 2.0, (B, 1, C))
    L21 = rng.uniform(-1.0, 1.0, (B, RU, C)) / C
    Y = rng.standard_normal((B, C, NR))
    W = rng.standard_normal((B, RU, NR))
    return [a.astype(np.float32) for a in (L11, L21, Y, W)]


def _close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("B,C,RU,NR", SHAPES)
def test_fwd_plain_matches_pallas(B, C, RU, NR):
    L11, L21, Y, WB = _inputs(B, C, RU, NR, seed=B + C + RU + NR)
    assert ref_step.step_fits(C, RU, NR)
    rx, rv = ref_step.solve_step_fwd(*map(jnp.asarray, (L11, L21, Y, WB)),
                                     interpret=True)
    xc, v = solve_step_fwd_plain(*map(torch.from_numpy, (L11, L21, Y, WB)))
    _close(xc.numpy(), np.asarray(rx))
    if RU:
        _close(v.numpy(), np.asarray(rv))
    else:
        assert v is None and rv is None


@pytest.mark.parametrize("B,C,RU,NR", SHAPES)
def test_bwd_plain_matches_pallas(B, C, RU, NR):
    L11, L21, Y, XB = _inputs(B, C, RU, NR, seed=7 * (B + C + RU + NR))
    rx = ref_step.solve_step_bwd(*map(jnp.asarray, (L11, L21, Y, XB)),
                                 interpret=True)
    xc = solve_step_bwd_plain(*map(torch.from_numpy, (L11, L21, Y, XB)))
    _close(xc.numpy(), np.asarray(rx))


@pytest.mark.parametrize("B,C,RU,NR", WIDE)
def test_plain_solves_the_wide_groups(B, C, RU, NR):
    L11, L21, Y, W = _inputs(B, C, RU, NR, seed=NR)
    L, P = L11.astype(np.float64), L21.astype(np.float64)
    xc, v = solve_step_fwd_plain(*map(torch.from_numpy, (L11, L21, Y, W)))
    x64 = np.linalg.solve(L, Y.astype(np.float64))
    _close(xc.numpy(), x64)
    _close(v.numpy(), W + P @ x64)
    xb = solve_step_bwd_plain(*map(torch.from_numpy, (L11, L21, Y, W)))
    _close(xb.numpy(), np.linalg.solve(np.swapaxes(L, 1, 2),
                                       Y - np.swapaxes(P, 1, 2) @ W))


def test_wrappers_take_plain_versions_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(6, 16, 24, 3, seed=2)]
    before = (solve_step_fwd.launches, solve_step_bwd.launches)
    xc, v = solve_step_fwd(*args)
    pxc, pv = solve_step_fwd_plain(*args)
    assert torch.equal(xc, pxc) and torch.equal(v, pv)
    assert torch.equal(solve_step_bwd(*args), solve_step_bwd_plain(*args))
    assert (solve_step_fwd.launches, solve_step_bwd.launches) == before


def test_fits_follows_shared_memory():
    assert step_fits(96, 720, 64) and step_fits(8, 8, 1)
    assert not step_fits(97, 8, 1)
    # 4 * (96 * 97 + 96 * NR + 64 * 97) bytes against 227 KB
    assert step_fits(96, 720, 443) and not step_fits(96, 720, 444)
    assert step_fits(96, 0, 508)                 # no L21 chunk at RU = 0


# ---- the kernels' launch plan (solve_step_geometry) and their walk ----

# (B, C, RU) of the 50 K3 groups of the n = 125k model plan, at NR 1 and 64
PLAN_NRS = (1, 64)
# off the plan: odd C (4-byte copies) at NR 5, RU far above 720, RU = 0,
# a slab of more than 64 columns, and shapes at the edge of step_fits
OFF_PLAN = [(3, 37, 101, 5), (1, 96, 4000, 64), (8, 8, 0, 1), (8, 8, 0, 64),
            (2, 96, 720, 443), (4, 13, 50, 2), (5, 96, 300, 100),
            (2, 96, 1, 507), (2, 8, 100, 7000)]
# (B, C, RU) of the 9 K3 groups of the 512-block forest of laplacian_3d(6)
FOREST_GROUPS = [(11130, 8, 8), (1536, 8, 16), (1015, 8, 16), (792, 16, 16),
                 (518, 16, 24), (1015, 16, 24), (19, 16, 32), (509, 16, 48),
                 (1013, 16, 48)]
WALK_CASES = [(B, C, RU, NR) for B, C, RU in list(K3_GROUPS) + FOREST_GROUPS
              for NR in PLAN_NRS] + OFF_PLAN


def _walk(g, B, C, RU, NR, transpose):
    """The kernels' index walk, as csrc/solve_step.cu does it, in numpy.

    Returns (elements, rows, xc, out): how often each element is taken by
    a team of each part (B, split); how often each row of RU is staged, by
    part and chunk, for one element ((RU,) counts); how often each cell of
    xc is stored (C, NR); and, forward, how often each cell of v is stored
    (RU, NR), or, backward, how often each cell of a part's partial sum is
    added to by each chunk of its rows ((C, NR) counts by (part, first
    row of the chunk))."""
    XS = slab_stride(NR, g.wpt, g.cpw)
    nblk = -(-B // g.tpb)
    slabs = -(-g.chunks // g.wpt)
    elements = np.zeros((B, g.split), int)
    e, t = np.meshgrid(np.arange(nblk), np.arange(g.tpb), indexing="ij")
    b = (e * g.tpb + t).ravel()
    for part in range(g.split):
        np.add.at(elements[:, part], b[b < B], 1)
    rows = np.zeros(RU, int)
    xc = np.zeros((C, NR), int)
    out = np.zeros((RU, NR), int) if not transpose else {}
    for s in range(slabs):
        s0 = s * g.wpt * g.cpw
        width = min(NR - s0, g.wpt * g.cpw)
        nch = min(g.wpt, g.chunks - s * g.wpt)
        assert 0 < width <= XS and nch * g.cpw <= XS
        for w in range(g.wpt):      # part 0 (rank 0) stores xc
            ch = s * g.wpt + w
            if ch < g.chunks:
                xc[:, ch * g.cpw:min(NR, (ch + 1) * g.cpw)] += 1
        for part in range(g.split):
            j0 = min(RU, part * g.prow)
            j1 = min(RU, j0 + g.prow)
            for r0 in range(j0, j1, max(g.crow, 1)):   # crow = 0 at RU = 0
                nr = min(g.crow, j1 - r0)
                if s == 0:
                    rows[r0:r0 + nr] += 1
                if transpose:
                    nq = -(-C // 4)
                    ch, q = np.divmod(np.arange(nq * nch), nq)
                    k = (4 * q[:, None, None] + np.arange(4)[:, None])
                    c = ch[:, None, None] * g.cpw + np.arange(g.cpw)
                    k, c = np.broadcast_arrays(k, c)
                    ok = (k < C) & (c < width)
                    p = out.setdefault((part, r0), np.zeros((C, NR), int))
                    np.add.at(p, (k[ok], s0 + c[ok]), 1)
                else:
                    prs = fwd_rows(g.cpw)
                    nrt = -(-nr // prs)
                    rt, ch = np.divmod(np.arange(nrt * nch), nch)
                    r = rt[:, None, None] + np.arange(prs)[:, None] * nrt
                    c = s0 + ch[:, None, None] * g.cpw + np.arange(g.cpw)
                    r, c = np.broadcast_arrays(r, c)
                    ok = (r < nr) & (c < NR)
                    np.add.at(out, (r0 + r[ok], c[ok]), 1)
    return elements, rows, xc, out


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B,C,RU,NR", WALK_CASES)
def test_geometry_walk_owns_each_cell_once(B, C, RU, NR, transpose):
    """Every element is taken once by each part; the parts' staged rows
    cover RU once; every cell of xc and of v is stored once and every cell
    of a partial sum is added to once by each chunk of rows; shared
    memory, block size and cluster are within the card's and the plan's
    limits."""
    g = solve_step_geometry(B, C, RU, NR, transpose)
    assert g.smem <= SMEM_BYTES and g.threads == g.tpb * g.lanes <= 256
    assert g.lanes == 32 * g.wpt or (g.lanes in (8, 16) and g.wpt == 1
                                     and NR == 1 and C <= g.lanes)
    assert g.split <= (MAX_SPLIT if transpose else max(RU, 1))
    assert g.split == 1 or g.tpb == 1
    assert g.blocks == -(-B // g.tpb) * g.split
    elements, rows, xc, out = _walk(g, B, C, RU, NR, transpose)
    assert (elements == 1).all() and (rows == 1).all() and (xc == 1).all()
    if transpose:
        assert len(out) == sum(-(-min(g.prow, RU - p * g.prow) // g.crow)
                               for p in range(g.split)) if RU else not out
        assert all((p == 1).all() for p in out.values())
    else:
        assert (out == 1).all()


@pytest.mark.parametrize("transpose", [False, True])
def test_geometry_exists_exactly_where_step_fits(transpose):
    for C in (1, 8, 13, 37, 48, 64, 95, 96, 97):
        for RU in (0, 1, 63, 64, 720):
            for NR in (1, 3, 4, 64, 100, 443, 444, 507, 508, 5000):
                if step_fits(C, RU, NR):
                    g = solve_step_geometry(7, C, RU, NR, transpose)
                    assert g.smem <= SMEM_BYTES
                else:
                    with pytest.raises(ValueError):
                        solve_step_geometry(7, C, RU, NR, transpose)


@pytest.mark.parametrize("NR", PLAN_NRS)
@pytest.mark.parametrize("transpose", [False, True])
def test_geometry_fills_the_card_where_ru_allows(NR, transpose):
    """Each plan group puts at least as many blocks on the card as it has
    SMs, or as many as its rows allow (parts of MIN_ROWS, a cluster of
    MAX_SPLIT backward), or its elements' warps alone fill the card."""
    for B, C, RU in K3_GROUPS:
        g = solve_step_geometry(B, C, RU, NR, transpose)
        cap = min(-(-RU // MIN_ROWS), MAX_SPLIT if transpose else RU)
        reach = min(SMS, B * cap)
        assert g.blocks >= reach or \
            B * g.split * g.wpt >= FILL_WARPS // 2, (B, C, RU, g)


def test_geometry_segments_warps_for_many_tiny_elements():
    """At NR 1 the many-element groups of RU <= C <= 16 put 4 (C <= 8) or
    2 elements in a warp; forced whole warps and segments, and bad
    segments."""
    g = solve_step_geometry(8735, 8, 8, 1, True)
    assert (g.lanes, g.tpb, g.threads, g.blocks) == (8, 4, 32, 2184)
    g = solve_step_geometry(11130, 8, 8, 1, False)
    assert (g.lanes, g.tpb, g.threads) == (8, 4, 32)
    # RU > C: whole warps, packed two a block
    g = solve_step_geometry(2339, 8, 16, 1, False)
    assert (g.lanes, g.tpb, g.threads) == (32, 2, 64)
    g = solve_step_geometry(2339, 8, 16, 1, False, lanes=8)
    assert (g.lanes, g.tpb, g.threads) == (8, 4, 32)
    assert solve_step_geometry(8735, 8, 8, 64, True).lanes == 256
    assert solve_step_geometry(8735, 8, 8, 1, True, lanes=32).lanes == 32
    assert solve_step_geometry(539, 16, 48, 1, False).lanes == 64
    with pytest.raises(ValueError):
        solve_step_geometry(8735, 8, 8, 3, True, lanes=8)
    with pytest.raises(ValueError):
        solve_step_geometry(12, 96, 720, 1, True, lanes=16)


@pytest.mark.parametrize("C,RU", [(8, 8), (13, 0), (16, 48), (8, 128)])
def test_geometry_takes_every_batch(C, RU):
    """A plan exists, and its blocks are whole warps, at every batch size
    (the segmented plans pack whole warps of elements)."""
    for B in range(1, 5000, 7):
        for transpose in (False, True):
            g = solve_step_geometry(B, C, RU, 1, transpose)
            assert g.threads % 32 == 0 and g.threads <= 256
            nb = g.blocks // g.split       # blocks of elements
            assert nb * g.tpb >= B > (nb - 1) * g.tpb


def test_geometry_forces_and_refuses():
    g = solve_step_geometry(12, 96, 720, 64, True, split=16)
    assert (g.split, g.prow, g.tpb) == (16, 45, 1)
    assert solve_step_geometry(12, 96, 720, 64, False, split=64).split == 60
    with pytest.raises(ValueError):
        solve_step_geometry(12, 96, 720, 1, True, split=2, tpb=2)
    with pytest.raises(ValueError):
        solve_step_geometry(12, 96, 720, 64, True, wpt=8, tpb=2)


def _emulate_bwd(L11, L21, Y, XB, g):
    """The backward kernel's sums in its order (float32): each part's
    partial sum L21^T xb over its rows in row order, the parts added in
    rank order, y minus that, then the transposed column loop."""
    B, RU, C = L21.shape
    parts = []
    for part in range(g.split):
        j0 = min(RU, part * g.prow)
        acc = np.zeros((B, C, Y.shape[2]), np.float32)
        for j in range(j0, min(RU, j0 + g.prow)):
            acc += L21[:, j, :, None] * XB[:, j, None, :]
        parts.append(acc)
    tot = np.zeros_like(Y)
    for p in parts:
        tot += p
    return batched_trisolve_plain(torch.from_numpy(L11),
                                  torch.from_numpy(Y - tot),
                                  transpose=True).numpy()


@pytest.mark.parametrize("split", [None, 1, 3, 8, 16])
@pytest.mark.parametrize("B,C,RU,NR", [(12, 96, 720, 64), (45, 48, 384, 1),
                                       (3, 37, 101, 5), (2, 16, 9, 2),
                                       (4, 8, 0, 3), (1, 96, 4000, 8)])
def test_kernel_walk_matches_plain(B, C, RU, NR, split):
    L11, L21, Y, XB = _inputs(B, C, RU, NR, seed=B + RU + NR)
    g = solve_step_geometry(B, C, RU, NR, True, split=split)
    got = _emulate_bwd(L11, L21, Y, XB, g)
    ref = solve_step_bwd_plain(*map(torch.from_numpy, (L11, L21, Y, XB)))
    _close(got, ref.numpy())
