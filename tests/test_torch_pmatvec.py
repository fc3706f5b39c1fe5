"""Port's streaming panel matvec K5 (plain version on the CPU) vs the
Pallas kernel, and the kernel's launch plan.

The reference kernel runs in interpret mode on panels zero padded per its
``pmv_pad`` and returns (B, NRpad8, Npad); the test pads the same seeded
inputs and cuts the result back to the port's (B, N, NR). Shapes: seeded,
with B = 1, K != N in both senses, NR in {1, 3, 5, 8}, N % 4 != 0 (the
kernel's 4-byte loads) and K shorter than one batch of a warp. Both sum
the same products in another order: 1e-5 of the largest entry.

The launch plan ``pmv_geometry`` is walked as ``csrc/pmatvec.cu`` walks
it, at the 14 K5 groups of the n = 125k plan in both orientations and at
shapes off the plan: every (b, column, k) is summed by one lane, every
output written once, and the walk's sums (in the kernel's order) match
the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.kernels.pmatvec import pmatvec_t as pmatvec_t_pallas
from suitesparse_tpu.kernels.pmatvec import pmv_pad
from suitesparse_tpu_torch.kernels.pmatvec import (
    CLUSTER_MIN_RUNS, COLS, FILL_WARPS, LANES, MAX_NR, MAX_SPLIT, MAX_WARPS,
    ONE_BLOCK_BATCHES, SMS, TILE_WIDTHS, UNROLL,
    pmatvec_t, pmatvec_t_plain, pmv_geometry)
from suitesparse_tpu_torch.kernels.trisolve import SMEM_BYTES

RTOL = 1e-5
SHAPES = [(1, 600, 600, 1), (1, 1100, 300, 3), (3, 200, 700, 8),
          (5, 96, 1300, 1), (2, 520, 64, 3), (1, 40, 24, 8),
          (2, 1001, 333, 5), (3, 5, 7, 2), (1, 6, 130, 8)]
# (B, R, C) of the 14 groups that the w2 route sends to K5 in the n = 125k
# plan (ND ordering); the forward step reads W2^T (B, C, R), the backward
# W2 (B, R, C)
PLAN_GROUPS = [(1, 3864, 3864), (5, 2712, 696), (3, 3288, 664),
               (1, 3912, 1408), (8, 1608, 352), (13, 1512, 192),
               (15, 936, 168), (1, 2792, 672), (8, 1064, 176),
               (12, 888, 128), (2, 2208, 304), (1, 2176, 552),
               (10, 896, 128), (1, 2168, 504)]
PLAN_SHAPES = [(B, C, R) for B, R, C in PLAN_GROUPS] + PLAN_GROUPS
# off the plan: 4-byte loads at N % 4 != 0, tiny, K below one batch, a
# long thin panel, wide and short, a large batch
OFF_SHAPES = [(2, 1001, 333), (1, 40, 24), (3, 5, 7), (1, 17, 4),
              (1, 20000, 8), (1, 16, 4096), (40, 300, 1030)]


def _inputs(B, K, N, NR):
    rng = np.random.default_rng(B * 100000 + K * 100 + N + NR)
    return (rng.standard_normal((B, K, N)).astype(np.float32),
            rng.standard_normal((B, K, NR)).astype(np.float32))


@pytest.mark.parametrize("B,K,N,NR", SHAPES)
def test_plain_matches_pallas(B, K, N, NR):
    M, X = _inputs(B, K, N, NR)
    Kp, Np = pmv_pad(K, N)
    Mp = np.zeros((B, Kp, Np), np.float32)
    Mp[:, :K, :N] = M
    Xp = np.zeros((B, Kp, NR), np.float32)
    Xp[:, :K] = X
    Z = np.asarray(pmatvec_t_pallas(jnp.asarray(Mp), jnp.asarray(Xp),
                                    interpret=True))
    ref = Z[:, :NR, :N].transpose(0, 2, 1)
    got = pmatvec_t_plain(torch.from_numpy(M), torch.from_numpy(X)).numpy()
    assert got.shape == ref.shape == (B, N, NR)
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_wrapper_takes_plain_version_on_cpu():
    M, X = (torch.from_numpy(a) for a in _inputs(2, 520, 64, MAX_NR))
    before = pmatvec_t.launches
    assert torch.equal(pmatvec_t(M, X), pmatvec_t_plain(M, X))
    assert pmatvec_t.launches == before


def _cdiv(a, b):
    return -(-a // b)


def _walk(g, B, K, N):
    """The kernel's work as csrc/pmatvec.cu walks plan ``g``: yields
    (b, columns [n0, n1), rows [k0, k1), flat outputs [z0, z1)) for each
    block's column tile, with the rows of each run. A warp's lanes cover
    a batch of UNROLL steps of LANES // tw rows: lane (cl, rs) takes row
    u * (LANES // tw) + rs at step u, which is each row of the batch once
    (checked here), so a run's rows are each summed by one lane."""
    nrs = LANES // g.tw
    rows_of = sorted(u * nrs + rs for u in range(UNROLL) for rs in range(nrs))
    assert rows_of == list(range(UNROLL * nrs))
    nc = _cdiv(N, COLS)
    for b in range(B):
        for tile in range(g.tiles):
            c0, c1 = tile * nc // g.tiles, (tile + 1) * nc // g.tiles
            assert 1 <= c1 - c0 <= g.tw
            n0, n1 = c0 * COLS, min(c1 * COLS, N)
            runs = []
            for rank in range(g.split):
                for w in range(g.warps):
                    k0 = min(K, (rank * g.warps + w) * g.rows)
                    runs.append((k0, min(K, k0 + g.rows)))
            yield b, (n0, n1), runs, (b * N + n0, b * N + n1)


@pytest.mark.parametrize("NR", [1, MAX_NR])
@pytest.mark.parametrize("B,K,N", PLAN_SHAPES + OFF_SHAPES)
def test_geometry_owns_each_cell_once(B, K, N, NR):
    """Each (b, column, k) is summed by exactly one lane of one warp and
    each output written once, by the plan and by every forced split."""
    for split in (None, 1, 3, MAX_SPLIT):
        g = pmv_geometry(B, K, N, NR, split=split)
        cells = np.zeros((B, N, K), np.uint8)
        out = np.zeros(B * N, np.uint8)
        for b, (n0, n1), runs, (z0, z1) in _walk(g, B, K, N):
            for k0, k1 in runs:
                cells[b, n0:n1, k0:k1] += 1
            out[z0:z1] += 1
        assert (cells == 1).all() and (out == 1).all()


@pytest.mark.parametrize("NR", range(1, MAX_NR + 1))
@pytest.mark.parametrize("B,K,N", PLAN_SHAPES + OFF_SHAPES)
def test_geometry_limits(B, K, N, NR):
    """Shared memory, cluster and block sizes within the card's limits,
    16-byte loads only where N % 4 == 0; tiles as wide as still leave room
    for SMS blocks, and at least FILL_WARPS warps wherever the tiles' runs
    of one batch of load steps each allow them."""
    g = pmv_geometry(B, K, N, NR)
    assert g.smem <= SMEM_BYTES and 1 <= g.split <= min(MAX_SPLIT, 16)
    assert 1 <= g.warps <= MAX_WARPS and g.threads == LANES * g.warps
    assert g.vec == (N % COLS == 0) and g.cols == COLS
    assert g.tw in TILE_WIDTHS and g.blocks == B * g.tiles * g.split
    assert g.rows * g.warps * g.split >= K
    nc = _cdiv(N, COLS)

    def room(tw):       # blocks of one batch of rows each, at most
        return B * _cdiv(nc, tw) * min(MAX_SPLIT,
                                       _cdiv(K, UNROLL * LANES // tw))

    assert min(SMS, room(g.tw)) == min(SMS, max(map(room, TILE_WIDTHS)))
    runs = min(MAX_WARPS * MAX_SPLIT, _cdiv(K, UNROLL * LANES // g.tw))
    # a tile that wants fewer than CLUSTER_MIN_RUNS runs, or whose runs
    # are short, keeps one block of up to MAX_WARPS warps
    step = UNROLL * LANES // g.tw
    assert g.blocks * g.warps >= min(FILL_WARPS, B * g.tiles * runs) or \
        (g.split == 1 and g.warps == MAX_WARPS
         and (B * g.tiles * (CLUSTER_MIN_RUNS - 1) >= FILL_WARPS
              or K <= ONE_BLOCK_BATCHES * MAX_WARPS * step))
    # no column tile is mostly idle: widths differ by at most one group
    widths = {(t + 1) * nc // g.tiles - t * nc // g.tiles
              for t in range(g.tiles)}
    assert max(widths) - min(widths) <= 1 and max(widths) <= g.tw


@pytest.mark.parametrize("NR", [1, MAX_NR])
def test_geometry_fills_the_card_at_the_root(NR):
    """(1, 3864, 3864): 31 tiles of 31-32 column groups, K over 7 warps
    times a cluster of 5, 155 blocks: every SM takes part. The smallest
    backward panel, (1, 2168, 504), takes tiles of 8 groups (4 rows a
    load step) to reach 128 blocks."""
    g = pmv_geometry(1, 3864, 3864, NR)
    assert (g.tw, g.tiles, g.warps, g.split) == (32, 31, 7, 5)
    assert g.blocks >= SMS and g.rows * g.warps * g.split >= 3864
    g = pmv_geometry(1, 2168, 504, NR)
    assert (g.tw, g.tiles, g.split) == (8, 16, MAX_SPLIT)


def _emulate(M, X, g):
    """The kernel's sums in its order (float32): per lane over its rows,
    the lanes of a column group by the butterfly, the warps in order, the
    cluster's blocks in rank order."""
    B, K, N = M.shape
    NR = X.shape[2]
    Z = np.full(B * N * NR, np.nan, np.float32)
    nrs = LANES // g.tw
    step = UNROLL * nrs
    for b, (n0, n1), runs, (z0, z1) in _walk(g, B, K, N):
        width = n1 - n0
        ranks = []
        for rank in range(g.split):
            warp_sums = []
            for k0, k1 in runs[rank * g.warps:(rank + 1) * g.warps]:
                lanes = np.zeros((nrs, width, NR), np.float32)
                for k in range(k0, k1, step):
                    for rs in range(nrs):
                        for u in range(UNROLL):
                            r = k + u * nrs + rs
                            if r < k1:
                                lanes[rs] += M[b, r, n0:n1, None] * X[b, r]
                off = 1     # lane rs ^ off, as the shuffles pair them
                while off < nrs:
                    lanes = lanes + lanes[np.arange(nrs) ^ off]
                    off *= 2
                warp_sums.append(lanes[0])
            acc = np.zeros((width, NR), np.float32)
            for v in warp_sums:
                acc += v
            ranks.append(acc)
        tot = ranks[0]
        if g.split > 1:
            tot = np.zeros((width, NR), np.float32)
            for v in ranks:
                tot += v
        Z[z0 * NR:z1 * NR] = tot.reshape(-1)
    return Z.reshape(B, N, NR)


@pytest.mark.parametrize("split", [None, 1, 3, MAX_SPLIT])
@pytest.mark.parametrize("B,K,N,NR", [(1, 100, 40, 3), (2, 1001, 333, 5),
                                      (1, 40, 24, 8), (3, 5, 7, 2),
                                      (1, 300, 504, 1), (2, 70, 130, 4)])
def test_kernel_walk_matches_plain(B, K, N, NR, split):
    M, X = _inputs(B, K, N, NR)
    g = pmv_geometry(B, K, N, NR, split=split)
    got = _emulate(M, X, g)
    ref = pmatvec_t_plain(torch.from_numpy(M), torch.from_numpy(X)).numpy()
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()
