"""Port's batched matvec K6 (plain version on the CPU) vs the Pallas kernel.

The reference kernel runs in interpret mode on lane-major panels
(I, J, B), zero padded per its ``bmv_pad``; the test moves the same seeded
batch-major inputs into that layout and the result back. Shapes: the
reference's own five (``tests/test_bmatvec.py``), in both directions. Both
sum the same products in another order: 1e-5 of the largest entry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.kernels.bmatvec import bmatvec_t, bmv_pad
from suitesparse_tpu_torch.kernels.bmatvec import (MAX_NR, MAX_SPLIT, SMS,
                                                   THREADS, bmatvec,
                                                   bmatvec_plain, bmv_fits,
                                                   bmv_geometry)
from suitesparse_tpu_torch.kernels.trisolve import SMEM_BYTES

RTOL = 1e-5
SHAPES = [(16, 16, 200, 1), (176, 48, 351, 1), (64, 64, 179, 2),
          (920, 136, 53, 1), (8, 24, 130, 4)]
# (B, I, J): the four largest K6 groups of the n = 125k plan (W2 is
# (B, R, C)), the reference shapes above, and chip_smoke.py's three shapes
# off the ladders (plain loads; a cluster of 8 and a ring; wide panels)
PLAN_SHAPES = [(8735, 16, 8), (45, 432, 48), (114, 224, 32), (40, 424, 48)]
GEOM_SHAPES = PLAN_SHAPES + [(B, I, J) for I, J, B, _ in SHAPES] + \
    [(37, 45, 13), (4, 6000, 52), (16, 16, 6000)]


def _inputs(I, J, B, NR, transpose):
    rng = np.random.default_rng(I * 1000 + J + B + NR)
    M = rng.standard_normal((B, I, J)).astype(np.float32)
    X = rng.standard_normal((B, I if transpose else J, NR)).astype(np.float32)
    return M, X


def _reference(M, X, transpose):
    """The Pallas kernel on the lane-major, padded copies of M and X."""
    B, I, J = M.shape
    NR = X.shape[2]
    Ipad, Bpad = bmv_pad(I, J, B)
    Mt = np.zeros((Ipad, J, Bpad), np.float32)
    Mt[:I, :, :B] = M.transpose(1, 2, 0)
    Xt = np.zeros((Ipad if transpose else J, NR, Bpad), np.float32)
    Xt[:X.shape[1], :, :B] = X.transpose(1, 2, 0)
    Zt = np.asarray(bmatvec_t(jnp.asarray(Mt), jnp.asarray(Xt),
                              transpose=transpose, interpret=True))
    return Zt[:J if transpose else I, :, :B].transpose(2, 0, 1)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("I,J,B,NR", SHAPES)
def test_plain_matches_pallas(I, J, B, NR, transpose):
    M, X = _inputs(I, J, B, NR, transpose)
    ref = _reference(M, X, transpose)
    got = bmatvec_plain(torch.from_numpy(M), torch.from_numpy(X),
                        transpose).numpy()
    assert got.shape == ref.shape == (B, J if transpose else I, NR)
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("transpose", [False, True])
def test_wrapper_takes_plain_version_on_cpu(transpose):
    M, X = _inputs(64, 64, 179, 2, transpose)
    before = (bmatvec.launches, bmatvec.transposed_launches)
    Mt, Xt = torch.from_numpy(M), torch.from_numpy(X)
    assert torch.equal(bmatvec(Mt, Xt, transpose),
                       bmatvec_plain(Mt, Xt, transpose))
    assert (bmatvec.launches, bmatvec.transposed_launches) == before


def test_fits_follows_shared_memory():
    assert all(bmv_fits(I, J, NR) for I, J, _B, NR in SHAPES)
    assert bmv_fits(3864, 3864, MAX_NR)          # 124 KB of right-hand sides
    assert not bmv_fits(16, 16, MAX_NR + 1)      # NR above the registers
    assert not bmv_fits(7200, 16, MAX_NR)        # 225 KB + partial sums


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("NR", [1, MAX_NR])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B,I,J", GEOM_SHAPES)
def test_geometry_covers_each_output_once(B, I, J, NR, transpose):
    """Walk the launch plan as csrc/bmatvec.cu does: each block's rows,
    its row chunks, (forward, wide rows) its slices of J, and (transposed)
    its column tile and its writes of Z."""
    g = bmv_geometry(B, I, J, NR, transpose)
    assert g.smem <= SMEM_BYTES and 1 <= g.cluster <= MAX_SPLIT
    assert (g.split <= MAX_SPLIT or not transpose) and \
        (g.epb == 1 or g.split == 1)
    assert g.cluster == (g.split if transpose else 1)
    nruns = _cdiv(B, g.epb)
    ntiles = _cdiv(J, THREADS) if transpose else 1
    assert g.blocks == nruns * g.split * ntiles
    rows = np.zeros((B, I), int)            # each panel row, by its block
    zw = np.zeros(B * (J if transpose else I) * NR, int)   # writes of Z
    for run in range(nruns):
        b0 = run * g.epb
        nb = min(g.epb, B - b0)
        for rank in range(g.split):
            r0, r1 = rank * g.part, min(I, (rank + 1) * g.part)
            assert r0 < r1
            rows[b0:b0 + nb, r0:r1] += 1
            g0, g1 = b0 * I + r0, (b0 + nb - 1) * I + r1
            assert g1 - g0 == (nb * I if g.split == 1 else r1 - r0)
            # the chunks tile [g0, g1) with no gap or overlap
            edges = [min(c, g1) for c in range(g0, g1 + g.chunk, g.chunk)]
            assert edges[0] == g0 and edges[-1] == g1
            assert all(a < b for a, b in zip(edges, edges[1:]))
            if not transpose:   # a block writes its rows' outputs
                zw[g0 * NR:g1 * NR] += 1
        if transpose:           # the cluster writes its columns' outputs
            tj = min(J, THREADS)
            s = THREADS // (g.epb * tj)
            assert s >= 1
            for by in range(ntiles):
                tw = min(tj, J - by * tj)
                zbase = (b0 * J + by * tj) * NR
                for e in range(nb * tw * NR):
                    el, rem = divmod(e, tw * NR)
                    assert zbase + e == ((b0 + el) * J + by * tj
                                         + rem // NR) * NR + rem % NR
                zw[zbase:zbase + nb * tw * NR] += 1
    assert (rows == 1).all()
    assert (zw == 1).all()
    if not transpose and J > THREADS:   # wide rows: slices of J tile it
        w = min(g.chunk, THREADS)
        ks = THREADS // w
        klen = _cdiv(_cdiv(J, ks), 4) * 4 if J % 4 == 0 else _cdiv(J, ks)
        cols = np.zeros(J, int)
        for k in range(ks):
            cols[k * klen:(k + 1) * klen] += 1
        assert (cols == 1).all() and (ks == 1 or g.chunk <= w)


@pytest.mark.parametrize("NR", [1, MAX_NR])
@pytest.mark.parametrize("B,I,J", [(45, 432, 48), (40, 424, 48)])
def test_geometry_fills_the_card_on_few_long_panels(B, I, J, NR):
    """Forward splits each panel's rows over blocks until the card is
    full. Transposed keeps one block per panel at these 83 KB panels (a
    cluster's sums cost more than its smaller copies save, measured on the
    H100) and splits long panels over a cluster of up to 8."""
    assert bmv_geometry(B, I, J, NR, False).blocks >= SMS
    assert bmv_geometry(B, I, J, NR, True).split == 1
    g = bmv_geometry(4, 6000, 52, NR, True)
    assert g.cluster == g.split == MAX_SPLIT and g.stages > 1


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("I,J", [(3864, 3864), (16, 7000), (7000, 16)])
def test_geometry_exists_wherever_fits(I, J, transpose):
    """The kernel takes every shape bmv_fits admits: the ring shrinks its
    chunks (forward X moves to device memory) to stay in shared memory."""
    assert bmv_fits(I, J, MAX_NR - 1)
    for B in (1, 32, 5000):
        g = bmv_geometry(B, I, J, MAX_NR - 1, transpose)
        assert g.smem <= SMEM_BYTES and g.chunk >= 1 and g.stages >= 1
