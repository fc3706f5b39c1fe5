"""Port's batched triangular solve (K4, plain version on the CPU) vs the
Pallas kernel, and the kernel's launch plan (``trisolve_geometry``).

The reference kernel runs in Pallas interpret mode, as its own tests run it
off the TPU (where its VMEM budget refuses a tile it takes XLA's triangular
solve). Inputs are seeded and well conditioned: unit-ish lower triangles
(diagonal in [1, 2], off-diagonal entries below 1/C), some tiles padded
with identity rows as the solve plans pad them. The forward solve runs the
same column loop on both sides; the transposed one sums in another order,
so X is held to 1e-5 relative to its largest entry.

The CUDA kernel cannot run here; its launch plan is pure Python and is
walked as ``csrc/trisolve.cu`` walks it."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from suitesparse_tpu.kernels.trisolve import \
    batched_trisolve as batched_trisolve_pallas
from suitesparse_tpu_torch.kernels.trisolve import (
    FILL_BLOCKS, MAX_C, MAX_WARPS, SMEM_BYTES, SMS, WIDE, _odd_stride,
    batched_trisolve, batched_trisolve_plain, trisolve_fits,
    trisolve_geometry)

RTOL = 1e-5

# (B, C, NR): leaf-like, mid, the forest's K4 root group (at 40 tiles and
# at its full 512, where the reference's VMEM budget sends it to XLA's
# triangular solve) and the widest tile
SHAPES = [(5, 8, 1), (33, 24, 3), (40, 64, 64), (7, 96, 1), (512, 64, 64)]
# the launch plans to walk: chip_smoke.py's K4 shapes, SHAPES, and the
# widest tile at NR 1, 8, 64 and the most its shared-memory gate admits
GEOM_SHAPES = sorted({(B, C, nr) for B, C in ((512, 64), (45, 48))
                      for nr in (1, 64)} | set(SHAPES)
                     | {(37, 96, nr) for nr in (1, 8, 64, 508)})
REG_CELLS = 24           # X cells a lane holds: 3 rows x WIDE columns


def _system(B, C, NR, seed):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.uniform(-1.0, 1.0, (B, C, C)) / C, -1)
    L += np.eye(C) * rng.uniform(1.0, 2.0, (B, 1, C))
    nc = rng.integers(1, C + 1, size=B)
    for b in range(0, B, 2):               # identity padding past nc
        L[b, nc[b]:, :] = 0.0
        L[b, :, nc[b]:] = 0.0
        L[b, nc[b]:, nc[b]:] = np.eye(C - nc[b])
    Y = rng.standard_normal((B, C, NR))
    return L.astype(np.float32), Y.astype(np.float32)


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "trans"])
@pytest.mark.parametrize("B,C,NR", SHAPES)
def test_plain_matches_pallas(B, C, NR, transpose):
    L, Y = _system(B, C, NR, seed=B * 100 + C + NR)
    ref = np.asarray(batched_trisolve_pallas(
        jnp.asarray(L), jnp.asarray(Y), transpose=transpose, interpret=True))
    got = batched_trisolve_plain(torch.from_numpy(L), torch.from_numpy(Y),
                                 transpose).numpy()
    assert got.shape == ref.shape == (B, C, NR)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()
    # and it solves the system (fp64 residual of the fp32 solution)
    M = np.swapaxes(L, 1, 2) if transpose else L
    res = M.astype(np.float64) @ got.astype(np.float64) - Y
    assert np.abs(res).max() <= 1e-5 * np.abs(Y).max()


def test_wrapper_takes_plain_version_on_cpu():
    L, Y = _system(6, 16, 3, seed=1)
    before = batched_trisolve.launches
    for transpose in (False, True):
        X = batched_trisolve(torch.from_numpy(L), torch.from_numpy(Y),
                             transpose=transpose)
        P = batched_trisolve_plain(torch.from_numpy(L), torch.from_numpy(Y),
                                   transpose)
        assert torch.equal(X, P)
    assert batched_trisolve.launches == before   # no kernel launch on the CPU


def test_fits_follows_shared_memory():
    assert trisolve_fits(MAX_C, 64) and trisolve_fits(8, 1)
    assert not trisolve_fits(MAX_C + 1, 1)       # the tile loop's bound
    # 4 * (96 * 97 + 96 * NR) bytes against 227 KB: NR = 508 fits, 509 not
    assert trisolve_fits(96, 508) and not trisolve_fits(96, 509)


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "trans"])
@pytest.mark.parametrize("B,C,NR", GEOM_SHAPES)
def test_geometry_owns_each_cell_once(B, C, NR, transpose):
    """Walk the plan as csrc/trisolve.cu does: block (x, y) -> its tiles ->
    each tile's warps -> each warp's column chunks. Every (tile, column) is
    held by exactly one warp, every row by one lane, within the register
    budget and the shared memory of one block; every block of a tile has a
    chunk."""
    g = trisolve_geometry(B, C, NR, transpose)
    assert g.cpw == (1 if NR < 4 else WIDE)
    assert g.rpl == -(-C // 32) <= 3 and g.rpl * g.cpw <= REG_CELLS
    assert g.chunks == -(-NR // g.cpw) and 1 <= g.wpt <= g.chunks
    assert g.threads == 32 * g.tpb * g.wpt <= 32 * MAX_WARPS
    pub = 2 * g.cpw if g.cpw >= 4 else 0
    assert g.smem == 4 * (g.tpb * g.wpt * (pub + C)
                          + g.tpb * C * _odd_stride(C)) <= SMEM_BYTES
    assert g.blocks == -(-B // g.tpb) * g.csplit
    assert 1 <= g.csplit and (g.csplit - 1) * g.wpt < g.chunks
    owned = np.zeros((B, NR), int)
    for blk in range(g.blocks // g.csplit):
        for y in range(g.csplit):
            for warp in range(g.tpb * g.wpt):
                b = blk * g.tpb + warp // g.wpt
                if b >= B:
                    continue
                for ch in range(warp % g.wpt + g.wpt * y, g.chunks,
                                g.wpt * g.csplit):
                    owned[b, ch * g.cpw:min(NR, (ch + 1) * g.cpw)] += 1
    assert (owned == 1).all()
    rows = np.zeros(C, int)                # lane l holds rows l + 32 j
    for j in range(g.rpl):
        rows[[i for i in range(32 * j, 32 * j + 32) if i < C]] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "trans"])
def test_geometry_exists_exactly_where_fits(transpose):
    """A plan exists for every shape the classic sweep's gate sends to the
    kernel, and for no other."""
    for C in range(1, MAX_C + 2):
        for NR in (1, 2, 3, 4, 5, 8, 63, 64, 65, 508, 509, 600):
            if trisolve_fits(C, NR):
                g = trisolve_geometry(33, C, NR, transpose)
                assert g.smem <= SMEM_BYTES and g.threads >= 32
            else:
                with pytest.raises(ValueError):
                    trisolve_geometry(33, C, NR, transpose)


def test_geometry_fills_the_card():
    """NR 1 runs one warp a tile; a large batch packs tiles into blocks
    only while the grid keeps FILL_BLOCKS blocks; NR 64 gives a tile 8
    warps of 8 columns; a few tiles with many chunks spread them over
    blocks."""
    g = trisolve_geometry(512, 64, 1, False)
    assert (g.tpb, g.wpt, g.cpw, g.csplit) == (1, 1, 1, 1)
    assert g.blocks >= SMS
    g = trisolve_geometry(8735, 8, 1, False)
    assert g.tpb == MAX_WARPS and g.blocks >= FILL_BLOCKS
    g = trisolve_geometry(512, 64, 64, True)
    assert (g.tpb, g.wpt, g.cpw, g.chunks, g.csplit) == (1, 8, WIDE, 8, 1)
    g = trisolve_geometry(37, 96, 508, False)
    assert (g.chunks, g.csplit) == (64, 8) and g.blocks >= FILL_BLOCKS
    # forced plans, as trisolve_sweep asks for them
    g = trisolve_geometry(512, 64, 64, False, cpw=1, wpt=8, tpb=1)
    assert (g.cpw, g.chunks, g.wpt) == (1, 64, 8)
    with pytest.raises(ValueError):
        trisolve_geometry(512, 64, 64, False, cpw=4)
    with pytest.raises(ValueError):
        trisolve_geometry(512, 64, 64, False, wpt=8, tpb=2)
