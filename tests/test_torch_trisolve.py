"""Port's batched triangular solve (K4, plain version on the CPU) vs the
Pallas kernel.

The reference kernel runs in Pallas interpret mode, as its own tests run it
off the TPU (where its VMEM budget refuses a tile it takes XLA's triangular
solve). Inputs are seeded and well conditioned: unit-ish lower triangles
(diagonal in [1, 2], off-diagonal entries below 1/C), some tiles padded
with identity rows as the solve plans pad them. The forward solve runs the
same column loop on both sides; the transposed one sums in another order,
so X is held to 1e-5 relative to its largest entry."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from suitesparse_tpu.kernels.trisolve import \
    batched_trisolve as batched_trisolve_pallas
from suitesparse_tpu_torch.kernels.trisolve import (
    MAX_C, batched_trisolve, batched_trisolve_plain, trisolve_fits)

RTOL = 1e-5

# (B, C, NR): leaf-like, mid, the forest's K4 root group and the widest tile
SHAPES = [(5, 8, 1), (33, 24, 3), (40, 64, 64), (7, 96, 1)]


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
