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
from suitesparse_tpu_torch.kernels.bmatvec import (MAX_NR, bmatvec,
                                                   bmatvec_plain, bmv_fits)

RTOL = 1e-5
SHAPES = [(16, 16, 200, 1), (176, 48, 351, 1), (64, 64, 179, 2),
          (920, 136, 53, 1), (8, 24, 130, 4)]


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
