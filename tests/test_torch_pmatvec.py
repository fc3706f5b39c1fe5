"""Port's streaming panel matvec K5 (plain version on the CPU) vs the
Pallas kernel.

The reference kernel runs in interpret mode on panels zero padded per its
``pmv_pad`` and returns (B, NRpad8, Npad); the test pads the same seeded
inputs and cuts the result back to the port's (B, N, NR). Shapes: seeded,
with B = 1, K != N in both senses, and NR in {1, 3, 8}. Both sum the same
products in another order: 1e-5 of the largest entry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.kernels.pmatvec import pmatvec_t as pmatvec_t_pallas
from suitesparse_tpu.kernels.pmatvec import pmv_pad
from suitesparse_tpu_torch.kernels.pmatvec import (MAX_NR, pmatvec_t,
                                                   pmatvec_t_plain)

RTOL = 1e-5
SHAPES = [(1, 600, 600, 1), (1, 1100, 300, 3), (3, 200, 700, 8),
          (5, 96, 1300, 1), (2, 520, 64, 3), (1, 40, 24, 8)]


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
