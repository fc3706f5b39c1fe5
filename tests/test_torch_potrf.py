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
from suitesparse_tpu_torch.kernels.potrf import potrf_trsm, potrf_trsm_plain

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
                                    (33, 96, 40)])
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
