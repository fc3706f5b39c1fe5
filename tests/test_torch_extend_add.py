"""Port's extend-add K7 (plain version on the CPU) vs the Pallas kernel and
the brute-force oracle of the reference's own test
(``tests/test_extend_add_kernel.py``), on its three shapes.

Inputs as that test makes them: seeded child blocks and sorted row maps
with padded rows, dst padded by ``pad_pairs`` so that every slot has a
pair. The reference kernel runs in interpret mode and returns F plus the
contribution; the port adds in place. Sums run in another order: 1e-5
absolute, the reference test's tolerance, on entries of order 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.kernels.extend_add import extend_add as extend_add_pallas
from suitesparse_tpu.kernels.extend_add import pad_pairs as pad_pairs_ref
from suitesparse_tpu_torch.kernels.extend_add import (extend_add,
                                                      extend_add_plain,
                                                      pad_pairs)

TOL = 1e-5
SHAPES = [(5, 24, 8, 7, 0), (3, 16, 16, 9, 1), (8, 40, 8, 2, 2)]


def _inputs(B, R, RU, npr, seed):
    rng = np.random.default_rng(seed)
    child = rng.standard_normal((npr, RU, RU)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(R, RU, replace=False))
                    for _ in range(npr)]).astype(np.int32)
    idx[0, -2:] = -1                       # padded rows
    dst0 = np.sort(rng.integers(0, B, npr)).astype(np.int32)
    F0 = rng.standard_normal((B, R, R)).astype(np.float32)
    return child, idx, dst0, F0


def _padded(B, child, idx, dst0):
    dstf, idxf, order = pad_pairs(B, dst0, idx)
    childf = np.zeros((dstf.size, *child.shape[1:]), np.float32)
    childf[order >= 0] = child[order[order >= 0]]
    return childf, idxf, dstf


def _oracle(F0, child, idx, dst0):
    Fref = F0.copy()
    for p in range(len(dst0)):
        for i in range(idx.shape[1]):
            if idx[p, i] < 0:
                continue
            for j in range(idx.shape[1]):
                if idx[p, j] >= 0:
                    Fref[dst0[p], idx[p, i], idx[p, j]] += child[p, i, j]
    return Fref


@pytest.mark.parametrize("B,R,RU,npr,seed", SHAPES)
def test_plain_matches_pallas_and_oracle(B, R, RU, npr, seed):
    child, idx, dst0, F0 = _inputs(B, R, RU, npr, seed)
    childf, idxf, dstf = _padded(B, child, idx, dst0)
    for a, b in zip(pad_pairs(B, dst0, idx), pad_pairs_ref(B, dst0, idx)):
        assert np.array_equal(a, b)
    ref = np.asarray(extend_add_pallas(jnp.asarray(F0), jnp.asarray(childf),
                                       idxf, dstf, interpret=True))
    Ft = torch.from_numpy(F0.copy())
    out = extend_add_plain(Ft, torch.from_numpy(childf),
                           torch.from_numpy(idxf), torch.from_numpy(dstf))
    assert out is Ft                                   # in place
    got = out.numpy()
    assert np.abs(got - ref).max() < TOL
    assert np.abs(got - _oracle(F0, child, idx, dst0)).max() < TOL


def test_wrapper_takes_plain_version_on_cpu():
    B = 5
    child, idx, dst0, F0 = _inputs(B, 24, 8, 7, 0)
    args = [torch.from_numpy(a) for a in _padded(B, child, idx, dst0)]
    before = extend_add.launches
    got = extend_add(torch.from_numpy(F0.copy()), *args)
    assert torch.equal(got, extend_add_plain(torch.from_numpy(F0.copy()),
                                             *args))
    assert extend_add.launches == before
