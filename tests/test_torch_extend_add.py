"""Port's extend-add K7 (plain version on the CPU) vs the Pallas kernel and
the brute-force oracle of the reference's own test
(``tests/test_extend_add_kernel.py``), on its three shapes and one that
puts 20 pairs on 2 slots.

Inputs as that test makes them: seeded child blocks and sorted row maps
with padded rows, dst padded by ``pad_pairs`` so that every slot has a
pair. The reference kernel runs in interpret mode and returns F plus the
contribution; the port adds in place. The factor's form (``src``: each
pair reads its child out of the source group's whole update block) is
held against the reference given those children gathered and padded, in
fp32 and fp64, and so is the library scatter ``extend_add_library``. Sums
run in another order: 1e-5 absolute in fp32, the reference test's
tolerance, on entries of order 1; 1e-12 in fp64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.kernels.extend_add import extend_add as extend_add_pallas
from suitesparse_tpu.kernels.extend_add import pad_pairs as pad_pairs_ref
from suitesparse_tpu_torch.kernels.extend_add import (extend_add,
                                                      extend_add_library,
                                                      extend_add_plain,
                                                      pad_pairs)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
# (B, R, RU, npairs, seed); the last puts 20 pairs on 2 slots
SHAPES = [(5, 24, 8, 7, 0), (3, 16, 16, 9, 1), (8, 40, 8, 2, 2),
          (2, 32, 12, 20, 3)]
DTYPES = [np.float32, np.float64]


def _inputs(B, R, RU, npr, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    child = rng.standard_normal((npr, RU, RU)).astype(dtype)
    idx = np.stack([np.sort(rng.choice(R, RU, replace=False))
                    for _ in range(npr)]).astype(np.int32)
    idx[0, -2:] = -1                       # padded rows
    dst0 = np.sort(rng.integers(0, B, npr)).astype(np.int32)
    F0 = rng.standard_normal((B, R, R)).astype(dtype)
    return child, idx, dst0, F0


def _source_block(child, seed):
    """The children as the factor finds them: slots of a source group's
    update block U (3 more slots than children, the rest random), and src
    with U[src] == child."""
    rng = np.random.default_rng(seed + 100)
    npr = child.shape[0]
    U = rng.standard_normal((npr + 3, *child.shape[1:])).astype(child.dtype)
    src = rng.permutation(npr + 3)[:npr].astype(np.int32)
    U[src] = child
    return U, src


def _padded(B, child, idx, dst0):
    dstf, idxf, order = pad_pairs(B, dst0, idx)
    childf = np.zeros((dstf.size, *child.shape[1:]), child.dtype)
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
    assert np.abs(got - ref).max() < TOL[np.float32]
    assert np.abs(got - _oracle(F0, child, idx, dst0)).max() < TOL[np.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,R,RU,npr,seed", SHAPES)
def test_src_form_matches_pallas(B, R, RU, npr, seed, dtype):
    """Each pair reads U[src[p]]: the same sums as the reference kernel on
    the gathered children, padded by ``pad_pairs``; fp64 against the
    reference in fp64."""
    child, idx, dst0, F0 = _inputs(B, R, RU, npr, seed, dtype)
    U, src = _source_block(child, seed)
    childf, idxf, dstf = _padded(B, child, idx, dst0)
    ref = np.asarray(extend_add_pallas(jnp.asarray(F0), jnp.asarray(childf),
                                       idxf, dstf, interpret=True))
    assert ref.dtype == dtype
    Ft = torch.from_numpy(F0.copy())
    out = extend_add_plain(Ft, torch.from_numpy(U), torch.from_numpy(idx),
                           torch.from_numpy(dst0), torch.from_numpy(src))
    assert out is Ft and out.dtype == getattr(torch, np.dtype(dtype).name)
    assert np.abs(out.numpy() - ref).max() < TOL[dtype]
    assert np.abs(out.numpy() - _oracle(F0, child, idx, dst0)).max() \
        < TOL[dtype]


@pytest.mark.parametrize("B,R,RU,npr,seed", SHAPES)
def test_library_matches_plain(B, R, RU, npr, seed):
    """The library scatter (the kernel's yardstick) on the flat fronts with
    their dump cell: the same placement, the dump cell apart."""
    child, idx, dst0, F0 = _inputs(B, R, RU, npr, seed, np.float64)
    U, src = _source_block(child, seed)
    args = [torch.from_numpy(a) for a in (U, idx, dst0)]
    Fbuf = torch.from_numpy(np.concatenate([F0.ravel(), [0.0]]))
    got = extend_add_library(Fbuf, *args, R, src=torch.from_numpy(src))
    want = extend_add_plain(torch.from_numpy(F0.copy()), *args,
                            torch.from_numpy(src))
    assert got is Fbuf
    assert np.abs(got[:-1].view(B, R, R).numpy() - want.numpy()).max() \
        < TOL[np.float64]


def test_wrapper_takes_plain_version_on_cpu():
    B = 5
    child, idx, dst0, F0 = _inputs(B, 24, 8, 7, 0)
    args = [torch.from_numpy(a) for a in _padded(B, child, idx, dst0)]
    before = extend_add.launches
    got = extend_add(torch.from_numpy(F0.copy()), *args)
    assert torch.equal(got, extend_add_plain(torch.from_numpy(F0.copy()),
                                             *args))
    assert extend_add.launches == before
    # the factor's form in fp64: the plain version, no launch counted
    child, idx, dst0, F0 = _inputs(B, 24, 8, 7, 0, np.float64)
    U, src = _source_block(child, 0)
    args = [torch.from_numpy(a) for a in (U, idx, dst0, src)]
    before = extend_add.fp64_launches
    got = extend_add(torch.from_numpy(F0.copy()), *args)
    assert torch.equal(got, extend_add_plain(torch.from_numpy(F0.copy()),
                                             *args))
    assert extend_add.fp64_launches == before
