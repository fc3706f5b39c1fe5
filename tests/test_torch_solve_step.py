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
    solve_step_bwd, solve_step_bwd_plain, solve_step_fwd,
    solve_step_fwd_plain, step_fits)

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
