"""K1 (``csrc/potrf_trsm.cu``) on a CUDA card: the kernel against its plain
version, bit-equal under every launch plan, and an indefinite tile's NaN
kept in its tile. Marked ``card``: they skip where no card is found (the
check is made inside the fixture, not at import). On the card (whose
Python needs no JAX: ``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_potrf_card.py -m card
"""

import numpy as np
import pytest
import torch

from suitesparse_tpu_torch.kernels.potrf import (_launch, potrf_geometry,
                                                 potrf_trsm, potrf_trsm_plain)

pytestmark = pytest.mark.card

RTOL = 1e-5   # fp32 sums in another order than the plain version's
SHAPES = ((8735, 8, 8), (45, 48, 384), (114, 32, 192), (5, 1, 3),
          (7, 96, 500), (2, 37, 101), (33, 96, 0), (9, 64, 77))
FORCED = ({"split": 1}, {"split": 4}, {"split": 16}, {"tpw": 1},
          {"wpt": 4})


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tiles(B, C, RU, dev, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, C, C), dtype=np.float32)
    f11 = torch.as_tensor(M @ np.swapaxes(M, 1, 2)
                          + C * np.eye(C, dtype=np.float32), device=dev)
    f21 = torch.as_tensor(rng.standard_normal((B, RU, C), dtype=np.float32),
                          device=dev) if RU else None
    return f11, f21


@pytest.mark.parametrize("B,C,RU", SHAPES)
def test_kernel_matches_plain_and_every_plan_bit_equal(dev, B, C, RU):
    f11, f21 = _tiles(B, C, RU, dev, seed=B + C + RU)
    L11, L21 = potrf_trsm(f11, f21)
    P11, P21 = potrf_trsm_plain(f11, f21)
    assert (L11 - P11).abs().max() <= RTOL * P11.abs().max()
    assert torch.equal(torch.triu(L11, 1), torch.zeros_like(L11))
    if RU:
        assert (L21 - P21).abs().max() <= RTOL * P21.abs().max()
    for kw in FORCED:
        try:
            g = potrf_geometry(B, C, RU, **kw)
        except ValueError:
            continue
        G11 = torch.empty_like(f11)
        G21 = None if f21 is None else torch.empty_like(f21)
        _launch(f11, f21, G11, G21, g)
        assert torch.equal(G11, L11) and (RU == 0 or torch.equal(G21, L21))


@pytest.mark.parametrize("C,RU", [(8, 8), (16, 24), (12, 5), (32, 40),
                                  (48, 100), (96, 10)])
def test_indefinite_tile_nan_stays_in_its_tile(dev, C, RU):
    B, bad = 11, 5
    f11, f21 = _tiles(B, C, RU, dev, seed=C)
    f11[bad] -= 4.0 * C * torch.eye(C, device=dev)
    L11, L21 = potrf_trsm(f11, f21)
    fin = torch.isfinite(L11).flatten(1).all(1) & \
        torch.isfinite(L21).flatten(1).all(1)
    assert fin.tolist() == [i != bad for i in range(B)]
