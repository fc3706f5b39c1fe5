"""K7 (``csrc/extend_add.cu``) on a CUDA card, in the factor's form (each
pair reads its child out of the source group's whole update block through
``src``): the kernel against its plain version in fp32 and fp64, two calls
bit-equal, and the wrapper's checks on ``src``; the group form (one launch
for several classes, ``extend_add_group``) against its plain version, bit
for bit equal to one launch a class and to itself cut into launches of
fewer classes, under every band height; the bfloat16-update instances
(fp32 and fp64 fronts) bit for bit equal to the same-type instance on the
widened U, in both forms, over vector and scalar child rows. Marked
``card``: they skip
where no card is found (the check is made inside the fixture, not at
import). On the card (whose Python needs no JAX: ``--noconftest`` skips
the JAX set-up of ``tests/conftest.py``):

    python -m pytest --noconftest tests/test_torch_extend_add_card.py -m card
"""

import numpy as np
import pytest
import torch

from suitesparse_tpu_torch.kernels.extend_add import (
    BANDS, build_work, class_maps, extend_add, extend_add_group,
    extend_add_group_plain, extend_add_plain)

pytestmark = pytest.mark.card

# fp32 or fp64 sums in another order than the plain version's, relative to
# the largest entry
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# (B, R, RU, npairs, B_c): the model plan's largest placed class, (114, 224)
# with (np, RU) = (75, 128); many pairs on few slots; an odd R and RU
SHAPES = ((114, 224, 128, 75, 120), (3, 64, 40, 30, 33), (17, 101, 37, 23, 40))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _class(B, R, RU, npairs, B_c, dtype, dev, seed):
    """F (B, R, R), U (B_c, RU, RU) and int32 idx, dst (sorted) and src
    (distinct slots of U); as in the plan, each map's valid rows come
    first, sorted, and the rest (up to half) are padded."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(R, RU, replace=False))
                    for _ in range(npairs)]).astype(np.int32)
    nvalid = rng.integers(RU // 2, RU + 1, npairs)
    idx[np.arange(RU)[None, :] >= nvalid[:, None]] = -1
    dst = np.sort(rng.integers(0, B, npairs)).astype(np.int32)
    src = rng.permutation(B_c)[:npairs].astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    F = t(rng.standard_normal((B, R, R))).to(dtype)
    U = t(rng.standard_normal((B_c, RU, RU))).to(dtype)
    return F, U, t(idx), t(dst), t(src)


# the wrapper's launch counter of each (F, U) instance
COUNTER = {(torch.float32, torch.float32): "launches",
           (torch.float64, torch.float64): "fp64_launches",
           (torch.float32, torch.bfloat16): "bf16_launches",
           (torch.float64, torch.bfloat16): "f64_bf16_launches"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,R,RU,npairs,B_c", SHAPES)
def test_src_form_matches_plain_and_reruns_bit_equal(dev, B, R, RU, npairs,
                                                     B_c, dtype):
    F0, U, idx, dst, src = _class(B, R, RU, npairs, B_c, dtype, dev,
                                  seed=B + R + RU)
    counter = "fp64_launches" if dtype == torch.float64 else "launches"
    before = getattr(extend_add, counter)
    got = extend_add(F0.clone(), U, idx, dst, src)
    again = extend_add(F0.clone(), U, idx, dst, src)
    want = extend_add_plain(F0.clone(), U, idx, dst, src)
    torch.cuda.synchronize()
    assert getattr(extend_add, counter) == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    assert (got - want).abs().max() <= RTOL[dtype] * want.abs().max()


def test_wrong_src_raises(dev):
    F, U, idx, dst, src = _class(5, 40, 16, 8, 12, torch.float32, dev, 0)
    wide = torch.stack([src, src], 1)
    bad = {"int64": src.long(), "non-contiguous": wide[:, 0],
           "on the CPU": src.cpu(), "short": src[:-1]}
    assert not wide[:, 0].is_contiguous()
    for s in bad.values():
        with pytest.raises(ValueError, match="src"):
            extend_add(F, U, idx, dst, s)
    with pytest.raises(ValueError):
        extend_add(F, U.double(), idx, dst, src)
    with pytest.raises(ValueError):
        extend_add(F.half(), U.half(), idx, dst, src)


# (B, R, classes): each class (npairs, RU, B_c); an odd R, classes of odd
# and even RU into the same slots (RU % 4 != 0 takes the scalar loads);
# one slot of many rows and a pair of RU 700, as the fp64 tile groups have
GROUPS = ((6, 101, ((9, 37, 12), (5, 40, 7), (12, 16, 20))),
          (1, 1000, ((1, 700, 2), (2, 300, 3))))


def _group(B, R, classes, dtype, dev, seed, rows=None, max_classes=32):
    rng = np.random.default_rng(seed)
    cls, Us = [], []
    for k, (npairs, RU, B_c) in enumerate(classes):
        idx = np.full((npairs, RU), -1, np.int32)
        for p, nv in enumerate(rng.integers(RU // 2, RU + 1, npairs)):
            idx[p, :nv] = np.sort(rng.choice(R, nv, replace=False))
        dst = np.sort(rng.integers(0, B, npairs)).astype(np.int32)
        src = rng.permutation(B_c)[:npairs].astype(np.int32)
        cls.append(((0, k), src, dst, idx))
        Us.append(torch.as_tensor(rng.standard_normal((B_c, RU, RU)),
                                  device=dev).to(dtype))
    F = torch.as_tensor(rng.standard_normal((B, R, R)), device=dev).to(dtype)
    return F, Us, build_work(B, R, cls, rows, max_classes).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,R,classes", GROUPS)
def test_group_form_matches_plain_and_one_launch_a_class(dev, B, R, classes,
                                                         dtype):
    F0, Us, work = _group(B, R, classes, dtype, dev, seed=R)
    counter = "fp64_launches" if dtype == torch.float64 else "launches"
    before = getattr(extend_add, counter)
    got = extend_add_group(F0.clone(), Us, work)
    again = extend_add_group(F0.clone(), Us, work)
    assert getattr(extend_add, counter) == before + 2
    chain = F0.clone()
    for c, U in enumerate(Us):
        extend_add(chain, U, *class_maps(work, c))
    want = extend_add_group_plain(F0.clone(), Us, work)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, chain)
    assert (got - want).abs().max() <= RTOL[dtype] * want.abs().max()
    # every band height, and one class a launch, give the same bits
    for rows in BANDS:
        _F, _U, w = _group(B, R, classes, dtype, dev, seed=R, rows=rows)
        assert torch.equal(extend_add_group(F0.clone(), Us, w), got)
    _F, _U, w = _group(B, R, classes, dtype, dev, seed=R, max_classes=1)
    before = getattr(extend_add, counter)
    assert torch.equal(extend_add_group(F0.clone(), Us, w), got)
    assert getattr(extend_add, counter) == before + len(classes)


def test_group_form_checks_its_blocks(dev):
    F, Us, work = _group(*GROUPS[0], torch.float32, dev, seed=0)
    with pytest.raises(ValueError, match="RU"):
        extend_add_group(F, Us[::-1], work)
    with pytest.raises(ValueError):
        extend_add_group(F, [U.double() for U in Us], work)
    with pytest.raises(ValueError, match="F"):
        extend_add_group(F[:-1].contiguous(), Us, work)
    with pytest.raises(ValueError, match="update blocks"):
        extend_add_group(F, Us[:-1], work)
    mixed = [Us[0].to(torch.bfloat16)] + Us[1:]
    with pytest.raises(ValueError, match="share a dtype"):
        extend_add_group(F, mixed, work)
    with pytest.raises(ValueError):
        extend_add_group(F.to(torch.bfloat16),
                         [U.to(torch.bfloat16) for U in Us], work)


@pytest.mark.parametrize("fdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,R,RU,npairs,B_c", SHAPES)
def test_bf16_instance_equals_the_same_type_instance(dev, B, R, RU, npairs,
                                                     B_c, fdtype):
    """One class: a bfloat16 U gives the bits the F-dtype instance gives
    on U widened (RU 128 loads eight bfloat16 a lane, 40 and 37 one)."""
    F0, U, idx, dst, src = _class(B, R, RU, npairs, B_c, fdtype, dev,
                                  seed=B + R + RU)
    Ub = U.to(torch.bfloat16)
    counter = COUNTER[fdtype, torch.bfloat16]
    before = getattr(extend_add, counter)
    got = extend_add(F0.clone(), Ub, idx, dst, src)
    again = extend_add(F0.clone(), Ub, idx, dst, src)
    same = extend_add(F0.clone(), Ub.to(fdtype), idx, dst, src)
    want = extend_add_plain(F0.clone(), Ub, idx, dst, src)
    torch.cuda.synchronize()
    assert getattr(extend_add, counter) == before + 2
    assert got.dtype == fdtype
    assert torch.equal(got, again) and torch.equal(got, same)
    assert (got - want).abs().max() <= RTOL[fdtype] * want.abs().max()


# the bfloat16 rows of GROUPS' classes (RU 37, 40, 16; 700, 300) and a
# group whose every class loads eight bfloat16 a lane (RU % 8 == 0)
BF16_GROUPS = GROUPS + ((2, 1000, ((1, 704, 2), (2, 296, 3))),)


@pytest.mark.parametrize("fdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,R,classes", BF16_GROUPS)
def test_bf16_group_form_equals_the_same_type_instance(dev, B, R, classes,
                                                       fdtype):
    F0, Us, work = _group(B, R, classes, fdtype, dev, seed=R)
    Ub = [U.to(torch.bfloat16) for U in Us]
    counter = COUNTER[fdtype, torch.bfloat16]
    before = getattr(extend_add, counter)
    got = extend_add_group(F0.clone(), Ub, work)
    assert getattr(extend_add, counter) == before + len(work.parts)
    same = extend_add_group(F0.clone(), [U.to(fdtype) for U in Ub], work)
    want = extend_add_group_plain(F0.clone(), Ub, work)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    assert (got - want).abs().max() <= RTOL[fdtype] * want.abs().max()
