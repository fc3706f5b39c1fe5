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
tolerance, on entries of order 1; 1e-12 in fp64.

The group form (``extend_add_group`` on a ``build_work`` list, the
factor's one launch a group) is held against the chain of one-class plain
calls and of reference calls, and its launch plan is walked as the kernel
walks it, over every group of the test plans."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from suitesparse_tpu.kernels.extend_add import extend_add as extend_add_pallas
from suitesparse_tpu.kernels.extend_add import pad_pairs as pad_pairs_ref
from suitesparse_tpu_torch.kernels.extend_add import (
    BANDS, BLOCK_CELLS, FILL_BLOCKS, MAX_CLASSES, build_work, class_maps,
    class_work, extend_add, extend_add_geometry, extend_add_group,
    extend_add_group_plain, extend_add_library, extend_add_plain, group_work,
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


# a group of R = 37 parent rows (odd) and 4 slots: (RU_c, npairs, B_c,
# seed) a class, RU_c odd or even, the valid rows of each map drawn from
# the same parent rows, so that the classes overlap on the same slots
GROUP_R, GROUP_B = 37, 4
GROUP_CLASSES = ((9, 5, 7, 10), (13, 4, 6, 11), (6, 3, 3, 12), (31, 2, 2, 13))


def _group(dtype, max_classes=MAX_CLASSES, rows=8):
    """Work list, update blocks and fronts of the GROUP_CLASSES group:
    every map padded with -1 after its valid rows, and the last class's
    first pair spanning all five 8-row bands."""
    classes, Us = [], []
    for key, (RU, npr, B_c, seed) in enumerate(GROUP_CLASSES):
        rng = np.random.default_rng(seed)
        nvalid = rng.integers(max(1, RU // 2), RU, npr)
        idx = np.full((npr, RU), -1, np.int32)
        for p, nv in enumerate(nvalid):
            idx[p, :nv] = np.sort(rng.choice(GROUP_R, nv, replace=False))
        if RU == 31:
            idx[0, :30] = np.arange(0, 37, 37 / 30).astype(np.int32)[:30]
            idx[0, 30] = -1
        dst = np.sort(np.concatenate([[2], rng.integers(0, GROUP_B,
                                                        npr - 1)]))
        dst = dst.astype(np.int32)      # every class reaches slot 2
        src = rng.permutation(B_c)[:npr].astype(np.int32)
        classes.append((("level", key), src, dst, idx))
        Us.append(rng.standard_normal((B_c, RU, RU)).astype(dtype))
    F0 = np.random.default_rng(9).standard_normal(
        (GROUP_B, GROUP_R, GROUP_R)).astype(dtype)
    return build_work(GROUP_B, GROUP_R, classes, rows, max_classes), Us, F0


@pytest.mark.parametrize("max_classes", [MAX_CLASSES, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_plain_matches_chain_and_pallas(dtype, max_classes):
    """The group form on the CPU equals the chain of one-class plain calls
    bit for bit, and agrees with the chain of reference kernels (interpret
    mode) on the children gathered and padded, and with the oracle."""
    work, Us, F0 = _group(dtype, max_classes)
    assert len(work.parts) == -(-len(GROUP_CLASSES) // max_classes)
    # the classes overlap: some slot takes pairs of every class
    slots = [set(class_maps(work, c)[1].tolist())
             for c in range(len(Us))]
    assert set.intersection(*slots)
    Ut = [torch.from_numpy(U) for U in Us]
    Ft = torch.from_numpy(F0.copy())
    got = extend_add_group(Ft, Ut, work.to("cpu"))
    assert got is Ft
    chain = torch.from_numpy(F0.copy())
    ref, want = F0.copy(), F0.copy()
    for c, U in enumerate(Us):
        idx, dst, src = class_maps(work, c)
        extend_add_plain(chain, torch.from_numpy(U), torch.from_numpy(idx),
                         torch.from_numpy(dst), torch.from_numpy(src))
        childf, idxf, dstf = _padded(GROUP_B, U[src], idx, dst)
        ref = np.asarray(extend_add_pallas(jnp.asarray(ref),
                                           jnp.asarray(childf), idxf, dstf,
                                           interpret=True))
        want = _oracle(want, U[src], idx, dst)
    assert torch.equal(got, chain)
    assert np.abs(got.numpy() - ref).max() < TOL[dtype]
    assert np.abs(got.numpy() - want).max() < TOL[dtype]
    plain = extend_add_group_plain(torch.from_numpy(F0.copy()), Ut,
                                   work.to("cpu"))
    assert torch.equal(plain, got)


def _warp_partition(lo, hi, pred):
    """The kernel's warp-wide search (``warp_partition``), lane by lane."""
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        n = sum(q < hi and pred(q)
                for q in (lo + (lane + 1) * step - 1 for lane in range(32)))
        hi = min(hi, lo + (n + 1) * step - 1)
        lo += n * step
    return lo + sum(q < hi and pred(q) for q in range(lo, lo + 32))


def _walk(work):
    """What the kernel adds, block by block and warp by warp: the list of
    (class, pair, child row) each warp of each listed block takes, by its
    owned parent rows [r0, r1), and each block's parent rows."""
    geom = work.geom
    h = geom.rows // geom.warps
    seen = []
    for c0, c1, blocks in work.parts:
        blocks = np.asarray(blocks)
        assert np.unique(blocks).size == blocks.size
        for b in blocks.tolist():
            slot, band = divmod(b, geom.nbands)
            assert 0 <= slot < work.B
            took = []
            for warp in range(geom.warps):
                r0 = band * geom.rows + warp * h
                r1 = min(r0 + h, work.R)
                if r0 >= work.R:
                    continue
                for c in range(c0, c1):
                    idx, dst, _src = class_maps(work, c)
                    p0, p1 = np.searchsorted(dst, [slot, slot + 1])
                    for p in range(p0, p1):
                        m = idx[p]
                        i0 = _warp_partition(
                            0, m.size, lambda i: 0 <= m[i] < r0)
                        i1 = _warp_partition(
                            i0, m.size, lambda i: 0 <= m[i] < r1)
                        nv = _warp_partition(i1, m.size, lambda i: m[i] >= 0)
                        assert nv == (m >= 0).sum() or i0 == i1
                        took += [(c, p, i) for i in range(i0, i1)]
                        assert all(r0 <= m[i] < r1 for i in range(i0, i1))
            assert took, f"block {b} is listed but takes no child row"
            seen += took
    return seen


def _every_row(work):
    return [(c, p, i) for c in range(len(work.keys))
            for p, m in enumerate(class_maps(work, c)[0])
            for i in np.flatnonzero(m >= 0).tolist()]


def test_walk_takes_every_child_row_once_on_the_group():
    for max_classes in (MAX_CLASSES, 2, 1):
        for rows in BANDS:
            work = _group(np.float32, max_classes, rows)[0]
            seen = _walk(work)
            assert len(seen) == len(set(seen))
            assert sorted(seen) == sorted(_every_row(work))


def _test_plan(tile_rmin):
    from suitesparse_tpu_torch import DEFAULT, fixtures
    from suitesparse_tpu_torch.numeric import supernodal_device
    from suitesparse_tpu_torch.ordering import nested_dissection_order
    from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

    A = fixtures.laplacian_3d(12)
    S = analyze_supernodal(A, nested_dissection_order(A, DEFAULT))
    return supernodal_device.build_plan(S, A.symperm(S.perm).transpose(),
                                        tile_rmin)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tile_rmin", [256, 32])
def test_walk_takes_every_child_row_once_on_the_plan(tile_rmin, dtype):
    """Every group of the laplacian_3d_12 plan: the work list the factor
    builds (fp32: the classes no manifest folds; fp64: all), its plan's
    band height, and every valid child row of every pair in exactly one
    listed (slot, band) block, by one warp."""
    plan = _test_plan(tile_rmin)
    nwork = 0
    for gl in plan.groups:
        for g in gl:
            folded = set(g._tile.folded) if g._tile is not None and \
                dtype == "float32" else set()
            classes = [((pc.src_level, pc.src_gi), *arrays)
                       for ci, (pc, arrays)
                       in enumerate(zip(g.pairs, g._pair_arrays))
                       if ci not in folded]
            if not classes:
                continue
            work = build_work(g.B, g.R, classes)
            nwork += 1
            slots = np.unique(np.concatenate([c[2] for c in classes])).size
            assert work.geom == extend_add_geometry(slots, g.R, work.cells)
            assert work.keys == [c[0] for c in classes]
            assert [p[:2] for p in work.parts] == [(0, len(classes))]
            seen = _walk(work)
            assert len(seen) == len(set(seen))
            assert sorted(seen) == sorted(_every_row(work))
            for c, (_key, src, dst, idx) in enumerate(classes):
                for a, b in zip(class_maps(work, c), (idx, dst, src)):
                    assert np.array_equal(a, b)
            nbytes, adds = group_work(work)
            assert adds == sum(class_work(g.R, c[3], c[2])[1]
                               for c in classes)
            assert nbytes <= sum(class_work(g.R, c[3], c[2], 4, c[1])[0]
                                 for c in classes) \
                + 4 * sum(p[2].size for p in work.parts)
    # at threshold 32 the manifests fold every class of this plan
    assert nwork > 0 or (tile_rmin, dtype) == (32, "float32")


def test_geometry_picks_the_tallest_band_that_fills_the_card():
    # one busy slot of 3912 rows: no band fills the card, so the shortest
    g = extend_add_geometry(1, 3912)
    assert (g.rows, g.warps, g.nbands) == (8, 8, 489)
    # 51 slots of 264 rows: 51 * 17 bands of 16 rows >= FILL_BLOCKS, 51 * 9
    # of 32 rows not
    assert 51 * 17 >= FILL_BLOCKS > 51 * 9
    assert extend_add_geometry(51, 264).rows == 16
    # many slots: the tallest band
    assert extend_add_geometry(8735, 16) == (32, 8, 1)
    # the model plan's (114, 224) group fills the card with 32-row bands
    # of under BLOCK_CELLS cells; the fp64 (15, 936) group's cells want
    # more blocks than 16-row bands give
    assert extend_add_geometry(114, 224, 2032895).rows == 32
    assert 15 * 59 < 5948704 / BLOCK_CELLS
    assert extend_add_geometry(15, 936, 5948704).rows == 8
    assert extend_add_geometry(15, 936).rows == 16
    for rows in BANDS:
        g = extend_add_geometry(3, 101, rows=rows)
        assert g.rows == rows and g.nbands == -(-101 // rows)
        assert g.rows % g.warps == 0
    for bad in (4, 12, 64, 128):
        with pytest.raises(ValueError, match="rows"):
            extend_add_geometry(3, 101, rows=bad)
    with pytest.raises(ValueError):
        extend_add_geometry(3, 0)
    with pytest.raises(ValueError):
        extend_add_geometry(3, 10, -1)


def test_build_work_rejects_maps_the_kernel_cannot_walk():
    work, _Us, _F0 = _group(np.float32)
    key, (idx, dst, src) = "k", class_maps(work, 0)
    bad = {"unsorted rows": idx[:, ::-1].copy(),
           "a hole": np.where(np.arange(idx.shape[1]) == 0, -1, idx),
           "a row past R": np.where(idx >= 0, idx + GROUP_R, -1)}
    for name, b in bad.items():
        with pytest.raises(ValueError, match="row map"):
            build_work(GROUP_B, GROUP_R, [(key, src, dst, b.astype(np.int32))])
    with pytest.raises(ValueError, match="dst"):
        build_work(GROUP_B, GROUP_R, [(key, src, dst[::-1].copy(), idx)])
    with pytest.raises(ValueError, match="src"):
        build_work(GROUP_B, GROUP_R, [(key, src[:-1], dst, idx)])
    with pytest.raises(ValueError, match="max_classes"):
        build_work(GROUP_B, GROUP_R, [(key, src, dst, idx)],
                   max_classes=MAX_CLASSES + 1)


def test_blocks_listed_heaviest_first():
    work = _group(np.float64, rows=8)[0]
    geom = work.geom
    for c0, c1, blocks in work.parts:
        load = {}
        for c in range(c0, c1):
            idx, dst, _src = class_maps(work, c)
            for p, m in enumerate(idx):
                nv = int((m >= 0).sum())
                for r in m[m >= 0]:
                    b = int(dst[p]) * geom.nbands + int(r) // geom.rows
                    load[b] = load.get(b, 0) + nv
        got = [load[b] for b in blocks.tolist()]
        assert sorted(load) == sorted(blocks.tolist())
        assert got == sorted(got, reverse=True)


def test_group_wrapper_takes_plain_version_on_cpu():
    work, Us, F0 = _group(np.float64)
    before = (extend_add.launches, extend_add.fp64_launches)
    Ut = [torch.from_numpy(U) for U in Us]
    got = extend_add_group(torch.from_numpy(F0.copy()), Ut, work.to("cpu"))
    want = extend_add_group_plain(torch.from_numpy(F0.copy()), Ut,
                                  work.to("cpu"))
    assert torch.equal(got, want)
    assert (extend_add.launches, extend_add.fp64_launches) == before
    with pytest.raises(ValueError, match="update blocks"):
        extend_add_group(torch.from_numpy(F0.copy()), Ut[:-1],
                         work.to("cpu"))
