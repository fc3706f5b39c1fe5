"""Extend-add placement of child update blocks (K7): CUDA kernel + plain
version.

Port of :mod:`suitesparse_tpu.kernels.extend_add`. For parent fronts
F (B, R, R), child update blocks U, int32 row maps idx (np, RU) (-1 = no
row) and int32 destination slots dst (np,) sorted ascending:

    F[dst[p], idx[p, i], idx[p, j]] += child_p[i, j]   where both idx >= 0

child_p is U[src[p]] for an int32 ``src`` (np,): the factor passes the
source group's whole (B_c, RU, RU) update block. Without ``src``, U holds
the children in the order of ``dst`` and child_p is U[p]. F in fp32 or
fp64, U of F's dtype or bfloat16 (a factor under
``Config.update_dtype="bfloat16"``): a bfloat16 child is widened to F's
dtype, exactly, and added in F's dtype, so the result is bit for bit the
one of U widened first. The kernel takes each row map as the plan makes
it: its valid rows first, strictly increasing, then -1.

Both versions update F IN PLACE and return it (the reference returns
F + the contribution). :func:`pad_pairs` (the reference's, copied) adds a
dummy pair for every slot without one, as the reference's contract asks;
the port's kernel needs no such cover. The JAX package wires this kernel
into nothing; the port's factor places every pair class that a tile
manifest does not fold with it, one launch a group
(:func:`extend_add_group` on the group's :class:`ExtendAddWork`, built once
a plan by :func:`build_work`). :func:`extend_add` places one class, the
same kernel on a one-class work list. :func:`extend_add_library` computes
the same placement with one library scatter, the yardstick of the
kernel's measurements; no path calls it.

:func:`extend_add_geometry` plans the launch (parent rows a block, warps
a block) in Python, so that the CPU tests can check it; the kernel's entry
point checks what it is given.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .trisolve import SMS

__all__ = ["COUNTERS", "BANDS", "BLOCK_CELLS", "FILL_BLOCKS", "MAX_CLASSES",
           "ExtendAddGeometry", "ExtendAddWork", "build_work", "class_maps",
           "class_work", "extend_add", "extend_add_geometry",
           "extend_add_group", "extend_add_group_plain", "extend_add_library",
           "extend_add_plain", "group_work", "pad_pairs"]

# the kernel's instance (``inst`` of sst_extend_add) for (F, U) dtypes, and
# the wrapper's attribute that counts its launches
_INSTANCES = {(torch.float32, torch.float32): (0, "launches"),
              (torch.float64, torch.float64): (1, "fp64_launches"),
              (torch.float32, torch.bfloat16): (2, "bf16_launches"),
              (torch.float64, torch.bfloat16): (3, "f64_bf16_launches")}
WARPS = 8              # warps of a block (kWarps in the kernel)
BANDS = (32, 16, 8)    # parent rows a block: 4, 2 or 1 a warp
# blocks a grid should have, where the slots' rows allow (4 an SM), and the
# most child cells a block should take on average: the pick on all 20
# groups that ``extend_add_sweep`` times every band height of (PERF.md)
FILL_BLOCKS = 4 * SMS
BLOCK_CELLS = 4096
MAX_CLASSES = 32       # classes a launch (kMaxClasses in the kernel)


class ExtendAddGeometry(NamedTuple):
    """Launch plan of ``csrc/extend_add.cu``: each destination slot's R
    parent rows are cut into ``nbands`` bands of ``rows`` rows, one block
    of ``warps`` warps a (slot, band); warp ``w`` of band ``b`` owns the
    parent rows ``b * rows + w * rows / warps`` and the ``rows / warps - 1``
    after it, and adds every child row that lands there."""
    rows: int
    warps: int
    nbands: int


def extend_add_geometry(slots: int, R: int, cells: int = 0,
                        rows: int | None = None) -> ExtendAddGeometry:
    """The kernel's launch plan for ``slots`` busy destination slots of R
    parent rows that take ``cells`` child cells: the tallest band of BANDS
    whose grid (``slots`` times the bands a slot) has FILL_BLOCKS blocks
    and at most BLOCK_CELLS cells a block, the shortest where none does.
    A taller band shares each pair's searches among more rows and finds a
    small group's few pairs with fewer blocks; a shorter one puts a few
    busy slots on more SMs and gives each warp fewer rows to walk one
    after another. ``rows`` asks for that band height instead
    (``extend_add_sweep``)."""
    if slots < 0 or R < 1 or cells < 0:
        raise ValueError(f"extend_add_geometry: slots {slots}, R {R} and "
                         f"cells {cells}")
    if rows is None:
        rows = next((h for h in BANDS
                     if slots * -(-R // h) >= max(FILL_BLOCKS,
                                                  cells / BLOCK_CELLS)),
                    BANDS[-1])
    elif rows not in BANDS:
        raise ValueError(f"extend_add_geometry: rows {rows} not in {BANDS}")
    return ExtendAddGeometry(rows, WARPS, -(-R // rows))


@dataclasses.dataclass
class ExtendAddWork:
    """One group's K7 work list: its pair classes in plan order, their maps
    concatenated, and the launches that place them.

    Class c has ``meta[c] = (RU_c, first pair, npairs, first idx entry)``:
    its pairs are ``dst[p0:p0 + np]`` and ``src[p0:p0 + np]``, its row maps
    ``idx[i0:i0 + np * RU_c]`` (np, RU_c; i0 a multiple of 4), and its
    children live in the update block of ``keys[c]``. Each part ``(c0, c1,
    blocks)`` is one launch for classes c0..c1-1 (at most MAX_CLASSES):
    ``blocks`` lists the (slot, band) blocks that some child row reaches,
    as ``slot * nbands + band``, the most child cells first. The maps are
    numpy arrays until :meth:`to` uploads them as int32 tensors."""
    B: int
    R: int
    geom: ExtendAddGeometry
    keys: list
    meta: np.ndarray
    idx: object
    dst: object
    src: object
    parts: list
    cells: int             # valid child cells: the adds of one placement

    def to(self, device) -> "ExtendAddWork":
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)

        return dataclasses.replace(
            self, idx=t(self.idx), dst=t(self.dst), src=t(self.src),
            parts=[(c0, c1, t(blk)) for c0, c1, blk in self.parts])


def _check_maps(R: int, B: int, src, dst, idx) -> None:
    """The kernel's contract on one class's maps (plan time)."""
    np_, RU = idx.shape
    if src.shape != (np_,) or dst.shape != (np_,):
        raise ValueError(f"build_work: src {src.shape} and dst {dst.shape} "
                         f"must be ({np_},)")
    ok = idx >= 0
    nv = ok.sum(1)
    if np.any(ok != (np.arange(RU)[None, :] < nv[:, None])) \
            or np.any(idx >= R) \
            or np.any(np.diff(idx, axis=1)[ok[:, 1:]] <= 0):
        raise ValueError("build_work: each row map must hold its valid rows "
                         "first, strictly increasing and below R, then -1")
    if np.any(np.diff(dst) < 0) or (np_ and (dst[0] < 0 or dst[-1] >= B)):
        raise ValueError("build_work: dst must ascend within [0, B)")


def build_work(B: int, R: int, classes, rows: int | None = None,
               max_classes: int = MAX_CLASSES) -> ExtendAddWork:
    """Plan-time work list of one group's placement through K7.

    ``classes``: ``[(key, src, dst, idx)]`` in plan order, numpy int
    arrays as the plan holds them (idx (np, RU_c), valid rows first and
    increasing; dst ascending). The band height comes from
    :func:`extend_add_geometry` on the slots that some pair reaches and the
    child cells, or is ``rows``; each launch takes ``max_classes`` classes
    at most."""
    if not 1 <= max_classes <= MAX_CLASSES:
        raise ValueError(f"build_work: max_classes {max_classes}")
    if not classes:
        raise ValueError("build_work: no classes")
    for _key, src, dst, idx in classes:
        _check_maps(R, B, src, dst, idx)
    slots = np.unique(np.concatenate([d for _k, _s, d, _i in classes])).size
    cells = sum(int((((idx >= 0).sum(1)).astype(np.int64) ** 2).sum())
                for _k, _s, _d, idx in classes)
    geom = extend_add_geometry(slots, R, cells, rows)
    # each class's maps start on 16 bytes, for the kernel's vector loads
    meta, p0, i0, maps = [], 0, 0, []
    for _key, _src, dst, idx in classes:
        meta.append((idx.shape[1], p0, dst.size, i0))
        p0 += dst.size
        i0 += -(-idx.size // 4) * 4
        maps += [np.asarray(idx, np.int32).ravel(),
                 np.full(-idx.size % 4, -1, np.int32)]
    if i0 >= 2 ** 31:
        raise ValueError(f"build_work: {i0} map entries overflow int32")
    parts = []
    for c0 in range(0, len(classes), max_classes):
        c1 = min(c0 + max_classes, len(classes))
        keys, weights = [], []
        for _key, _src, dst, idx in classes[c0:c1]:
            ok = idx >= 0
            nv = ok.sum(1).astype(np.int64)
            pair, _ = np.nonzero(ok)
            keys.append(dst.astype(np.int64)[pair] * geom.nbands
                        + idx[ok].astype(np.int64) // geom.rows)
            weights.append(nv[pair])
        blk, inv = np.unique(np.concatenate(keys), return_inverse=True)
        load = np.bincount(inv, weights=np.concatenate(weights))
        order = np.lexsort((blk, -load))
        parts.append((c0, c1, blk[order].astype(np.int32)))
    dst, src = (np.concatenate([np.asarray(c[j], np.int32) for c in classes])
                for j in (2, 1))
    return ExtendAddWork(B=B, R=R, geom=geom, keys=[c[0] for c in classes],
                         meta=np.array(meta, np.int32).reshape(-1, 4),
                         idx=np.concatenate(maps), dst=dst, src=src,
                         parts=parts, cells=cells)


def class_maps(work: ExtendAddWork, c: int):
    """Class c's (idx (np, RU_c), dst, src) out of the concatenated maps."""
    RU, p0, npairs, i0 = (int(v) for v in work.meta[c])
    return (work.idx[i0:i0 + npairs * RU].reshape(npairs, RU),
            work.dst[p0:p0 + npairs], work.src[p0:p0 + npairs])


def pad_pairs(B: int, dst: np.ndarray, idx: np.ndarray):
    """Plan-time helper: pad a dummy pair (idx = -1) for every slot without a
    real pair and return (dst_full, idx_full, src_order) with dst_full sorted
    ascending. src_order[t] = original pair index, or -1 for a dummy."""
    RU = idx.shape[1]
    missing = np.setdiff1d(np.arange(B, dtype=dst.dtype), dst)
    dst_full = np.concatenate([dst, missing])
    idx_full = np.concatenate(
        [idx, np.full((missing.size, RU), -1, dtype=idx.dtype)])
    src_order = np.concatenate(
        [np.arange(dst.size, dtype=np.int64),
         np.full(missing.size, -1, dtype=np.int64)])
    order = np.argsort(dst_full, kind="stable")
    return dst_full[order], idx_full[order], src_order[order]


def _touched(R: int, idx: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Flat parent cells that one class's placement reaches."""
    ok = idx >= 0
    flat = [((int(d) * R + r[:, None]) * R + r[None, :]).ravel()
            for d, r in zip(dst, (row[m].astype(np.int64)
                                  for row, m in zip(idx, ok)))]
    return np.unique(np.concatenate(flat)) if flat else np.empty(0, np.int64)


def class_work(R: int, idx: np.ndarray, dst: np.ndarray, itemsize: int = 4,
               src: np.ndarray | None = None,
               u_itemsize: int | None = None) -> tuple[float, float]:
    """(bytes, adds) that one class's placement must move and do on these
    maps: each valid child cell read once (``u_itemsize`` bytes, default
    ``itemsize``: 2 for bfloat16 updates), each parent cell it reaches read
    and written once (``itemsize`` bytes), the int32 maps read once."""
    cells = float(((idx >= 0).sum(1).astype(np.int64) ** 2).sum())
    maps = idx.size + dst.size + (0 if src is None else src.size)
    u = itemsize if u_itemsize is None else u_itemsize
    return u * cells + 2.0 * itemsize * _touched(R, idx, dst).size \
        + 4.0 * maps, cells


def group_work(work: ExtendAddWork, itemsize: int = 4,
               u_itemsize: int | None = None) -> tuple[float, float]:
    """(bytes, adds) of one group's placement (host maps): as
    :func:`class_work`, a parent cell that several classes reach read and
    written once, the block list read once."""
    touched = np.unique(np.concatenate(
        [_touched(work.R, *class_maps(work, c)[:2])
         for c in range(len(work.keys))]))
    maps = work.idx.size + work.dst.size + work.src.size \
        + sum(blk.size for _c0, _c1, blk in work.parts)
    u = itemsize if u_itemsize is None else u_itemsize
    return u * work.cells + 2.0 * itemsize * touched.size + 4.0 * maps, \
        float(work.cells)


def extend_add_plain(F, U, idx, dst, src=None):
    """The reference's two-pass placement with ``index_add_``: child rows
    into per-pair (R, RU) blocks, then their columns into F (in place); a
    child of another dtype (bfloat16) is widened to F's first."""
    child = (U if src is None else U[src.long()]).to(F.dtype)
    B, R, _ = F.shape
    npairs, RU, _ = child.shape
    dev = F.device
    p = torch.arange(npairs, device=dev)[:, None]
    ix = idx.long()
    ok = ix >= 0
    rows = torch.zeros(npairs * R, RU, dtype=F.dtype, device=dev)
    rows.index_add_(0, (p * R + ix)[ok], child[ok])
    rows = rows.view(npairs, R, RU)
    flat = (dst.long()[:, None, None] * R + torch.arange(R, device=dev)
            [None, :, None]) * R + ix[:, None, :]
    keep = ok[:, None, :].expand(npairs, R, RU)
    F.view(-1).index_add_(0, flat[keep], rows[keep])
    return F


def extend_add_group_plain(F, Us, work: ExtendAddWork):
    """:func:`extend_add_plain` on each class of ``work`` in plan order,
    class c reading ``Us[c]`` (in place)."""
    for c, U in enumerate(Us):
        extend_add_plain(F, U, *class_maps(work, c))
    return F


def extend_add_library(Fbuf, U, idx, dst, R: int, src=None):
    """The same placement as one ``index_put_(accumulate=True)`` (a sort on
    CUDA) into the flat fronts Fbuf (B * R * R + 1,), in place. Cells with
    idx < 0 go to Fbuf's last element, a dump cell outside the fronts, so
    the scatter needs no mask compaction (and no device sync). A child of
    another dtype (bfloat16) is widened to Fbuf's first."""
    child = (U if src is None else U[src.long()]).to(Fbuf.dtype)
    dump = Fbuf.numel() - 1
    ix = idx.long()
    ok = ix >= 0
    ii = torch.where(ok, ix, 0)
    flat = dst.long()[:, None, None] * (R * R) + ii[:, :, None] * R \
        + ii[:, None, :]
    flat = torch.where(ok[:, :, None] & ok[:, None, :], flat, dump)
    Fbuf.index_put_((flat.reshape(-1),), child.reshape(-1), accumulate=True)
    return Fbuf


def _check_blocks(F, U, name: str) -> None:
    if F.device.type != "cuda" or (F.dtype, U.dtype) not in _INSTANCES \
            or U.device != F.device:
        raise ValueError(f"{name}: needs CUDA tensors on one device, F in "
                         f"fp32 or fp64 and U in F's dtype or bfloat16, got "
                         f"F {F.dtype} on {F.device}, U {U.dtype} on "
                         f"{U.device}")
    if F.dim() != 3 or U.dim() != 3 or F.shape[1] != F.shape[2] \
            or U.shape[1] != U.shape[2] or not F.is_contiguous() \
            or not U.is_contiguous():
        raise ValueError(f"{name}: F {tuple(F.shape)} and U "
                         f"{tuple(U.shape)} must be contiguous square "
                         f"blocks")


def _check_map(name: str, t, shape, F) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != F.device:
        raise ValueError(f"extend_add: {name} must be contiguous int32 "
                         f"{shape} on {F.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(F, Us, meta: np.ndarray, idx, dst, src, blocks, nblocks: int,
            geom: ExtendAddGeometry) -> None:
    """One launch of the kernel for the classes of ``meta`` (rows of
    (RU_c, first pair, npairs, first idx entry)), class c reading
    ``Us[c]`` (all of one dtype); ``blocks`` None: every (slot, band) of
    F."""
    lib = _build.load()
    ptrs = (ctypes.c_void_p * len(Us))(*[U.data_ptr() for U in Us])
    meta = np.ascontiguousarray(meta, np.int32)
    inst, counter = _INSTANCES[F.dtype, Us[0].dtype]
    B, R, _ = F.shape
    with torch.cuda.device(F.device):
        err = lib.sst_extend_add(
            F.data_ptr(), ctypes.addressof(ptrs), meta.ctypes.data, len(Us),
            idx.data_ptr(), dst.data_ptr(),
            None if src is None else src.data_ptr(),
            None if blocks is None else blocks.data_ptr(), nblocks, B, R,
            geom.rows, geom.warps, inst,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "extend_add")
    setattr(extend_add, counter, getattr(extend_add, counter) + 1)


def extend_add_group(F, Us, work: ExtendAddWork):
    """Every class of ``work`` placed into F (B, R, R), in plan order,
    class c reading its children out of ``Us[c]`` through the work's
    ``src``; in place, returns F.

    A CPU F takes :func:`extend_add_group_plain`; a CUDA F launches the
    kernel once a part of ``work`` (one launch for a group of up to
    MAX_CLASSES classes), or raises: F and each U contiguous, F fp32 or
    fp64 and every U of F's dtype or every U bfloat16, U c of (B_c, RU_c,
    RU_c), the work's maps uploaded to F's device (the src values are not
    checked)."""
    if len(Us) != len(work.keys):
        raise ValueError(f"extend_add_group: {len(Us)} update blocks for "
                         f"{len(work.keys)} classes")
    if F.device.type == "cpu":
        return extend_add_group_plain(F, Us, work)
    if tuple(F.shape) != (work.B, work.R, work.R):
        raise ValueError(f"extend_add_group: F {tuple(F.shape)} is not the "
                         f"work's ({work.B}, {work.R}, {work.R})")
    if len({U.dtype for U in Us}) > 1:
        raise ValueError(f"extend_add_group: the update blocks of one group "
                         f"must share a dtype, got {[U.dtype for U in Us]}")
    for U, (RU, *_rest) in zip(Us, work.meta):
        _check_blocks(F, U, "extend_add_group")
        if U.shape[1] != RU:
            raise ValueError(f"extend_add_group: U {tuple(U.shape)} for a "
                             f"class of RU {RU}")
    for name in ("idx", "dst", "src"):
        t = getattr(work, name)
        _check_map(name, t, tuple(t.shape), F)
    for c0, c1, blocks in work.parts:
        _check_map("blocks", blocks, tuple(blocks.shape), F)
        if blocks.numel():
            _launch(F, Us[c0:c1], work.meta[c0:c1], work.idx, work.dst,
                    work.src, blocks, blocks.numel(), work.geom)
    return F


def extend_add(F, U, idx, dst, src=None):
    """F[dst[p]] += P_p child_p P_p^T, in place; returns F.

    A CPU F takes :func:`extend_add_plain`; a CUDA F launches the kernel
    on a one-class work list, every (slot, band) of F a block, or raises:
    F and U contiguous, F fp32 or fp64 and U of F's dtype or bfloat16,
    idx (np, RU), dst (np,)
    and src (np,) contiguous int32 on F's device (the src values, which
    index U's first axis, are not checked; each map's valid rows come
    first, increasing, as the plan makes them)."""
    if F.device.type == "cpu":
        return extend_add_plain(F, U, idx, dst, src)
    _check_blocks(F, U, "extend_add")
    npairs = dst.shape[0] if dst.dim() == 1 else -1
    if src is None and U.shape[0] != npairs:
        raise ValueError(f"extend_add: U {tuple(U.shape)} must hold one "
                         f"child a pair unless src is given")
    B, R, _ = F.shape
    RU = U.shape[1]
    _check_map("idx", idx, (npairs, RU), F)
    _check_map("dst", dst, (npairs,), F)
    if src is not None:
        _check_map("src", src, (npairs,), F)
    if npairs == 0 or B == 0 or RU == 0:
        return F
    geom = extend_add_geometry(B, R)
    _launch(F, [U], np.array([[RU, 0, npairs, 0]], np.int32), idx, dst, src,
            None, B * geom.nbands, geom)
    return F


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {
    # fp32 instance, group and one-class launches
    "extend_add": (extend_add, "launches"),
    "extend_add_f64": (extend_add, "fp64_launches"),    # fp64 instance
    # fp32 fronts, bfloat16 updates
    "extend_add_bf16": (extend_add, "bf16_launches"),
    # fp64 fronts, bfloat16 updates
    "extend_add_f64_bf16": (extend_add, "f64_bf16_launches")}
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
