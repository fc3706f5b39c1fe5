"""Extend-add placement of child update blocks (K7): CUDA kernel + plain
version.

Port of :mod:`suitesparse_tpu.kernels.extend_add`. For parent fronts
F (B, R, R), child update blocks U, int32 row maps idx (np, RU) (-1 = no
row) and int32 destination slots dst (np,) sorted ascending:

    F[dst[p], idx[p, i], idx[p, j]] += child_p[i, j]   where both idx >= 0

child_p is U[src[p]] for an int32 ``src`` (np,): the factor passes the
source group's whole (B_c, RU, RU) update block. Without ``src``, U holds
the children in the order of ``dst`` and child_p is U[p]. fp32 and fp64.

Both versions update F IN PLACE and return it (the reference returns
F + the contribution). :func:`pad_pairs` (the reference's, copied) adds a
dummy pair for every slot without one, as the reference's contract asks;
the port's kernel needs no such cover. The JAX package wires this kernel
into nothing; the port's factor places every pair class that a tile
manifest does not fold with it. :func:`extend_add_library` computes the
same placement with one library scatter, the yardstick of the kernel's
measurements; no path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["class_work", "extend_add", "extend_add_library",
           "extend_add_plain", "pad_pairs"]

_FP64 = {torch.float32: 0, torch.float64: 1}


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


def class_work(R: int, idx: np.ndarray, dst: np.ndarray, itemsize: int = 4,
               src: np.ndarray | None = None) -> tuple[float, float]:
    """(bytes, adds) that one class's placement must move and do on these
    maps: each valid child cell read once, each parent cell it reaches read
    and written once, the int32 maps read once."""
    ok = idx >= 0
    cells = float((ok.sum(1).astype(np.int64) ** 2).sum())
    flat = [((int(d) * R + r[:, None]) * R + r[None, :]).ravel()
            for d, r in zip(dst, (row[m].astype(np.int64)
                                  for row, m in zip(idx, ok)))]
    touched = np.unique(np.concatenate(flat)).size if flat else 0
    maps = idx.size + dst.size + (0 if src is None else src.size)
    return itemsize * (cells + 2.0 * touched) + 4.0 * maps, cells


def extend_add_plain(F, U, idx, dst, src=None):
    """The reference's two-pass placement with ``index_add_``: child rows
    into per-pair (R, RU) blocks, then their columns into F (in place)."""
    child = U if src is None else U[src.long()]
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


def extend_add_library(Fbuf, U, idx, dst, R: int, src=None):
    """The same placement as one ``index_put_(accumulate=True)`` (a sort on
    CUDA) into the flat fronts Fbuf (B * R * R + 1,), in place. Cells with
    idx < 0 go to Fbuf's last element, a dump cell outside the fronts, so
    the scatter needs no mask compaction (and no device sync)."""
    child = U if src is None else U[src.long()]
    dump = Fbuf.numel() - 1
    ix = idx.long()
    ok = ix >= 0
    ii = torch.where(ok, ix, 0)
    flat = dst.long()[:, None, None] * (R * R) + ii[:, :, None] * R \
        + ii[:, None, :]
    flat = torch.where(ok[:, :, None] & ok[:, None, :], flat, dump)
    Fbuf.index_put_((flat.reshape(-1),), child.reshape(-1), accumulate=True)
    return Fbuf


def extend_add(F, U, idx, dst, src=None):
    """F[dst[p]] += P_p child_p P_p^T, in place; returns F.

    A CPU F takes :func:`extend_add_plain`; a CUDA F launches the kernel,
    one block per slot, or raises: F and U contiguous, both fp32 or both
    fp64, idx (np, RU), dst (np,) and src (np,) contiguous int32 on F's
    device (the src values, which index U's first axis, are not checked)."""
    if F.device.type == "cpu":
        return extend_add_plain(F, U, idx, dst, src)
    if F.device.type != "cuda" or F.dtype not in _FP64 \
            or U.dtype != F.dtype or U.device != F.device:
        raise ValueError(f"extend_add: needs fp32 or fp64 CUDA tensors of "
                         f"one dtype on one device, got F {F.dtype} on "
                         f"{F.device}, U {U.dtype} on {U.device}")
    npairs = dst.shape[0] if dst.dim() == 1 else -1
    if F.dim() != 3 or U.dim() != 3 or F.shape[1] != F.shape[2] \
            or U.shape[1] != U.shape[2] or not F.is_contiguous() \
            or not U.is_contiguous() \
            or (src is None and U.shape[0] != npairs):
        raise ValueError(f"extend_add: F {tuple(F.shape)} and U "
                         f"{tuple(U.shape)} must be contiguous square "
                         f"blocks, U one a pair unless src is given")
    B, R, _ = F.shape
    RU = U.shape[1]
    maps = [("idx", idx, (npairs, RU)), ("dst", dst, (npairs,))]
    if src is not None:
        maps.append(("src", src, (npairs,)))
    for name, t, shape in maps:
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != F.device:
            raise ValueError(f"extend_add: {name} must be contiguous int32 "
                             f"{shape} on {F.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if npairs == 0 or B == 0 or RU == 0:
        return F
    lib = _build.load()
    fp64 = _FP64[F.dtype]
    with torch.cuda.device(F.device):
        err = lib.sst_extend_add(
            F.data_ptr(), U.data_ptr(), idx.data_ptr(), dst.data_ptr(),
            None if src is None else src.data_ptr(), npairs, B, R, RU, fp64,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "extend_add")
    if fp64:
        extend_add.fp64_launches += 1
    else:
        extend_add.launches += 1
    return F


extend_add.launches = 0         # fp32 instance
extend_add.fp64_launches = 0    # fp64 instance
