"""Extend-add placement of child update blocks (K7): CUDA kernel + plain
version.

Port of :mod:`suitesparse_tpu.kernels.extend_add`. For parent fronts
F (B, R, R), child blocks (np, RU, RU) gathered in the order of ``dst``,
int32 row maps idx (np, RU) (-1 = no row) and int32 destination slots
dst (np,) sorted ascending:

    F[dst[p], idx[p, i], idx[p, j]] += child[p, i, j]   where both idx >= 0

Both versions update F IN PLACE and return it (the reference returns
F + the contribution). :func:`pad_pairs` (the reference's, copied) adds a
dummy pair for every slot without one, as the reference's contract asks;
the port's kernel needs no such cover. The JAX package wires this kernel
into nothing; the port's factor places these classes with ``_place``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["extend_add", "extend_add_plain", "pad_pairs"]


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


def extend_add_plain(F, child, idx, dst):
    """The reference's two-pass placement with ``index_add_``: child rows
    into per-pair (R, RU) blocks, then their columns into F (in place)."""
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


def extend_add(F, child, idx, dst):
    """F[dst[p]] += P_p child[p] P_p^T, in place; returns F.

    A CPU F takes :func:`extend_add_plain`; a CUDA F launches the kernel,
    one block per slot, or raises: F and child contiguous fp32, idx
    (np, RU) and dst (np,) contiguous int32 on F's device."""
    if F.device.type == "cpu":
        return extend_add_plain(F, child, idx, dst)
    if F.device.type != "cuda" or F.dtype != torch.float32 \
            or child.dtype != torch.float32 or child.device != F.device:
        raise ValueError(f"extend_add: needs fp32 CUDA tensors on one "
                         f"device, got F {F.dtype} on {F.device}, child "
                         f"{child.dtype} on {child.device}")
    B, R, R2 = F.shape
    npairs, RU, RU2 = child.shape
    if R != R2 or RU != RU2 or not F.is_contiguous() \
            or not child.is_contiguous():
        raise ValueError(f"extend_add: F {tuple(F.shape)} and child "
                         f"{tuple(child.shape)} must be contiguous square "
                         f"blocks")
    for name, t, shape in (("idx", idx, (npairs, RU)),
                           ("dst", dst, (npairs,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != F.device:
            raise ValueError(f"extend_add: {name} must be contiguous int32 "
                             f"{shape} on {F.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if npairs == 0 or B == 0 or RU == 0:
        return F
    lib = _build.load()
    with torch.cuda.device(F.device):
        err = lib.sst_extend_add(F.data_ptr(), child.data_ptr(),
                                 idx.data_ptr(), dst.data_ptr(), npairs, B, R,
                                 RU, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "extend_add")
    extend_add.launches += 1
    return F


extend_add.launches = 0
