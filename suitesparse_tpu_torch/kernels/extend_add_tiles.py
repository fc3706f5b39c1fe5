"""Tiled multifrontal extend-add: CUDA kernel + plain version.

Port of the one-piece form of :mod:`suitesparse_tpu.kernels.extend_add_tiles`.
The manifest is the reference's own (``build_group_manifest``, 10 columns):

    0 slot  1 tr  2 tc  3 init  4 has_piece  5 uslot  6 blkr  7 blkr2
    8 blkc  9 blkc2

Each step adds one child update ("piece") into one lower 128 x 128 tile
(slot, tr, tc) of the parent fronts F: tile row i takes Ucat row
``(rm[i] < 128 ? blkr : blkr2) * 128 + rm[i] % 128`` of child slot ``uslot``,
columns likewise; -1 in a map means no entry, and a non-finite child cell
counts as zero. Steps of one tile are consecutive; ``run_ptr`` holds the
first step of each tile's run (``man[:, 3] == 1``) and, last, the step count.
F is updated IN PLACE: unvisited tiles keep their content, which replaces
the TPU kernel's input/output aliasing.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["TILE", "run_ptr", "extend_add_tiles", "extend_add_tiles_plain"]

TILE = 128
_PLAIN_CHUNK = 512     # manifest steps per gather in the plain version


def run_ptr(man: np.ndarray) -> np.ndarray:
    """CSR offsets of the tile runs of a one-piece manifest (int32)."""
    starts = np.flatnonzero(man[:, 3] == 1)
    return np.concatenate([starts, [man.shape[0]]]).astype(np.int32)


def _child_index(v, blk, blk2):
    return torch.where(v < TILE, blk, blk2) * TILE + v % TILE


def extend_add_tiles_plain(F, Ucat, man, rowmap, colmap):
    """The manifest's extend-add with index tensors (in place; returns F)."""
    B, R, _ = F.shape
    RUp = Ucat.shape[1]
    Ff = F.view(-1)
    Uf = Ucat.reshape(-1)
    ar = torch.arange(TILE, device=F.device)
    for s0 in range(0, man.shape[0], _PLAIN_CHUNK):
        m = man[s0:s0 + _PLAIN_CHUNK].long()
        rm = rowmap[s0:s0 + _PLAIN_CHUNK, 0].long()
        cm = colmap[s0:s0 + _PLAIN_CHUNK, 0].long()
        crow = _child_index(rm, m[:, 6:7], m[:, 7:8])
        ccol = _child_index(cm, m[:, 8:9], m[:, 9:10])
        prow = m[:, 1:2] * TILE + ar
        pcol = m[:, 2:3] * TILE + ar
        rv = (rm >= 0) & (prow < R)
        cv = (cm >= 0) & (pcol < R)
        valid = (rv[:, :, None] & cv[:, None, :]
                 & (m[:, 4] == 1)[:, None, None])
        uidx = ((m[:, 5, None, None] * RUp + crow[:, :, None]) * RUp
                + ccol[:, None, :])
        v = Uf[torch.where(valid, uidx, 0)]
        v = torch.where(valid & torch.isfinite(v), v, 0)
        fidx = ((m[:, 0, None, None] * R + prow[:, :, None]) * R
                + pcol[:, None, :])
        Ff.index_put_((fidx[valid],), v[valid], accumulate=True)
    return F


def extend_add_tiles(F, Ucat, man, rowmap, colmap, runs):
    """F (B, R, R) += the manifest's pieces of Ucat (K, RUp, RUp), in place.

    ``man`` (NS, 10), ``rowmap``/``colmap`` (NS, 1, 128) and ``runs`` (the
    :func:`run_ptr` offsets) are int32 tensors on F's device. A CPU F takes
    :func:`extend_add_tiles_plain`; a CUDA F launches the kernel, one block
    per visited tile, or raises."""
    if F.device.type == "cpu":
        return extend_add_tiles_plain(F, Ucat, man, rowmap, colmap)
    NS = man.shape[0]
    B, R, R2 = F.shape
    K, RUp, RUp2 = Ucat.shape
    if F.device.type != "cuda" or F.dtype != torch.float32 \
            or Ucat.dtype != torch.float32:
        raise ValueError(f"extend_add_tiles: needs fp32 CUDA tensors, got F "
                         f"{F.dtype} on {F.device}, Ucat {Ucat.dtype}")
    if R != R2 or RUp != RUp2 or RUp % TILE or not F.is_contiguous() \
            or not Ucat.is_contiguous():
        raise ValueError(f"extend_add_tiles: F {tuple(F.shape)} and Ucat "
                         f"{tuple(Ucat.shape)} must be contiguous square "
                         f"blocks, RUp a multiple of {TILE}")
    for name, t, shape in (("man", man, (NS, 10)),
                           ("rowmap", rowmap, (NS, 1, TILE)),
                           ("colmap", colmap, (NS, 1, TILE))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != F.device:
            raise ValueError(f"extend_add_tiles: {name} must be contiguous "
                             f"int32 {shape} on {F.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if runs.dtype != torch.int32 or runs.dim() != 1 or runs.device != F.device:
        raise ValueError("extend_add_tiles: runs must be int32 (NR+1,) on "
                         f"{F.device}")
    nruns = runs.shape[0] - 1
    if nruns <= 0:
        return F
    lib = _build.load()
    with torch.cuda.device(F.device):
        err = lib.sst_extend_add_tiles(
            F.data_ptr(), Ucat.data_ptr(), man.data_ptr(), rowmap.data_ptr(),
            colmap.data_ptr(), runs.data_ptr(), nruns, R, RUp,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "extend_add_tiles")
    extend_add_tiles.launches += 1
    return F


extend_add_tiles.launches = 0
