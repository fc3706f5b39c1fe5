"""Tiled multifrontal extend-add: CUDA kernels + plain version.

Port of :mod:`suitesparse_tpu.kernels.extend_add_tiles`, both forms. The
manifest (``build_group_manifest``, the reference's host code, copied)
has one piece per step (10 columns):

    0 slot  1 tr  2 tc  3 init  4 has_piece  5 uslot  6 blkr  7 blkr2
    8 blkc  9 blkc2

or, with ``npiece=2`` (``_pair_manifest``), two pieces per step
(14 columns):

    0 slot  1 tr  2 tc  3 init
    4 u0  5 br0  6 br20  7 bc0  8 bc20   9 u1  10 br1  11 br21  12 bc1  13 bc21

where a dead second piece has all-(-1) maps. Each piece adds one child
update into one lower T x T tile (slot, tr, tc) of the parent fronts F:
tile row i takes Ucat row ``(rm[i] < T ? blkr : blkr2) * T + rm[i] % T`` of
child slot ``uslot``, columns likewise; -1 in a map means no entry, and a
non-finite child cell counts as zero. The tile width T is the maps' last
dimension: 128, or 256 for the groups ``build_plan(..., tile_big=)`` gives
wide tiles (the reference's ``SSTPU_TILE_BIG``). Steps of one tile are consecutive;
``run_ptr`` holds the first step of each tile's run (``man[:, 3] == 1``)
and, last, the step count. F is updated IN PLACE: unvisited tiles keep
their content, which replaces the TPU kernel's input/output aliasing.

:func:`tile_geometry` plans the kernel's launch (row slabs a tile, rows a
warp) in Python, so that the CPU tests can check it; the kernel's entry
points check what they are given. :func:`synthetic_group` makes manifests
off the plans for checks and sweeps.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .trisolve import SMEM_BYTES, SMS

__all__ = ["COUNTERS", "TILE", "TILES", "TileGeometry", "TileManifest",
           "build_group_manifest", "manifest_work", "run_ptr",
           "synthetic_group", "tile_geometry", "extend_add_tiles",
           "extend_add_tiles_plain"]

TILE = 128
TILES = (128, 256)     # tile widths the kernel is built for
_PLAIN_CHUNK = 512     # manifest steps per gather in the plain version
LANES = 32
WARPS = 4              # warps of a block (kWarps in the kernel)
SPLITS = (4, 8, 16)    # row slabs a 128-wide tile: 8, 4 or 2 rows a warp
WIDE_SPLITS = (8, 16, 32)   # row slabs a 256-wide tile: 8, 4 or 2 rows a
#                             warp, whose 8 x 8 sums stay in registers
_SPLITS = {128: SPLITS, 256: WIDE_SPLITS}
# blocks a grid should have, where the tiles allow: 8 an SM (32 warps);
# ``tile_sweep`` on the H100 puts the split this picks within 10% of the
# best one on every manifest of the model plan (PERF.md)
FILL_BLOCKS = 8 * SMS


class TileGeometry(NamedTuple):
    """Launch plan of ``csrc/extend_add_tiles.cu``: each tile's T rows
    are cut into ``split`` slabs, one a block of ``warps`` warps, and each
    warp takes ``rows`` neighbouring rows (slab ``b``'s warp ``w`` starts
    at tile row ``(b * warps + w) * rows``). ``vec``: the plan allows
    16-byte F traffic (R % 4 == 0; the wrapper also needs F 16-byte
    aligned). ``smem`` bytes of shared memory a block (the warps' rows of
    F); ``blocks`` blocks of ``threads`` threads; ``T`` the tile width."""
    split: int
    rows: int
    warps: int
    vec: int
    smem: int
    blocks: int
    threads: int
    T: int = TILE


@functools.lru_cache(maxsize=1024)
def tile_geometry(nruns: int, R: int, RUp: int, npiece: int,
                  split: int | None = None, T: int = TILE) -> TileGeometry:
    """The kernel's launch plan for ``nruns`` tile runs of fronts of R rows
    and child blocks of RUp, ``npiece`` pieces a step, tiles T wide (128 or
    256; RUp a multiple of T). Cached: the factor asks for the same
    manifests on every call.

    The least split of the width's splits (SPLITS at 128, WIDE_SPLITS at
    256: 8, 4 or 2 rows a warp either way) that gives the grid FILL_BLOCKS
    blocks (the largest where none does): a warp's rows share its pieces'
    maps, so fewer, longer slabs read fewer maps, and more slabs put a
    small manifest's tiles on more SMs. The kernel walks a two-piece step
    as two pieces, so ``npiece`` and ``RUp`` are checked but do not move
    the plan. ``split`` asks for that many slabs instead (``tile_sweep``)."""
    if T not in TILES:
        raise ValueError(f"tile_geometry: tile width {T} not in {TILES}")
    if npiece not in (1, 2) or RUp < T or RUp % T:
        raise ValueError(f"tile_geometry: npiece {npiece} must be 1 or 2 and "
                         f"RUp {RUp} a multiple of {T}")
    splits = _SPLITS[T]
    if split is None:
        split = next((s for s in splits if nruns * s >= FILL_BLOCKS),
                     splits[-1])
    elif split not in splits:
        raise ValueError(f"tile_geometry: split {split} not in {splits}")
    rows = T // (WARPS * split)
    smem = 4 * WARPS * rows * T
    assert smem <= SMEM_BYTES, (nruns, R, RUp, npiece, split, T)
    return TileGeometry(split, rows, WARPS, int(R % 4 == 0), smem,
                        nruns * split, WARPS * LANES, T)


@dataclasses.dataclass
class TileManifest:
    man: np.ndarray        # (NS, 10 or 14) int32 step table (columns above)
    rowmap: np.ndarray     # (NS, npiece, T) int32 in-window row map, -1 none
    colmap: np.ndarray     # (NS, npiece, T) int32
    RUp: int               # Ucat padded child size (multiple of T)
    nslots: int            # Ucat slots (total folded pairs)
    uslices: list          # [(class_i, k0, (src_level, src_gi), RU_c, src)]
    folded: list           # class indices handled by the kernel


def _class_tiles(iv: np.ndarray, T: int):
    """Touched front tiles and child ranges for one sorted coord row."""
    tiles = np.unique(iv // T)
    bounds = np.searchsorted(iv, np.stack([tiles * T, tiles * T + T],
                                          axis=1).ravel()).reshape(-1, 2)
    return tiles, bounds


def build_group_manifest(g, T: int = TILE, ru_min_frac: float = 0.5,
                         npiece: int = 1):
    """The tile manifest of one GroupPlan, or None if no class folds;
    ``npiece=2`` merges consecutive same-tile pieces into two-piece steps
    (:func:`_pair_manifest`).

    A pair class folds iff RU_c >= ru_min_frac * RUp or RU_c >= 2T
    (zero-padding every child to the largest folded size must not
    dominate); the other classes keep their direct placement. Child row
    maps are monotone, so the child rows landing in one T x T parent tile
    span at most two T-aligned child blocks (blkr, blkr2). Only lower tiles
    (tr >= tc) are listed; tiles with no piece are never visited."""
    R = g.R
    if not g.pairs:
        return None
    RUmax = max(pc.RU_c for pc in g.pairs)
    RUp = -(-RUmax // T) * T
    folded = [i for i, pc in enumerate(g.pairs)
              if pc.RU_c >= ru_min_frac * RUp or pc.RU_c >= 2 * T]
    if not folded:
        return None
    nbr = RUp // T
    nrt = -(-R // T)

    piece_by_tile: dict = {}
    uslices = []
    k0 = 0
    for ci in folded:
        pc = g.pairs[ci]
        src, dst, idx = g._pair_arrays[ci]
        uslices.append((ci, k0, (pc.src_level, pc.src_gi), pc.RU_c, src))
        for p in range(dst.size):
            iv = idx[p][idx[p] >= 0]
            if iv.size == 0:
                k0 += 1
                continue
            uslot = k0
            k0 += 1
            tiles, bounds = _class_tiles(iv, T)
            rms = {}
            for t, (a0, a1) in zip(tiles, bounds):
                blkr = a0 // T
                rm = np.full(T, -1, np.int32)
                rm[iv[a0:a1] - t * T] = np.arange(a0, a1) - blkr * T
                rms[int(t)] = (int(blkr), int(min(blkr + 1, nbr - 1)), rm)
            d = int(dst[p])
            for tr in tiles:
                br, br2, rm = rms[int(tr)]
                for tc in tiles[tiles <= tr]:
                    bc, bc2, cm = rms[int(tc)]
                    piece_by_tile.setdefault((d, int(tr), int(tc)), []) \
                        .append((uslot, br, br2, bc, bc2, rm, cm))

    man, rmaps, cmaps = [], [], []
    for slot in range(g.B):
        for tr in range(nrt):
            for tc in range(tr + 1):
                ps = piece_by_tile.get((slot, tr, tc), ())
                for i, (u, br, br2, bc, bc2, rm, cm) in enumerate(ps):
                    man.append([slot, tr, tc, 1 if i == 0 else 0, 1,
                                u, br, br2, bc, bc2])
                    rmaps.append(rm)
                    cmaps.append(cm)
    if not man:
        return None
    if npiece == 2:
        return _pair_manifest(man, rmaps, cmaps, T, RUp, k0, uslices, folded)
    return TileManifest(man=np.asarray(man, np.int32),
                        rowmap=np.stack(rmaps)[:, None, :],
                        colmap=np.stack(cmaps)[:, None, :],
                        RUp=RUp, nslots=k0, uslices=uslices, folded=folded)


def _pair_manifest(man, rmaps, cmaps, T, RUp, k0, uslices, folded):
    """Merge consecutive same-tile pieces into two-piece steps (14 columns,
    maps (NS, 2, T)); the second piece of an odd tail is dead: zero block
    coordinates and all-(-1) maps, so it adds nothing."""
    dead = np.full(T, -1, np.int32)
    man2, rm2, cm2 = [], [], []
    i = 0
    while i < len(man):
        a = man[i]
        if i + 1 < len(man) and man[i + 1][:3] == a[:3]:
            b = man[i + 1]
            man2.append(a[:4] + a[5:] + b[5:])
            rm2.append(np.stack([rmaps[i], rmaps[i + 1]]))
            cm2.append(np.stack([cmaps[i], cmaps[i + 1]]))
            i += 2
        else:
            man2.append(a[:4] + a[5:] + [0, 0, 0, 0, 0])
            rm2.append(np.stack([rmaps[i], dead]))
            cm2.append(np.stack([cmaps[i], dead]))
            i += 1
    return TileManifest(man=np.asarray(man2, np.int32),
                        rowmap=np.stack(rm2), colmap=np.stack(cm2),
                        RUp=RUp, nslots=k0, uslices=uslices, folded=folded)


def synthetic_group(rng, B: int, R: int, classes):
    """A group of B fronts of R rows whose pair classes are random children,
    enough of a GroupPlan for :func:`build_group_manifest`: ``classes``
    lists (npairs, RU_c); each child lands in a random front on a random
    sorted set of RU_c of its R rows. Manifests off the plans (odd R, long
    runs, few tiles) for checks and sweeps."""
    pairs, arrays = [], []
    for ci, (npairs, RU) in enumerate(classes):
        pairs.append(types.SimpleNamespace(RU_c=RU, src_level=0, src_gi=ci))
        idx = np.stack([np.sort(rng.choice(R, RU, replace=False))
                        for _ in range(npairs)]).astype(np.int32)
        arrays.append((np.arange(npairs), rng.integers(0, B, npairs), idx))
    return types.SimpleNamespace(B=B, R=R, pairs=pairs, _pair_arrays=arrays)


def run_ptr(man: np.ndarray) -> np.ndarray:
    """CSR offsets of the tile runs of a manifest of either form (int32)."""
    starts = np.flatnonzero(man[:, 3] == 1)
    return np.concatenate([starts, [man.shape[0]]]).astype(np.int32)


def manifest_work(tm: TileManifest, runs: np.ndarray, R: int):
    """(bytes, additions) of a manifest's extend-add at the least: each
    piece reads its valid child cells and adds them once; each visited tile
    of F is read and written once; the step table and the maps are read
    once."""
    T = tm.rowmap.shape[-1]
    cells = float(((tm.rowmap >= 0).sum(2) * (tm.colmap >= 0).sum(2)).sum())
    starts = tm.man[runs[:-1]]
    tile_cells = float((np.minimum(T, R - starts[:, 1] * T)
                        * np.minimum(T, R - starts[:, 2] * T)).sum())
    return (4.0 * cells + 8.0 * tile_cells + 4.0 * tm.man.size
            + 4.0 * (tm.rowmap.size + tm.colmap.size), cells)


def _child_index(v, blk, blk2, T):
    return torch.where(v < T, blk, blk2) * T + v % T


def _one_piece(man, rowmap, colmap):
    """A two-piece manifest as one piece per row (10 columns; a dead piece
    keeps its all-(-1) maps and adds nothing)."""
    NS, T = man.shape[0], rowmap.shape[-1]
    head = torch.cat([man[:, :4], torch.ones_like(man[:, :1])], dim=1)
    pieces = [torch.cat([head, man[:, 4 + 5 * p:9 + 5 * p]], dim=1)
              for p in range(2)]
    return (torch.stack(pieces, dim=1).reshape(2 * NS, 10),
            rowmap.reshape(2 * NS, 1, T), colmap.reshape(2 * NS, 1, T))


def extend_add_tiles_plain(F, Ucat, man, rowmap, colmap):
    """The manifest's extend-add with index tensors, either form, tiles as
    wide as the maps' last dimension (in place; returns F)."""
    if man.shape[1] == 14:
        man, rowmap, colmap = _one_piece(man, rowmap, colmap)
    B, R, _ = F.shape
    RUp = Ucat.shape[1]
    T = rowmap.shape[-1]
    Ff = F.view(-1)
    Uf = Ucat.reshape(-1)
    ar = torch.arange(T, device=F.device)
    for s0 in range(0, man.shape[0], _PLAIN_CHUNK):
        m = man[s0:s0 + _PLAIN_CHUNK].long()
        rm = rowmap[s0:s0 + _PLAIN_CHUNK, 0].long()
        cm = colmap[s0:s0 + _PLAIN_CHUNK, 0].long()
        crow = _child_index(rm, m[:, 6:7], m[:, 7:8], T)
        ccol = _child_index(cm, m[:, 8:9], m[:, 9:10], T)
        prow = m[:, 1:2] * T + ar
        pcol = m[:, 2:3] * T + ar
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

    ``man`` (NS, 10) with ``rowmap``/``colmap`` (NS, 1, T), or ``man``
    (NS, 14) with maps (NS, 2, T), T = 128 or 256, and ``runs`` (the
    :func:`run_ptr` offsets) are int32 tensors on F's device. Maps of any
    other width raise. A CPU F takes :func:`extend_add_tiles_plain`; a CUDA
    F launches the one-piece or the two-piece kernel of width T with the
    launch plan :func:`tile_geometry` picks, or raises."""
    T = rowmap.shape[-1]
    if T not in TILES:
        raise ValueError(f"extend_add_tiles: maps of width {T}; the kernel "
                         f"takes tiles of {TILES}")
    if F.device.type == "cpu":
        return extend_add_tiles_plain(F, Ucat, man, rowmap, colmap)
    NS, ncols = man.shape
    B, R, R2 = F.shape
    K, RUp, RUp2 = Ucat.shape
    if F.device.type != "cuda" or F.dtype != torch.float32 \
            or Ucat.dtype != torch.float32:
        raise ValueError(f"extend_add_tiles: needs fp32 CUDA tensors, got F "
                         f"{F.dtype} on {F.device}, Ucat {Ucat.dtype}")
    if R != R2 or RUp != RUp2 or RUp % T or not F.is_contiguous() \
            or not Ucat.is_contiguous():
        raise ValueError(f"extend_add_tiles: F {tuple(F.shape)} and Ucat "
                         f"{tuple(Ucat.shape)} must be contiguous square "
                         f"blocks, RUp a multiple of {T}")
    if ncols not in (10, 14):
        raise ValueError(f"extend_add_tiles: man has {ncols} columns, not 10 "
                         f"(one piece a step) or 14 (two)")
    npiece = 1 if ncols == 10 else 2
    for name, t, shape in (("man", man, (NS, ncols)),
                           ("rowmap", rowmap, (NS, npiece, T)),
                           ("colmap", colmap, (NS, npiece, T))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != F.device:
            raise ValueError(f"extend_add_tiles: {name} must be contiguous "
                             f"int32 {shape} on {F.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if rowmap.data_ptr() % 16:
        raise ValueError("extend_add_tiles: rowmap must be 16-byte aligned "
                         "(its rows are read as 16-byte words)")
    if runs.dtype != torch.int32 or runs.dim() != 1 or runs.device != F.device:
        raise ValueError("extend_add_tiles: runs must be int32 (NR+1,) on "
                         f"{F.device}")
    nruns = runs.shape[0] - 1
    if nruns <= 0:
        return F
    _launch(F, Ucat, man, rowmap, colmap, runs,
            tile_geometry(nruns, R, RUp, npiece, T=T))
    counter = ("" if T == TILE else "wide_") + \
        ("launches" if npiece == 1 else "pair_launches")
    setattr(extend_add_tiles, counter, getattr(extend_add_tiles, counter) + 1)
    return F


def _launch(F, Ucat, man, rowmap, colmap, runs, g: TileGeometry) -> None:
    """Launch the one- or two-piece kernel of width ``g.T`` on checked
    tensors with launch plan ``g``; 16-byte F traffic where the plan allows it and F's base is
    16-byte aligned (then every row's is: R % 4 == 0)."""
    vec = int(bool(g.vec) and F.data_ptr() % 16 == 0)
    lib = _build.load()
    entry = lib.sst_extend_add_tiles if man.shape[1] == 10 \
        else lib.sst_extend_add_tiles_pair
    with torch.cuda.device(F.device):
        err = entry(F.data_ptr(), Ucat.data_ptr(), man.data_ptr(),
                    rowmap.data_ptr(), colmap.data_ptr(), runs.data_ptr(),
                    runs.shape[0] - 1, F.shape[1], Ucat.shape[1], g.T,
                    g.split, vec, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "extend_add_tiles")


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {
    # one-piece kernel (K2), T = 128
    "extend_add_tiles": (extend_add_tiles, "launches"),
    # two-piece kernel (K2b), T = 128
    "extend_add_tiles_pair": (extend_add_tiles, "pair_launches"),
    # K2 at T = 256
    "extend_add_tiles_wide": (extend_add_tiles, "wide_launches"),
    # K2b at T = 256
    "extend_add_tiles_pair_wide": (extend_add_tiles, "wide_pair_launches")}
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
