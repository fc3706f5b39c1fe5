"""Batched Cholesky panel factorization (potrf + trsm, K1): CUDA kernel +
plain.

Port of :mod:`suitesparse_tpu.kernels.potrf`. For B prepared tiles (F11
symmetric full with identity on padded rows/cols, F21 the subdiagonal panel)
both versions return L11 = chol(F11), zero above the diagonal, and
L21 = F21 L11^{-T}, by the TPU kernel's right-looking column loop with an
rsqrt pivot and no pivoting; a non-SPD tile gives non-finite values.

``potrf_trsm`` runs ``csrc/potrf_trsm.cu`` on a CUDA tensor and
``potrf_trsm_plain`` on a CPU tensor. Layout is batch-major (B, C, C) /
(B, RU, C), the port's natural layout; the TPU kernel's lane-major transpose
is not carried over. :func:`potrf_geometry` plans the kernel's launch (the
instance, tiles a warp, warps a tile, parts of RU, rows staged at once) in
Python, so that the CPU tests can check it; the kernel checks what it is
given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .trisolve import SMEM_BYTES, SMS

__all__ = ["COUNTERS", "MAX_C", "PotrfGeometry", "potrf_geometry",
           "potrf_trsm", "potrf_trsm_plain"]

MAX_C = 96   # the kernel keeps a C x C tile's columns in shared memory
# the kernel's instances: C is rounded up to one of these and masked
INSTANCES = (8, 16, 32, 48, 64, 96)
MAX_WARPS = 8       # warps of a block (csrc/potrf_trsm.cu)
SEG_WARPS = 4       # warps a block of segments takes at most
# teams a grid should have, where RU allows: segments (C <= 32) until the
# grid has 16 warps an SM, blocks (C > 32) until it has 4 blocks an SM
FILL_WARPS = 16 * SMS
FILL_BLOCKS = 4 * SMS


class PotrfGeometry(NamedTuple):
    """Launch plan of ``csrc/potrf_trsm.cu``. ``inst`` is the instance (C
    rounded up). Each tile's RU rows are cut into ``split`` parts of
    ``prow`` rows, one team each, staged ``crow`` rows at a time. For inst
    <= 32 a team is a segment of ``lanes`` lanes, ``tpw`` teams a warp,
    ``warps`` warps a block; for inst > 32 a team is a block of ``wpt``
    warps (``lanes`` = 32 wpt threads, ``tpw`` = 1), whose first
    ceil(inst / 32) warps factor L11. ``smem`` bytes of shared memory a
    block, ``blocks`` blocks of ``threads`` threads."""
    inst: int
    lanes: int
    tpw: int
    wpt: int
    split: int
    prow: int
    crow: int
    warps: int
    smem: int
    blocks: int
    threads: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r4(n: int) -> int:
    return _cdiv(n, 4) * 4


def row_stride(C: int) -> int:
    """Row stride of staged F21 rows (``row_stride`` in the kernel): whole
    16-byte words, an odd number of them."""
    return 4 * ((_r4(C) // 4) | 1)


def team_floats(inst: int, lanes: int, crow: int, C: int) -> int:
    """Floats of one team's shared memory, as ``team_floats`` in the
    kernel: L's columns (inst x inst), the pivots' rsqrt, for the rolled
    instances (inst > 48) a double-buffered unscaled column (2 inst), the
    staged rows; a segment's region starts ``lanes`` banks after the one
    before it."""
    n = (inst * inst + _r4(inst) + (2 * inst if inst > 48 else 0)
         + crow * row_stride(C))
    if lanes < 32:
        while n % 32 != lanes:
            n += 4
    return n


@functools.lru_cache(maxsize=1024)
def potrf_geometry(B: int, C: int, RU: int, split: int | None = None,
                   tpw: int | None = None,
                   wpt: int | None = None) -> PotrfGeometry:
    """The kernel's launch plan for B tiles of (C, RU). Raises
    ``ValueError`` where the kernel does not take the shape or a forced
    choice. ``split``, ``tpw`` and ``wpt`` force a choice in place of the
    rules below (``potrf_sweep``).

    Rules: the instance is the least of ``INSTANCES`` >= C. For C <= 32 a
    team is a segment of as many lanes (8, 16 or 32) as the instance, so a
    warp holds 4, 2 or 1 tiles; for C > 32 a team is a block of
    ceil(inst / 32) warps. RU is cut into parts of at least one row a
    thread of the team until the grid has FILL_WARPS warps (segments) or
    FILL_BLOCKS blocks. A block of segments takes up to SEG_WARPS warps
    while the grid keeps 4 blocks an SM. A part stages all its rows at
    once, fewer where shared memory runs out."""
    if not 1 <= C <= MAX_C or RU < 0 or B < 0:
        raise ValueError(f"potrf_geometry: (B, C, RU) = ({B}, {C}, {RU}) is "
                         f"not taken by the kernel (1 <= C <= {MAX_C})")
    inst = next(i for i in INSTANCES if i >= C)
    B1 = max(B, 1)
    if inst <= 32:
        if wpt not in (None, 1):
            raise ValueError("potrf_geometry: a segment team has one warp")
        wpt = 1
        if tpw is None:
            tpw = 32 // inst
        if tpw not in (1, 2, 4) or 32 // tpw < inst:
            raise ValueError(f"potrf_geometry: {tpw} tiles a warp do not "
                             f"hold C = {C}")
        lanes = 32 // tpw
        fill = FILL_WARPS * tpw
    else:
        if tpw not in (None, 1):
            raise ValueError("potrf_geometry: C > 32 takes one tile a team")
        tpw = 1
        fw = _cdiv(inst, 32)
        if wpt is None:
            wpt = fw
        if not fw <= wpt <= MAX_WARPS:
            raise ValueError(f"potrf_geometry: {wpt} warps a tile, C = {C} "
                             f"needs {fw} to {MAX_WARPS}")
        lanes = 32 * wpt
        fill = FILL_BLOCKS
    if RU == 0:
        if split not in (None, 1):
            raise ValueError("potrf_geometry: RU = 0 has one part")
        split, prow = 1, 0
    else:
        if split is None:
            split = min(_cdiv(RU, lanes), max(1, _cdiv(fill, B1)))
        if split < 1:
            raise ValueError(f"potrf_geometry: split {split}")
        prow = _cdiv(RU, min(split, RU))
        split = _cdiv(RU, prow)
    if inst <= 32:
        warps = max(1, min(SEG_WARPS, _cdiv(B1 * split, tpw) // (4 * SMS)))
        teams = warps * tpw
    else:
        warps, teams = wpt, 1

    def smem(crow):
        return 4 * teams * team_floats(inst, lanes, crow, C)

    crow = prow
    if smem(crow) > SMEM_BYTES:
        fixed = team_floats(inst, lanes, 0, C) + 32
        crow = max(1, (SMEM_BYTES // (4 * teams) - fixed) // row_stride(C))
        while crow > 1 and smem(crow) > SMEM_BYTES:
            crow -= 1
    if smem(crow) > SMEM_BYTES:
        raise ValueError(f"potrf_geometry: no plan fits at C = {C}")
    return PotrfGeometry(inst, lanes, tpw, wpt, split, prow, crow, warps,
                         smem(crow), _cdiv(B * split, teams), 32 * warps)


def potrf_trsm_plain(f11: torch.Tensor, f21: torch.Tensor | None = None):
    """The kernel's column loop in plain PyTorch (any device, any float)."""
    L = f11.clone()
    Y = None if f21 is None else f21.clone()
    C = L.shape[1]
    rows = torch.arange(C, device=L.device)
    zero = L.new_zeros(())
    for k in range(C):
        inv = torch.rsqrt(L[:, k, k])                       # (B,)
        colw = torch.where(rows >= k, L[:, :, k] * inv[:, None], zero)
        L[:, :, k] = colw
        collo = torch.where(rows > k, colw, zero)           # (B, C)
        L -= collo[:, :, None] * collo[:, None, :]
        if Y is not None and Y.shape[1] > 0:
            u = Y[:, :, k] * inv[:, None]                   # (B, RU)
            Y[:, :, k] = u
            Y -= u[:, :, None] * collo[:, None, :]
    return L, Y


def potrf_trsm(f11: torch.Tensor, f21: torch.Tensor | None = None):
    """(L11, L21) of B prepared tiles: the CUDA kernel for CUDA tensors.

    f11 (B, C, C) and f21 (B, RU, C) or None. A CPU tensor takes
    :func:`potrf_trsm_plain`; a CUDA tensor must be contiguous fp32 with
    C <= MAX_C, or this raises."""
    if f11.device.type == "cpu":
        return potrf_trsm_plain(f11, f21)
    B, C, C2 = f11.shape
    RU = 0 if f21 is None else f21.shape[1]
    if f11.device.type != "cuda" or f11.dtype != torch.float32:
        raise ValueError(f"potrf_trsm: needs fp32 CUDA tiles, got "
                         f"{f11.dtype} on {f11.device}")
    if C != C2 or not 1 <= C <= MAX_C or not f11.is_contiguous():
        raise ValueError(f"potrf_trsm: f11 must be contiguous (B, C, C) with "
                         f"C <= {MAX_C}, got {tuple(f11.shape)}")
    if f21 is not None and (f21.device != f11.device
                            or f21.dtype != torch.float32
                            or f21.shape != (B, RU, C)
                            or not f21.is_contiguous()):
        raise ValueError(f"potrf_trsm: f21 must be contiguous fp32 "
                         f"(B, RU, C) on {f11.device}, got "
                         f"{tuple(f21.shape)} {f21.dtype} on {f21.device}")
    L11 = torch.empty_like(f11)
    L21 = None if f21 is None else torch.empty_like(f21)
    if B == 0:
        return L11, L21
    _launch(f11, f21, L11, L21, potrf_geometry(B, C, RU))
    potrf_trsm.launches += 1
    return L11, L21


def _launch(f11, f21, L11, L21, g: PotrfGeometry) -> None:
    """Launch the kernel on checked tensors with launch plan g."""
    B, C, _ = f11.shape
    RU = 0 if f21 is None else f21.shape[1]
    lib = _build.load()
    with torch.cuda.device(f11.device):
        err = lib.sst_potrf_trsm(
            f11.data_ptr(), f21.data_ptr() if RU > 0 else None,
            L11.data_ptr(), L21.data_ptr() if RU > 0 else None,
            B, C, RU, g.inst, g.lanes, g.wpt, g.split, g.prow, g.crow,
            g.warps, g.smem, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "potrf_trsm")


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {"potrf_trsm": (potrf_trsm, "launches")}
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
