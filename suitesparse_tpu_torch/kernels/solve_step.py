"""Fused per-group solve steps of the classic sweep (K3): CUDA kernels +
plain versions.

Port of :mod:`suitesparse_tpu.kernels.solve_step`. Per batch element, with
L11 (C, C) lower-triangular (identity on padding) and L21 (RU, C):

    forward   xc = L11^-1 y,  v = wb + L21 xc       (v goes to the parent)
    backward  xc = L11^-T (y - L21^T xb)

``solve_step_fwd`` / ``solve_step_bwd`` run ``csrc/solve_step.cu`` on CUDA
tensors and the ``_plain`` versions on CPU tensors. L21 and wb / xb may
have any batch stride (views into the packed factor and the sweep's
buffers) as long as their rows are contiguous; L11 and y are contiguous.
:func:`solve_step_geometry` plans the kernels' launch (elements a block,
warps an element, parts of RU, rows staged at once) in Python, so that the
CPU tests can check it; the kernels check what they are given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .trisolve import (MAX_C, SMEM_BYTES, SMS, WIDE, _odd_stride,
                       batched_trisolve_plain)

__all__ = ["COUNTERS", "SolveStepGeometry", "solve_step_fwd",
           "solve_step_bwd", "solve_step_fwd_plain", "solve_step_bwd_plain",
           "solve_step_geometry", "step_fits"]

CHUNK = 64     # L21 rows of step_fits's shared-memory rule
MAX_WARPS = 8       # warps of a block (csrc/solve_step.cu)
MAX_SPLIT = 8       # blocks of a backward cluster the plan takes (portable)
MAX_FORCED_SPLIT = 16   # the most a forced backward split may take
CHUNK_ROWS = 128    # L21 rows a block stages at once, at most
# warps an element takes at least below 4 right-hand sides: more threads
# stage its rows and share its product (``step_sweep``: 10-20% faster than
# one warp at NR 1)
MIN_WARPS = 4
MAX_TPB = 4         # elements a block packs, at most (8 was slower at NR 1)
MIN_ROWS = 32       # rows of RU a part keeps at least
# warps a grid should have, where RU allows: 8 a SM (``step_sweep``: more
# parts than that lost at NR 64, where a block has 8 warps)
FILL_WARPS = MAX_WARPS * SMS


def step_fits(C: int, RU: int, NR: int) -> bool:
    """True iff both kernels take the shape: the classic sweep's gate for
    K3 (``classic_route``), kept from the first form of the kernels (L11,
    the right-hand sides and a chunk of 64 L21 rows in one block's shared
    memory), so that the same groups take K3."""
    ld = _odd_stride(C)
    return 1 <= C <= MAX_C and RU >= 0 and NR >= 1 and \
        4 * (C * ld + C * NR + min(RU, CHUNK) * ld) <= SMEM_BYTES


class SolveStepGeometry(NamedTuple):
    """Launch plan of ``csrc/solve_step.cu``. Each element's RU rows are
    cut into ``split`` parts of ``prow`` rows (backward: the blocks of a
    thread-block cluster when ``split`` > 1), staged ``crow`` rows at a
    time; a block holds ``tpb`` elements (teams) of ``lanes`` threads:
    ``wpt`` warps, or at NR 1 and C <= 16 a segment of 8 or 16 lanes of a
    warp (``wpt`` = 1); the NR columns are ``chunks`` chunks of ``cpw``,
    taken ``wpt`` chunks (a slab) at a time, warp w solving chunk w of the
    slab (``rpl`` rows a lane). ``smem`` bytes of shared memory a block,
    ``blocks`` blocks of ``threads`` threads."""
    tpb: int
    wpt: int
    lanes: int
    cpw: int
    chunks: int
    split: int
    prow: int
    crow: int
    rpl: int
    smem: int
    blocks: int
    threads: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r4(n: int) -> int:
    return _cdiv(n, 4) * 4


def fwd_rows(cpw: int) -> int:
    """Rows of v a thread owns in the forward product (``kPR``)."""
    return 2 if cpw >= 4 else 4


def chunk_stride(C: int) -> int:
    """Row stride of staged L21 rows (``chunk_stride`` in the kernel): whole
    16-byte words, an odd number of them."""
    return 4 * ((_r4(C) // 4 + 1) | 1)


def slab_stride(NR: int, wpt: int, cpw: int) -> int:
    """Columns of a slab in shared memory (``slab_stride``)."""
    return _r4(min(_cdiv(NR, cpw), wpt) * cpw)


def _smem(C: int, NR: int, tpb: int, wpt: int, cpw: int, split: int,
          crow: int, bwd: bool) -> int:
    """Bytes, as ``Layout`` in csrc/solve_step.cu: publish rows, pivot
    reciprocals, L11 tiles, the slabs of xc or of the partial sum, backward
    rank 0's reduced slab (in a cluster) or each team's slab of y, the
    staged L21 rows and the staged rows of wb or xb."""
    XS = slab_stride(NR, wpt, cpw)
    pub = 2 * cpw if cpw >= 4 else 0
    floats = (tpb * wpt * pub + _r4(tpb * wpt * C)
              + _r4(tpb * C * _odd_stride(C)) + tpb * C * XS
              + ((1 if split > 1 else tpb) * C * XS if bwd else 0)
              + tpb * crow * (chunk_stride(C) + XS))
    return 4 * floats


@functools.lru_cache(maxsize=1024)
def solve_step_geometry(B: int, C: int, RU: int, NR: int, transpose: bool,
                        split: int | None = None, wpt: int | None = None,
                        tpb: int | None = None,
                        lanes: int | None = None) -> SolveStepGeometry:
    """The kernels' launch plan for a group (B, C, RU) at NR right-hand
    sides, forward or backward (``transpose``). Raises ``ValueError`` where
    :func:`step_fits` is false. ``split``, ``wpt`` and ``tpb`` force a
    choice in place of the rules below (``step_sweep``); ``lanes`` = 32
    keeps whole-warp elements where the rules would segment warps.

    Rules: a warp holds one column below 4 right-hand sides, WIDE from 4 on;
    an element takes a warp for each chunk of its slab (at most MAX_WARPS),
    and below 4 right-hand sides at least MIN_WARPS, halved while B times
    that exceeds 1.5 FILL_WARPS; RU is cut into parts of at least MIN_ROWS
    rows until the grid has FILL_WARPS such warps (backward: at most a
    cluster of MAX_SPLIT); a part takes more warps where its product has
    more than 32 tiles a warp; up to MAX_TPB elements are packed into a
    block while the grid keeps FILL_WARPS warps; a part stages at most
    CHUNK_ROWS rows at once, fewer where shared memory runs out. At NR 1,
    RU <= C <= 16 and one warp an element, one part in one chunk, an
    element takes a segment of 8 (C <= 8) or 16 lanes instead, one warp of
    them a block: a warp then solves 4 or 2 elements at once (at RU = 16 >
    C whole warps were faster, ``step_sweep``)."""
    if not step_fits(C, RU, NR):
        raise ValueError(f"solve_step_geometry: (C, RU, NR) = ({C}, {RU}, "
                         f"{NR}) is not taken by the kernels")
    cpw = 1 if NR < 4 else WIDE
    chunks = _cdiv(NR, cpw)
    nch = min(chunks, MAX_WARPS)
    B1 = max(B, 1)
    # warps an element, before its product asks for more: MIN_WARPS below
    # 4 right-hand sides, halved while the elements alone overfill the card
    w0 = max(nch, MIN_WARPS if cpw == 1 else 1)
    while w0 > nch and B1 * w0 > FILL_WARPS * 3 // 2:
        w0 //= 2
    if RU == 0:
        split, prow = 1, 0
    else:
        if split is None:
            split = min(max(1, FILL_WARPS // (B1 * w0)),
                        _cdiv(RU, MIN_ROWS), MAX_SPLIT if transpose else RU)
        split = max(1, min(split, RU,
                           MAX_FORCED_SPLIT if transpose else RU))
        prow = _cdiv(RU, split)
        split = _cdiv(RU, prow)
    rows = min(prow, CHUNK_ROWS)
    tiles = (_cdiv(C, 4) if transpose else _cdiv(rows, fwd_rows(cpw))) * nch
    if wpt is None:
        wpt = max(w0, min(MAX_WARPS, _cdiv(tiles, 32)))
    wpt = max(1, min(wpt, MAX_WARPS))
    forced_tpb = tpb is not None
    if tpb is None:
        tpb = max(1, min(MAX_WARPS // wpt, MAX_TPB,
                         B1 * wpt // FILL_WARPS)) if split == 1 else 1
    if tpb < 1 or tpb * wpt > MAX_WARPS or (split > 1 and tpb > 1):
        raise ValueError(f"solve_step_geometry: {tpb} elements of {wpt} "
                         f"warps a block, split {split}, are not a plan")

    def smem(tpb, crow):
        return _smem(C, NR, tpb, wpt, cpw, split, crow, transpose)

    crow = rows
    while crow > 1 and smem(tpb, crow) > SMEM_BYTES:
        crow -= 1
    while not forced_tpb and tpb > 1 and smem(tpb, crow) > SMEM_BYTES:
        tpb -= 1
    if smem(tpb, crow) > SMEM_BYTES:
        raise ValueError(f"solve_step_geometry: no plan fits at {tpb} "
                         f"elements of {wpt} warps a block")
    seg = NR == 1 and RU <= C <= 16 and wpt == 1 and split == 1
    if lanes is None:
        lanes = (8 if C <= 8 else 16) if seg and not forced_tpb else 32
    if lanes < 32:
        if not (NR == 1 and C <= lanes and wpt == 1 and split == 1 and
                crow >= RU) or lanes not in (8, 16):
            raise ValueError(f"solve_step_geometry: segments of {lanes} "
                             f"lanes do not take this plan")
        if not forced_tpb:   # one warp
            tpb = 32 // lanes
        if tpb * lanes % 32 or tpb * lanes > 32 * MAX_WARPS or \
                smem(tpb, crow) > SMEM_BYTES:
            raise ValueError(f"solve_step_geometry: {tpb} segments of "
                             f"{lanes} lanes are not a block")
    elif lanes != 32:
        raise ValueError("solve_step_geometry: lanes must be 8, 16 or 32")
    else:
        lanes = 32 * wpt
    return SolveStepGeometry(tpb, wpt, lanes, cpw, chunks, split, prow, crow,
                             _cdiv(C, 32), smem(tpb, crow),
                             _cdiv(B, tpb) * split, tpb * lanes)


def solve_step_fwd_plain(L11, L21, Y, WB):
    """(xc, v) by the kernel's order: the forward column loop, then
    v = wb + sum_k L21[:, k] xc[k]. v is None when RU = 0."""
    xc = batched_trisolve_plain(L11, Y)
    if L21.shape[1] == 0:
        return xc, None
    v = WB.clone()
    for k in range(L11.shape[1]):
        v += L21[:, :, k, None] * xc[:, k, None, :]
    return xc, v


def solve_step_bwd_plain(L11, L21, Y, XB):
    """xc = L11^-T (y - L21^T xb); the sum over RU as one batched product."""
    if L21.shape[1]:
        Y = torch.baddbmm(Y, L21.mT, XB, alpha=-1)
    return batched_trisolve_plain(L11, Y, transpose=True)


def _check(name, L11, L21, Y, V):
    """Shapes (B, C, RU, NR) of a CUDA call, or raise."""
    B, C, C2 = L11.shape
    tensors = (L11, L21, Y, V)
    if any(t.device != L11.device or t.dtype != torch.float32
           for t in tensors) or L11.device.type != "cuda":
        raise ValueError(f"{name}: needs fp32 CUDA tensors on one device, "
                         f"got {[(t.dtype, str(t.device)) for t in tensors]}")
    RU, NR = L21.shape[1], Y.shape[2]
    if C != C2 or tuple(L21.shape) != (B, RU, C) or \
            tuple(Y.shape) != (B, C, NR) or tuple(V.shape) != (B, RU, NR):
        raise ValueError(f"{name}: shapes L11 {tuple(L11.shape)}, L21 "
                         f"{tuple(L21.shape)}, Y {tuple(Y.shape)}, "
                         f"{tuple(V.shape)} do not match")
    if not L11.is_contiguous() or not Y.is_contiguous() or (RU and (
            L21.stride()[1:] != (C, 1) or V.stride()[1:] != (NR, 1))):
        raise ValueError(f"{name}: L11 and Y must be contiguous, and the rows "
                         f"of L21 and of the (B, RU, NR) vectors")
    if not step_fits(C, RU, NR):
        raise ValueError(f"{name}: (C, RU, NR) = ({C}, {RU}, {NR}) does not "
                         f"fit in one block's shared memory")
    return B, C, RU, NR


def solve_step_fwd(L11, L21, Y, WB):
    """(xc, v) of one group's forward step: the CUDA kernel for CUDA
    tensors, :func:`solve_step_fwd_plain` for CPU tensors; raises on what
    the kernel does not take. v is None when RU = 0."""
    if L11.device.type == "cpu":
        return solve_step_fwd_plain(L11, L21, Y, WB)
    B, C, RU, NR = _check("solve_step_fwd", L11, L21, Y, WB)
    xc = torch.empty_like(Y)
    v = torch.empty(B, RU, NR, dtype=Y.dtype, device=Y.device) if RU else None
    if B == 0:
        return xc, v
    _launch_fwd(L11, L21, Y, WB, xc, v,
                solve_step_geometry(B, C, RU, NR, False))
    solve_step_fwd.launches += 1
    return xc, v


def solve_step_bwd(L11, L21, Y, XB):
    """xc of one group's backward step: the CUDA kernel for CUDA tensors,
    :func:`solve_step_bwd_plain` for CPU tensors; raises on what the kernel
    does not take."""
    if L11.device.type == "cpu":
        return solve_step_bwd_plain(L11, L21, Y, XB)
    B, C, RU, NR = _check("solve_step_bwd", L11, L21, Y, XB)
    xc = torch.empty_like(Y)
    if B == 0:
        return xc
    _launch_bwd(L11, L21, Y, XB, xc,
                solve_step_geometry(B, C, RU, NR, True))
    solve_step_bwd.launches += 1
    return xc


def _plan_args(g: SolveStepGeometry) -> tuple:
    return (g.tpb, g.wpt, g.lanes, g.cpw, g.chunks, g.split, g.prow, g.crow,
            g.smem)


def _launch_fwd(L11, L21, Y, WB, xc, v, g: SolveStepGeometry) -> None:
    """Launch the forward kernel on checked tensors with launch plan g."""
    B, C, _ = L11.shape
    RU, NR = L21.shape[1], Y.shape[2]
    lib = _build.load()
    with torch.cuda.device(L11.device):
        err = lib.sst_solve_step_fwd(
            L11.data_ptr(), L21.data_ptr(), L21.stride(0), Y.data_ptr(),
            WB.data_ptr(), WB.stride(0), xc.data_ptr(),
            v.data_ptr() if RU else None, B, C, RU, NR, *_plan_args(g),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "solve_step_fwd")


def _launch_bwd(L11, L21, Y, XB, xc, g: SolveStepGeometry) -> None:
    """Launch the backward kernel on checked tensors with launch plan g."""
    B, C, _ = L11.shape
    RU, NR = L21.shape[1], Y.shape[2]
    lib = _build.load()
    with torch.cuda.device(L11.device):
        err = lib.sst_solve_step_bwd(
            L11.data_ptr(), L21.data_ptr(), L21.stride(0), Y.data_ptr(),
            XB.data_ptr(), XB.stride(0), xc.data_ptr(), B, C, RU, NR,
            *_plan_args(g), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "solve_step_bwd")


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {"solve_step_fwd": (solve_step_fwd, "launches"),
            "solve_step_bwd": (solve_step_bwd, "launches")}
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
