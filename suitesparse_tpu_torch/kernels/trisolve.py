"""Batched small triangular solve (K4): CUDA kernel + plain version.

Port of :mod:`suitesparse_tpu.kernels.trisolve`. For B lower-triangular
tiles L (B, C, C) with a nonzero diagonal (identity on padding) and
right-hand sides Y (B, C, NR), both versions return X = L^-1 Y, or
X = L^-T Y with ``transpose``, by the right-looking column loop: step k
takes x_k = X[k] / L[k, k] and subtracts L[i, k] x_k from the rows below
(transposed: L[k, i] x_k from the rows above). Both read L's lower triangle
and diagonal only.

``batched_trisolve`` runs ``csrc/trisolve.cu`` on a CUDA tensor and
``batched_trisolve_plain`` on a CPU tensor. Layout is batch-major; the TPU
kernel's lane-major transpose and batch padding are not carried over.
:func:`trisolve_geometry` plans the kernel's launch (tiles a block, warps a
tile, columns a warp holds in registers) in Python, so that the CPU tests
can check it; the kernel checks what it is given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["COUNTERS", "MAX_C", "SMEM_BYTES", "TrisolveGeometry",
           "batched_trisolve", "batched_trisolve_plain", "trisolve_fits",
           "trisolve_geometry"]

MAX_C = 96               # a lane holds at most 3 rows of 32
SMEM_BYTES = 232448      # shared memory one block can take on the H100
SMS = 132                # streaming multiprocessors of the H100
MAX_WARPS = 8            # warps of one block (csrc/trisolve.cu)
WIDE = 8                 # columns a warp holds when NR >= 4 (else 1)
FILL_BLOCKS = 2 * SMS    # blocks a grid should have, where the tiles allow


class TrisolveGeometry(NamedTuple):
    """Launch plan of ``csrc/trisolve.cu``. A block solves ``tpb`` tiles
    with ``wpt`` warps each; a tile's ``chunks`` column chunks of ``cpw``
    columns are spread over ``csplit`` blocks: warp w of the tile in block
    y holds chunk w + wpt y, then w + wpt (y + csplit), ... in registers
    (``rpl`` rows a lane). ``smem`` bytes of shared memory a block,
    ``blocks`` blocks of ``threads`` threads."""
    tpb: int
    wpt: int
    cpw: int
    chunks: int
    csplit: int
    rpl: int
    smem: int
    blocks: int
    threads: int


def _odd_stride(C: int) -> int:
    return C + 1 - (C & 1)


def _smem(C: int, tpb: int, wpt: int, cpw: int) -> int:
    """Bytes, as ``smem_bytes`` in csrc/trisolve.cu: each warp's two publish
    rows (cpw >= 4) and pivot reciprocals, then each tile."""
    pub = 2 * cpw if cpw >= 4 else 0
    return 4 * (tpb * wpt * (pub + C) + tpb * C * _odd_stride(C))


def trisolve_fits(C: int, NR: int) -> bool:
    """The classic sweep's gate for K4 (``classic_route``): the tile at an
    odd row stride and the right-hand sides fit in one block's shared
    memory, as an earlier form of the kernel staged them. Kept as it was,
    so that the same groups take K4; the kernel itself holds X in registers
    and would take any NR."""
    return 1 <= C <= MAX_C and NR >= 1 and \
        4 * (C * _odd_stride(C) + C * NR) <= SMEM_BYTES


@functools.lru_cache(maxsize=1024)
def trisolve_geometry(B: int, C: int, NR: int, transpose: bool,
                      cpw: int | None = None, wpt: int | None = None,
                      tpb: int | None = None) -> TrisolveGeometry:
    """The kernel's launch plan for B tiles (C, C) and NR right-hand sides,
    in either direction (both take the same plan). Raises ``ValueError``
    where :func:`trisolve_fits` is false. ``cpw`` (1 or WIDE), ``wpt`` and
    ``tpb`` force a choice in place of the rules below (``trisolve_sweep``).

    Rules: a warp holds one column below 4 right-hand sides, WIDE from 4 on
    (wasting at most 3 columns' registers); a tile takes one warp a chunk,
    up to a block of MAX_WARPS; tiles are packed into a block while the
    grid keeps FILL_BLOCKS blocks and the block fits in shared memory; a
    tile with more chunks than warps spreads them over blocks up to
    FILL_BLOCKS."""
    if not trisolve_fits(C, NR):
        raise ValueError(f"trisolve_geometry: (C, NR) = ({C}, {NR}) is not "
                         f"taken by the kernel")
    if cpw is None:
        cpw = 1 if NR < 4 else WIDE
    if cpw not in (1, WIDE):
        raise ValueError(f"trisolve_geometry: cpw must be 1 or {WIDE}")
    chunks = -(-NR // cpw)
    wpt = min(chunks, MAX_WARPS) if wpt is None else min(wpt, chunks)
    if tpb is None:
        tpb = max(1, min(MAX_WARPS // wpt, B // FILL_BLOCKS))
        while tpb > 1 and _smem(C, tpb, wpt, cpw) > SMEM_BYTES:
            tpb -= 1
    if not (1 <= wpt and 1 <= tpb and tpb * wpt <= MAX_WARPS):
        raise ValueError(f"trisolve_geometry: {tpb} tiles of {wpt} warps "
                         f"exceed a block of {MAX_WARPS} warps")
    tiles = -(-B // tpb)
    csplit = max(1, min(-(-chunks // wpt), -(-FILL_BLOCKS // max(tiles, 1))))
    return TrisolveGeometry(tpb, wpt, cpw, chunks, csplit, -(-C // 32),
                            _smem(C, tpb, wpt, cpw), tiles * csplit,
                            32 * tpb * wpt)


def batched_trisolve_plain(L: torch.Tensor, Y: torch.Tensor,
                           transpose: bool = False) -> torch.Tensor:
    """The kernel's column loop in plain PyTorch (any device, any float)."""
    X = Y.clone()
    C = L.shape[1]
    for step in range(C):
        k = C - 1 - step if transpose else step
        xk = X[:, k, :] / L[:, k, k, None]                      # (B, NR)
        if transpose:
            X[:, :k, :] -= L[:, k, :k, None] * xk[:, None, :]
        else:
            X[:, k + 1:, :] -= L[:, k + 1:, k, None] * xk[:, None, :]
        X[:, k, :] = xk
    return X


def batched_trisolve(L: torch.Tensor, Y: torch.Tensor,
                     transpose: bool = False) -> torch.Tensor:
    """X solving L X = Y (or L^T X = Y): the CUDA kernel for CUDA tensors.

    L (B, C, C) and Y (B, C, NR). A CPU tensor takes
    :func:`batched_trisolve_plain`; CUDA tensors must be contiguous fp32 on
    one device with :func:`trisolve_fits`, or this raises."""
    if L.device.type == "cpu":
        return batched_trisolve_plain(L, Y, transpose)
    B, C, C2 = L.shape
    if L.device.type != "cuda" or L.dtype != torch.float32 \
            or Y.dtype != torch.float32 or Y.device != L.device:
        raise ValueError(f"batched_trisolve: needs fp32 CUDA tensors on one "
                         f"device, got L {L.dtype} on {L.device}, Y "
                         f"{Y.dtype} on {Y.device}")
    if C != C2 or Y.dim() != 3 or Y.shape[:2] != (B, C) \
            or not L.is_contiguous() or not Y.is_contiguous():
        raise ValueError(f"batched_trisolve: L {tuple(L.shape)} and Y "
                         f"{tuple(Y.shape)} must be contiguous (B, C, C) and "
                         f"(B, C, NR)")
    NR = Y.shape[2]
    if not trisolve_fits(C, NR):
        raise ValueError(f"batched_trisolve: (C, NR) = ({C}, {NR}) does not "
                         f"fit in one block's shared memory")
    X = torch.empty_like(Y)
    if B == 0:
        return X
    _launch(L, Y, X, transpose, trisolve_geometry(B, C, NR, bool(transpose)))
    batched_trisolve.launches += 1
    return X


def _launch(L: torch.Tensor, Y: torch.Tensor, X: torch.Tensor,
            transpose: bool, g: TrisolveGeometry) -> None:
    """Launch the kernel on checked tensors with launch plan ``g``."""
    B, C, _ = L.shape
    lib = _build.load()
    with torch.cuda.device(L.device):
        err = lib.sst_trisolve(L.data_ptr(), Y.data_ptr(), X.data_ptr(), B, C,
                               Y.shape[2], int(bool(transpose)), g.tpb, g.wpt,
                               g.cpw, g.chunks, g.csplit, g.smem,
                               torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "batched_trisolve")


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {"batched_trisolve": (batched_trisolve, "launches")}
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
