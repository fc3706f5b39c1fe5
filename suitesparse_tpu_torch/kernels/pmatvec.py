"""Streaming panel matvec (K5): CUDA kernel + plain version.

Port of :mod:`suitesparse_tpu.kernels.pmatvec`: Z[b] = M[b]^T X[b] for big
panels M (B, K, N) with a small batch and NR <= 8 right-hand sides
X (B, K, NR); Z is (B, N, NR). The reference's zero padding of K and N to
its (8, 128) tiles (``pmv_pad``), its VMEM fit and its (B, NRpad8, Npad)
output are TPU layout and are not carried.

``pmatvec_t`` runs ``csrc/pmatvec.cu`` on CUDA tensors and
``pmatvec_t_plain`` on CPU tensors. :func:`pmv_geometry` plans the kernel's
launch (column tiles, warps a block, blocks a cluster, rows a warp, shared
memory) in Python, so that the CPU tests can check it; the kernel checks
what it is given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .trisolve import SMEM_BYTES, SMS

__all__ = ["COUNTERS", "MAX_B", "MAX_NR", "PmvGeometry", "pmatvec_t",
           "pmatvec_t_plain", "pmv_geometry"]

MAX_NR = 8          # right-hand sides the kernel keeps in registers
MAX_B = 65535       # batch elements on the kernel's second grid axis
LANES = 32          # lanes of a warp
COLS = 4            # columns a thread owns: one 16-byte load a row
TILE_WIDTHS = (32, 16, 8)   # column groups of a tile, widest first
UNROLL = 8          # load steps a warp has in flight (kUnroll in the kernel)
MAX_WARPS = 8       # warps of a block, each on its own rows of K
MAX_SPLIT = 8       # blocks of a column tile: a portable cluster
# warps the grid aims for: 8 a SM, each with UNROLL 512-byte load steps in
# flight, 32 KB a SM
FILL_WARPS = 8 * SMS
# a tile's runs stay in one block below this many, or where one block's
# warps need at most ONE_BLOCK_BATCHES batches of load steps each: a
# cluster costs about half a microsecond (its barrier and its sums), more
# than it saves there on the plan's panels (``pmv_sweep`` on the H100,
# PERF.md)
CLUSTER_MIN_RUNS = MAX_WARPS * 3 // 2 + 1
ONE_BLOCK_BATCHES = 3


class PmvGeometry(NamedTuple):
    """Launch plan of ``csrc/pmatvec.cu``. Each panel's column groups (of
    ``cols`` columns) are cut into ``tiles`` tiles of at most ``tw`` groups
    (equal widths, to one group); a warp's lanes cover a tile's groups and
    LANES // tw neighbouring rows, and have UNROLL such load steps in
    flight. A tile's K rows are cut into ``warps * split`` runs of ``rows``
    rows, one a warp, over ``split`` blocks of ``warps`` warps (a
    thread-block cluster when ``split`` > 1). ``vec``: the plan allows
    16-byte loads (N % 4 == 0; the wrapper also needs M 16-byte aligned).
    ``smem`` bytes of shared memory a block; ``blocks`` blocks of
    ``threads`` threads."""
    vec: int
    cols: int
    tw: int
    tiles: int
    warps: int
    split: int
    rows: int
    smem: int
    blocks: int
    threads: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem(NR: int, warps: int, split: int) -> int:
    """Bytes, as ``smem_bytes`` in csrc/pmatvec.cu: each warp's sums of a
    tile (a lane's at an odd stride), the cluster's sums (read in rank 0),
    each warp's X rows."""
    tile = LANES * COLS * NR
    return 4 * (warps * LANES * (COLS * NR + 1)
                + (split * tile if split > 1 else 0)
                + warps * UNROLL * (LANES // TILE_WIDTHS[-1]) * NR)


def _reach(B: int, K: int, nc: int, tw: int) -> int:
    """Blocks a grid of tiles of ``tw`` groups can have: each tile's K in
    runs of at least one batch of load steps, over at most MAX_SPLIT
    blocks."""
    return B * _cdiv(nc, tw) * min(MAX_SPLIT,
                                   max(1, _cdiv(K, UNROLL * LANES // tw)))


@functools.lru_cache(maxsize=1024)
def pmv_geometry(B: int, K: int, N: int, NR: int,
                 split: int | None = None) -> PmvGeometry:
    """The kernel's launch plan for panels (B, K, N) and NR right-hand
    sides. Cached: the sweep asks for the same few shapes on every solve.

    Tiles are the widest that leave the grid room for SMS blocks (else
    the ones that leave it the most room, :func:`_reach`). K is cut into
    as many runs as it takes to put FILL_WARPS warps on the card (at least
    one batch of load steps each, at most MAX_WARPS * MAX_SPLIT); runs
    fill a block's warps first, then, from CLUSTER_MIN_RUNS on and where
    a block's warps would need more than ONE_BLOCK_BATCHES batches each,
    the blocks of a cluster. ``split`` asks for that many blocks a tile
    instead (``pmv_sweep``)."""
    nc = _cdiv(max(N, 1), COLS)
    B1 = max(B, 1)
    tw = max(TILE_WIDTHS, key=lambda t: (min(SMS, _reach(B1, K, nc, t)), t))
    tiles = _cdiv(nc, tw)
    step = UNROLL * LANES // tw         # rows of a batch
    runs = max(1, min(_cdiv(FILL_WARPS, B1 * tiles), _cdiv(K, step),
                      MAX_WARPS * MAX_SPLIT))
    if split is None:
        one_block = runs < CLUSTER_MIN_RUNS or \
            K <= ONE_BLOCK_BATCHES * MAX_WARPS * step
        split = 1 if one_block else _cdiv(runs, MAX_WARPS)
    else:
        split = max(1, min(split, MAX_SPLIT))
    warps = max(1, min(MAX_WARPS, _cdiv(runs, split)))
    rows = max(1, _cdiv(K, warps * split))
    smem = _smem(NR, warps, split)
    assert smem <= SMEM_BYTES, (B, K, N, NR, split)
    return PmvGeometry(int(N % COLS == 0), COLS, tw, tiles, warps, split,
                       rows, smem, B * tiles * split, warps * LANES)


def pmatvec_t_plain(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Z = M^T X per batch element, summed in k order."""
    Z = torch.zeros(M.shape[0], M.shape[2], X.shape[2], dtype=X.dtype,
                    device=X.device)
    for k in range(M.shape[1]):
        Z += M[:, k, :, None] * X[:, k, None, :]
    return Z


def pmatvec_t(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Z[b] = M[b]^T X[b] for M (B, K, N) and X (B, K, NR).

    A CPU tensor takes :func:`pmatvec_t_plain`; CUDA tensors must be
    contiguous fp32 on one device with NR <= 8, or this raises."""
    if M.device.type == "cpu":
        return pmatvec_t_plain(M, X)
    if M.device.type != "cuda" or M.dtype != torch.float32 \
            or X.dtype != torch.float32 or X.device != M.device:
        raise ValueError(f"pmatvec_t: needs fp32 CUDA tensors on one device, "
                         f"got M {M.dtype} on {M.device}, X {X.dtype} on "
                         f"{X.device}")
    B, K, N = M.shape
    if X.dim() != 3 or X.shape[:2] != (B, K) or not M.is_contiguous() \
            or not X.is_contiguous():
        raise ValueError(f"pmatvec_t: M {tuple(M.shape)} and X "
                         f"{tuple(X.shape)} must be contiguous (B, K, N) and "
                         f"(B, K, NR)")
    NR = X.shape[2]
    if not 1 <= NR <= MAX_NR or B > MAX_B:
        raise ValueError(f"pmatvec_t: NR = {NR} must be in [1, {MAX_NR}] "
                         f"and B = {B} at most {MAX_B}")
    Z = torch.empty(B, N, NR, dtype=X.dtype, device=X.device)
    if B == 0 or N == 0:
        return Z
    _launch(M, X, Z, pmv_geometry(B, K, N, NR))
    pmatvec_t.launches += 1
    return Z


def _launch(M: torch.Tensor, X: torch.Tensor, Z: torch.Tensor,
            g: PmvGeometry) -> None:
    """Launch the kernel on checked tensors with launch plan ``g``; 16-byte
    loads where the plan allows them and M's base is 16-byte aligned (then
    every batch element's is: N % 4 == 0)."""
    B, K, N = M.shape
    vec = int(bool(g.vec) and M.data_ptr() % 16 == 0)
    lib = _build.load()
    with torch.cuda.device(M.device):
        err = lib.sst_pmatvec(M.data_ptr(), X.data_ptr(), Z.data_ptr(), B, K,
                              N, X.shape[2], vec, g.tw, g.tiles, g.warps,
                              g.split, g.rows, g.smem,
                              torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "pmatvec_t")


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {"pmatvec_t": (pmatvec_t, "launches")}
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
