"""Batched matvec on batch-major panels (K6): CUDA kernel + plain version.

Port of :mod:`suitesparse_tpu.kernels.bmatvec`. For panels M (B, I, J) and
NR <= 8 right-hand sides:

    forward     Z[b] = M[b] X[b],    X (B, J, NR) -> Z (B, I, NR)
    transposed  Z[b] = M[b]^T X[b],  X (B, I, NR) -> Z (B, J, NR)

The reference's ``bmatvec_t`` is named for its transposed, lane-major
storage (I, J, B) with the batch on the TPU's 128 lanes; its padding
helpers (``bmv_pad``, ``bmv_group_geom``) and the lane transposes around it
are TPU layout and are not carried. Here the panels stay batch-major, so the
w2 sweep's W2 (B, R, C) serves both directions as it is.

``bmatvec`` runs ``csrc/bmatvec.cu`` on CUDA tensors and ``bmatvec_plain``
on CPU tensors. :func:`bmv_geometry` plans the kernel's launch (elements
per block, blocks per panel, ring of stages, shared memory) in Python, so
that the CPU tests can check it; the kernel checks what it is given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .trisolve import SMEM_BYTES, SMS

__all__ = ["COUNTERS", "MAX_NR", "BmvGeometry", "bmatvec", "bmatvec_plain",
           "bmv_fits", "bmv_geometry"]

MAX_NR = 8               # right-hand sides the kernel keeps in registers
THREADS = 256            # threads of one block (csrc/bmatvec.cu)
SPLIT_BELOW = 2 * SMS    # below this batch, panels' rows may be split
PACK_BLOCKS = 4 * SMS    # above it, whole panels are packed to this many blocks
MAX_SPLIT = 8            # transposed blocks of one panel: a portable cluster
MIN_PART_ROWS = 16       # rows of a panel part, at least
# transposed: a cluster rank takes about this many bytes of its panel. The
# cluster's partial sums cost more than smaller copies save on short
# panels: on the H100, one block per 83 KB panel of (45, 432, 48) beat
# clusters of 2-8 (PERF.md, section 6; ``bmv_sweep`` measures it).
CLUSTER_PART_BYTES = 128 << 10
RING_MIN_BYTES = 112 << 10  # a block's run up to this moves in one copy
RING_STAGES = 3          # a longer run moves in this many chunks at once
RING_BYTES = 32 << 10    # of at most about this size each (then a ring)
PACK_BYTES = 64 << 10    # packed whole panels of a block, at most
XS_BYTES = 64 << 10      # forward: X staged in shared memory up to this
BAR_BYTES = 64           # the mbarriers at the start of shared memory


class BmvGeometry(NamedTuple):
    """Launch plan of ``csrc/bmatvec.cu``. A block owns ``epb`` whole
    panels (``split`` = 1) or rows [rank * part, (rank + 1) * part) of one
    panel (``split`` > 1 blocks per panel; transposed, they form a cluster
    of that size). Its rows stream in chunks of ``chunk`` rows through
    ``stages`` shared-memory buffers. ``xsmem``: forward X staged in shared
    memory (else read from device memory). ``blocks`` counts the grid."""
    epb: int
    split: int
    part: int
    chunk: int
    stages: int
    xsmem: int
    smem: int
    blocks: int
    cluster: int


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _row_stride(transpose: bool, J: int) -> int:
    """Shared-memory stride of a panel row (``row_stride`` in the kernel):
    forward rows of 32 or more columns are padded to an odd number of
    16-byte words."""
    if transpose or J % 4 or J < 32:
        return J
    return J + (4 if (J // 4) % 2 == 0 else 8)


def _stage_floats(transpose: bool, chunk: int, J: int, NR: int) -> int:
    return _r4(chunk * _row_stride(transpose, J)) + \
        (_r4(chunk * NR) if transpose else 0)


@functools.lru_cache(maxsize=1024)
def bmv_geometry(B: int, I: int, J: int, NR: int, transpose: bool,
                 split: int | None = None) -> BmvGeometry:
    """The kernel's launch plan for panels (B, I, J) and NR right-hand sides
    (the same arithmetic as ``smem_bytes`` in ``csrc/bmatvec.cu``). Cached:
    the sweep asks for the same few shapes on every solve. ``split`` asks
    for that many blocks a panel (at most MAX_SPLIT transposed, at least
    MIN_PART_ROWS rows each) in place of the rule below (``bmv_sweep``)."""
    tj = min(J, THREADS)
    row_floats = _row_stride(transpose, J) + (NR if transpose else 0)
    if split is not None or B < SPLIT_BELOW:
        epb = 1
        if split is not None:
            want = min(split, MAX_SPLIT) if transpose else split
        elif transpose:
            want = min(MAX_SPLIT, -(-4 * I * row_floats // CLUSTER_PART_BYTES))
        else:           # forward parts need no cluster
            want = -(-SPLIT_BELOW // max(B, 1))
        split = max(1, min(want, I // MIN_PART_ROWS))
        part = min(I, _r4(-(-I // split)))
        split = -(-I // part)
    else:
        want = -(-B // PACK_BLOCKS)
        if transpose:   # epb divides the columns' room, so slices fill it
            cap = THREADS // tj
            want = cap // -(-cap // want)
        epb = max(1, min(want, PACK_BYTES // (4 * I * row_floats)))
        split, part = 1, I
    run = epb * I if split == 1 else part
    xs = _r4(epb * J * NR) if not transpose and \
        4 * epb * J * NR <= XS_BYTES else 0

    def smem(stages, chunk):   # bytes, as smem_bytes in csrc/bmatvec.cu
        sums = THREADS * NR if transpose or J > THREADS else 0
        if transpose and split > 1:
            sums += split * tj * NR
        return BAR_BYTES + 4 * (
            xs + stages * _stage_floats(transpose, chunk, J, NR) + sums)

    if 4 * _stage_floats(transpose, run, J, NR) <= RING_MIN_BYTES:
        stages, chunk = 1, run
    else:
        stages = RING_STAGES
        chunk = min(_r4(-(-run // stages)),
                    max(4, RING_BYTES // (4 * row_floats) // 4 * 4))
    while chunk > 1 and smem(stages, chunk) > SMEM_BYTES:
        chunk //= 2
    assert smem(stages, chunk) <= SMEM_BYTES, (B, I, J, NR, transpose)
    blocks = -(-B // epb) * split * (-(-J // THREADS) if transpose else 1)
    return BmvGeometry(epb, split, part, chunk, stages, int(xs > 0),
                       smem(stages, chunk), blocks, split if transpose else 1)


def bmv_fits(I: int, J: int, NR: int) -> bool:
    """The w2 sweep's gate for K6 (``w2_route``): one element's right-hand
    sides (the longer axis) and a block's partial sums fit in one block's
    shared memory, as an earlier form of the kernel staged them. Kept as
    it was, so that the same groups take K6; the kernel takes every shape
    it admits (:func:`bmv_geometry` shrinks its chunks to fit)."""
    return I >= 1 and J >= 1 and 1 <= NR <= MAX_NR and \
        4 * (max(I, J) * NR + THREADS * NR) <= SMEM_BYTES


def bmatvec_plain(M: torch.Tensor, X: torch.Tensor,
                  transpose: bool = False) -> torch.Tensor:
    """Z = M X (or M^T X) per batch element, summed in k order."""
    Mk = M.mT if transpose else M
    Z = torch.zeros(M.shape[0], Mk.shape[1], X.shape[2], dtype=X.dtype,
                    device=X.device)
    for k in range(Mk.shape[2]):
        Z += Mk[:, :, k, None] * X[:, k, None, :]
    return Z


def bmatvec(M: torch.Tensor, X: torch.Tensor,
            transpose: bool = False) -> torch.Tensor:
    """Z[b] = M[b] X[b] (or M[b]^T X[b] with ``transpose``).

    A CPU tensor takes :func:`bmatvec_plain`; CUDA tensors must be
    contiguous fp32 on one device, with NR <= 8 and :func:`bmv_fits`, or
    this raises."""
    if M.device.type == "cpu":
        return bmatvec_plain(M, X, transpose)
    if M.device.type != "cuda" or M.dtype != torch.float32 \
            or X.dtype != torch.float32 or X.device != M.device:
        raise ValueError(f"bmatvec: needs fp32 CUDA tensors on one device, "
                         f"got M {M.dtype} on {M.device}, X {X.dtype} on "
                         f"{X.device}")
    B, I, J = M.shape
    K = I if transpose else J
    if X.dim() != 3 or X.shape[:2] != (B, K) or not M.is_contiguous() \
            or not X.is_contiguous():
        raise ValueError(f"bmatvec: M {tuple(M.shape)} and X "
                         f"{tuple(X.shape)} must be contiguous (B, I, J) and "
                         f"(B, {'I' if transpose else 'J'}, NR)")
    NR = X.shape[2]
    if not bmv_fits(I, J, NR):
        raise ValueError(f"bmatvec: (I, J, NR) = ({I}, {J}, {NR}) does not "
                         f"fit the kernel (NR <= {MAX_NR}, shared memory)")
    Z = torch.empty(B, J if transpose else I, NR, dtype=X.dtype,
                    device=X.device)
    if B == 0:
        return Z
    _launch(M, X, Z, transpose, bmv_geometry(B, I, J, NR, bool(transpose)))
    if transpose:
        bmatvec.transposed_launches += 1
    else:
        bmatvec.launches += 1
    return Z


def _launch(M: torch.Tensor, X: torch.Tensor, Z: torch.Tensor,
            transpose: bool, g: BmvGeometry) -> None:
    """Launch the kernel on checked tensors with launch plan ``g``."""
    B, I, J = M.shape
    lib = _build.load()
    with torch.cuda.device(M.device):
        err = lib.sst_bmatvec(M.data_ptr(), X.data_ptr(), Z.data_ptr(), B, I,
                              J, X.shape[2], int(bool(transpose)), g.epb,
                              g.split, g.part, g.chunk, g.stages, g.xsmem,
                              g.smem, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "bmatvec")


# the launch counters, by the name a count is reported under: (wrapper,
# attribute), each set to 0 here
COUNTERS = {"bmatvec": (bmatvec, "launches"),              # forward kernel
            "bmatvec_t": (bmatvec, "transposed_launches")}  # transposed
for _fn, _attr in COUNTERS.values():
    setattr(_fn, _attr, 0)
