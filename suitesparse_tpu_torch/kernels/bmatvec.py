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
on CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .trisolve import SMEM_BYTES

__all__ = ["MAX_NR", "bmatvec", "bmatvec_plain", "bmv_fits"]

MAX_NR = 8               # right-hand sides the kernel keeps in registers
THREADS = 256            # threads of one block (csrc/bmatvec.cu)


def bmv_fits(I: int, J: int, NR: int) -> bool:
    """True iff the kernel takes panels (I, J) with NR right-hand sides in
    both directions: one element's right-hand sides (the longer axis) and
    the block's partial sums must fit in one block's shared memory."""
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
    lib = _build.load()
    with torch.cuda.device(M.device):
        err = lib.sst_bmatvec(M.data_ptr(), X.data_ptr(), Z.data_ptr(), B, I,
                              J, NR, int(bool(transpose)),
                              torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "bmatvec")
    if transpose:
        bmatvec.transposed_launches += 1
    else:
        bmatvec.launches += 1
    return Z


bmatvec.launches = 0               # forward kernel
bmatvec.transposed_launches = 0    # transposed kernel
