"""Batched small triangular solve (K4): CUDA kernel + plain version.

Port of :mod:`suitesparse_tpu.kernels.trisolve`. For B lower-triangular
tiles L (B, C, C) with a nonzero diagonal (identity on padding) and
right-hand sides Y (B, C, NR), both versions return X = L^-1 Y, or
X = L^-T Y with ``transpose``, by the right-looking column loop: step k
takes x_k = X[k] / L[k, k] and subtracts L[i, k] x_k from the rows below
(transposed: L[k, i] x_k from the rows above).

``batched_trisolve`` runs ``csrc/trisolve.cu`` on a CUDA tensor and
``batched_trisolve_plain`` on a CPU tensor. Layout is batch-major; the TPU
kernel's lane-major transpose and batch padding are not carried over.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["MAX_C", "SMEM_BYTES", "batched_trisolve", "batched_trisolve_plain",
           "trisolve_fits"]

MAX_C = 96               # the tile lives in shared memory
SMEM_BYTES = 232448      # shared memory one block can take on the H100


def _odd_stride(C: int) -> int:
    return C + 1 - (C & 1)


def trisolve_fits(C: int, NR: int) -> bool:
    """True iff the kernel takes a (C, C) tile with NR right-hand sides:
    the tile at an odd row stride and the right-hand sides must fit in one
    block's shared memory."""
    return 1 <= C <= MAX_C and NR >= 1 and \
        4 * (C * _odd_stride(C) + C * NR) <= SMEM_BYTES


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
    lib = _build.load()
    with torch.cuda.device(L.device):
        err = lib.sst_trisolve(L.data_ptr(), Y.data_ptr(), X.data_ptr(), B, C,
                               NR, int(bool(transpose)),
                               torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "batched_trisolve")
    batched_trisolve.launches += 1
    return X


batched_trisolve.launches = 0
