"""Batched Cholesky panel factorization (potrf + trsm): CUDA kernel + plain.

Port of :mod:`suitesparse_tpu.kernels.potrf`. For B prepared tiles (F11
symmetric full with identity on padded rows/cols, F21 the subdiagonal panel)
both versions return L11 = chol(F11), zero above the diagonal, and
L21 = F21 L11^{-T}, by the TPU kernel's right-looking column loop with an
rsqrt pivot and no pivoting; a non-SPD tile gives non-finite values.

``potrf_trsm`` runs ``csrc/potrf_trsm.cu`` on a CUDA tensor and
``potrf_trsm_plain`` on a CPU tensor. Layout is batch-major (B, C, C) /
(B, RU, C), the port's natural layout; the TPU kernel's lane-major transpose
is not carried over.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["MAX_C", "potrf_trsm", "potrf_trsm_plain"]

MAX_C = 96   # the kernel keeps a C x C tile in shared memory


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
    lib = _build.load()
    with torch.cuda.device(f11.device):
        err = lib.sst_potrf_trsm(
            f11.data_ptr(), f21.data_ptr() if RU > 0 else None,
            L11.data_ptr(), L21.data_ptr() if RU > 0 else None,
            B, C, RU, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "potrf_trsm")
    potrf_trsm.launches += 1
    return L11, L21


potrf_trsm.launches = 0
