"""Streaming panel matvec (K5): CUDA kernel + plain version.

Port of :mod:`suitesparse_tpu.kernels.pmatvec`: Z[b] = M[b]^T X[b] for big
panels M (B, K, N) with a small batch and NR <= 8 right-hand sides
X (B, K, NR); Z is (B, N, NR). The reference's zero padding of K and N to
its (8, 128) tiles (``pmv_pad``), its VMEM fit and its (B, NRpad8, Npad)
output are TPU layout and are not carried.

``pmatvec_t`` runs ``csrc/pmatvec.cu`` on CUDA tensors and
``pmatvec_t_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["MAX_B", "MAX_NR", "pmatvec_t", "pmatvec_t_plain"]

MAX_NR = 8          # right-hand sides the kernel keeps in registers
MAX_B = 65535       # batch elements on the kernel's third grid axis


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
    lib = _build.load()
    with torch.cuda.device(M.device):
        err = lib.sst_pmatvec(M.data_ptr(), X.data_ptr(), Z.data_ptr(), B, K,
                              N, NR, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "pmatvec_t")
    pmatvec_t.launches += 1
    return Z


pmatvec_t.launches = 0
