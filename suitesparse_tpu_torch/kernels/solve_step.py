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
"""

from __future__ import annotations

import torch

from . import _build
from .trisolve import MAX_C, SMEM_BYTES, _odd_stride, batched_trisolve_plain

__all__ = ["solve_step_fwd", "solve_step_bwd", "solve_step_fwd_plain",
           "solve_step_bwd_plain", "step_fits"]

CHUNK = 64     # L21 rows the forward kernel stages in shared memory at once


def step_fits(C: int, RU: int, NR: int) -> bool:
    """True iff both kernels take the shape: L11, the right-hand sides and
    (forward) one chunk of L21 rows must fit in one block's shared memory."""
    ld = _odd_stride(C)
    return 1 <= C <= MAX_C and RU >= 0 and NR >= 1 and \
        4 * (C * ld + C * NR + min(RU, CHUNK) * ld) <= SMEM_BYTES


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
    lib = _build.load()
    with torch.cuda.device(L11.device):
        err = lib.sst_solve_step_fwd(
            L11.data_ptr(), L21.data_ptr(), L21.stride(0), Y.data_ptr(),
            WB.data_ptr(), WB.stride(0), xc.data_ptr(),
            v.data_ptr() if RU else None, B, C, RU, NR,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "solve_step_fwd")
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
    lib = _build.load()
    with torch.cuda.device(L11.device):
        err = lib.sst_solve_step_bwd(
            L11.data_ptr(), L21.data_ptr(), L21.stride(0), Y.data_ptr(),
            XB.data_ptr(), XB.stride(0), xc.data_ptr(), B, C, RU, NR,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "solve_step_bwd")
    solve_step_bwd.launches += 1
    return xc


solve_step_fwd.launches = 0
solve_step_bwd.launches = 0
