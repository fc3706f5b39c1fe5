"""Device choice and fp32 matmul precision for the port.

The device rule: CUDA unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises, so no run silently falls back to the CPU.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["CARD", "CARD_BYTES_S", "CARD_FLOP_S", "fp32_precision",
           "resolve_device"]

# the card whose peaks the static reports' bounds use (PERF.md, section 2)
CARD = "NVIDIA H100 SXM"
CARD_BYTES_S = 3.35e12                           # device memory rate
CARD_FLOP_S = {4: 67e12, 8: 34e12}               # fp32, fp64 outside the
#                                                  tensor cores, by itemsize


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "suitesparse_tpu_torch: CUDA was asked for and no CUDA device "
                "is available (pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"suitesparse_tpu_torch: unsupported device {dev}")
    return dev


@contextlib.contextmanager
def fp32_precision(precision: str = "highest"):
    """Scope in which ``Config.precision == "highest"`` means true fp32.

    TF32 keeps about three decimal digits, and a solve with many right-hand
    sides then misses its residual gate (the same trap as the TPU's one-pass
    bf16 default). Inside the scope TF32 is off for matmuls and cuDNN; the
    caller's settings come back on exit. Other precisions leave them as the
    caller set them."""
    if precision != "highest":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
