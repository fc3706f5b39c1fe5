"""Device choice, fp32 matmul precision and free memory for the port.

The device rule: CUDA unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises, so no run silently falls back to the CPU.

The free memory the port's memory checks read (:func:`free_bytes`) is the
free memory ``mem_get_info`` reports and the blocks PyTorch's allocator
caches, less the free blocks of live CUDA graphs' private pools
(:func:`hold_graph_bytes`), which the allocator counts as cached but hands
to no other allocation.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

__all__ = ["CARD", "CARD_BYTES_S", "CARD_FLOP_S", "fp32_precision",
           "free_bytes", "graph_held_bytes", "hold_graph_bytes",
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


# device index -> the free bytes that live CUDA graphs' pools hold
_GRAPH_HELD: dict = {}


def _index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def hold_graph_bytes(owner, device, nbytes: int) -> None:
    """Count ``nbytes`` of ``device`` (a graph pool's free blocks) as
    held until ``owner``, the object that keeps the graph, is collected."""
    i = _index(device)
    _GRAPH_HELD[i] = _GRAPH_HELD.get(i, 0) + nbytes
    weakref.finalize(owner, _release, i, nbytes)


def _release(i: int, nbytes: int) -> None:
    _GRAPH_HELD[i] -= nbytes


def graph_held_bytes(device) -> int:
    """The bytes of ``device`` that live CUDA graphs' pools hold."""
    return _GRAPH_HELD.get(_index(device), 0)


def free_bytes(device) -> int:
    """The CUDA device's free memory: what ``mem_get_info`` reports, and
    PyTorch's cached free blocks less those only a live graph can use."""
    free, _total = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device) - graph_held_bytes(device)
