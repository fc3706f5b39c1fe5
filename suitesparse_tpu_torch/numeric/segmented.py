"""Segmented execution of the device factors: a bounded working set.

The port of the JAX package's ``numeric/segmented.py`` (the QR-shaped
runner) and of the supernodal factor's ``_segment_schedule``. Each device
factor (the supernodal Cholesky, the multifrontal QR and the unsymmetric
LU) runs its groups one at a time in plan order; what it holds beyond its
output is every group's index arrays (uploaded once a plan) and one
group's front and workspace. Past a budget the groups are cut into
contiguous segments: a segment's index arrays go up to the device when it
starts and are let go when it ends, so the factor holds one segment's
arrays instead of the whole plan's. The host keeps every group's arrays
for the next upload.

The estimate is in bytes of what the port holds, not the reference's
cells of one-hot placement terms and XLA buffers: each group costs its
index arrays (``index``) and its transient working set (``work``: the
front, the update or panel, the library's workspace; the Cholesky's
update at its own itemsize, 2 bytes under
``Config.update_dtype="bfloat16"``), and a segment holds the sum of its
groups' index arrays and the largest working set among them. The
Cholesky's schedule is cached per (compute dtype, update dtype). The
switch, ``Config.segment_bytes``: 0 (auto) gives a budget of
:data:`AUTO_SHARE` of the device's free memory at call time
(:func:`..device.free_bytes`, which leaves out the free blocks of live
CUDA graphs' pools; none on the CPU); a positive value is the budget
itself. A factor runs in segments when its one-piece estimate (every
group's index arrays and the largest working set) passes the budget.

What crosses a segment boundary stays where the one-piece factor keeps it:
the Cholesky's child updates are freed after their last consumer group, as
in ``supernodal_device._run_plan`` (the counterpart of the reference's
donated update dict); the QR's and the LU's contribution rows live in the
flat panel pool, which stays whole on the device for the solve, as the
reference's concatenated panels do (so the reference's ``_consumers`` has
no use here).

Not ported, as workarounds of XLA on the TPU: ``_precompile_segments``
and ``SSTPU_SEG_PRECOMPILE`` (concurrent compiles of segment programs),
``SSTPU_SEG_ARGS`` (index arrays as arguments rather than constants in the
HLO) and the ``warnings`` filters for donated buffers. The port reads no
``SSTPU_*`` variable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..device import free_bytes
from ..stats import count, span

__all__ = ["AUTO_SHARE", "budget", "one_piece_bytes", "schedule",
           "segments", "uploads", "nbytes", "to_device"]

# The auto budget's share of the device's free memory at call time, after
# the factor's output. Half, because the estimate leaves out what the
# factor holds besides its index arrays and one group's working set: the
# Cholesky's carried child updates, the caching allocator's rounding and
# split blocks, and a second factor of the same plan that a caller keeps
# alive (refinement, a solve of the previous factor).
AUTO_SHARE = 0.5


def budget(config: Config, device: torch.device, out_bytes: int,
           held_bytes: int = 0) -> int:
    """The bytes a factor on ``device`` may hold beyond its output of
    ``out_bytes``, or 0 when it runs in one piece whatever its size.

    ``held_bytes``: index arrays of this plan already on the device (a
    cached one-piece upload), which a segmented run lets go, so they count
    as free."""
    if config.segment_bytes < 0:
        raise ValueError(f"segment_bytes must be >= 0, got "
                         f"{config.segment_bytes}")
    if config.segment_bytes:
        return int(config.segment_bytes)
    if device.type != "cuda":
        return 0
    return max(1, int(AUTO_SHARE * (free_bytes(device) + held_bytes
                                    - out_bytes)))


def one_piece_bytes(index_bytes: int, costs) -> int:
    """What the one-piece factor holds beyond its output: every group's
    index arrays (``index_bytes``, as its upload holds them) and the
    largest working set of ``costs`` ([(index, work)] a group)."""
    return index_bytes + max((w for _i, w in costs), default=0)


def schedule(costs, budget_bytes: int) -> list:
    """Contiguous segments of group positions, in plan order: a new
    segment starts where the next group would take the current one past
    ``budget_bytes`` (its index arrays summed, the largest working set).
    A group alone past the budget is a segment of its own."""
    segs, cur, index, work = [], [], 0, 0
    for pos, (i, w) in enumerate(costs):
        if cur and index + i + max(work, w) > budget_bytes:
            segs.append(cur)
            cur, index, work = [], 0, 0
        cur.append(pos)
        index += i
        work = max(work, w)
    if cur:
        segs.append(cur)
    return segs


def segments(dp, key: tuple, costs, config: Config, device: torch.device,
             out_bytes: int) -> list | None:
    """The segments a factor on the device plan ``dp`` runs in, or None
    when it runs in one piece.

    ``dp`` holds ``index_bytes`` (the one-piece upload's bytes), ``groups``
    (that upload, or None) and ``schedule`` (the last schedule and its
    key). A segmented run lets the one-piece upload go, so that the plan's
    cache does not hold it beside the segments; the schedule is cached
    under ``key`` (which must pin the plan, its right-hand sides, the dtype
    and the device) and the budget."""
    held = dp.index_bytes if dp.groups is not None else 0
    b = budget(config, device, out_bytes, held)
    if not b or one_piece_bytes(dp.index_bytes, costs) <= b:
        return None
    dp.groups = None
    key = (*key, b)
    if dp.schedule is None or dp.schedule[0] != key:
        dp.schedule = (key, schedule(costs, b))
    return dp.schedule[1]


def uploads(host: list, segs: list, device: torch.device, part=None,
            reverse: bool = False):
    """Yield (position, arrays on ``device``) of every group, segment by
    segment (both in reverse for a backward sweep): a segment's arrays
    (``part(host[pos])``, or all of them) go up when it starts and are let
    go when it ends (each upload a span ``factor.index_upload``, its bytes
    counted in ``h2d_bytes.index``)."""
    for seg in (reversed(segs) if reverse else segs):
        order = seg[::-1] if reverse else seg
        with span("factor.index_upload"):
            arrays = [to_device(part(host[p]) if part else host[p], device)
                      for p in order]
            count("h2d_bytes.index", nbytes(arrays))
        yield from zip(order, arrays)
        del arrays


def to_device(obj, device: torch.device, _memo=None):
    """``obj`` with every tensor on ``device``: tensors, lists, tuples and
    dataclasses field by field; a dataclass with its own ``to`` (the K7
    work list) moves itself. An object reached twice is moved once."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(to_device(o, device, memo) for o in obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = obj.to(device) if hasattr(obj, "to") else dataclasses.replace(
            obj, **{f.name: to_device(getattr(obj, f.name), device, memo)
                    for f in dataclasses.fields(obj) if f.init})
    else:
        return obj
    memo[id(obj)] = out
    return out


def nbytes(obj, _seen=None) -> int:
    """Bytes of the tensors and numpy arrays in ``obj`` (walked as
    :func:`to_device` walks it, each array counted once)."""
    seen = set() if _seen is None else _seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (list, tuple)):
        return sum(nbytes(o, seen) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(nbytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0
