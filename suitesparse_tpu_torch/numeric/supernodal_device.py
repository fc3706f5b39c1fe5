"""Supernodal multifrontal Cholesky factor on torch tensors (CUDA or CPU).

Port of :mod:`suitesparse_tpu.numeric.supernodal_device` (the one-shot
``factorize_device`` → ``_run_plan`` → ``_group_compute`` path). The host
plan is the reference's own: the same level/shape-bucket groups, the same
pair classes and the same tile manifests, built by the reference's numpy
helpers. The factor keeps the reference's padded device layout (each group's
(B, R, C) panels at ``panel_base``, ``dev_size`` cells in all), so the two
factors compare entry by entry.

Per group: A's values are scattered into the fronts F; child updates whose
parent group has a tile manifest are added by the tiled extend-add kernel,
the other pair classes by direct indexing; the fronts are factored by the
fused potrf+trsm kernel where its gate passes (B >= 32, C <= 96, fp32) and
by ``cholesky_ex`` + ``solve_triangular`` elsewhere; the update
U = F22 - L21 L21^T goes up to the parent group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from suitesparse_tpu.config import DEFAULT, Config
from suitesparse_tpu.kernels.extend_add_tiles import build_group_manifest
from suitesparse_tpu.numeric.supernodal_device import (
    _C_LADDER, _R_LADDER, Plan, _build_groups_vectorized, _clow_data,
    _find_minor, _mark_symmetrize, _pad_to, _update_consumers)
from suitesparse_tpu.sparse import CSC
from suitesparse_tpu.symbolic.supernodes import SupernodalSymbolic

from ..device import fp32_precision, resolve_device
from ..kernels.extend_add_tiles import extend_add_tiles, run_ptr
from ..kernels.potrf import MAX_C, potrf_trsm

__all__ = ["TILE_RMIN", "build_plan", "device_plan", "factorize_device"]

TILE_RMIN = 256     # groups with R >= this assemble through the tile kernel


def build_plan(S: SupernodalSymbolic, C_low: CSC,
               tile_rmin: int = TILE_RMIN) -> Plan:
    """The reference's device plan with tile manifests attached explicitly.

    Groups with ``R >= tile_rmin`` get the one-piece manifest that folds
    every pair class (the reference's defaults for its tile placement);
    ``g._tile_runs`` holds the manifest's :func:`run_ptr` offsets."""
    level_layouts = []
    place = {}
    panel_off = 0
    for d, level_nodes in enumerate(S.levels):
        buckets: dict = {}
        for s in level_nodes:
            nr, nc = S.nrows(s), S.ncols(s)
            key = (_pad_to(nr - nc, _R_LADDER) + _pad_to(nc, _C_LADDER),
                   _pad_to(nc, _C_LADDER))
            buckets.setdefault(key, []).append(int(s))
        placed = []
        for gi, (_key, ss) in enumerate(sorted(buckets.items())):
            # panels tightened to the group's actual maxima (sublane rounded)
            maxnc = max(S.ncols(s) for s in ss)
            maxru = max(S.nrows(s) - S.ncols(s) for s in ss)
            C = max(8 * ((maxnc + 7) // 8), 4)
            R = C + 8 * ((maxru + 7) // 8)
            for b, s in enumerate(ss):
                place[s] = (d, gi, b, R - C)
            placed.append((R, C, ss, panel_off))
            panel_off += len(ss) * R * C
        level_layouts.append(placed)
    groups = _build_groups_vectorized(S, C_low, level_layouts, place)
    plan = Plan(groups=groups, lnz=S.lnz, dev_size=panel_off, _S=S)
    for glist in plan.groups:
        for g in glist:
            g._tile = None
            g._tile_runs = None
            if g.R >= tile_rmin:
                g._tile = build_group_manifest(g, T=128, ru_min_frac=0.0,
                                               npiece=1)
                if g._tile is not None:
                    g._tile_runs = run_ptr(g._tile.man)
    _mark_symmetrize(plan)
    return plan


@dataclasses.dataclass
class GroupArrays:
    """One group's index arrays on the device."""

    asrc: torch.Tensor           # gather into Cdata
    adst: torch.Tensor           # flat destination in the (B*R*R) fronts
    nc: torch.Tensor             # (B, 1, 1) actual column counts
    pairs: list                  # per class (src, dst, idx) int64
    tile: tuple | None           # (man, rowmap, colmap, runs) int32
    uslices: list                # per folded class (k0, src key, RU_c, src)


@dataclasses.dataclass
class DevicePlan:
    """A host :class:`Plan` and its index arrays uploaded to one device."""

    plan: Plan
    device: torch.device
    groups: list                 # groups[level] = [GroupArrays]
    solve: object = None         # solve routing, built at the first solve


def _upload(plan: Plan, device: torch.device) -> DevicePlan:
    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    groups = []
    for glist in plan.groups:
        row = []
        for g in glist:
            tm = g._tile
            tile, uslices = None, []
            if tm is not None:
                tile = (t32(tm.man), t32(tm.rowmap), t32(tm.colmap),
                        t32(g._tile_runs))
                uslices = [(k0, key, RU_c, t64(src))
                           for (_ci, k0, key, RU_c, src) in tm.uslices]
            row.append(GroupArrays(
                asrc=t64(g.asrc), adst=t64(g.adst),
                nc=t64(g.nc).reshape(g.B, 1, 1),
                pairs=[(t64(s), t64(d), t64(i)) for (s, d, i)
                       in g._pair_arrays],
                tile=tile, uslices=uslices))
        groups.append(row)
    return DevicePlan(plan=plan, device=device, groups=groups)


def device_plan(A: CSC, S: SupernodalSymbolic, device: torch.device,
                tile_rmin: int = TILE_RMIN) -> DevicePlan:
    """The plan for ``S`` (the analysis of ``A``) on ``device``, built and
    uploaded once.

    Cached on ``S._torch_plan`` (never on the reference's ``_device_plan``,
    whose contents depend on the JAX backend), keyed by everything that
    changes it: the tile threshold and the device."""
    cache = getattr(S, "_torch_plan", None)
    if cache is None:
        cache = {}
        S._torch_plan = cache
    key = (int(tile_rmin), str(device))
    if key not in cache:
        C_low = A.symperm(S.perm).transpose()
        cache[key] = _upload(build_plan(S, C_low, tile_rmin), device)
    return cache[key]


def _use_potrf_kernel(dtype: torch.dtype, B: int, C: int) -> bool:
    """The fused potrf+trsm gate: a batch that fills the card, short column
    loops, fp32 (the reference's gate without its TPU VMEM budget)."""
    return B >= 32 and C <= MAX_C and dtype == torch.float32


def _place(Fbuf: torch.Tensor, U: torch.Tensor, dst: torch.Tensor,
           idx: torch.Tensor, R: int) -> None:
    """Fbuf[dst[p]*R*R + idx[p,i]*R + idx[p,j]] += U[p,i,j] where idx >= 0.

    Cells with idx < 0 go to Fbuf's last element, a dump cell outside the
    fronts, so the scatter needs no mask compaction (and no device sync)."""
    dump = Fbuf.numel() - 1
    ok = idx >= 0
    ii = torch.where(ok, idx, 0)
    flat = dst[:, None, None] * (R * R) + ii[:, :, None] * R + ii[:, None, :]
    flat = torch.where(ok[:, :, None] & ok[:, None, :], flat, dump)
    Fbuf.index_put_((flat.reshape(-1),), U.reshape(-1), accumulate=True)


def _group_compute(g, ix: GroupArrays, Cdata: torch.Tensor, updates: dict,
                   dtype: torch.dtype):
    """Assemble and factor one group; returns (panel (B, R, C), U or None)."""
    B, R, C = g.B, g.R, g.C
    RU = R - C
    dev = Cdata.device
    Fbuf = torch.zeros(B * R * R + 1, dtype=dtype, device=dev)
    if ix.asrc.numel():
        Fbuf[ix.adst] = Cdata[ix.asrc]
    F = Fbuf[:-1].view(B, R, R)

    skip = ()
    if ix.tile is not None and dtype == torch.float32:
        tm = g._tile
        Ucat = torch.zeros(max(tm.nslots, 1), tm.RUp, tm.RUp, dtype=dtype,
                           device=dev)
        for (k0, key, RU_c, src) in ix.uslices:
            Ucat[k0:k0 + src.numel(), :RU_c, :RU_c] = updates[key][src]
        extend_add_tiles(F, Ucat, *ix.tile)
        skip = set(tm.folded)
    for ci, (pc, (src, dst, idx)) in enumerate(zip(g.pairs, ix.pairs)):
        if ci not in skip:
            _place(Fbuf, updates[(pc.src_level, pc.src_gi)][src], dst, idx,
                   R)

    F11 = F[:, :C, :C]
    F11s = torch.tril(F11) + torch.tril(F11, -1).mT
    ar = torch.arange(C, device=dev)
    live = (ar[:, None] < ix.nc) & (ar[None, :] < ix.nc)        # (B, C, C)
    eye = torch.eye(C, dtype=dtype, device=dev)
    F11m = torch.where(live, F11s, eye)
    F21 = F[:, C:, :C].contiguous() if RU > 0 else None
    if _use_potrf_kernel(dtype, B, C):
        L11, L21 = potrf_trsm(F11m.contiguous(), F21)
        L11 = torch.where(live, L11, 0)
    else:
        L, info = torch.linalg.cholesky_ex(F11m)
        # a failed tile is all NaN, as the reference's XLA cholesky leaves
        # it: the factor's minor is found from non-finite panels
        L = torch.where((info > 0)[:, None, None], torch.nan, L)
        L11 = torch.where(live, L, 0)
        L21 = None
        if RU > 0:
            L21 = torch.linalg.solve_triangular(
                torch.where(live, L11, eye).mT, F21, upper=True, left=False)
    if RU == 0:
        return L11, None
    U = torch.baddbmm(F[:, C:, C:], L21, L21.mT, alpha=-1)
    if skip and g._symm_u:
        # lower-only tile assembly, and a consumer reads U whole
        U = torch.tril(U) + torch.tril(U, -1).mT
    return torch.cat([L11, L21], dim=1), U


def _run_plan(dp: DevicePlan, Cdata: torch.Tensor, dtype: torch.dtype):
    """Every group in level order; returns the padded factor (dev_size,).

    A child update is freed right after the last group that reads it."""
    plan = dp.plan
    order, last = _update_consumers(plan)
    free_after: dict = {}
    for key, pos in last.items():
        free_after.setdefault(pos, []).append(key)
    Lx = torch.empty(plan.dev_size, dtype=dtype, device=Cdata.device)
    updates: dict = {}
    for d, glist in enumerate(plan.groups):
        for gi, (g, ix) in enumerate(zip(glist, dp.groups[d])):
            panel, U = _group_compute(g, ix, Cdata, updates, dtype)
            Lx[g.panel_base:g.panel_base + panel.numel()] = panel.reshape(-1)
            if U is not None and (d, gi) in last:
                updates[(d, gi)] = U
            for key in free_after.get(order[(d, gi)], ()):
                del updates[key]
    return Lx


def compute_dtype(config: Config) -> torch.dtype:
    """The factor's and the solve's dtype under ``config``."""
    if config.update_dtype != "float32":
        raise NotImplementedError(
            "update_dtype other than float32 is not in the port yet "
            "(ROADMAP queue 1)")
    return torch.float64 if config.compute_dtype == "float64" \
        else torch.float32


def factorize_device(A: CSC, S: SupernodalSymbolic, config: Config = DEFAULT,
                     device="cuda", tile_rmin: int = TILE_RMIN):
    """A(p,p) = L L^T on ``device``; a TorchSupernodalFactor (device layout).

    ``minor`` follows the cholmod contract: the first column of the first
    supernode whose panel is not finite, or n on success."""
    from .supernodal import TorchSupernodalFactor

    dev = resolve_device(device)
    dtype = compute_dtype(config)
    dp = device_plan(A, S, dev, tile_rmin)
    Cdata = torch.as_tensor(_clow_data(A, S), device=dev).to(dtype)
    with fp32_precision(config.precision):
        Lx = _run_plan(dp, Cdata, dtype)
    minor = S.n
    if not bool(torch.isfinite(Lx).all()):
        minor = _find_minor(S, dp.plan, Lx.cpu().numpy())
    return TorchSupernodalFactor(S=S, Lx=Lx, minor=minor, dplan=dp)
