"""Multifrontal supernodal solve on the port's device factor (w2 sweep).

Port of the stacked-inverse ("w2") mode of
:mod:`suitesparse_tpu.numeric.supernodal_solve`, the reference's default
solve on its accelerator. Once per factor, every solve group gets the
stacked panel W2 = [W ; L21 W] with W = L11^{-1} (identity on padding). Then
each group costs one batched matmul per sweep, with no dependency chain
inside the group:

    forward   [xc ; v] = W2 yc                (xc = W yc, v = L21 xc)
    backward  xc = W2^T [yc ; -xb]

Contributions move child -> parent along the factor plan's pair classes:
forward, each class's pass-up rows are added into the parent's vector with
``index_add_``; backward, each child gathers its rows of the parent's x.
The reference's class-sorted routing and its opt-in solve modes are not
ported (see ROADMAP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from suitesparse_tpu.config import DEFAULT, Config
from suitesparse_tpu.numeric.supernodal_solve import (
    SolvePlan, _mf_xmap, build_solve_plan)

from ..device import fp32_precision
from .supernodal_device import DevicePlan, compute_dtype

__all__ = ["build_w2", "solve_device"]


@dataclasses.dataclass
class SolveRouting:
    """Index tensors of the multifrontal solve, on the plan's device."""

    splan: SolvePlan
    col_idx: list        # col_idx[d][gi]: (B*C,) rows of the permuted rhs
    classes: list        # classes[d][gi] = [(src key, src, rows)]
    xmap: torch.Tensor   # (n,) row of the concatenated xc holding column j


def _routing(S, dp: DevicePlan) -> SolveRouting:
    """Built once per device plan: ``rows`` flattens (dst, idx) into the
    parent's (B*R + 1) vector rows, with idx < 0 sent to the last (dump) row."""
    if dp.solve is None:
        plan, dev = dp.plan, dp.device

        def t64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        splan = build_solve_plan(S, "device", plan=plan)
        col_idx, classes = [], []
        for glist, sglist in zip(plan.groups, splan.groups):
            col_idx.append([t64(sg.col_idx) for sg in sglist])
            crow = []
            for g in glist:
                cl = []
                for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays):
                    rows = np.where(idx >= 0,
                                    dst.astype(np.int64)[:, None] * g.R + idx,
                                    g.B * g.R)
                    cl.append(((pc.src_level, pc.src_gi), t64(src),
                               t64(rows.ravel())))
                crow.append(cl)
            classes.append(crow)
        dp.solve = SolveRouting(splan=splan, col_idx=col_idx,
                                classes=classes, xmap=t64(_mf_xmap(S, plan)))
    return dp.solve


def _group_panels(Lx: torch.Tensor, sg, dtype):
    """(L11, L21) of one solve group; L11 identity-padded."""
    B, R, C = sg.B, sg.R, sg.C
    P = Lx[sg.panel_base:sg.panel_base + B * R * C].view(B, R, C).to(dtype)
    ar = torch.arange(C, device=Lx.device)
    nc = torch.as_tensor(sg.nc, device=Lx.device).view(B, 1, 1)
    live = (ar[:, None] < nc) & (ar[None, :] < nc)
    eye = torch.eye(C, dtype=dtype, device=Lx.device)
    return torch.where(live, P[:, :C], eye), P[:, C:]


def build_w2(splan: SolvePlan, Lx: torch.Tensor, dtype) -> list:
    """W2[d][gi] = [W ; L21 W] (B, R, C), W = L11^{-1}, for every group.

    Built once per factor in true fp32 whatever the configured precision:
    an error baked into W2 reaches every later solve."""
    out = []
    with fp32_precision("highest"):
        for sglist in splan.groups:
            row = []
            for sg in sglist:
                L11, L21 = _group_panels(Lx, sg, dtype)
                eye = torch.eye(sg.C, dtype=dtype, device=Lx.device)
                W = torch.linalg.solve_triangular(
                    L11, eye.expand(sg.B, sg.C, sg.C), upper=False)
                row.append(torch.cat([W, torch.bmm(L21, W)], dim=1)
                           if sg.R > sg.C else W)
            out.append(row)
    return out


def _mf_solve_fn(dp: DevicePlan, rt: SolveRouting, W2: list,
                 pb: torch.Tensor) -> torch.Tensor:
    """xcat (sum B*C, nrhs) from the permuted rhs ``pb`` (n+1, nrhs) whose
    last row is zero (the dump row that padded columns read)."""
    plan = dp.plan
    nrhs = pb.shape[1]
    dtype, dev = pb.dtype, pb.device

    up: dict = {}      # (level, gi) -> pass-up vectors (B, RU, nrhs)
    yfwd: dict = {}    # (level, gi) -> forward solution (B, C, nrhs)
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            B, R, C = g.B, g.R, g.C
            w = torch.zeros(B * R + 1, nrhs, dtype=dtype, device=dev)
            for key, src, rows in rt.classes[d][gi]:
                w.index_add_(0, rows, up[key][src].reshape(-1, nrhs))
            w = w[:-1].view(B, R, nrhs)
            yc = pb[rt.col_idx[d][gi]].view(B, C, nrhs) - w[:, :C]
            z = torch.bmm(W2[d][gi], yc)
            yfwd[(d, gi)] = z[:, :C]
            if R > C:
                up[(d, gi)] = z[:, C:] + w[:, C:]

    xb: dict = {}      # (level, gi) -> x on the group's below rows
    xcs: dict = {}
    for d in range(len(plan.groups) - 1, -1, -1):
        for gi in range(len(plan.groups[d]) - 1, -1, -1):
            g = plan.groups[d][gi]
            B, R, C = g.B, g.R, g.C
            RU = R - C
            below = xb.pop((d, gi), None)
            if below is None:
                below = torch.zeros(B, max(RU, 1), nrhs, dtype=dtype,
                                    device=dev)
            yc = yfwd.pop((d, gi))
            yin = torch.cat([yc, -below[:, :RU]], dim=1) if RU > 0 else yc
            xc = torch.bmm(W2[d][gi].mT, yin)
            xcs[(d, gi)] = xc
            if not rt.classes[d][gi]:
                continue
            fx = torch.cat([xc, below[:, :RU]], dim=1) if RU > 0 else xc
            fx = torch.cat([fx.reshape(B * R, nrhs),
                            fx.new_zeros(1, nrhs)])
            for key, src, rows in rt.classes[d][gi]:
                cg = plan.groups[key[0]][key[1]]
                buf = xb.get(key)
                if buf is None:
                    buf = torch.zeros(cg.B, cg.R - cg.C, nrhs, dtype=dtype,
                                      device=dev)
                    xb[key] = buf
                buf[src] = fx[rows].view(src.numel(), cg.R - cg.C, nrhs)
    return torch.cat([xcs[(d, gi)].reshape(-1, nrhs)
                      for d in range(len(plan.groups))
                      for gi in range(len(plan.groups[d]))])


def _w2_of(F, dtype, splan: SolvePlan) -> list:
    """W2 cached on the factor, keyed on the factor tensor and the dtype."""
    c = F._w2
    if c is None or c[0] is not F.Lx or c[1] != dtype:
        F._w2 = (F.Lx, dtype, build_w2(splan, F.Lx, dtype))
    return F._w2[2]


def solve_device(F, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """x = A \\ b through the device factor ``F`` (handles the permutation;
    ``b`` is (n,) or (n, nrhs))."""
    S = F.S
    if not F.ok:
        raise ValueError(f"solve_device: the factor failed at column "
                         f"{F.minor}")
    dp = F.dplan
    dtype = compute_dtype(config)
    rt = _routing(S, dp)
    b = np.asarray(b, dtype=np.float64)
    one_d = b.ndim == 1
    bb = b.reshape(-1, 1) if one_d else b
    pbp = np.concatenate([bb[S.perm], np.zeros((1, bb.shape[1]))], axis=0)
    W2 = _w2_of(F, dtype, rt.splan)
    with fp32_precision(config.precision):
        pb = torch.as_tensor(pbp, device=dp.device).to(dtype)
        xcat = _mf_solve_fn(dp, rt, W2, pb)
        yz = xcat[rt.xmap].cpu().numpy().astype(np.float64)
    x = np.empty_like(yz)
    x[S.perm] = yz
    return x[:, 0] if one_d else x
