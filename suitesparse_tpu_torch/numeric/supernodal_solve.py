"""Multifrontal supernodal solve on the port's device factor.

Port of :mod:`suitesparse_tpu.numeric.supernodal_solve`: the solve plan
(per group, the panel offset and the rhs rows of its columns), the
child -> parent routing and the two sweeps of ``_mf_solve_fn``. Both
sweeps walk the factor plan's groups leaves -> root (forward) and back
(backward); per group and sweep:

* ``w2`` (the reference's default on its accelerator): once per factor,
  every group gets the stacked panel W2 = [W ; L21 W] with W = L11^-1
  (identity on padding), and each step is one batched matmul:
  forward ``[xc ; v] = W2 yc``, backward ``xc = W2^T [yc ; -xb]``.
* ``classic`` (the reference's solve everywhere else, and its fallback
  where W2 does not fit): triangular solves on the factor's own panels.
  A group with below rows, B >= 8, C <= 96 and fp32 runs the fused K3
  step kernel (``kernels/solve_step``); any other group solves with the
  K4 batched trisolve kernel (``kernels/trisolve``: B >= 32, C <= 96,
  fp32) or ``torch.linalg.solve_triangular``, then a batched matmul
  applies L21 (forward v = wb + L21 xc, backward y - L21^T xb).

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

from ..config import DEFAULT, SOLVE_MODES, Config
from ..device import fp32_precision
from ..kernels.solve_step import solve_step_bwd, solve_step_fwd, step_fits
from ..kernels.trisolve import batched_trisolve, trisolve_fits
from ..symbolic.supernodes import SupernodalSymbolic
from .supernodal_device import DevicePlan, _use_potrf_kernel, compute_dtype

__all__ = ["SolvePlan", "build_solve_plan", "build_w2", "classic_route",
           "solve_device", "solve_mode"]


@dataclasses.dataclass
class SolveGroup:
    R: int
    C: int
    B: int
    panel_base: int         # Lx[panel_base : +B*R*C] holds the group's panels
    col_idx: np.ndarray     # [B*C] global column ids (pad -> n)
    nc: np.ndarray          # per-slot actual column counts


@dataclasses.dataclass
class SolvePlan:
    groups: list            # groups[level] = [SolveGroup, ...]


def build_solve_plan(S: SupernodalSymbolic, plan) -> SolvePlan:
    """The solve groups of the factor plan ``plan`` (device layout)."""
    groups_all = []
    for glist in plan.groups:
        row = []
        for g in glist:
            cidx = np.full(g.B * g.C, S.n, dtype=np.int64)
            nc_arr = np.zeros(g.B, dtype=np.int32)
            for b, s in enumerate(g.snodes):
                nc = S.ncols(int(s))
                f = int(S.super_first[s])
                nc_arr[b] = nc
                cidx[b * g.C:b * g.C + nc] = np.arange(f, f + nc)
            row.append(SolveGroup(R=g.R, C=g.C, B=g.B,
                                  panel_base=g.panel_base, col_idx=cidx,
                                  nc=nc_arr))
        groups_all.append(row)
    return SolvePlan(groups=groups_all)


def _mf_xmap(S: SupernodalSymbolic, plan) -> np.ndarray:
    """xmap[j] = row of the concatenated per-group xc holding column j."""
    xmap = np.empty(S.n, dtype=np.int64)
    base = 0
    for glist in plan.groups:
        for g in glist:
            for b, s in enumerate(g.snodes):
                f = int(S.super_first[s])
                nc = S.ncols(int(s))
                xmap[f:f + nc] = base + b * g.C + np.arange(nc)
            base += g.B * g.C
    return xmap


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

        splan = build_solve_plan(S, plan)
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
    """(L11, L21) of one solve group: L11 an identity-padded copy, L21 a
    view into ``Lx`` (batch stride R*C, contiguous rows)."""
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


def classic_route(dtype: torch.dtype, B: int, C: int, RU: int,
                  nrhs: int) -> str:
    """Which code solves a group of the classic sweep: ``"solve_step"`` (K3,
    both sweeps in one kernel each), ``"trisolve"`` (K4, then a batched
    matmul for L21) or ``"library"`` (``solve_triangular``, then the
    matmul). The reference's gates, with the card's fit functions in place
    of its VMEM budgets."""
    if RU > 0 and B >= 8 and C <= 96 and dtype == torch.float32 \
            and step_fits(C, RU, nrhs):
        return "solve_step"
    if _use_potrf_kernel(dtype, B, C) and trisolve_fits(C, nrhs):
        return "trisolve"
    return "library"


def _trisolve(route: str, L11, Y, transpose: bool):
    if route == "trisolve":
        return batched_trisolve(L11, Y, transpose=transpose)
    if transpose:
        return torch.linalg.solve_triangular(L11.mT, Y, upper=True)
    return torch.linalg.solve_triangular(L11, Y, upper=False)


def _w2_steps(W2: list):
    """(forward, backward) group steps of the w2 sweep."""
    def fwd(d, gi, yc, wb):
        z = torch.bmm(W2[d][gi], yc)
        C = yc.shape[1]
        return z[:, :C], (None if wb is None else z[:, C:] + wb)

    def bwd(d, gi, yc, xb):
        yin = yc if xb is None else torch.cat([yc, -xb], dim=1)
        return torch.bmm(W2[d][gi].mT, yin)

    return fwd, bwd


def _classic_steps(splan: SolvePlan, Lx: torch.Tensor, L11s: list, dtype):
    """(forward, backward) group steps of the classic sweep."""
    def panels(d, gi, nrhs):
        sg = splan.groups[d][gi]
        L21 = Lx[sg.panel_base:sg.panel_base + sg.B * sg.R * sg.C].view(
            sg.B, sg.R, sg.C)[:, sg.C:]
        route = classic_route(dtype, sg.B, sg.C, sg.R - sg.C, nrhs)
        return L11s[d][gi], L21, route

    def fwd(d, gi, yc, wb):
        L11, L21, route = panels(d, gi, yc.shape[2])
        if route == "solve_step":
            return solve_step_fwd(L11, L21, yc, wb)
        xc = _trisolve(route, L11, yc, False)
        return xc, (None if wb is None else torch.baddbmm(wb, L21, xc))

    def bwd(d, gi, yc, xb):
        L11, L21, route = panels(d, gi, yc.shape[2])
        if route == "solve_step":
            return solve_step_bwd(L11, L21, yc, xb)
        if xb is not None:
            yc = torch.baddbmm(yc, L21.mT, xb, alpha=-1)
        return _trisolve(route, L11, yc, True)

    return fwd, bwd


def _mf_solve_fn(dp: DevicePlan, rt: SolveRouting, pb: torch.Tensor,
                 fwd, bwd) -> torch.Tensor:
    """xcat (sum B*C, nrhs) from the permuted rhs ``pb`` (n+1, nrhs) whose
    last row is zero (the dump row that padded columns read).

    ``fwd(d, gi, yc, wb) -> (xc, v)`` and ``bwd(d, gi, yc, xb) -> xc`` are
    one group's steps (wb, xb, v are None for a group without below rows)."""
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
            xc, v = fwd(d, gi, yc, w[:, C:] if R > C else None)
            yfwd[(d, gi)] = xc
            if R > C:
                up[(d, gi)] = v

    xb: dict = {}      # (level, gi) -> x on the group's below rows
    xcs: dict = {}
    for d in range(len(plan.groups) - 1, -1, -1):
        for gi in range(len(plan.groups[d]) - 1, -1, -1):
            g = plan.groups[d][gi]
            B, R, C = g.B, g.R, g.C
            RU = R - C
            below = xb.pop((d, gi), None)
            if below is None and RU > 0:
                below = torch.zeros(B, RU, nrhs, dtype=dtype, device=dev)
            xc = bwd(d, gi, yfwd.pop((d, gi)), below)
            xcs[(d, gi)] = xc
            if not rt.classes[d][gi]:
                continue
            fx = torch.cat([xc, below], dim=1) if RU > 0 else xc
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


def _w2_fits(F, dtype) -> bool:
    """The reference's W2 capacity gate (``_winv_fits`` and
    ``SSTPU_W2_MAX_CELLS``) on the card's memory: W2 is one more
    factor-sized buffer, and as much again must stay free for its build and
    the sweeps, out of the card's free memory (PyTorch's cached free blocks
    included). A CPU factor always fits."""
    dev = F.Lx.device
    if dev.type != "cuda":
        return True
    need = 2 * F.dplan.plan.dev_size * torch.empty((), dtype=dtype).itemsize
    free, _total = torch.cuda.mem_get_info(dev)
    return need <= free + torch.cuda.memory_reserved(dev) \
        - torch.cuda.memory_allocated(dev)


def solve_mode(F, config: Config = DEFAULT) -> str:
    """The sweep a solve of the device factor ``F`` takes: ``"w2"`` or
    ``"classic"`` (``config.solve_mode``; "auto" is w2 where W2 is already
    built for this factor or fits, else classic)."""
    mode = config.solve_mode
    if mode not in SOLVE_MODES:
        raise ValueError(f"solve_mode must be one of {SOLVE_MODES}, got "
                         f"{mode!r}")
    if mode == "classic":
        return mode
    dtype = compute_dtype(config)
    built = F._solve.get(("w2", dtype))
    if built is not None and built[0] is F.Lx:
        return "w2"
    return "w2" if _w2_fits(F, dtype) else "classic"


def _solve_state(F, mode: str, dtype, splan: SolvePlan) -> list:
    """Per-factor state of a sweep, cached on ``F._solve`` keyed on the mode
    and the dtype and tied to the factor tensor: W2 for ``w2``, the
    identity-padded L11 copies for ``classic``."""
    key = (mode, dtype)
    c = F._solve.get(key)
    if c is None or c[0] is not F.Lx:
        if mode == "w2":
            state = build_w2(splan, F.Lx, dtype)
        else:
            state = [[_group_panels(F.Lx, sg, dtype)[0].contiguous()
                      for sg in sglist] for sglist in splan.groups]
        F._solve[key] = (F.Lx, state)
    return F._solve[key][1]


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
    mode = solve_mode(F, config)
    state = _solve_state(F, mode, dtype, rt.splan)
    steps = _w2_steps(state) if mode == "w2" else \
        _classic_steps(rt.splan, F.Lx.to(dtype), state, dtype)
    b = np.asarray(b, dtype=np.float64)
    one_d = b.ndim == 1
    bb = b.reshape(-1, 1) if one_d else b
    pbp = np.concatenate([bb[S.perm], np.zeros((1, bb.shape[1]))], axis=0)
    with fp32_precision(config.precision):
        pb = torch.as_tensor(pbp, device=dp.device).to(dtype)
        xcat = _mf_solve_fn(dp, rt, pb, *steps)
        yz = xcat[rt.xmap].cpu().numpy().astype(np.float64)
    x = np.empty_like(yz)
    x[S.perm] = yz
    return x[:, 0] if one_d else x
