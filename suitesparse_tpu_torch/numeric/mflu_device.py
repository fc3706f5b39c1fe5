"""Multifrontal LU on the device, symmetric strategy: level-batched square
fronts with partial pivoting within each front.

The port of the JAX package's ``numeric/mflu_device.py`` (UMFPACK's
symmetric strategy: the supernodal analysis of pattern(A + A') from
:func:`.multifrontal_lu.analyze_mflu`, its row pre-permutation applied).
Each front is a full R x R matrix over the supernode's row pattern,
assembled from

  * A's entries of the supernode's columns (L side) and rows (U side), one
    index copy a group (every front cell has one source at most);
  * each child's full square update, added by one ``index_add_`` a pair
    class on the fronts' flattened positions (the reference places it by
    the one-hot matmuls ``P @ U_c @ P^T``, a TPU device the port does not
    carry; ROADMAP, North star).

The fully summed block F11 is factored by batched ``torch.linalg.lu_factor_ex``
with partial pivoting within it (a dead, padded front is masked to the
identity first), L21 = F21 U11^-1 and U12 = L11^-1 P F12 by two batched
triangular solves, and the update F22 - L21 U12 by one ``baddbmm``; it
goes up to the parent group and is let go after its last consumer.

Output layout per group (R, C), the reference's:
  Lpanel  [B, R, C]:  rows 0..C = L11 (unit lower), rows C.. = L21
  Utpanel [B, R, C]:  U11^T then U12^T (stored transposed: lower trapezoid)
and per supernode its pivot permutation (``perms``, B*C a group), which
the solve applies to the supernode's rows of the right-hand side.

The solve (:func:`solve_mflu_device`) sweeps the same groups on the device:
forward ``xc = L11^-1 P y[cols]``, ``y[below] -= L21 xc``; backward
``xc = U11^-1 (y[cols] - U12 y[below])``. The reference solves on the host
in fp64, one supernode at a time, from panels it copies there; the port's
sweep runs in the factor's dtype, a level's supernodes at once.

The reference reaches no Pallas kernel here (``lax.linalg.lu``,
``triangular_solve``, one-hot matmuls), so it is library calls and index
scatters here too. No entry point routes to it: ``mflusol`` factors the
symmetric strategy on the host, as the reference's does (ROADMAP item 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT, Config
from ..device import fp32_precision, resolve_device
from ..sparse import CSC
from ..symbolic.supernodes import SupernodalSymbolic
from .mflu_unsym import lu_perm
from .multifrontal_lu import _perm_general
from .supernodal_device import _C_LADDER, _R_LADDER, _pad_to, compute_dtype

__all__ = ["LUGroupPlan", "LUPlan", "MFLUDeviceFactor", "build_lu_plan",
           "factorize_lu_device", "solve_mflu_device"]


@dataclasses.dataclass
class LUGroupPlan:
    R: int
    C: int
    B: int
    snodes: np.ndarray
    asrc: np.ndarray       # [na] gather into Cg.data
    adst: np.ndarray       # [na] flat dst into (B*R*R), sorted, unique
    nc: np.ndarray
    pairs: list            # [(src_level, src_gi, RU_c, src_slots, dst_slots, idx)]
    panel_base: int


@dataclasses.dataclass
class LUPlan:
    groups: list
    dev_size: int
    n: int


def build_lu_plan(S: SupernodalSymbolic, Cg: CSC, CgT: CSC) -> LUPlan:
    """Index plans; ``Cg`` = general permuted matrix, ``CgT`` its transpose."""
    children: list = [[] for _ in range(S.nsuper)]
    for s in range(S.nsuper):
        if S.sparent[s] != -1:
            children[S.sparent[s]].append(s)

    level_layouts = []
    place = {}             # snode -> (level, gi, slot, group RU)
    panel_off = 0
    for d, level_nodes in enumerate(S.levels):
        buckets: dict = {}
        for s in level_nodes:
            nr, nc = S.nrows(s), S.ncols(s)
            key = (_pad_to(nr - nc, _R_LADDER) + _pad_to(nc, _C_LADDER),
                   _pad_to(nc, _C_LADDER))
            buckets.setdefault(key, []).append(int(s))
        placed = []
        for gi, ((R, C), ss) in enumerate(sorted(buckets.items())):
            maxnc = max(S.ncols(s) for s in ss)
            maxru = max(S.nrows(s) - S.ncols(s) for s in ss)
            C = max(8 * ((maxnc + 7) // 8), 4)
            R = C + 8 * ((maxru + 7) // 8)
            for b, s in enumerate(ss):
                place[s] = (d, gi, b, R - C)
            placed.append((R, C, ss, panel_off))
            panel_off += len(ss) * R * C
        level_layouts.append(placed)

    # CgT entry t -> position of the same entry in Cg.data
    cols_g = np.repeat(np.arange(Cg.ncol, dtype=np.int64), np.diff(Cg.indptr))
    order_g = np.lexsort((cols_g, Cg.indices))   # Cg entries by (row, col)
    colsT = np.repeat(np.arange(CgT.ncol, dtype=np.int64), np.diff(CgT.indptr))
    order_t = np.lexsort((CgT.indices, colsT))   # CgT entries by (col, row)
    t2g = np.empty(CgT.nnz, dtype=np.int64)
    t2g[order_t] = order_g

    groups_all = []
    for placed in level_layouts:
        gplans = []
        for (R, C, ss, pbase) in placed:
            gplans.append(_build_lu_group(S, Cg, CgT, t2g, ss, R, C, place,
                                          children, pbase))
        groups_all.append(gplans)
    return LUPlan(groups=groups_all, dev_size=panel_off, n=S.n)


def _build_lu_group(S, Cg, CgT, t2g, ss, R, C, place, children, pbase):
    B = len(ss)
    a_src, a_dst = [], []
    nc_arr = np.zeros(B, dtype=np.int32)
    pair_cls: dict = {}

    for b, s in enumerate(ss):
        rows = S.rows[s]
        nr = len(rows)
        f, l = int(S.super_first[s]), int(S.super_first[s + 1])
        nc = l - f
        nc_arr[b] = nc
        base = b * R * R

        def fcoord(pos):
            return np.where(pos < nc, pos, C + (pos - nc))

        # column side: entries of supernode columns with row in pattern
        # (covers F11 fully + F21)
        lo, hi = int(Cg.indptr[f]), int(Cg.indptr[l])
        ents = np.diff(Cg.indptr[f:l + 1])
        colk = np.repeat(np.arange(nc, dtype=np.int64), ents)
        rr = Cg.indices[lo:hi]
        keep = rr >= f
        pos = np.searchsorted(rows, rr[keep])
        a_src.append(np.arange(lo, hi, dtype=np.int64)[keep])
        a_dst.append(base + fcoord(pos) * R + colk[keep])

        # row side: entries (j=f+k, c) with c beyond the supernode -> F12
        loT, hiT = int(CgT.indptr[f]), int(CgT.indptr[l])
        entsT = np.diff(CgT.indptr[f:l + 1])
        rowk = np.repeat(np.arange(nc, dtype=np.int64), entsT)
        cc = CgT.indices[loT:hiT]
        posc = np.searchsorted(rows, cc)
        keep2 = (posc >= nc) & (posc < nr) & (rows[np.minimum(posc, nr - 1)]
                                              == cc)
        a_src.append(t2g[np.arange(loT, hiT, dtype=np.int64)[keep2]])
        a_dst.append(base + rowk[keep2] * R + fcoord(posc[keep2]))

        # extend-add from children: full square update into the full front
        for ch in children[s]:
            mu = S.nrows(ch) - S.ncols(ch)
            if mu == 0:
                continue
            dc, gc, slot_c, RU_c = place[ch]
            rows_c = S.rows[ch][S.ncols(ch):]
            idx = fcoord(np.searchsorted(rows, rows_c)).astype(np.int32)
            row = np.full(RU_c, -1, dtype=np.int32)
            row[:mu] = idx
            cls = pair_cls.setdefault((dc, gc), {"RU_c": RU_c, "src": [],
                                                 "dst": [], "idx": []})
            cls["src"].append(slot_c)
            cls["dst"].append(b)
            cls["idx"].append(row)

    asrc = np.concatenate(a_src) if a_src else np.empty(0, np.int64)
    adst = np.concatenate(a_dst) if a_dst else np.empty(0, np.int64)
    order = np.argsort(adst, kind="stable")
    asrc, adst = asrc[order].astype(np.int32), adst[order]

    pairs = []
    for (dc, gc), cls in sorted(pair_cls.items()):
        dst = np.asarray(cls["dst"], dtype=np.int32)
        order = np.argsort(dst, kind="stable")
        pairs.append((dc, gc, cls["RU_c"],
                      np.asarray(cls["src"], dtype=np.int32)[order],
                      dst[order],
                      np.stack(cls["idx"], axis=0)[order]))
    return LUGroupPlan(R=R, C=C, B=B, snodes=np.asarray(ss, dtype=np.int64),
                       asrc=asrc, adst=adst, nc=nc_arr, pairs=pairs,
                       panel_base=pbase)


@dataclasses.dataclass
class _GroupArrays:
    """One group's index arrays on the device."""

    B: int
    R: int
    C: int
    panel_base: int
    perm_base: int         # the group's B*C pivots start here in ``perms``
    asrc: torch.Tensor
    adst: torch.Tensor
    live: torch.Tensor     # [B, C, C] bool: the pivot block of each slot
    eye: torch.Tensor      # [C, C] bool
    pairs: list            # [(child key, src slots, int32 flat dst of the
    #                        class's np*RU_c^2 update cells)]
    last: list             # child keys whose last consumer this group is
    cols: torch.Tensor     # [B*C] global columns of the slots (pad -> n)
    below: torch.Tensor    # [B*max(RU, 1)] global below rows (pad -> n)


def _flat_dst(dst: np.ndarray, idx: np.ndarray, R: int, B: int) -> np.ndarray:
    """Flattened front positions (B*R*R + 1 cells, the last a dump) of a
    pair class's child updates: cell (i, j) of the p-th child goes to
    dst[p]*R*R + idx[p, i]*R + idx[p, j], a padded row or column to the
    dump."""
    idx = idx.astype(np.int64)
    ok = (idx >= 0)[:, :, None] & (idx >= 0)[:, None, :]
    pos = dst.astype(np.int64)[:, None, None] * R * R \
        + idx[:, :, None] * R + idx[:, None, :]
    return np.where(ok, pos, B * R * R).ravel()


def _upload(S: SupernodalSymbolic, plan: LUPlan,
            device: torch.device) -> list:
    """Every group's arrays on ``device``, in plan order."""
    def t64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=device)

    def t32(a):       # the flattened front positions (fronts < 2^31 cells)
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    flat = [(d, gi, g) for d, gl in enumerate(plan.groups)
            for gi, g in enumerate(gl)]
    last: dict = {}
    for k, (_d, _gi, g) in enumerate(flat):
        for (dc, gc, *_rest) in g.pairs:
            last[(dc, gc)] = k
    out, perm_base = [], 0
    for k, (d, gi, g) in enumerate(flat):
        B, R, C = g.B, g.R, g.C
        RU = R - C
        nc = g.nc.astype(np.int64)
        ar = np.arange(C)
        live = (ar[None, :, None] < nc[:, None, None]) & \
            (ar[None, None, :] < nc[:, None, None])
        cols = np.full(B * C, S.n, dtype=np.int64)
        below = np.full(B * max(RU, 1), S.n, dtype=np.int64)
        for b, s in enumerate(g.snodes):
            f = int(S.super_first[s])
            cols[b * C:b * C + nc[b]] = np.arange(f, f + nc[b])
            rows = S.rows[s][nc[b]:]
            below[b * max(RU, 1):b * max(RU, 1) + rows.size] = rows
        if B * R * R >= 2 ** 31:
            raise ValueError(f"an LU front group of {B} x {R} x {R} cells "
                             f"passes the int32 positions")
        pairs = [((dc, gc), t64(src), t32(_flat_dst(dst, idx, R, B)))
                 for (dc, gc, _RU_c, src, dst, idx) in g.pairs]
        out.append(_GroupArrays(
            B=B, R=R, C=C, panel_base=g.panel_base, perm_base=perm_base,
            asrc=t64(g.asrc), adst=t64(g.adst),
            live=torch.as_tensor(live, device=device),
            eye=torch.eye(C, dtype=torch.bool, device=device),
            pairs=pairs, last=[key for key, kk in last.items() if kk == k],
            cols=t64(cols), below=t64(below)))
        perm_base += B * C
    return out


def _run_lu_plan(groups: list, keys: list, cdata: torch.Tensor,
                 dev_size: int, nperm: int):
    """(Lpanels, Utpanels, perms) of every group in plan order."""
    dtype, dev = cdata.dtype, cdata.device
    Lp = torch.zeros(dev_size, dtype=dtype, device=dev)
    Ut = torch.zeros(dev_size, dtype=dtype, device=dev)
    perms = torch.empty(nperm, dtype=torch.int64, device=dev)
    updates: dict = {}
    for key, g in zip(keys, groups):
        B, R, C = g.B, g.R, g.C
        RU = R - C
        F = torch.zeros(B * R * R + 1, dtype=dtype, device=dev)
        F.index_copy_(0, g.adst, cdata[g.asrc])
        for ckey, src, fdst in g.pairs:
            F.index_add_(0, fdst, updates[ckey][src].reshape(-1))
        for ckey in g.last:
            del updates[ckey]
        F = F[:-1].view(B, R, R)
        F11m = torch.where(g.live, F[:, :C, :C], g.eye)
        LU, piv, _info = torch.linalg.lu_factor_ex(F11m, check_errors=False)
        perm = lu_perm(LU, piv)
        perms[g.perm_base:g.perm_base + B * C] = perm.reshape(-1)
        L11 = torch.where(g.live, LU.tril(-1), 0.0) + g.eye
        U11 = torch.where(g.live, LU.triu(), g.eye)
        Lout = Lp[g.panel_base:g.panel_base + B * R * C].view(B, R, C)
        Uout = Ut[g.panel_base:g.panel_base + B * R * C].view(B, R, C)
        Lout[:, :C] = torch.where(g.live, L11, 0.0)
        Uout[:, :C] = torch.where(g.live, U11, 0.0).mT
        if RU > 0:
            L21 = torch.linalg.solve_triangular(U11, F[:, C:, :C],
                                                upper=True, left=False)
            F12p = F[:, :C, C:].gather(1, perm[:, :, None].expand(B, C, RU))
            U12 = torch.linalg.solve_triangular(L11, F12p, upper=False,
                                                unitriangular=True)
            updates[key] = torch.baddbmm(F[:, C:, C:], L21, U12, alpha=-1.0)
            Lout[:, C:] = L21
            Uout[:, C:] = U12.mT
    return Lp, Ut, perms


@dataclasses.dataclass
class MFLUDeviceFactor:
    S: SupernodalSymbolic
    Lpanels: torch.Tensor  # device tensor, padded group layout
    Utpanels: torch.Tensor
    perms: torch.Tensor    # [sum B*C] per-supernode pivot perms (local)
    minor: int
    groups: list = dataclasses.field(default=None, repr=False)
    precision: str = "highest"

    @property
    def ok(self) -> bool:
        return self.minor == self.S.n


def _cg_data(A: CSC, S: SupernodalSymbolic) -> np.ndarray:
    """Values of _perm_general(A, S) via a cached position map (steady-state
    factor-many does no per-call host symbolic work, like _clow_data)."""
    key = A.pattern_key()
    cache = getattr(S, "_cg_map", None)
    if cache is None or cache[0] != key:
        trace = CSC(A.nrow, A.ncol, A.indptr, A.indices,
                    np.arange(A.nnz, dtype=np.float64), A.sym)
        Cg = _perm_general(trace, S)
        S._cg_map = (key, Cg.data.astype(np.int64))
    return A.data[S._cg_map[1]]


def _device_groups(A: CSC, S: SupernodalSymbolic, device: torch.device):
    """(host plan, groups' arrays on ``device``, plan-order keys), the plan
    built once on ``S`` and its upload cached there per device."""
    plan = getattr(S, "_mflu_dev_plan", None)
    if plan is None:
        Cg = _perm_general(A, S)
        plan = build_lu_plan(S, Cg, Cg.transpose())
        S._mflu_dev_plan = plan
        S._torch_mflu = {}
    uploads = S._torch_mflu
    if str(device) not in uploads:
        uploads[str(device)] = _upload(S, plan, device)
    keys = [(d, gi) for d, gl in enumerate(plan.groups)
            for gi in range(len(gl))]
    return plan, uploads[str(device)], keys


def factorize_lu_device(A: CSC, S: SupernodalSymbolic,
                        config: Config = DEFAULT,
                        device="cuda") -> MFLUDeviceFactor:
    """The LU panels of A (rows pre-permuted by ``S._rowpre``, then
    symmetrically by ``S.perm``) on ``device`` in ``config.compute_dtype``,
    the fp32 products under ``config.precision``. ``minor`` is 0 when a
    panel comes out non-finite, else n."""
    if np.iscomplexobj(A.data):
        raise ValueError("the device LU factor is real-only")
    dev = resolve_device(device)
    plan, groups, keys = _device_groups(A, S, dev)
    dtype = compute_dtype(config)
    cdata = torch.as_tensor(_cg_data(A, S), device=dev).to(dtype)
    nperm = sum(g.B * g.C for g in groups)
    with fp32_precision(config.precision):
        Lp, Ut, perms = _run_lu_plan(groups, keys, cdata, plan.dev_size,
                                     nperm)
    ok = bool(torch.isfinite(Lp).all()) and bool(torch.isfinite(Ut).all())
    return MFLUDeviceFactor(S=S, Lpanels=Lp, Utpanels=Ut, perms=perms,
                            minor=S.n if ok else 0, groups=groups,
                            precision=config.precision)


def solve_mflu_device(F: MFLUDeviceFactor, b: np.ndarray) -> np.ndarray:
    """x = A \\ b through the device factor: the forward sweep (pivot
    permutation, unit L11, L21 into the ancestors' rows) and the backward
    sweep (U12 from the ancestors' x, U11), a group at a time on the
    factor's device in its dtype; ``b`` is (n,) or (n, nrhs)."""
    if not F.ok:
        raise ValueError("solve_mflu_device: the factor is not finite")
    S = F.S
    b = np.asarray(b, dtype=np.float64)
    one_d = b.ndim == 1
    bb = b.reshape(-1, 1) if one_d else b
    rowpre = getattr(S, "_rowpre", None)
    if rowpre is not None:
        bb = bb[rowpre]
    n, nrhs = S.n, bb.shape[1]
    dtype, dev = F.Lpanels.dtype, F.Lpanels.device
    y = torch.zeros(n + 1, nrhs, dtype=dtype, device=dev)
    y[:n] = torch.as_tensor(bb[S.perm], device=dev).to(dtype)

    def panels(g):
        size = g.B * g.R * g.C
        return (F.Lpanels[g.panel_base:g.panel_base + size].view(
                    g.B, g.R, g.C),
                F.Utpanels[g.panel_base:g.panel_base + size].view(
                    g.B, g.R, g.C))

    with fp32_precision(F.precision):
        for g in F.groups:                                # leaves -> root
            B, C, RU = g.B, g.C, g.R - g.C
            Lg, _Ug = panels(g)
            perm = F.perms[g.perm_base:g.perm_base + B * C].view(B, C, 1)
            yc = y[g.cols].view(B, C, nrhs).gather(
                1, perm.expand(B, C, nrhs))
            xc = torch.linalg.solve_triangular(Lg[:, :C], yc, upper=False,
                                               unitriangular=True)
            y[g.cols] = xc.reshape(-1, nrhs)
            if RU > 0:
                y.index_add_(0, g.below,
                             torch.bmm(Lg[:, C:], xc).view(-1, nrhs),
                             alpha=-1)
            y[n] = 0
        for g in reversed(F.groups):                      # root -> leaves
            B, C, RU = g.B, g.C, g.R - g.C
            _Lg, Ug = panels(g)
            rhs = y[g.cols].view(B, C, nrhs)
            if RU > 0:
                rhs = torch.baddbmm(rhs, Ug[:, C:].mT,
                                    y[g.below].view(B, RU, nrhs), alpha=-1)
            U11 = torch.where(g.live, Ug[:, :C].mT, g.eye)
            xc = torch.linalg.solve_triangular(U11, rhs, upper=True)
            y[g.cols] = xc.reshape(-1, nrhs)
            y[n] = 0
    yz = y[:n].cpu().numpy().astype(np.float64)
    x = np.empty_like(yz)
    x[S.perm] = yz
    return x[:, 0] if one_d else x
