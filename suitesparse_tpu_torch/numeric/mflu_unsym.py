"""Unsymmetric multifrontal LU on the device: matched fronts, partial pivoting.

The port of the JAX package's ``numeric/mflu_unsym.py``. Reference analog:
UMFPACK's UNSYMMETRIC strategy (``umfpack_qsymbolic.c``: COLAMD column order
and column-etree frontal matrices; numeric kernel ``umf_kernel.c`` with
threshold partial pivoting in ``umf_local_search.c``).

The static shapes rest on a WEIGHTED row-column MATCHING (the MC64-style
static-pivoting pre-step of SuperLU_DIST; ``native/src/wmatch.cc`` maximizes
the product of matched magnitudes, so the home pivot blocks are numerically
strong, not merely structurally nonsingular):

  * every row is HOME at the front owning its matched column; each front's
    pivot block is the square block of its nc home rows x nc pivot columns,
    which carries a perfect structural matching, so partial pivoting within
    it (batched ``torch.linalg.lu_factor_ex``) cannot run out of structural
    support (the failure UMFPACK resolves by delaying pivots, which static
    shapes cannot express);
  * a row whose leftmost column lives in a descendant front enters there as
    a FOREIGN row: it receives that front's eliminations and passes up the
    contribution block in a static order, so the plan knows every row's
    position in every front it visits;
  * the right-hand side rides as extra columns, so the forward substitution
    happens inside the elimination, and the backward sweep over the stored
    U panels is the QR's R backsolve (:func:`.mfqr_device.qr_solve_device`),
    which takes every position from the plan.

The host parts (the analysis and :func:`build_lu_unsym_plan`) are copied;
the matching is native only (the reference's structural ``maxtrans``
fallback without its C++ library is not copied); the plan lists each
front's children once, where the reference scans every lower supernode for
each front (quadratic in the supernodes), with the same result. The device part runs on torch tensors, a group at a
time: one gather of its fronts from the flat pool (every front cell has one
source at most, :func:`.mfqr_device.gather_index`), the dead unit pivots of
the padded columns, a batched LU of the home blocks, the GESP bump of tiny
pivots, the home rows' trailing columns permuted by an index gather, two
batched triangular solves, one ``baddbmm`` for the contribution block, and
the stored panel's rows written into the pool by an index. The reference
reaches no Pallas kernel here (``lax.linalg.lu``, ``triangular_solve`` and
one-hot matmuls), so it is library calls and gathers here too.

Tiny home pivots are perturbed (GESP); a second pass with a relaxed
perturbation replays the factor when a panel comes out non-finite; fp64
iterative refinement, a repair by the device multifrontal QR and the host
KLU path (:func:`.lu.lusol`) guard the last mile (:func:`mflusol_unsym`).
Past ``Config.segment_bytes`` (or its auto budget on the card) the factor,
its relaxed pass and the sweep upload the groups' index arrays a segment at
a time (:mod:`.segmented`, the reference's ``run_qrplan_segmented``), the
QR's runner with the LU's group body. Complex input to :func:`mflusol_unsym`
runs this real LU on the 2x2 real embedding
(:func:`.complex_embed.lusol_complex_device`), as in the reference; the
device factor itself is real-only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..config import DEFAULT, Config
from ..device import fp32_precision, resolve_device
from ..sparse import CSC, residual_norm
from . import lu
from . import mfqr_device as md
from .mfqr_device import (MFQRDeviceFactor, NonFiniteFactor, QRGroupPlan,
                          QRPlan, _pad8, mfqrsol_device, qr_solve_device)
from .multifrontal_qr import QRSymbolicMF, _children, analyze_mfqr

__all__ = ["LUUnsymSymbolic", "analyze_mflu_unsym", "build_lu_unsym_plan",
           "factorize_lu_unsym_device", "lu_unsym_solve_device",
           "mflusol_unsym", "lu_flops"]

# device factor passes run (each refinement step is a whole factor, the
# right-hand side riding along), those of them at the relaxed tau, and the
# factors that ran in segments
device_factors = 0
relaxed_factors = 0
segmented_factors = 0
# the rung of the escalation ladder that answered each mflusol_unsym call
rungs = {"lu": 0, "relaxed": 0, "qr": 0, "klu": 0}
TAU_REL = 1e-6          # GESP perturbation of a tiny home pivot
TAU_RELAXED = 1e-3      # the second pass's, when a panel is non-finite


@dataclasses.dataclass
class LUUnsymSymbolic:
    SQ: QRSymbolicMF            # column analysis (COLAMD + column etree)
    rowpre: np.ndarray          # row matching: Ap = A[rowpre, :] has the
                                # matched row of column j AT row j
    home: np.ndarray            # (permuted) row r's home supernode
    enter: np.ndarray           # (permuted) row r enters at this supernode
    front_rows: list            # per supernode: permuted row ids, home first
    nforeign: np.ndarray        # foreign (pass-through) rows per front


def _complete_matching(A: CSC, match: np.ndarray) -> tuple:
    """Augment a partial row-for-column matching over A's structural
    pattern (Kuhn alternating paths, iterative): existing pairs are KEPT
    — the weighted matcher chose them for pivot magnitude — and only the
    columns it left unmatched (all-stored-zero columns) get new rows."""
    n = A.ncol
    indptr, indices = A.indptr, A.indices
    rowof = np.asarray(match, dtype=np.int64).copy()
    rmatch = np.full(A.nrow, -1, dtype=np.int64)
    for j in range(n):
        if rowof[j] >= 0:
            rmatch[rowof[j]] = j
    for j0 in np.flatnonzero(rowof < 0):
        seen = np.zeros(A.nrow, dtype=bool)
        # iterative DFS over alternating paths; frame = [col, cursor, row]
        stack = [[int(j0), int(indptr[j0]), -1]]
        while stack:
            fr = stack[-1]
            j, p = fr[0], fr[1]
            if p >= indptr[j + 1]:
                stack.pop()
                if stack:
                    stack[-1][1] += 1
                    stack[-1][2] = -1
                continue
            r = int(indices[p])
            if seen[r]:
                fr[1] += 1
                continue
            seen[r] = True
            fr[2] = r
            if rmatch[r] < 0:
                # augment: every frame's current (col, row) edge flips
                for (cj, _, cr) in stack:
                    rowof[cj] = cr
                    rmatch[cr] = cj
                break
            stack.append([int(rmatch[r]), int(indptr[rmatch[r]]), -1])
    return int((rowof >= 0).sum()), rowof


def analyze_mflu_unsym(A: CSC, config: Config = DEFAULT) -> LUUnsymSymbolic:
    """The weighted matching (completed over the pattern where stored
    zeros left a column unmatched), the column analysis of the matched
    matrix (COLAMD, the front tree of its A'A), each row's home and entry
    front and each front's rows. Raises ``ValueError`` for a non-square or
    structurally singular A."""
    m, n = A.shape
    if m != n:
        raise ValueError("unsymmetric multifrontal LU expects square A")
    nmatch, match = native.wmatch(m, n, A.indptr, A.indices, A.data)
    if nmatch < n:
        # wmatch treats stored zeros as absent edges: complete the matching
        # over the structural pattern, keeping every weighted pair
        nmatch, match = _complete_matching(A, match)
    if nmatch != n:
        raise ValueError("structurally singular matrix (no full transversal)")
    # Ap has the matched entry of column j on the diagonal
    Ap = A.permuted(match, None)
    SQ = analyze_mfqr(Ap, config)
    S = SQ.S
    # Aq = Ap[:, q]: permuted row r is matched to the k with q[k] = r
    qinv = np.empty(n, dtype=np.int64)
    qinv[SQ.q] = np.arange(n)
    home = S.snode_of_col[qinv]
    # entry front: leftmost column of the PERMUTED row (the QR's rule; the
    # rows of Aq' are sorted, so the leftmost is the first)
    AqT = Ap.permuted(None, SQ.q).transpose(values=False)
    if not (np.diff(AqT.indptr) > 0).all():
        raise ValueError("structurally singular matrix (an empty row)")
    enter = S.snode_of_col[AqT.indices[AqT.indptr[:-1]]]
    # front row lists: home rows (in pivot-column order) first, then the
    # rows in transit from their entry front up to their home
    front_rows = []
    nforeign = np.zeros(S.nsuper, dtype=np.int64)
    transit: list = [[] for _ in range(S.nsuper)]
    for r in range(n):
        s = int(enter[r])
        h = int(home[r])
        while s != h:
            transit[s].append(r)
            s = int(S.sparent[s])
            if s == -1:
                raise RuntimeError(f"row {r} never reached its home front")
    for s in range(S.nsuper):
        f = int(S.super_first[s])
        nc = S.ncols(s)
        front_rows.append(np.concatenate(
            [SQ.q[f:f + nc], np.asarray(transit[s], dtype=np.int64)]))
        nforeign[s] = len(transit[s])
    return LUUnsymSymbolic(SQ=SQ, rowpre=match, home=home, enter=enter,
                           front_rows=front_rows, nforeign=nforeign)


def build_lu_unsym_plan(SL: LUUnsymSymbolic, Aq: CSC, nrhs: int) -> QRPlan:
    """Static plan over matched fronts (the reference's
    ``build_lu_unsym_plan``): ``QRGroupPlan`` groups whose stored panel per
    front holds [U rows (nc) | CB rows (nforeign)], in a GAPPED column
    layout: pivot columns at [0, nc), padding to Cg, the beyond-pivot
    columns from Cg, the right-hand sides after them."""
    SQ = SL.SQ
    S = SQ.S
    n = S.n
    # Aq's entries in (row, col) order: AqT's entry t is Aq's src_of_T[t]
    cols_g = np.repeat(np.arange(n, dtype=np.int64), np.diff(Aq.indptr))
    src_of_T = np.lexsort((cols_g, Aq.indices))
    AqT = Aq.transpose(values=False)
    children = _children(S)

    pool_data = 1 + Aq.nnz + n * nrhs
    pool_off = pool_data
    level_layouts = []
    place = {}
    for d, level_nodes in enumerate(S.levels):
        buckets: dict = {}
        for s in level_nodes:
            nf = len(S.rows[s])
            nc = S.ncols(s)
            mrows = nc + int(SL.nforeign[s])
            key = (_pad8(nc, lo=4), _pad8(mrows),
                   _pad8(nf - nc + nrhs, lo=8))
            buckets.setdefault(key, []).append(int(s))
        placed = []
        for gi, (_, ss) in enumerate(sorted(buckets.items())):
            # the home-block slice [:, :Cg, :Cg] holds ONLY pivot columns,
            # so dead unit pivots are safe to inject
            Cg = _pad8(max(S.ncols(s) for s in ss), lo=4)
            N = Cg + _pad8(max(len(S.rows[s]) - S.ncols(s) for s in ss)
                           + nrhs, lo=8)
            M = Cg + _pad8(max(int(SL.nforeign[s]) for s in ss), lo=8)
            K = _pad8(max(S.ncols(s) + int(SL.nforeign[s]) for s in ss))
            for b, s in enumerate(ss):
                place[s] = (d, gi, b, K, N, Cg)
            placed.append((M, N, K, Cg, ss, pool_off))
            pool_off += len(ss) * K * N
        level_layouts.append(placed)

    # row position inside each front: homes at their pivot index, foreigners
    # after Cg in transit order (static everywhere)
    groups_all = []
    for placed in level_layouts:
        glist = []
        for (M, N, K, Cg, ss, pbase) in placed:
            B = len(ss)
            a_src, a_dst = [], []
            nc_arr = np.zeros(B, dtype=np.int32)
            col_idx = np.full(B * N, n, dtype=np.int64)
            rhs_col = np.empty((B, nrhs), dtype=np.int64)
            beyond = []
            row_col = np.full(B * K, n, dtype=np.int64)
            pair_cls: dict = {}
            for b, s in enumerate(ss):
                cols = S.rows[s]
                nf = len(cols)
                nc = S.ncols(s)
                nc_arr[b] = nc
                base = b * M * N

                def gcol(pos):
                    return np.where(pos < nc, pos, Cg + (pos - nc))

                col_idx[b * N:b * N + nc] = cols[:nc]
                col_idx[b * N + Cg:b * N + Cg + (nf - nc)] = cols[nc:]
                rhs_col[b] = Cg + (nf - nc) + np.arange(nrhs)
                beyond.append(b * N + Cg + np.arange(nf - nc))
                row_col[b * K:b * K + nc] = np.arange(
                    S.super_first[s], S.super_first[s] + nc)
                rows_s = SL.front_rows[s]
                pos_of = {int(r): k for k, r in enumerate(rows_s[:nc])}
                for t, r in enumerate(rows_s[nc:]):
                    pos_of[int(r)] = Cg + t
                # A rows entering here
                for r in rows_s:
                    r = int(r)
                    if int(SL.enter[r]) != s:
                        continue
                    lo, hi = int(AqT.indptr[r]), int(AqT.indptr[r + 1])
                    cpos = gcol(np.searchsorted(cols, AqT.indices[lo:hi]))
                    rowp = pos_of[r]
                    a_src.append(src_of_T[lo:hi])
                    a_dst.append(base + rowp * N + cpos)
                    a_src.append(Aq.nnz + r * nrhs + np.arange(nrhs))
                    a_dst.append(base + rowp * N + Cg + (nf - nc)
                                 + np.arange(nrhs))
                # children's CB rows: their foreign rows in static order
                for c in children[s]:
                    nfo_c = int(SL.nforeign[c])
                    if nfo_c == 0:
                        continue
                    dc, gc, slot_c, Kc, Nc, Cgc = place[c]
                    cols_c = S.rows[c]
                    nc_c = S.ncols(c)
                    nf_c = len(cols_c)
                    cpos = gcol(np.searchsorted(cols, cols_c[nc_c:]))
                    rowmap = np.full(Kc, -1, dtype=np.int32)
                    rowmap[nc_c:nc_c + nfo_c] = [
                        pos_of[int(r)] for r in SL.front_rows[c][nc_c:]]
                    # the child's stored columns are in ITS gapped layout
                    colmap = np.full(Nc, -1, dtype=np.int32)
                    colmap[Cgc:Cgc + (nf_c - nc_c)] = cpos
                    colmap[Cgc + (nf_c - nc_c):Cgc + (nf_c - nc_c) + nrhs] = \
                        Cg + (nf - nc) + np.arange(nrhs)
                    cls = pair_cls.setdefault(
                        (dc, gc), {"Kc": Kc, "Nc": Nc, "src": [], "dst": [],
                                   "rowmap": [], "colmap": []})
                    cls["src"].append(slot_c)
                    cls["dst"].append(b)
                    cls["rowmap"].append(rowmap)
                    cls["colmap"].append(colmap)
            asrc = (np.concatenate(a_src) if a_src
                    else np.empty(0, np.int64)).astype(np.int64)
            adst = (np.concatenate(a_dst) if a_dst
                    else np.empty(0, np.int64)).astype(np.int64)
            order = np.argsort(adst, kind="stable")
            asrc, adst = asrc[order], adst[order]
            pairs = []
            for (dc, gc), cls in sorted(pair_cls.items()):
                dst = np.asarray(cls["dst"], dtype=np.int32)
                order = np.argsort(dst, kind="stable")
                pairs.append((dc, gc, cls["Kc"], cls["Nc"],
                              np.asarray(cls["src"], dtype=np.int32)[order],
                              dst[order],
                              np.stack(cls["rowmap"], axis=0)[order],
                              np.stack(cls["colmap"], axis=0)[order]))
            glist.append(QRGroupPlan(M=M, N=N, K=K, B=B,
                                     snodes=np.asarray(ss, dtype=np.int64),
                                     asrc=asrc, adst=adst, nc=nc_arr,
                                     pairs=pairs, panel_base=pbase,
                                     col_idx=col_idx, rhs_col=rhs_col,
                                     beyond=np.concatenate(beyond),
                                     row_col=row_col, Cg=Cg,
                                     fm=nc_arr.copy()))
        groups_all.append(glist)
    return QRPlan(groups=groups_all, pool_data=pool_data, pool_size=pool_off,
                  nrhs=nrhs, n=n)


def plan_cells(plan: QRPlan) -> int:
    """The reference's working-set estimate of a plan in cells
    (``segmented.qrplan_total_cells``), which its segmented switch reads
    (the port's switch reads bytes: :mod:`.segmented`)."""
    cells = 0
    for gl in plan.groups:
        for g in gl:
            cells += 2 * g.B * g.M * g.N + g.B * g.K * g.N
            for (_dc, _gc, Kc, Nc, psrc, *_maps) in g.pairs:
                cells += len(psrc) * (g.M * Kc + g.M * Nc + Nc * g.N
                                      + g.M * g.N)
    return cells


@dataclasses.dataclass
class _LUGroupArrays:
    """One group's arrays of the LU factor (beside the gather and sweep
    arrays of the QR's)."""

    Cg: int
    dead: torch.Tensor     # [B, Cg] bool: the padded pivot columns of a slot
    osel: torch.Tensor     # [B*K] row of the finished front each panel row
                           # takes (U rows, then CB rows at Cg + k - nc)
    ozero: torch.Tensor | None   # panel rows no front row reaches (zeroed)


def _host_arrays(plan: QRPlan) -> list:
    """The QR's host arrays of each group with the LU's attached."""
    out = md._host_arrays(plan)
    for ga, g in zip(out, (g for gl in plan.groups for g in gl)):
        B, M, K, Cg = g.B, g.M, g.K, g.Cg
        nc = g.nc.astype(np.int64)[:, None]
        k = np.arange(K)[None, :]
        row = np.where(k < nc, k, Cg + k - nc)       # [B, K] front row
        keep = row < M
        osel = np.where(keep, np.arange(B)[:, None] * M + row, 0)
        zero = np.flatnonzero(~keep.ravel())
        ga.lu = _LUGroupArrays(
            Cg=Cg, dead=torch.as_tensor(np.arange(Cg)[None, :] >= nc),
            osel=torch.as_tensor(osel.ravel()),
            ozero=torch.as_tensor(zero) if zero.size else None)
    return out


def _plan_entry(SL: LUUnsymSymbolic, A: CSC, nrhs: int,
                device: torch.device) -> md.QRDevicePlan:
    def build():
        plan = build_lu_unsym_plan(SL, A.permuted(SL.rowpre, SL.SQ.q), nrhs)
        return plan, _host_arrays(plan)

    return md._entry(SL, "_torch_lu", nrhs, device, build)


def device_plan(SL: LUUnsymSymbolic, A: CSC, nrhs: int,
                device: torch.device) -> md.QRDevicePlan:
    """The LU plan of ``SL`` at ``nrhs`` right-hand sides with every
    group's index arrays on ``device``, built and uploaded once and cached
    on ``SL``, keyed by both; the dtype and the precision apply at each
    call."""
    return md._upload(_plan_entry(SL, A, nrhs, device))


def _value_map(SL: LUUnsymSymbolic, A: CSC) -> np.ndarray:
    """Aq.data = A.data[vmap] for A(rowpre, q), built once on ``SL``."""
    vmap = getattr(SL, "_vmap", None)
    if vmap is None:
        trace = CSC(A.nrow, A.ncol, A.indptr, A.indices,
                    np.arange(A.nnz, dtype=np.float64), 0)
        vmap = trace.permuted(SL.rowpre, SL.SQ.q).data.astype(np.int64)
        SL._vmap = vmap
    return vmap


def lu_perm(LU: torch.Tensor, pivots: torch.Tensor) -> torch.Tensor:
    """The row permutation of ``lu_factor_ex``'s sequential swaps: perm
    with (P'H)[i] = H[perm[i]], the reference's ``lax.linalg.lu`` perm."""
    P = torch.lu_unpack(LU, pivots, unpack_data=False)[0]   # H = P L U
    return P.argmax(dim=1)


def _factor_group(g, lg: _LUGroupArrays, pool: torch.Tensor,
                  tau_rel: float) -> None:
    """One matched-front group: its fronts gathered from the pool, the
    batched LU of the home blocks with tiny pivots bumped, the home rows'
    trailing columns (the right-hand sides among them) through L11, the
    foreign rows' multipliers and contribution block, and the stored panel
    (U rows, then CB rows) written into the pool."""
    B, M, N, K, Cg = g.B, g.M, g.N, g.K, lg.Cg
    F = pool.index_select(0, g.gidx).view(B, M, N)
    # home block: the nc live matched rows and dead unit rows (j, j) for
    # the padded pivot columns (those cells hold no source, so 0 + 1)
    H = F[:, :Cg, :Cg].clone()
    H.diagonal(dim1=1, dim2=2).masked_fill_(lg.dead, 1.0)
    LU, piv, _info = torch.linalg.lu_factor_ex(H, check_errors=False)
    perm = lu_perm(LU, piv)
    # GESP: a pivot below tau (|H|'s largest, at least 1, times tau_rel)
    # becomes +-tau; an exactly zero one +tau
    tau = H.abs().amax(dim=(1, 2)).clamp_(min=1.0).mul_(tau_rel)[:, None]
    d = LU.diagonal(dim1=1, dim2=2)
    d.copy_(torch.where(d.abs() < tau, torch.where(d < 0, -tau, tau), d))
    F12p = F[:, :Cg, Cg:].gather(1, perm[:, :, None].expand(B, Cg, N - Cg))
    U12y = torch.linalg.solve_triangular(LU, F12p, upper=False,
                                         unitriangular=True)
    # the foreign rows keep their static order: L21 = F21 U11^-1
    L21 = torch.linalg.solve_triangular(LU, F[:, Cg:, :Cg], upper=True,
                                        left=False)
    CB = torch.baddbmm(F[:, Cg:, Cg:], L21, U12y, alpha=-1.0)
    F[:, :Cg, :Cg] = LU.triu_()
    F[:, :Cg, Cg:] = U12y
    F[:, Cg:, :Cg] = 0.0
    F[:, Cg:, Cg:] = CB
    out = pool[g.panel_base:g.panel_base + B * K * N].view(B * K, N)
    torch.index_select(F.view(B * M, N), 0, lg.osel, out=out)
    if lg.ozero is not None:
        out.index_fill_(0, lg.ozero, 0.0)


def _factor(arrays, pool: torch.Tensor, pool_data: int, tau_rel: float,
            precision: str) -> bool:
    """Every group of ``arrays`` ((position, arrays on the device) in plan
    order); True when every panel is finite."""
    global device_factors
    with fp32_precision(precision):
        for _pos, g in arrays:
            _factor_group(g, g.lu, pool, tau_rel)
    device_factors += 1
    return bool(torch.isfinite(pool[pool_data:]).all())


def factorize_lu_unsym_device(A: CSC, SL: LUUnsymSymbolic, b: np.ndarray,
                              config: Config = DEFAULT,
                              device="cuda") -> MFQRDeviceFactor:
    """The stored U panels of A(rowpre, q) with L^-1 P b in their
    right-hand-side columns, on ``device`` in ``config.compute_dtype``; in
    segments past ``config.segment_bytes`` (:mod:`.segmented`). A second
    pass at tau 1e-3 replays the factor when a panel comes out non-finite
    (in the same segments); :class:`.mfqr_device.NonFiniteFactor` when that
    one does too."""
    global relaxed_factors, segmented_factors
    if np.iscomplexobj(A.data) or np.iscomplexobj(b):
        raise ValueError(
            "the device LU factor is real-only: complex input takes "
            "mflusol_unsym, which runs it on the 2x2 real embedding")
    dev = resolve_device(device)
    bb = np.asarray(b, dtype=np.float64)
    bb = (bb.reshape(-1, 1) if bb.ndim == 1 else bb)[SL.rowpre]
    dp = _plan_entry(SL, A, bb.shape[1], dev)
    plan = dp.plan
    dtype = torch.float64 if config.compute_dtype == "float64" \
        else torch.float32
    groups, segs = md._segments(dp, dtype, config)
    src = torch.from_numpy(np.concatenate(
        [A.data[_value_map(SL, A)], bb.ravel(), [0.0]])).to(dev, dtype)
    pool = torch.empty(plan.pool_size, dtype=dtype, device=dev)
    pool[:plan.pool_data] = src

    def passes(tau_rel):
        return _factor(md._walk(dp, groups, segs, md._factor_part), pool,
                       plan.pool_data, tau_rel, config.precision)

    ok = passes(TAU_REL)
    if not ok:
        # device-local stand-in for UMFPACK's delayed pivots: the same
        # factor with a stronger perturbation (refinement absorbs it)
        relaxed_factors += 1
        ok = passes(TAU_RELAXED)
    if not ok:
        raise NonFiniteFactor("unsymmetric multifrontal LU produced "
                              "non-finite panels")
    if segs is not None:
        segmented_factors += 1
    return MFQRDeviceFactor(SQ=SL.SQ, dplan=dp, pool=pool, ok=ok,
                            precision=config.precision, groups=groups,
                            segments=segs)


def lu_unsym_solve_device(A: CSC, b: np.ndarray, config: Config = DEFAULT,
                          SL: LUUnsymSymbolic | None = None,
                          device="cuda") -> np.ndarray:
    """Factor + solve Ax = b with the right-hand side riding through the
    elimination (umfpack_wsolve-style one-shot), then the backward sweep
    over the U panels. Pass a cached ``SL`` from
    :func:`analyze_mflu_unsym` for the analyze-once/solve-many regime: the
    plan is cached on it per nrhs and device."""
    if SL is None:
        SL = analyze_mflu_unsym(A, config)
    F = factorize_lu_unsym_device(A, SL, b, config, device)
    x = qr_solve_device(F)
    return x[:, 0] if np.asarray(b).ndim == 1 else x


def mflusol_unsym(A: CSC, b: np.ndarray, config: Config = DEFAULT,
                  device="cuda") -> np.ndarray:
    """One-call unsymmetric multifrontal LU solve with iterative refinement
    and device-local recovery from truly deficient fronts.

    The escalation ladder (UMFPACK's delayed-pivot role, re-designed for
    static shapes; the rung that answers is counted in :data:`rungs`):

      1. the matched-front LU on ``device``, tiny pivots perturbed (GESP,
         tau 1e-6), a second pass at tau 1e-3 if a panel is non-finite
         (``"lu"``, or ``"relaxed"`` when that pass ran);
      2. fp64-residual iterative refinement, each step a whole factor with
         the residual riding along;
      3. if that stalls above 1e-9 (an EXACTLY singular home block, which
         no perturbation fixes), the multifrontal QR on ``device``
         (:func:`.mfqr_device.mfqrsol_device`) with refinement: orthogonal
         elimination needs no pivots (``"qr"``);
      4. the host KLU path (:func:`.lu.lusol`, cross-front partial
         pivoting) for inputs the QR also rejects (``"klu"``).

    A non-finite factor (:class:`.mfqr_device.NonFiniteFactor`) or a
    structurally singular A (``ValueError`` from the analysis) moves the
    call down the ladder; every other error propagates. Complex A or b
    takes the whole ladder on the 2x2 real embedding
    (:func:`.complex_embed.lusol_complex_device`)."""
    if np.iscomplexobj(A.data) or np.iscomplexobj(b):
        from .complex_embed import lusol_complex_device
        return lusol_complex_device(A, b, config, device)
    Ag = A.to_full_storage()
    b = np.asarray(b, dtype=np.float64)
    x, rx, rung = None, np.inf, None
    try:
        SL = analyze_mflu_unsym(Ag, config)
    except ValueError:               # structurally singular
        SL = None
    if SL is not None:
        relaxed0 = relaxed_factors
        try:
            x = lu_unsym_solve_device(Ag, b, config, SL, device)
            prev = np.inf
            for _ in range(max(config.ir_steps, 2)):
                r = b - Ag.matvec(x)
                nrm = np.abs(r).max(initial=0.0)
                if nrm == 0.0 or nrm >= prev:
                    break
                prev = nrm
                x = x + lu_unsym_solve_device(Ag, r, config, SL, device)
            rx = residual_norm(Ag, x, b)
            rung = "relaxed" if relaxed_factors > relaxed0 else "lu"
            if rx < 1e-9:
                # a healthy LU + refinement: no QR pass for the last digits
                rungs[rung] += 1
                return x
        except NonFiniteFactor:
            x, rx = None, np.inf
    # stalled or failed: the device QR repair pass (+ refinement)
    try:
        SQR = analyze_mfqr(Ag, config)
        xq = mfqrsol_device(Ag, b, config, SQ=SQR, device=device)
        for _ in range(max(config.ir_steps, 2)):
            r = b - Ag.matvec(xq)
            if np.abs(r).max(initial=0.0) == 0.0:
                break
            xq = xq + mfqrsol_device(Ag, r, config, SQ=SQR, device=device)
        rq = residual_norm(Ag, xq, b)
        if x is None or rq <= rx:
            x, rx, rung = xq, rq, "qr"
        if rx < 1e-9:
            rungs[rung] += 1
            return x
    except NonFiniteFactor:
        pass
    if x is not None and rx < 1e-6:
        rungs[rung] += 1
        return x
    rungs["klu"] += 1
    return lu.lusol(Ag, b, config)


def lu_flops(SL: LUUnsymSymbolic) -> float:
    """Flops of the dense front LUs: over each front's pivots k,
    2 (m - k - 1)(nf - k), m = nc + nforeign its rows, nf its columns."""
    S = SL.SQ.S
    total = 0.0
    for s in range(S.nsuper):
        k = np.arange(S.ncols(s), dtype=np.float64)
        m = S.ncols(s) + float(SL.nforeign[s])
        total += float(np.sum(2.0 * (m - k - 1.0) * (len(S.rows[s]) - k)))
    return total
