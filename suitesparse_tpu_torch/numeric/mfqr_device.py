"""Multifrontal QR on the device: level-batched fronts, one gather a front
group, a batched Householder R with Q'b, and the backward sweep.

The port of the JAX package's ``numeric/mfqr_device.py``. Its plan
(:func:`build_qr_plan`) is copied; the device part runs on torch tensors:

  * assembly is pure PLACEMENT: every front cell receives at most one source
    (an A entry, a right-hand-side entry or one cell of a child's R panel,
    since contribution rows occupy distinct front rows). So each group's
    fronts are ONE gather ``pool[gidx]`` from a flat pool that holds
    ``[A.data | b | 0]`` and then every group's R panel at its
    ``panel_base``; ``gidx`` is built once a plan on the host (cells no
    source reaches point at the pool's zero), and :func:`gather_index`
    checks that no cell has two sources, which makes the gather equal to
    the reference's scatter plus one-hot matmul placement;
  * the right-hand side rides as extra front columns:
    ``torch.linalg.qr(F, mode="r")`` of ``[F | y]`` yields both R and Q'y,
    and R (its rows padded or cut to the group's K) lands in the pool;
  * the least-squares solve is one backward sweep, root to leaves, of index
    gathers, a batched matmul and a batched triangular solve a group.

The path reaches no Pallas kernel in the reference (``jnp.linalg.qr``,
``triangular_solve`` and one-hot matmuls), so it is library calls and
gathers here. Each group's index arrays are built once a plan on the host;
the factor runs one group at a time, so it holds the pool, the index
arrays and one group's fronts. The one-piece factor uploads every group's
arrays once and keeps them; past ``Config.segment_bytes`` (or its auto
budget on the card) the factor and the sweep upload them a segment at a
time (:mod:`.segmented`, the reference's ``run_qrplan_segmented``), and the
pool stays whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT, Config
from ..device import fp32_precision, resolve_device
from ..sparse import CSC, _concat_ranges
from . import segmented
from .multifrontal_qr import QRSymbolicMF, analyze_mfqr

__all__ = ["QRGroupPlan", "QRPlan", "build_qr_plan", "MFQRDeviceFactor",
           "factorize_qr_device", "qr_solve_device", "mfqrsol_device",
           "householder_flops", "NonFiniteFactor", "dead_columns",
           "rank_tol"]

# device factorizations run: a caller can tell the device route from the
# host's
device_factors = 0


class NonFiniteFactor(ArithmeticError):
    """The device QR panels or its x hold a non-finite value: non-finite
    input or overflow (a rank-deficient A gets the basic solution)."""


def _pad8(x: int, lo: int = 8) -> int:
    return max(lo, 8 * ((x + 7) // 8))


@dataclasses.dataclass
class QRGroupPlan:
    M: int                 # padded front rows
    N: int                 # padded front cols (incl. nrhs)
    K: int                 # padded stored R rows (nc + cb rows)
    B: int
    snodes: np.ndarray
    asrc: np.ndarray       # [na] gather into [Adata | bflat]
    adst: np.ndarray       # [na] flat dst into (B*M*N), sorted, unique
    nc: np.ndarray
    pairs: list            # [(src_level, src_gi, K_c, N_c, src, dst,
                           #   rowmap [np,K_c], colmap [np,N_c])]
    panel_base: int        # offset of this group's R output in the pool
    # solve-time positions (the sweep reads every position from here)
    col_idx: np.ndarray    # [B*N] global x-column of each front col (pad -> n)
    rhs_col: np.ndarray    # [B, nrhs] front column of each right-hand side
    beyond: np.ndarray     # positions b*N + c of the real beyond-pivot columns
    row_col: np.ndarray    # [B*K] global column owning stored R row (pad -> n)
    # LU mode only (mflu_unsym): padded pivot-column count and per-slot home
    # block rows
    Cg: int = 0
    fm: np.ndarray | None = None


@dataclasses.dataclass
class QRPlan:
    groups: list
    pool_data: int         # 1 + nnz + m*nrhs (start of panel region)
    pool_size: int
    nrhs: int
    n: int


def build_qr_plan(SQ: QRSymbolicMF, Aq: CSC, nrhs: int) -> QRPlan:
    """Level-batched front groups of ``SQ`` for ``nrhs`` right-hand sides
    (the reference's ``build_qr_plan``): each level's fronts bucketed by
    padded (rows, columns), A entries and b entries as (source, cell)
    pairs, each child's contribution block as a pair class of row and
    column maps."""
    S = SQ.S
    AqT = Aq.transpose(values=False)
    # AqT's entries run in (row, col) order: entry t is Aq's src_of_T[t]
    cols_g = np.repeat(np.arange(Aq.ncol, dtype=np.int64), np.diff(Aq.indptr))
    src_of_T = np.lexsort((cols_g, Aq.indices))

    m = Aq.nrow
    children: list = [[] for _ in range(S.nsuper)]
    for s in range(S.nsuper):
        if S.sparent[s] != -1:
            children[S.sparent[s]].append(s)

    pool_data = 1 + Aq.nnz + m * nrhs
    pool_off = pool_data
    level_layouts = []
    place = {}   # snode -> (level, gi, slot, K, N)
    for d, level_nodes in enumerate(S.levels):
        buckets: dict = {}
        for s in level_nodes:
            nf = len(S.rows[s])
            mrows = int(SQ.front_m[s])
            key = (_pad8(mrows), _pad8(nf + nrhs))
            buckets.setdefault(key, []).append(int(s))
        placed = []
        for gi, ((M, N), ss) in enumerate(sorted(buckets.items())):
            K = _pad8(max(int(S.ncols(s) + SQ.cb_rows[s]) for s in ss))
            for b, s in enumerate(ss):
                place[s] = (d, gi, b, K, N)
            placed.append((M, N, K, ss, pool_off))
            pool_off += len(ss) * K * N
        level_layouts.append(placed)

    groups_all = []
    for placed in level_layouts:
        glist = []
        for (M, N, K, ss, pbase) in placed:
            B = len(ss)
            a_src, a_dst = [], []
            nc_arr = np.zeros(B, dtype=np.int32)
            col_idx = np.full(B * N, SQ.S.n, dtype=np.int64)
            rhs_col = np.empty((B, nrhs), dtype=np.int64)
            beyond = []
            row_col = np.full(B * K, SQ.S.n, dtype=np.int64)
            pair_cls: dict = {}
            for b, s in enumerate(ss):
                cols = S.rows[s]
                nf = len(cols)
                nc = S.ncols(s)
                nc_arr[b] = nc
                base = b * M * N
                col_idx[b * N:b * N + nf] = cols
                rhs_col[b] = nf + np.arange(nrhs)
                beyond.append(b * N + np.arange(nc, nf))
                row_col[b * K:b * K + nc] = np.arange(
                    S.super_first[s], S.super_first[s] + nc)
                row = 0
                # A rows (sources: Adata entries, then bflat at nnz + r*nrhs+j)
                for r in SQ.front_arows[s]:
                    lo, hi = int(AqT.indptr[r]), int(AqT.indptr[r + 1])
                    pos = np.searchsorted(cols, AqT.indices[lo:hi])
                    a_src.append(src_of_T[lo:hi])
                    a_dst.append(base + row * N + pos)
                    a_src.append(Aq.nnz + r * nrhs + np.arange(nrhs))
                    a_dst.append(base + row * N + nf + np.arange(nrhs))
                    row += 1
                # children contribution blocks: contiguous R-row slices with
                # scattered columns
                for c in children[s]:
                    mu = int(SQ.cb_rows[c])
                    if mu == 0:
                        continue
                    dc, gc, slot_c, Kc, Nc = place[c]
                    cols_c = S.rows[c]
                    nc_c = S.ncols(c)
                    nf_c = len(cols_c)
                    pos = np.searchsorted(cols, cols_c[nc_c:])
                    rowmap = np.full(Kc, -1, dtype=np.int32)
                    rowmap[nc_c:nc_c + mu] = row + np.arange(mu)
                    colmap = np.full(Nc, -1, dtype=np.int32)
                    colmap[nc_c:nf_c] = pos
                    colmap[nf_c:nf_c + nrhs] = nf + np.arange(nrhs)
                    cls = pair_cls.setdefault(
                        (dc, gc), {"Kc": Kc, "Nc": Nc, "src": [], "dst": [],
                                   "rowmap": [], "colmap": []})
                    cls["src"].append(slot_c)
                    cls["dst"].append(b)
                    cls["rowmap"].append(rowmap)
                    cls["colmap"].append(colmap)
                    row += mu
                if row != SQ.front_m[s]:
                    raise RuntimeError(f"front {s}: {row} rows placed, "
                                       f"{SQ.front_m[s]} counted")
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
                                     row_col=row_col))
        groups_all.append(glist)
    return QRPlan(groups=groups_all, pool_data=pool_data, pool_size=pool_off,
                  nrhs=nrhs, n=S.n)


def gather_index(plan: QRPlan, g: QRGroupPlan) -> np.ndarray:
    """Pool position of each of the group's B*M*N front cells: an A or b
    entry, a cell of a child's R panel, or the pool's zero (its cell
    ``pool_data - 1``). Raises if a cell has two sources."""
    size = g.B * g.M * g.N
    dsts, srcs = [g.adst], [g.asrc]
    for dc, gc, Kc, Nc, psrc, pdst, rowmap, colmap in g.pairs:
        cbase = plan.groups[dc][gc].panel_base
        live = (rowmap >= 0)[:, :, None] & (colmap >= 0)[:, None, :]
        p, r, c = np.nonzero(live)
        dsts.append((pdst[p].astype(np.int64) * g.M + rowmap[p, r]) * g.N
                    + colmap[p, c])
        srcs.append(cbase + (psrc[p].astype(np.int64) * Kc + r) * Nc + c)
    dst = np.concatenate(dsts)
    if np.bincount(dst, minlength=size).max(initial=0) > 1:
        raise RuntimeError("a QR front cell has two sources: the gather "
                           "would drop one")
    gidx = np.full(size, plan.pool_data - 1, dtype=np.int64)
    gidx[dst] = np.concatenate(srcs)
    return gidx


@dataclasses.dataclass
class _GroupArrays:
    """One group's index arrays (on the host, or uploaded to the device):
    the factor's gather (and the LU's arrays), the sweep's positions."""

    B: int
    M: int
    N: int
    K: int
    panel_base: int
    gidx: torch.Tensor     # [B*M*N] pool positions of the front cells
    yidx: torch.Tensor     # [B*K*nrhs] Q'b cells of the panels (group-local)
    xidx: torch.Tensor     # [B*N] x row of each beyond-pivot column, else n
    live: torch.Tensor     # [B, K, K] bool: the pivot block R11 of a slot
    eye: torch.Tensor      # [K, K] bool identity, R11's padding
    rows: torch.Tensor     # group-local stored rows b*K + r with r < nc_b
    cols: torch.Tensor     # the x column each of them solves
    lu: object = None      # the LU factor's arrays (mflu_unsym), or None


def _factor_part(g: _GroupArrays) -> _GroupArrays:
    """The arrays the factor reads."""
    return dataclasses.replace(g, yidx=None, xidx=None, live=None, eye=None,
                               rows=None, cols=None)


def _sweep_part(g: _GroupArrays) -> _GroupArrays:
    """The arrays the backward sweep reads."""
    return dataclasses.replace(g, gidx=None, lu=None)


@dataclasses.dataclass
class QRDevicePlan:
    """A plan, its groups' index arrays on the host and, for the one-piece
    factor, uploaded to one device."""

    plan: QRPlan
    device: torch.device
    host: list             # [_GroupArrays] on the host, in plan order
    groups: list | None = None   # their one-piece upload, or None (not
    #                              uploaded, or let go by a segmented factor)
    index_bytes: int = 0   # bytes of the one-piece upload
    costs: dict = dataclasses.field(default_factory=dict)
    #                        dtype -> [(index, work) bytes a group]
    schedule: tuple | None = None   # (key, segments) of the last segmented
    #                                 factor (numeric/segmented.py)
    # the QR's pivots R[k, k]: their pool positions on the device and the
    # column (of A(:, q)) each one solves
    diag: tuple | None = None


def _host_arrays(plan: QRPlan) -> list:
    """The groups' gather and sweep index arrays on the host, in plan
    order, every position taken from the plan (so a QR plan and the LU's
    gapped panels share the sweep)."""
    n = plan.n
    idx_dtype = torch.int32 if plan.pool_size < 2**31 else torch.int64

    def host(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)

    out = []
    for glist in plan.groups:
        for g in glist:
            B, M, N, K = g.B, g.M, g.N, g.K
            nc = g.nc.astype(np.int64)
            ar_k = np.arange(K)
            yidx = ((np.arange(B)[:, None, None] * K + ar_k[None, :, None])
                    * N + g.rhs_col[:, None, :])
            xidx = np.full(B * N, n, dtype=np.int64)
            xidx[g.beyond] = g.col_idx[g.beyond]
            live = (ar_k[None, :, None] < nc[:, None, None]) & \
                (ar_k[None, None, :] < nc[:, None, None])
            rows = np.flatnonzero(g.row_col < n)
            out.append(_GroupArrays(
                B=B, M=M, N=N, K=K, panel_base=g.panel_base,
                gidx=host(gather_index(plan, g), idx_dtype),
                yidx=host(yidx.ravel()), xidx=host(xidx),
                live=host(live, torch.bool),
                eye=torch.eye(K, dtype=torch.bool),
                rows=host(rows), cols=host(g.row_col[rows])))
    return out


def _work_bytes(g: QRGroupPlan, dtype: torch.dtype) -> int:
    """One group's transient working set in bytes: the gathered fronts,
    the library QR's or LU's workspace (two fronts: its copy of the front
    and the pieces cut from it) and the panel it writes."""
    return (3 * g.B * g.M * g.N + g.B * g.K * g.N) * dtype.itemsize


def _entry(holder, attr: str, nrhs: int, device: torch.device,
           build) -> QRDevicePlan:
    """The plan at ``nrhs`` right-hand sides on ``device`` and its host
    arrays (``build()``), built once and cached on ``holder.<attr>``,
    keyed by both (a new nrhs or device rebuilds it). The dtype and the
    matmul precision are not part of the key because nothing in the plan
    depends on them: they are applied at each call."""
    key = (int(nrhs), str(device))
    cached = getattr(holder, attr, None)
    if cached is None or cached[0] != key:
        setattr(holder, attr, None)     # let the old plan go before the new
        plan, host = build()
        dp = QRDevicePlan(plan=plan, device=device, host=host,
                          index_bytes=segmented.nbytes(host))
        cached = (key, dp)
        setattr(holder, attr, cached)
    return cached[1]


def _upload(dp: QRDevicePlan) -> QRDevicePlan:
    """The one-piece upload: every group's arrays on the device."""
    if dp.groups is None:
        dp.groups = segmented.to_device(dp.host, dp.device)
    return dp


def _plan_entry(SQ: QRSymbolicMF, Aq: CSC, nrhs: int,
                device: torch.device) -> QRDevicePlan:
    def build():
        plan = build_qr_plan(SQ, Aq, nrhs)
        return plan, _host_arrays(plan)

    return _entry(SQ, "_torch_qr", nrhs, device, build)


def device_plan(SQ: QRSymbolicMF, Aq: CSC, nrhs: int,
                device: torch.device) -> QRDevicePlan:
    """The plan of ``SQ`` at ``nrhs`` right-hand sides with every group's
    index arrays on ``device`` (cached on ``SQ`` per nrhs and device)."""
    return _upload(_plan_entry(SQ, Aq, nrhs, device))


def _segments(dp: QRDevicePlan, dtype: torch.dtype, config: Config):
    """(one-piece groups on the device or None, segments or None) of a
    factor on ``dp`` in ``dtype`` (:func:`.segmented.segments`: the pool
    stays whole, the groups' arrays are the budget's)."""
    plan = dp.plan
    costs = dp.costs.get(dtype)
    if costs is None:
        dp.costs[dtype] = costs = [
            (segmented.nbytes(h), _work_bytes(g, dtype))
            for h, g in zip(dp.host, (g for gl in plan.groups for g in gl))]
    segs = segmented.segments(
        dp, (id(plan), plan.nrhs, str(dtype), str(dp.device)), costs,
        config, dp.device, plan.pool_size * dtype.itemsize)
    return (_upload(dp).groups if segs is None else None), segs


def _walk(dp: QRDevicePlan, groups, segs, part, reverse: bool = False):
    """(position, arrays on the device) of every group: the one-piece
    ``groups``, or the host's uploaded a segment at a time (``part`` of
    each), in plan order or in reverse."""
    if segs is None:
        pos = range(len(groups))
        return zip(reversed(pos), reversed(groups)) if reverse \
            else zip(pos, groups)
    return segmented.uploads(dp.host, segs, dp.device, part, reverse)


@dataclasses.dataclass
class MFQRDeviceFactor:
    SQ: QRSymbolicMF
    dplan: QRDevicePlan
    pool: torch.Tensor     # [A.data | b | 0 | R panels] on the device
    ok: bool               # every panel finite
    precision: str
    groups: list | None            # the one-piece arrays the sweep reads,
    segments: list | None = None   # or the segments the factor ran in
    # the QR's rank estimate (pivots with |R[k,k]| > tol) and its
    # tolerance (rank_tol); None for the LU's panels, whose sweep divides
    # by every pivot
    rank_est: int | None = None
    tol: float | None = None

    @property
    def panels(self) -> torch.Tensor:
        """The concatenated R outputs, padded (the reference's layout)."""
        return self.pool[self.dplan.plan.pool_data:]


def _factor_group(g: _GroupArrays, pool: torch.Tensor) -> None:
    """One group: its fronts gathered from the pool, their R (and Q'b in
    the right-hand-side columns) by one batched Householder QR, R's rows
    padded or cut to K and written to the group's panels."""
    F = pool.index_select(0, g.gidx).view(g.B, g.M, g.N)
    R = torch.linalg.qr(F, mode="r")[1]              # [B, min(M, N), N]
    out = pool[g.panel_base:g.panel_base + g.B * g.K * g.N].view(
        g.B, g.K, g.N)
    k = min(R.shape[1], g.K)
    out[:, :k] = R[:, :k]
    if k < g.K:
        out[:, k:] = 0


def factorize_qr_device(A: CSC, SQ: QRSymbolicMF, b: np.ndarray,
                        config: Config = DEFAULT,
                        device="cuda") -> MFQRDeviceFactor:
    """R panels and Q'b of A(:, SQ.q) on ``device`` in
    ``config.compute_dtype``: per group one gather of its fronts, one
    batched Householder QR, and R written into the pool; in segments past
    ``config.segment_bytes`` (:mod:`.segmented`)."""
    global device_factors
    if np.iscomplexobj(A.data) or np.iscomplexobj(b):
        raise ValueError(
            "the device QR factor is real-only: complex input takes qrsol, "
            "which runs it on the 2x2 real embedding")
    dev = resolve_device(device)
    Aq = A.permuted(None, SQ.q)
    bb = np.asarray(b, dtype=np.float64)
    bb = bb.reshape(-1, 1) if bb.ndim == 1 else bb
    dp = _plan_entry(SQ, Aq, bb.shape[1], dev)
    plan = dp.plan
    dtype = torch.float64 if config.compute_dtype == "float64" \
        else torch.float32
    groups, segs = _segments(dp, dtype, config)
    pool = torch.empty(plan.pool_size, dtype=dtype, device=dev)
    src = np.concatenate([Aq.data, bb.ravel(), [0.0]])
    pool[:plan.pool_data] = torch.from_numpy(src).to(dev, dtype)
    with fp32_precision(config.precision):
        for _pos, g in _walk(dp, groups, segs, _factor_part):
            _factor_group(g, pool)
    ok = bool(torch.isfinite(pool[plan.pool_data:]).all())
    tol = rank_tol(A, dtype, config.qr_tol)
    rank_est = int((pool[_diag_index(dp)[0]].abs() > tol).sum())
    device_factors += 1
    return MFQRDeviceFactor(SQ=SQ, dplan=dp, pool=pool, ok=ok,
                            precision=config.precision, groups=groups,
                            segments=segs, rank_est=rank_est, tol=tol)


def rank_tol(A: CSC, dtype: torch.dtype, qr_tol: float = -1.0) -> float:
    """The rank-detection tolerance of a factor in ``dtype``: ``qr_tol``
    where it is >= 0 (``Config.qr_tol``, as the host QR reads it), else 20
    max_j ||A(:, j)||_2 times the larger of (m + n) eps_64, SPQR's default
    (``spqr_tol.cpp:23``, the host QR's ``qr.py``: the tolerance of every
    fp64 factor), and sqrt(m + n) eps of ``dtype``. In fp32, (m + n) eps
    outgrows the true pivots of large problems (it marked pivots of the
    full-rank grid_gradient_3d(32), m + n = 128,327, dead), while the
    roundoff that a dependent column's pivot keeps grows like sqrt(m + n)
    eps."""
    if qr_tol >= 0:
        return float(qr_tol)
    m, n = A.shape
    sq = np.zeros(n)
    np.add.at(sq, np.repeat(np.arange(n), np.diff(A.indptr)),
              np.abs(A.data) ** 2)
    maxnorm = float(np.sqrt(sq.max(initial=0.0)))
    return 20.0 * maxnorm * max((m + n) * np.finfo(np.float64).eps,
                                np.sqrt(m + n) * torch.finfo(dtype).eps)


def _diag_index(dp: QRDevicePlan) -> tuple:
    """(pool positions on the device, columns of A(:, q)) of every pivot
    R[k, k] of the QR plan (slot b's stored row r < nc_b sits at column r
    of its panel), built once on the device plan."""
    if dp.diag is None:
        pos, cols = [], []
        for g in (g for gl in dp.plan.groups for g in gl):
            nc = g.nc.astype(np.int64)
            r = np.arange(nc.sum()) - np.repeat(np.cumsum(nc) - nc, nc)
            b = np.repeat(np.arange(g.B), nc)
            pos.append(g.panel_base + (b * g.K + r) * g.N + r)
            cols.append(g.row_col[b * g.K + r])
        dp.diag = (torch.as_tensor(np.concatenate(pos), device=dp.device),
                   np.concatenate(cols))
    return dp.diag


def dead_columns(F: MFQRDeviceFactor) -> np.ndarray:
    """The columns of A (sorted) whose pivot |R[k,k]| is at or under
    ``F.tol``: the x that the basic solution fixes at zero."""
    pos, cols = _diag_index(F.dplan)
    dead = (F.pool[pos].abs() <= F.tol).cpu().numpy()
    return np.sort(F.SQ.q[cols[dead]])


def _columns(A: CSC, keep: np.ndarray) -> CSC:
    """A(:, keep) for sorted column indices ``keep``."""
    lo = A.indptr[keep]
    lens = A.indptr[keep + 1] - lo
    take = _concat_ranges(lo, lens)
    return CSC(A.nrow, keep.size, np.concatenate([[0], np.cumsum(lens)]),
               A.indices[take], A.data[take], 0)


def qr_solve_device(F: MFQRDeviceFactor) -> np.ndarray:
    """x = R \\ (Q'b): the backward sweep over the device panels, root to
    leaves (``x`` keeps a zero row n that padded columns read). Every
    position comes from the plan, so the LU's stored U panels
    (:mod:`.mflu_unsym`: pivots, then the beyond-pivot columns from Cg,
    then the right-hand sides) take the same sweep.

    On a QR factor the x of each pivot with |R[k,k]| <= ``F.tol`` is fixed
    at zero, the host ``qr_solve``'s rule (its row of R11 becomes the
    identity's and its right-hand side zero, so the rows above read
    x_k = 0): x stays finite, but the dropped rows' part of Q'b is lost,
    which :func:`mfqrsol_device` repairs. The LU's factor (``tol`` None)
    divides by every pivot."""
    dp = F.dplan
    n, nrhs = dp.plan.n, dp.plan.nrhs
    x = torch.zeros((n + 1, nrhs), dtype=F.pool.dtype, device=F.pool.device)
    with fp32_precision(F.precision):
        for _pos, g in _walk(dp, F.groups, F.segments, _sweep_part,
                             reverse=True):
            flat = F.pool[g.panel_base:g.panel_base + g.B * g.K * g.N]
            R = flat.view(g.B, g.K, g.N)
            y = flat.index_select(0, g.yidx).view(g.B, g.K, nrhs)
            xg = x.index_select(0, g.xidx).view(g.B, g.N, nrhs)
            rhs = torch.baddbmm(y, R, xg, alpha=-1.0)    # y - R_beyond x
            Rsq = R[:, :, :g.K]
            if g.K > g.N:     # more stored rows than columns: zero-pad R11
                Rsq = torch.nn.functional.pad(Rsq, (0, g.K - g.N))
            R11 = torch.where(g.live, Rsq, g.eye)
            if F.tol is not None:
                dead = g.live.diagonal(dim1=1, dim2=2) & \
                    (R11.diagonal(dim1=1, dim2=2).abs() <= F.tol)
                R11 = torch.where(dead[:, :, None], g.eye, R11)
                rhs = rhs.masked_fill(dead[:, :, None], 0.0)
            xs = torch.linalg.solve_triangular(R11, rhs, upper=True)
            x.index_copy_(0, g.cols,
                          xs.reshape(g.B * g.K, nrhs).index_select(0, g.rows))
    xh = x[:n].double().cpu().numpy()
    xout = np.empty_like(xh)
    xout[F.SQ.q] = xh
    return xout


def householder_flops(SQ: QRSymbolicMF, nrhs: int = 1) -> float:
    """Householder flops of the factor: 2k^2 (max(M, N) - k/3) a front,
    k = min(M, N), M its structural rows, N its columns plus nrhs."""
    M = SQ.front_m.astype(np.float64)
    N = np.array([len(r) for r in SQ.S.rows], np.float64) + nrhs
    k = np.minimum(M, N)
    return float(np.sum(2.0 * k * k * (np.maximum(M, N) - k / 3.0)))


_SQ_CACHE: dict = {}     # analysis key -> QRSymbolicMF


def _analysis_key(A: CSC, config: Config) -> tuple:
    """Everything of the config the front-tree analysis of A reads: the
    ordering with COLAMD's absorption and dense cuts, and the supernode
    relaxation (the reference keys on the pattern only, so a second
    ordering reused the first's)."""
    return (A.nrow, A.ncol, A.pattern_key(), config.ordering,
            config.amd_aggressive, config.colamd_dense_row,
            config.colamd_dense_col, tuple(config.nrelax),
            tuple(config.zrelax))


def mfqrsol_device(A: CSC, b: np.ndarray, config: Config = DEFAULT,
                   SQ: QRSymbolicMF | None = None,
                   device="cuda") -> np.ndarray:
    """Least squares min ||Ax - b|| (m >= n) by the device multifrontal QR.

    Pass a cached ``SQ`` for the analyze-once/solve-many regime; without
    one the analysis (and through it the device plan) is cached per
    analysis key, at most 8 of them. Raises :class:`NonFiniteFactor` when
    the panels or x come out non-finite. A rank-deficient A (a pivot at
    or under :func:`rank_tol`, ``F.rank_est < n``) gets the basic
    solution: x = 0 on the dead pivots' columns and least squares on the
    rest (:func:`_basic_solution`, a second factor without those columns).
    The reference's device sweep divides by every pivot and gives such an
    A a finite but unbounded x."""
    if SQ is None:
        key = _analysis_key(A, config)
        SQ = _SQ_CACHE.get(key)
        if SQ is None:
            if len(_SQ_CACHE) >= 8:
                _SQ_CACHE.clear()
            SQ = analyze_mfqr(A, config)
            _SQ_CACHE[key] = SQ
    F = factorize_qr_device(A, SQ, b, config, device)
    if not F.ok:
        raise NonFiniteFactor("QR factorization produced non-finite panels")
    if F.rank_est < A.ncol:
        x = _basic_solution(A, b, config, dead_columns(F), device)
    else:
        x = qr_solve_device(F)
    if not np.isfinite(x).all():
        raise NonFiniteFactor("QR solve produced a non-finite x")
    return x[:, 0] if np.asarray(b).ndim == 1 else x


def _basic_solution(A: CSC, b: np.ndarray, config: Config,
                    dead: np.ndarray, device) -> np.ndarray:
    """The basic least-squares solution (n, nrhs): x = 0 on the ``dead``
    columns, the least-squares x of A without them on the rest. The sweep
    alone (:func:`qr_solve_device`) drops the dead pivots' rows of R, and
    with them the part of the right-hand side they carry, so it is no
    least-squares solution; the QR of the columns that stay loses nothing.
    That factor finds its own dead pivots, if any, in the same way."""
    bb = np.asarray(b, dtype=np.float64)
    bb = bb.reshape(-1, 1) if bb.ndim == 1 else bb
    keep = np.setdiff1d(np.arange(A.ncol), dead)
    x = np.zeros((A.ncol, bb.shape[1]))
    if keep.size:
        x[keep] = mfqrsol_device(_columns(A, keep), bb, config,
                                 device=device)
    return x
