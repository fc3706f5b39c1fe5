"""Supernodal multifrontal Cholesky factor on torch tensors (CUDA or CPU).

Port of :mod:`suitesparse_tpu.numeric.supernodal_device` (the
``factorize_device`` -> ``_run_plan`` -> ``_group_compute`` path, in one
piece or segmented: ``_run_plan_segmented`` and ``_segment_schedule`` are
:mod:`.segmented`'s runner here), with its
numpy plan builder copied here: the supernodes of each elimination-tree
level are bucketed by padded shape into groups, and each group's pair
classes (child group -> parent slot extend-adds) and tile manifests are
precomputed on the host. The factor keeps the reference's padded device
layout (each group's (B, R, C) panels at ``panel_base``, ``dev_size`` cells
in all), so the two factors compare entry by entry.

Per group: A's values are scattered into the fronts F; child updates whose
parent group has a tile manifest are added by the tiled extend-add kernel
(one piece per manifest step, or two with ``Config.tile_pair``; fp32;
128-wide tiles, or 256-wide on the groups of R >= ``tile_big``), the
other pair classes by the extend-add kernel, one launch a group for all
of them, each reading its children where they lie; the fronts are
factored by the fused potrf+trsm kernel where its gate passes (B >= 32,
C <= 96, fp32) and by ``cholesky_ex`` + ``solve_triangular`` elsewhere;
the update U = F22 - L21 L21^T goes up to the parent group.

``Config.update_dtype="bfloat16"`` stores each U in bfloat16 (the
reference's mixed-precision factor): the fronts, the panels and the sums
stay in the compute dtype, U is rounded once after it is computed, and the
extend-add kernel widens it exactly as it reads it. Such a factor places
every pair class through the extend-add kernel (no tile manifest, as the
reference turns its tiled kernel off for any update dtype but fp32);
``solve_refined`` brings its residual back to the fp32 class.

Each group's index arrays are built once a plan on the host. The one-piece
factor uploads them all once and keeps them; past ``Config.segment_bytes``
(or its auto budget on the card) a factor uploads them a segment at a time
(:mod:`.segmented`), with the same kernels, the same carried updates and
the same bits.

On a CUDA device the one-piece group loop is captured as a CUDA graph
(:class:`FactorGraph`, cached on the :class:`DevicePlan` per compute
dtype, update dtype and ``Config.precision``): the first factor of such a
key runs eagerly and warms up the library's handles and the kernels, the
second runs the loop on a side stream (its factor is the one returned) and
captures it there, and every later one replays it, the same launches on
the same addresses, so the card and not the host's launches paces the
factor. A replay reads A's values from the graph's own input buffer and
writes the graph's own padded factor, which each call copies out, so every
factor returned owns its values. The graph's pool keeps the loop's
working set reserved between calls; its free blocks count as held
(:func:`..device.free_bytes`), so the budget of another key's factor and
the solve's memory gates leave them out, and a replay under the auto
budget runs in one piece in them. The segmented factor, a factor under
``torch.profiler`` before its key has a graph, a CPU factor and one whose
capture would not fit in the card's free memory run eagerly; the counters
``factor.graph.capture``, ``.replay`` and ``.eager`` (CUDA factors only)
and ``graph_pool_bytes`` say which ran.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from ..config import DEFAULT, Config
from ..device import (CARD, CARD_BYTES_S, CARD_FLOP_S, fp32_precision,
                      free_bytes, hold_graph_bytes, resolve_device)
from ..kernels import extend_add as extend_add_k, \
    extend_add_tiles as tiles_k, potrf as potrf_k
from ..kernels.extend_add import build_work, extend_add_group
from ..kernels.extend_add_tiles import build_group_manifest, extend_add_tiles, \
    run_ptr
from ..kernels.potrf import MAX_C, potrf_trsm
from ..sparse import CSC
from ..stats import OFF, count, span, tracing
from ..symbolic.supernodes import SupernodalSymbolic
from . import segmented

__all__ = ["TILE_RMIN", "Plan", "build_plan", "device_plan",
           "factorize_device", "k7_classes", "roofline_report"]

TILE_RMIN = 256     # groups with R >= this assemble through the tile kernel

_R_LADDER = [8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
             1536, 2048, 3072, 4096, 6144, 8192]
_C_LADDER = [4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512]


def _pad_to(x: int, ladder) -> int:
    for v in ladder:
        if x <= v:
            return v
    step = ladder[-1]
    return ((x + step - 1) // step) * step


@dataclasses.dataclass
class PairClass:
    """All (child of group src -> parent slot of this group) extend-adds."""

    src_level: int
    src_gi: int
    RU_c: int              # child update block size (padded, = source group RU)
    npairs: int


@dataclasses.dataclass
class GroupPlan:
    """One (level, shape-bucket) batched step."""

    R: int
    C: int
    B: int
    snodes: np.ndarray
    asrc: np.ndarray       # [nnz_g] gather into Cdata (original entries)
    adst: np.ndarray       # [nnz_g] flat dst into (B*R*R), sorted, unique
    nc: np.ndarray         # per-slot actual column counts
    pairs: list            # [PairClass]; per-class arrays live in the idx dict
    panel_base: int        # offset of this group's panels in the device factor
    # per class (src, dst, idx) index arrays, aligned with ``pairs``
    _pair_arrays: list = dataclasses.field(default_factory=list)
    _tile: object = None   # TileManifest of the tiled extend-add, or None
    _tile_runs: np.ndarray | None = None   # run_ptr offsets of the manifest
    _symm_u: bool = False  # symmetrize U before a full-reading consumer


@dataclasses.dataclass
class Plan:
    groups: list           # groups[level] = [GroupPlan, ...]
    lnz: int               # CHOLMOD px-layout size (host materialization)
    dev_size: int          # total device factor size (sum of B*R*C)
    _S: object = None      # symbolic handle for lazy map construction
    _px: tuple | None = None

    # host-side materialization map Lx_px[px_dst] = Lx_dev[px_src] — built
    # LAZILY (it is lnz-sized; only host materialization needs it, and
    # building it eagerly dominated plan time on big problems)
    def px_maps(self):
        if self._px is None:
            self._px = _build_px_maps(self._S, self)
        return self._px

    @property
    def px_src(self):
        return self.px_maps()[0]

    @property
    def px_dst(self):
        return self.px_maps()[1]


def _build_px_maps(S, plan):
    """px-layout materialization maps, fully vectorized over all lnz entries
    (per-supernode Python loops took minutes at audikw-class sizes)."""
    # per-supernode metadata in group order
    s_all, base_all, C_all = [], [], []
    for glist in plan.groups:
        for g in glist:
            s_all.append(g.snodes)
            base_all.append(g.panel_base
                            + np.arange(g.B, dtype=np.int64) * g.R * g.C)
            C_all.append(np.full(g.B, g.C, dtype=np.int64))
    if not s_all:
        e = np.empty(0, np.int64)
        return e, e
    s_all = np.concatenate(s_all)
    base_all = np.concatenate(base_all)
    C_all = np.concatenate(C_all)
    nr_s = np.array([S.nrows(int(s)) for s in s_all], dtype=np.int64)
    nc_s = S.super_first[s_all + 1] - S.super_first[s_all]
    Lpx_s = S.Lpx[s_all]

    # per-column vectors (total ncols = n): local col index k, owner supernode
    k_col = _ranges(np.zeros(s_all.size, np.int64), nc_s)     # 0..nc_s-1 runs
    owner = np.repeat(np.arange(s_all.size, dtype=np.int64), nc_s)
    len_col = nr_s[owner] - k_col                              # entries per col
    # per-entry vectors (total = sum of panel triangles)
    rp = _ranges(k_col, nr_s[owner])                           # k..nr-1 runs
    kk = np.repeat(k_col, len_col)
    own_e = np.repeat(owner, len_col)
    nc_e = nc_s[own_e]
    rloc = np.where(rp < nc_e, rp, C_all[own_e] + (rp - nc_e))
    src = base_all[own_e] + rloc * C_all[own_e] + kk
    dst = Lpx_s[own_e] + kk * nr_s[own_e] + rp
    return src, dst


def _build_groups_vectorized(S: SupernodalSymbolic, C_low: CSC,
                             level_layouts, place):
    """All GroupPlans in one sweep: one global searchsorted over
    (snode, row) keys, no per-supernode or per-child Python loops."""
    n = S.n
    nsuper = S.nsuper
    nc_of = (S.super_first[1:] - S.super_first[:-1]).astype(np.int64)
    nr_of = np.array([len(S.rows[s]) for s in range(nsuper)], dtype=np.int64)
    rows_ptr = np.zeros(nsuper + 1, dtype=np.int64)
    np.cumsum(nr_of, out=rows_ptr[1:])
    rows_cat = (np.concatenate(S.rows) if nsuper
                else np.empty(0, np.int64))

    # per-snode placement -> flat arrays; gid = global group index
    slot_of = np.zeros(nsuper, dtype=np.int64)
    gid_of = np.zeros(nsuper, dtype=np.int64)
    R_of = np.zeros(nsuper, dtype=np.int64)
    C_of = np.zeros(nsuper, dtype=np.int64)
    gid_meta = []              # (level, gi, R, C, ss, pbase)
    gid_key = {}               # (level, gi) -> gid
    gid = 0
    for d, placed in enumerate(level_layouts):
        for gi, (R, C, ss, pbase) in enumerate(placed):
            arr = np.asarray(ss, dtype=np.int64)
            slot_of[arr] = np.arange(len(ss), dtype=np.int64)
            gid_of[arr] = gid
            R_of[arr] = R
            C_of[arr] = C
            gid_key[(d, gi)] = gid
            gid_meta.append((d, gi, R, C, arr, pbase))
            gid += 1
    ngid = gid
    RU_of_gid = np.array([m[2] - m[3] for m in gid_meta], dtype=np.int64)

    # sorted global row-list key: snode blocks ascending, rows sorted within
    stride = n + 1
    rowkey = np.repeat(np.arange(nsuper, dtype=np.int64), nr_of) * stride \
        + rows_cat

    # ---- A entries: position of each C_low entry within its snode panel ----
    ecols = np.repeat(np.arange(n, dtype=np.int64), np.diff(C_low.indptr))
    esn = S.snode_of_col[ecols]
    colk = ecols - S.super_first[esn]
    pos = np.searchsorted(rowkey, esn * stride + C_low.indices) \
        - rows_ptr[esn]
    fc = np.where(pos < nc_of[esn], pos, C_of[esn] + (pos - nc_of[esn]))
    adst_all = slot_of[esn] * R_of[esn] * R_of[esn] + fc * R_of[esn] + colk
    egid = gid_of[esn]
    order = np.lexsort((adst_all, egid))
    asrc_all = order.astype(np.int32)            # source = entry index
    adst_all = adst_all[order]
    egid_sorted = egid[order]
    e_counts = np.bincount(egid_sorted, minlength=ngid)
    e_splits = np.zeros(ngid + 1, dtype=np.int64)
    np.cumsum(e_counts, out=e_splits[1:])

    # ---- extend-add pairs: child update rows -> parent front coords ----
    ch = np.flatnonzero((S.sparent >= 0) & (nr_of > nc_of))
    par = S.sparent[ch]
    mu = nr_of[ch] - nc_of[ch]
    seg = _ranges(rows_ptr[ch] + nc_of[ch], rows_ptr[ch + 1])
    rows_c = rows_cat[seg] if seg.size else np.empty(0, np.int64)
    par_rep = np.repeat(par, mu)
    posp = np.searchsorted(rowkey, par_rep * stride + rows_c) \
        - rows_ptr[par_rep]
    fcp = np.where(posp < nc_of[par_rep], posp,
                   C_of[par_rep] + (posp - nc_of[par_rep])).astype(np.int32)
    # order children by (parent gid, child gid, parent slot)
    pgid, cgid = gid_of[par], gid_of[ch]
    ch_order = np.lexsort((slot_of[par], cgid, pgid))
    mu_o = mu[ch_order]
    # class boundaries over the sorted (pgid, cgid) pairs
    pk = pgid[ch_order] * ngid + cgid[ch_order]
    if pk.size:
        cls_start = np.flatnonzero(np.concatenate([[True], pk[1:] != pk[:-1]]))
        cls_end = np.concatenate([cls_start[1:], [pk.size]])
    else:
        cls_start = cls_end = np.empty(0, np.int64)
    # fcp re-gathered into ch_order (one flat gather, no per-child slices)
    seg_off = np.zeros(ch.size + 1, dtype=np.int64)
    np.cumsum(mu, out=seg_off[1:])
    if ch.size:
        gidx = _ranges(seg_off[ch_order], seg_off[ch_order] + mu[ch_order])
        fcp_sorted_flat = fcp[gidx]
    else:
        fcp_sorted_flat = np.empty(0, np.int32)
    flat_off = np.zeros(ch.size + 1, dtype=np.int64)
    np.cumsum(mu[ch_order] if ch.size else mu, out=flat_off[1:])

    src_sorted = slot_of[ch][ch_order]
    dst_sorted = slot_of[par][ch_order]
    cgid_sorted = cgid[ch_order]
    pgid_sorted = pgid[ch_order]

    # assemble GroupPlans
    groups_all = [[] for _ in level_layouts]
    cls_by_pgid: dict = {}
    for a, b in zip(cls_start, cls_end):
        cls_by_pgid.setdefault(int(pgid_sorted[a]), []).append((int(a),
                                                                int(b)))
    cap_cells = 16 << 20
    for g_id, (d, gi, R, C, ss, pbase) in enumerate(gid_meta):
        B = len(ss)
        lo, hi = int(e_splits[g_id]), int(e_splits[g_id + 1])
        nc_arr = nc_of[ss].astype(np.int32)
        pairs, pair_arrays = [], []
        chunk = max(1, cap_cells // max(R * R, 1))
        for (a, b) in cls_by_pgid.get(g_id, []):
            c_gid = int(cgid_sorted[a])
            dc, gic = gid_meta[c_gid][0], gid_meta[c_gid][1]
            RU_c = int(RU_of_gid[c_gid])
            npc = b - a
            idx = np.full((npc, RU_c), -1, dtype=np.int32)
            mus = mu_o[a:b]
            rows_flat = np.repeat(np.arange(npc, dtype=np.int64), mus) * RU_c \
                + _ranges(np.zeros(npc, np.int64), mus)
            idx.ravel()[rows_flat] = \
                fcp_sorted_flat[flat_off[a]:flat_off[b]]
            src = src_sorted[a:b].astype(np.int32)
            dst = dst_sorted[a:b].astype(np.int32)
            for clo in range(0, npc, chunk):
                chi = min(clo + chunk, npc)
                pairs.append(PairClass(src_level=dc, src_gi=gic,
                                       RU_c=RU_c, npairs=chi - clo))
                pair_arrays.append((src[clo:chi], dst[clo:chi],
                                    idx[clo:chi]))
        g = GroupPlan(R=R, C=C, B=B, snodes=ss,
                      asrc=asrc_all[lo:hi], adst=adst_all[lo:hi],
                      nc=nc_arr, pairs=pairs, panel_base=pbase,
                      _pair_arrays=pair_arrays)
        groups_all[d].append(g)
    return groups_all


def _mark_symmetrize(plan: "Plan") -> None:
    """Flag tile-assembled groups whose update block is read FULL by some
    consumer (a non-tile parent, or a class the parent's manifest did not
    fold): such groups must symmetrize their update from its valid lower
    triangle before handing it up (lower-only assembly leaves the upper
    tiles of F22 — hence of U — unspecified)."""
    gmap = {}
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            gmap[(d, gi)] = g
            g._symm_u = False
    for glist in plan.groups:
        for g in glist:
            folded = set(g._tile.folded) if g._tile is not None else ()
            for i, pc in enumerate(g.pairs):
                if i not in folded:
                    src = gmap[(pc.src_level, pc.src_gi)]
                    if src._tile is not None:
                        src._symm_u = True


def _ranges(starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
    """Concatenated [starts[i], stops[i]) ranges (vectorized)."""
    lens = stops - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    nz = lens > 0
    srt, lns = starts[nz], lens[nz]
    e = np.cumsum(lns)
    out[0] = srt[0]
    out[e[:-1]] = srt[1:] - (srt[:-1] + lns[:-1] - 1)
    return np.cumsum(out)


def _update_consumers(plan: Plan):
    """last_seg_consumer[(d,gi)] = index of the LAST group (in schedule
    order) whose pairs read update (d,gi)."""
    order = {}
    pos = 0
    last = {}
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            order[(d, gi)] = pos
            for pc in g.pairs:
                last[(pc.src_level, pc.src_gi)] = pos
            pos += 1
    return order, last


def _clow_data(A: CSC, S: SupernodalSymbolic) -> np.ndarray:
    """Values of symperm(A, perm).transpose() via a cached position map —
    the steady-state factor-many path does NO per-call symbolic work."""
    key = A.pattern_key()
    cache = getattr(S, "_clow_map", None)
    if cache is None or cache[0] != key:
        trace = CSC(A.nrow, A.ncol, A.indptr, A.indices,
                    np.arange(A.nnz, dtype=np.float64), A.sym)
        C_low = trace.symperm(S.perm).transpose()
        S._clow_map = (key, C_low.data.astype(np.int64))
    return A.data[S._clow_map[1]]


def _find_minor(S, plan, Lxdev) -> int:
    """First non-finite column (cholmod L->minor contract) from the device
    factor buffer."""
    Lh = np.asarray(Lxdev, dtype=np.float64)
    Lpx_h = np.zeros(plan.lnz)
    Lpx_h[plan.px_dst] = Lh[plan.px_src]
    for s in range(S.nsuper):
        if not np.all(np.isfinite(Lpx_h[S.Lpx[s]:S.Lpx[s + 1]])):
            return int(S.super_first[s])
    return S.n


def build_plan(S: SupernodalSymbolic, C_low: CSC,
               tile_rmin: int = TILE_RMIN, tile_pair: bool = False,
               split_mask: np.ndarray | None = None,
               ladders: tuple | None = None, tile_big: int = 0,
               tile_frac: float = 0.0) -> Plan:
    """The device plan, with tile manifests attached explicitly.

    Groups with ``R >= tile_rmin`` get a tile manifest (the reference's
    tile placement), one piece per step, or two with ``tile_pair``;
    ``g._tile_runs`` holds the manifest's :func:`run_ptr` offsets. Its
    tiles are 128 wide, or 256 where ``tile_big`` is set and ``R >=
    tile_big`` (the reference's ``SSTPU_TILE_BIG``); it folds the pair
    classes with ``RU_c >= tile_frac * RUp`` or ``RU_c >= 2 T`` (the
    reference's ``SSTPU_TILE_FRAC``; the default 0 folds every class), and
    the rest go to K7. ``split_mask`` (a bool or int a supernode)
    puts supernodes of different values into different groups, as the
    reference's: the distributed planner keeps the separator crown (and,
    on a (host, chip) topology, the host-local MID supernodes) out of the
    subtree groups (:mod:`..parallel.schedule`). ``ladders`` ((R rungs, C
    rungs); default the factor's ``_R_LADDER`` and ``_C_LADDER``) buckets
    the supernodes: the coarse solve plan's pow4 rungs, or the reference's
    other ladders (the panels are tightened to each group's maxima either
    way)."""
    R_lad, C_lad = (_R_LADDER, _C_LADDER) if ladders is None else ladders
    level_layouts = []
    place = {}
    panel_off = 0
    for d, level_nodes in enumerate(S.levels):
        buckets: dict = {}
        for s in level_nodes:
            nr, nc = S.nrows(s), S.ncols(s)
            key = (_pad_to(nr - nc, R_lad) + _pad_to(nc, C_lad),
                   _pad_to(nc, C_lad),
                   int(split_mask[s]) if split_mask is not None else 0)
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
            if g.R >= tile_rmin:
                g._tile = build_group_manifest(
                    g, T=256 if (tile_big and g.R >= tile_big) else 128,
                    ru_min_frac=tile_frac, npiece=2 if tile_pair else 1)
                if g._tile is not None:
                    g._tile_runs = run_ptr(g._tile.man)
    _mark_symmetrize(plan)
    return plan


@dataclasses.dataclass
class GroupArrays:
    """One group's index arrays (on the host, or uploaded to the device)."""

    asrc: torch.Tensor           # gather into Cdata
    adst: torch.Tensor           # flat destination in the (B*R*R) fronts
    nc: torch.Tensor             # (B, 1, 1) actual column counts
    k7: object                   # ExtendAddWork of the classes no manifest
    #                              folds (the fp32 factor's K7), or None
    k7_all: object               # ExtendAddWork of every class (fp64 and
    #                              bfloat16-update factors), or None
    tile: tuple | None           # (man, rowmap, colmap, runs) int32
    uslices: list                # per folded class (k0, src key, RU_c, src)


@dataclasses.dataclass
class DevicePlan:
    """A host :class:`Plan`, its groups' index arrays on the host and, for
    the one-piece factor, uploaded to one device."""

    plan: Plan
    device: torch.device
    groups: list | None          # groups[level] = [GroupArrays] on the
    #                              device, or None (not uploaded, or let go
    #                              by a segmented factor)
    host: list = dataclasses.field(default_factory=list)
    #                              [GroupArrays] on the host, in plan order
    index_bytes: int = 0         # bytes of the one-piece upload
    costs: dict = dataclasses.field(default_factory=dict)
    #                              (dtype, update dtype) -> [(index, work)
    #                              bytes a group]
    graphs: dict = dataclasses.field(default_factory=dict)
    #                              :func:`_graph_key` -> None after the
    #                              key's first (eager) factor, then its
    #                              FactorGraph, or False where the capture
    #                              did not fit
    schedule: tuple | None = None   # (key, segments) of the last segmented
    #                                 factor (numeric/segmented.py)
    solve_base: object = None    # the solve's route-independent index
    #                              tensors, built at the first solve
    solve: dict = dataclasses.field(default_factory=dict)
    #                              route -> w2/inv solve routing, built at
    #                              the first solve on that route
    coarse: tuple | None = None  # (the coarse solve plan's DevicePlan, the
    #                              relayout of this plan's Lx into it),
    #                              built at the first solve that takes it


def k7_classes(g: GroupPlan, skip=()) -> list:
    """The pair classes of ``g`` outside ``skip``, in plan order, as
    :func:`build_work` takes them: (source key, src, dst, idx)."""
    return [((pc.src_level, pc.src_gi), *arrays) for ci, (pc, arrays)
            in enumerate(zip(g.pairs, g._pair_arrays)) if ci not in skip]


def _host_arrays(plan: Plan) -> list:
    """Every group's index arrays on the host, in plan order (the K7 work
    lists as :func:`build_work` gives them, uploaded by their ``to``)."""
    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64))

    def t32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))

    def k7(g, skip):
        classes = k7_classes(g, skip)
        return build_work(g.B, g.R, classes) if classes else None

    out = []
    for glist in plan.groups:
        for g in glist:
            tm = g._tile
            tile, uslices = None, []
            if tm is not None:
                tile = (t32(tm.man), t32(tm.rowmap), t32(tm.colmap),
                        t32(g._tile_runs))
                uslices = [(k0, key, RU_c, t64(src))
                           for (_ci, k0, key, RU_c, src) in tm.uslices]
            k7_all = k7(g, ())
            out.append(GroupArrays(
                asrc=t64(g.asrc), adst=t64(g.adst),
                nc=t64(g.nc).reshape(g.B, 1, 1),
                k7=k7(g, set(tm.folded)) if tm is not None else k7_all,
                k7_all=k7_all, tile=tile, uslices=uslices))
    return out


def _tiled(dtype: torch.dtype, udtype: torch.dtype | None = None) -> bool:
    """Whether a factor in ``dtype`` with updates in ``udtype`` (default
    ``dtype``) assembles the groups that have a manifest through K2: fp32
    fronts and fp32 updates only, as the reference's ``_tile_runtime``."""
    return dtype == torch.float32 and udtype in (None, torch.float32)


def _select(ix: GroupArrays, dtype: torch.dtype,
            udtype: torch.dtype | None = None) -> GroupArrays:
    """The arrays a factor in ``dtype`` with updates in ``udtype`` reads
    of a group: an fp32 factor assembles a group with a manifest through
    K2 and K7 on the unfolded classes, every other group, and every group
    of any other factor, through K7 on all classes."""
    if ix.tile is not None and _tiled(dtype, udtype):
        return dataclasses.replace(ix, k7_all=None)
    return dataclasses.replace(ix, k7=None, tile=None, uslices=[])


def _work_bytes(g: GroupPlan, dtype: torch.dtype,
                udtype: torch.dtype | None = None) -> int:
    """One group's transient working set in bytes (:func:`_group_compute`):
    the fronts, the update's product, the finished panel and the pivot
    blocks' copies in ``dtype``, the update it hands up in ``udtype``
    (default ``dtype``) and, for an fp32 manifest, the padded child
    blocks."""
    udtype = dtype if udtype is None else udtype
    RU = g.R - g.C
    cells = g.B * (g.R * g.R + RU * RU + g.R * g.C + 3 * g.C * g.C)
    if g._tile is not None and _tiled(dtype, udtype):
        cells += max(g._tile.nslots, 1) * g._tile.RUp ** 2
    return cells * dtype.itemsize + g.B * RU * RU * udtype.itemsize


def _plan_entry(A: CSC, S: SupernodalSymbolic, device: torch.device,
                tile_rmin: int, tile_pair: bool, tile_big: int = 0,
                tile_frac: float = 0.0) -> DevicePlan:
    """The plan for ``S`` (the analysis of ``A``) and its host arrays,
    built once and cached on ``S._torch_plan``, keyed by everything that
    changes it: the tile threshold, the manifest form, the wide-tile
    threshold, the fold fraction and the device."""
    cache = getattr(S, "_torch_plan", None)
    if cache is None:
        cache = {}
        S._torch_plan = cache
    key = (int(tile_rmin), bool(tile_pair), str(device), int(tile_big),
           float(tile_frac))
    if key not in cache:
        count("plan.build")
        C_low = A.symperm(S.perm).transpose()
        plan = build_plan(S, C_low, tile_rmin, tile_pair, tile_big=tile_big,
                          tile_frac=tile_frac)
        host = _host_arrays(plan)
        cache[key] = DevicePlan(plan=plan, device=device, groups=None,
                                host=host, index_bytes=segmented.nbytes(host))
    return cache[key]


def _upload(dp: DevicePlan) -> DevicePlan:
    """The one-piece upload: every group's arrays on the device."""
    if dp.groups is None:
        with span("factor.index_upload"):
            flat = segmented.to_device(dp.host, dp.device)
            count("h2d_bytes.index", dp.index_bytes)
        it = iter(flat)
        dp.groups = [[next(it) for _g in glist] for glist in dp.plan.groups]
    return dp


def device_plan(A: CSC, S: SupernodalSymbolic, device: torch.device,
                tile_rmin: int = TILE_RMIN, tile_pair: bool = False,
                tile_big: int = 0, tile_frac: float = 0.0) -> DevicePlan:
    """The plan for ``S`` (the analysis of ``A``) with every group's index
    arrays on ``device`` (:func:`_plan_entry`'s, uploaded once)."""
    return _upload(_plan_entry(A, S, device, tile_rmin, tile_pair, tile_big,
                               tile_frac))


def _use_potrf_kernel(dtype: torch.dtype, B: int, C: int) -> bool:
    """The fused potrf+trsm gate: a batch that fills the card, short column
    loops, fp32 (the reference's gate without its TPU VMEM budget)."""
    return B >= 32 and C <= MAX_C and dtype == torch.float32


def _assemble(g, ix: GroupArrays, Cdata: torch.Tensor, updates: dict,
              dtype: torch.dtype, f0: torch.Tensor | None = None,
              udtype: torch.dtype | None = None):
    """One group's fronts F (B, R, R): A's entries scattered, then the
    children's updates (in ``udtype``, default ``dtype``) added (K2 on the
    classes a manifest folds, fp32 fronts and updates; K7 on the others,
    one launch). Returns (F, the folded classes).

    ``f0`` (the distributed factor's, B * R * R contiguous cells): the
    summed contributions from across the cut; the fronts start from it, in
    place, and A's entries are added into it."""
    B, R = g.B, g.R
    dev = Cdata.device
    if f0 is None:
        Fbuf = torch.zeros(B * R * R + 1, dtype=dtype, device=dev)
        if ix.asrc.numel():
            Fbuf[ix.adst] = Cdata[ix.asrc]
        F = Fbuf[:-1].view(B, R, R)
    else:
        F = f0.view(B, R, R)
        if ix.asrc.numel():
            F.view(-1)[ix.adst] += Cdata[ix.asrc]

    skip, work = (), ix.k7_all
    if ix.tile is not None and _tiled(dtype, udtype):
        tm = g._tile
        Ucat = torch.zeros(max(tm.nslots, 1), tm.RUp, tm.RUp, dtype=dtype,
                           device=dev)
        for (k0, key, RU_c, src) in ix.uslices:
            Ucat[k0:k0 + src.numel(), :RU_c, :RU_c] = updates[key][src]
        extend_add_tiles(F, Ucat, *ix.tile)
        skip, work = set(tm.folded), ix.k7
    if work is not None:
        extend_add_group(F, [updates[key] for key in work.keys], work)
    return F, skip


def _pivots(F: torch.Tensor, nc: torch.Tensor, C: int):
    """(live, eye, F11m) of fronts F: the (B, C, C) mask of each slot's
    real columns, the identity, and F11 symmetrized from its lower
    triangle with the identity on the padding."""
    F11 = F[:, :C, :C]
    F11s = torch.tril(F11) + torch.tril(F11, -1).mT
    ar = torch.arange(C, device=F.device)
    live = (ar[:, None] < nc) & (ar[None, :] < nc)              # (B, C, C)
    eye = torch.eye(C, dtype=F.dtype, device=F.device)
    return live, eye, torch.where(live, F11s, eye)


def _chol(F11m: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """L11 by the library: a failed tile is all NaN, as the reference's
    XLA cholesky leaves it (the factor's minor is found from non-finite
    panels); zero on the padding."""
    L, info = torch.linalg.cholesky_ex(F11m)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    return torch.where(live, L, 0)


def _group_compute(g, ix: GroupArrays, Cdata: torch.Tensor, updates: dict,
                   dtype: torch.dtype, f0: torch.Tensor | None = None,
                   gate_B: int | None = None,
                   udtype: torch.dtype | None = None):
    """Assemble and factor one group; returns (panel (B, R, C), U or None).

    ``f0``: see :func:`_assemble`. ``gate_B``: the batch the K1 gate reads
    (the mesh factor's tree-sharded groups pass the whole group's, so that
    a rank's share takes the single card's route); default ``g.B``.
    ``udtype``: the dtype the children's updates come in and U goes up in
    (default ``dtype``); U is computed in ``dtype`` and rounded once, after
    its symmetrization, as the reference does."""
    B, R, C = g.B, g.R, g.C
    RU = R - C
    udtype = dtype if udtype is None else udtype
    F, skip = _assemble(g, ix, Cdata, updates, dtype, f0, udtype)
    live, eye, F11m = _pivots(F, ix.nc, C)
    F21 = F[:, C:, :C].contiguous() if RU > 0 else None
    if _use_potrf_kernel(dtype, B if gate_B is None else gate_B, C):
        L11, L21 = potrf_trsm(F11m.contiguous(), F21)
        L11 = torch.where(live, L11, 0)
    else:
        L11 = _chol(F11m, live)
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
    return torch.cat([L11, L21], dim=1), U.to(udtype)


def _group_args(g, ix: GroupArrays, d: int, gi: int, dtype: torch.dtype,
                udtype: torch.dtype | None) -> dict:
    """The arguments of a group's span: where it sits, its shape and the
    route :func:`_group_compute` takes (K1 or the library's potrf, a K2
    manifest, the pair classes K7 places)."""
    k2 = ix.tile is not None and _tiled(dtype, udtype)
    work = ix.k7 if k2 else ix.k7_all
    return {"level": d, "index": gi, "B": g.B, "R": g.R, "C": g.C,
            "potrf": "K1" if _use_potrf_kernel(dtype, g.B, g.C) else
            "library", "K2": int(k2),
            "K7_classes": 0 if work is None else len(work.keys)}


def _run_plan(plan: Plan, arrays, Cdata: torch.Tensor, dtype: torch.dtype,
              udtype: torch.dtype | None = None):
    """Every group in plan order; returns the padded factor (dev_size,).

    ``arrays`` yields (position, GroupArrays on the device) for each group
    in plan order: the one-piece upload, or a segment's upload at a time.
    The updates are held in ``udtype`` (default ``dtype``). A child update
    is freed right after the last group that reads it."""
    keys = [(d, gi) for d, glist in enumerate(plan.groups)
            for gi in range(len(glist))]
    _order, last = _update_consumers(plan)
    free_after: dict = {}
    for key, pos in last.items():
        free_after.setdefault(pos, []).append(key)
    Lx = torch.empty(plan.dev_size, dtype=dtype, device=Cdata.device)
    updates: dict = {}
    traced = tracing()
    for pos, ix in arrays:
        d, gi = keys[pos]
        g = plan.groups[d][gi]
        with span("factor.group", _group_args(g, ix, d, gi, dtype, udtype)) \
                if traced else OFF:
            panel, U = _group_compute(g, ix, Cdata, updates, dtype,
                                      udtype=udtype)
            Lx[g.panel_base:g.panel_base + panel.numel()] = \
                panel.reshape(-1)
        if U is not None and (d, gi) in last:
            updates[(d, gi)] = U
        for key in free_after.get(pos, ()):
            del updates[key]
    return Lx


# the factor's kernels' launch counters, (wrapper, attribute): a replay
# adds the launches its capture recorded, as the eager loop adds its own
_LAUNCH_COUNTERS = tuple(c for k in (potrf_k, tiles_k, extend_add_k)
                         for c in k.COUNTERS.values())


@dataclasses.dataclass
class FactorGraph:
    """The one-piece group loop of one :func:`_graph_key`, captured as a
    CUDA graph. A replay reads A's values from ``Cdata`` and writes the
    padded factor into ``Lx``; ``groups`` holds the index arrays it reads
    (alive while the graph is), ``launches`` the launches of one run by
    counter of :data:`_LAUNCH_COUNTERS`."""

    graph: torch.cuda.CUDAGraph
    Cdata: torch.Tensor
    Lx: torch.Tensor
    groups: list
    launches: dict

    def replay(self) -> torch.Tensor:
        """One run of the loop on the values in ``Cdata``; returns a copy
        of its factor, which the next replay leaves alone."""
        self.graph.replay()
        for (fn, name), n in self.launches.items():
            setattr(fn, name, getattr(fn, name) + n)
        count("factor.graph.replay")
        return self.Lx.clone()


def _graph_key(config: Config, dtype: torch.dtype,
               udtype: torch.dtype) -> tuple:
    """What a captured loop depends on beside its plan (the
    :class:`DevicePlan` it is cached on): the fronts' and the updates'
    dtypes, and the precision (``fp32_precision`` sets the library's TF32
    mode when the loop is captured)."""
    return dtype, udtype, config.precision


def _graph_mode(dp: DevicePlan, key: tuple, device: torch.device,
                segmented: bool) -> str:
    """How a factor's group loop runs: ``"replay"`` of the key's graph,
    ``"capture"`` at the key's second factor, else ``"eager"``: off CUDA,
    in segments, at the key's first factor (which warms up the library's
    handles and the kernels), under ``torch.profiler`` while the key has
    no graph, and for good where its capture did not fit."""
    if device.type != "cuda" or segmented:
        return "eager"
    if key not in dp.graphs:
        dp.graphs[key] = None
        return "eager"
    state = dp.graphs[key]
    if state:
        return "replay"
    return "capture" if state is None and not tracing() else "eager"


def _loop_bytes(plan: Plan, costs, udtype: torch.dtype) -> int:
    """The group loop's largest live set in bytes: a group's working set
    (the work bytes of ``costs``, :func:`_work_bytes`) and the child
    updates held across it, each from the group that makes it to the last
    that reads it, as :func:`_run_plan` holds them."""
    _order, last = _update_consumers(plan)
    ends: dict = {}
    live = peak = pos = 0
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            peak = max(peak, live + costs[pos][1])
            if (d, gi) in last:
                u = g.B * (g.R - g.C) ** 2 * udtype.itemsize
                live += u
                ends[last[d, gi]] = ends.get(last[d, gi], 0) + u
            live -= ends.pop(pos, 0)
            pos += 1
    return peak


def _pool_free(graph: torch.cuda.CUDAGraph) -> int:
    """Free bytes in the segments of ``graph``'s private memory pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] - seg["allocated_size"]
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _capture(dp: DevicePlan, key: tuple, Cdata: torch.Tensor,
             dtype: torch.dtype, udtype: torch.dtype,
             costs) -> torch.Tensor | None:
    """The key's second factor: the group loop on ``Cdata`` run on a side
    stream, whose factor it returns, then captured on that stream as the
    key's graph, kept on ``dp.graphs``; the free blocks its pool keeps
    count as held (:func:`..device.hold_graph_bytes`) while the graph
    lives. The key stays eager for good where the capture runs out of
    memory, or where the estimate (the padded factor twice, the graph's
    and this factor's, and :func:`_loop_bytes`) passes the card's free
    memory: then None, before any run."""
    plan, dev = dp.plan, Cdata.device
    dp.graphs[key] = False
    need = 2 * plan.dev_size * dtype.itemsize \
        + _loop_bytes(plan, costs, udtype)
    if need > free_bytes(dev):
        return None
    arrays = list(enumerate(ix for il in dp.groups for ix in il))
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        Lx = _run_plan(plan, arrays, Cdata, dtype, udtype)
    # the caller reads this factor on its own stream
    Lx.record_stream(torch.cuda.current_stream(dev))
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    before = {c: getattr(*c) for c in _LAUNCH_COUNTERS}
    graph, out = torch.cuda.CUDAGraph(), None
    try:
        with span("factor.capture"), torch.cuda.device(dev), \
                torch.cuda.graph(graph, stream=stream):
            out = _run_plan(plan, arrays, Cdata, dtype, udtype)
    except torch.cuda.OutOfMemoryError:
        pass
    finally:
        # the capture recorded its launches without running them
        launches = {c: getattr(*c) - n for c, n in before.items()}
        for (fn, name), n in before.items():
            setattr(fn, name, n)
    if out is None:
        del graph
        torch.cuda.empty_cache()
        return Lx
    pool = torch.cuda.memory_reserved(dev) - reserved
    fg = FactorGraph(graph=graph, Cdata=Cdata, Lx=out, groups=dp.groups,
                     launches={c: n for c, n in launches.items() if n})
    gc.collect()        # the capture's garbage, which may hold pool blocks
    hold_graph_bytes(fg, dev, _pool_free(graph))
    count("factor.graph.capture")
    count("graph_pool_bytes", pool)
    dp.graphs[key] = fg
    return Lx


def _costs(dp: DevicePlan, dtype: torch.dtype,
           udtype: torch.dtype) -> list:
    """[(index, work) bytes a group] of the plan's factor in ``dtype``
    with updates in ``udtype`` (:mod:`.segmented`), cached on
    ``dp.costs``."""
    costs = dp.costs.get((dtype, udtype))
    if costs is None:
        dp.costs[dtype, udtype] = costs = [
            (segmented.nbytes(_select(ix, dtype, udtype)),
             _work_bytes(g, dtype, udtype))
            for ix, g in zip(dp.host,
                             (g for gl in dp.plan.groups for g in gl))]
    return costs


def compute_dtype(config: Config) -> torch.dtype:
    """The factor's and the solve's dtype under ``config``."""
    return torch.float64 if config.compute_dtype == "float64" \
        else torch.float32


def update_dtype(config: Config, dtype: torch.dtype) -> torch.dtype:
    """The dtype the factor in ``dtype`` holds its child updates in under
    ``config``: bfloat16 for ``update_dtype="bfloat16"``, else ``dtype``
    (the reference's ``factorize_device``, whatever the front dtype)."""
    return torch.bfloat16 if config.update_dtype == "bfloat16" else dtype


def factorize_device(A: CSC, S: SupernodalSymbolic, config: Config = DEFAULT,
                     device="cuda", tile_rmin: int = TILE_RMIN,
                     tile_big: int = 0, tile_frac: float = 0.0):
    """A(p,p) = L L^T on ``device``; a TorchSupernodalFactor (device layout).

    ``tile_rmin``, ``tile_big`` and ``tile_frac`` shape the tile manifests
    (:func:`build_plan`; the defaults are the reference's);
    ``config.tile_pair`` picks the two-piece tile manifests;
    ``config.update_dtype`` the dtype of the child updates
    (:func:`update_dtype`); ``config.segment_bytes`` the budget past which
    the groups run in segments (:mod:`.segmented`; the same kernels, the
    same layout and the same bits). On CUDA a one-piece factor replays its
    group loop from a CUDA graph from the second factor of a plan on
    (:func:`_graph_mode`). ``minor`` follows the cholmod contract: the
    first column of the first supernode whose panel is not finite, or n on
    success."""
    from .supernodal import TorchSupernodalFactor

    dev = resolve_device(device)
    dtype = compute_dtype(config)
    udtype = update_dtype(config, dtype)
    key = _graph_key(config, dtype, udtype)
    with span("factor.plan"):
        dp = _plan_entry(A, S, dev, tile_rmin, config.tile_pair, tile_big,
                         tile_frac)
        plan = dp.plan
        costs = _costs(dp, dtype, udtype)
        # under the auto budget a replay runs in the memory its graph's
        # pool holds: one piece
        segs = None if dp.graphs.get(key) and not config.segment_bytes \
            else segmented.segments(
                dp, (id(plan), str(dtype), str(udtype), str(dev)), costs,
                config, dev, plan.dev_size * dtype.itemsize)
    if segs is None:
        groups = _upload(dp).groups
        arrays = enumerate(ix for il in groups for ix in il)
    else:
        # a segmented factor lets the one-piece upload go, which the
        # graphs read
        dp.graphs.clear()
        arrays = segmented.uploads(dp.host, segs, dev,
                                   lambda ix: _select(ix, dtype, udtype))
    mode = _graph_mode(dp, key, dev, segs is not None)
    with span("factor.gather"):
        values = _clow_data(A, S)
    with span("factor.upload"):
        src = torch.as_tensor(values, device=dev)
        Cdata = dp.graphs[key].Cdata.copy_(src) if mode == "replay" \
            else src.to(dtype)
        count("h2d_bytes.values", values.nbytes)
    with span("factor.groups"), fp32_precision(config.precision):
        Lx = None
        if mode == "replay":
            Lx = dp.graphs[key].replay()
        elif mode == "capture":
            Lx = _capture(dp, key, Cdata, dtype, udtype, costs)
        if Lx is None:
            Lx = _run_plan(plan, arrays, Cdata, dtype, udtype)
        if dev.type == "cuda" and not dp.graphs.get(key):
            count("factor.graph.eager")
    minor = S.n
    with span("factor.check"):
        if not bool(torch.isfinite(Lx).all()):
            minor = _find_minor(S, plan, Lx.cpu().numpy())
    return TorchSupernodalFactor(S=S, Lx=Lx, minor=minor, dplan=dp,
                                 segments=1 if segs is None else len(segs))


def _cached_plan(S: SupernodalSymbolic) -> Plan:
    """A plan already built for ``S`` (any entry of ``S._torch_plan``:
    their groups are the same); raises if none was."""
    cache = getattr(S, "_torch_plan", None)
    if not cache:
        raise ValueError("no device plan for this analysis: run "
                         "factorize_device (or device_plan) first")
    return next(iter(cache.values())).plan


def _roofline_rows(plan: Plan, bytes_per_elt: int = 4,
                   update_bytes: int | None = None) -> list:
    """One row a group, in plan order: (level, R, C, B, flops, bytes).

    Flops: what the port's route computes on the padded shapes, a slot
    C^3/3 (potrf) + RU C^2 (trsm) + 2 RU^2 C (the update, a full product).
    Bytes: A's scatter (two int64 indices and the value read, the value
    written), the front zeroed and read, the panel and U written, and the
    placement of every pair class (each valid child cell read, its parent
    cell read and written, the int32 maps read: K2 and K7 place by gather,
    no product). U written and the child cells read count
    ``update_bytes`` each (default ``bytes_per_elt``; 2 for bfloat16
    updates), the rest ``bytes_per_elt``."""
    e = bytes_per_elt
    u = e if update_bytes is None else update_bytes
    rows = []
    for d, glist in enumerate(plan.groups):
        for g in glist:
            C, RU = g.C, g.R - g.C
            flops = g.B * (C ** 3 / 3 + RU * C * C + 2.0 * RU * RU * C)
            byt = g.asrc.size * (16 + 2 * e) \
                + e * g.B * (2 * g.R * g.R + g.R * C) + u * g.B * RU * RU
            for src, dst, idx in g._pair_arrays:
                cells = int(((idx >= 0).sum(1).astype(np.int64) ** 2).sum())
                byt += (u + 2 * e) * cells \
                    + 4 * (idx.size + dst.size + src.size)
            rows.append((d, g.R, g.C, g.B, float(flops), float(byt)))
    return rows


def _bound_ms(flops: float, byt: float, bytes_per_elt: int) -> float:
    return 1e3 * max(byt / CARD_BYTES_S, flops / CARD_FLOP_S[bytes_per_elt])


def roofline_report(S: SupernodalSymbolic, bytes_per_elt: int = 4,
                    update_bytes: int | None = None) -> str:
    """Per-group flop and byte accounting of the factor from the static
    plan (the counterpart of the reference's ``roofline_report``, with the
    port's routes, :func:`_roofline_rows`), each group's bound on the card
    and the TOTAL (sums; the bound summed over the groups, which run one
    after another). ``update_bytes``: the updates' itemsize (2 for a
    factor under ``update_dtype="bfloat16"``; default ``bytes_per_elt``).
    Needs a plan of ``S`` (:func:`_cached_plan`)."""
    rows = _roofline_rows(_cached_plan(S), bytes_per_elt, update_bytes)
    peak = CARD_FLOP_S[bytes_per_elt]
    upd = "" if update_bytes in (None, bytes_per_elt) else \
        f", {8 * update_bytes}-bit updates"
    lines = [f"bound: max(bytes / {CARD_BYTES_S / 1e12:g} TB/s, flops / "
             f"{peak / 1e12:g} TFLOP/s) on the {CARD}, "
             f"{8 * bytes_per_elt}-bit{upd}",
             "level  bucket(RxC)  batch    MFLOP       MB  flop/byte "
             " bound_ms"]
    tot_f = tot_b = tot_ms = 0.0
    for d, R, C, B, fl, byt in rows:
        ms = _bound_ms(fl, byt, bytes_per_elt)
        tot_f, tot_b, tot_ms = tot_f + fl, tot_b + byt, tot_ms + ms
        lines.append(f"{d:5d}  {R:5d}x{C:<5d} {B:6d} {fl / 1e6:8.1f} "
                     f"{byt / 1e6:8.1f} {fl / max(byt, 1):10.2f} {ms:9.4f}")
    lines.append(f"TOTAL  {'':12s} {'':6s} {tot_f / 1e6:8.1f} "
                 f"{tot_b / 1e6:8.1f} {tot_f / max(tot_b, 1):10.2f} "
                 f"{tot_ms:9.4f}")
    return "\n".join(lines)
