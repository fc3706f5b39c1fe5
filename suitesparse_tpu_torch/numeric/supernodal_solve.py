"""Multifrontal supernodal solve on the port's device factor.

Port of :mod:`suitesparse_tpu.numeric.supernodal_solve`: the solve plan
(per group, the panel offset and the rhs rows of its columns), the
child -> parent routing and the two sweeps of ``_mf_solve_fn`` (and
``_mf2_solve_fn``). Both sweeps walk the plan's groups (the coarse solve
plan's, below) leaves -> root (forward) and back (backward); per group
and sweep:

* ``w2`` (the reference's default on its accelerator): once per factor,
  every group gets the stacked panel W2 = [W ; L21 W] with W = L11^-1
  (identity on padding), and each step is one batched matvec:
  forward ``[xc ; v] = W2 yc``, backward ``xc = W2^T [yc ; -xb]``. Per call
  and group, ``w2_route`` picks the code: ``torch.bmm`` (the reference's
  plain matmul), or with ``Config.solve_pmv`` / ``solve_bmv`` at nrhs <= 8
  the streaming panel matvec K5 (``kernels/pmatvec``, big panels of small
  batch; W2^T is kept beside W2 for its forward step) or the batched matvec
  K6 (``kernels/bmatvec``, large batch; reads W2 in both directions).
* ``inv`` (the reference's inverse-panel sweep without W2, which its
  accelerator takes where W2 does not fit but W does): once per factor,
  every group gets W = L11^-1 (identity on padding), and each step is two
  batched matvecs: forward ``xc = W yc``, ``v = L21 xc + wb``; backward
  ``xc = W^T (yc - L21^T xb)``. ``inv_route`` picks per call and group
  ``torch.matmul`` or, with ``Config.solve_bmv`` at nrhs <= 8, K6 on both
  panels (W, and a contiguous copy of L21 kept beside it).
* ``classic`` (the reference's solve everywhere else, and its fallback
  where W2 does not fit): triangular solves on the factor's own panels.
  A group with below rows, B >= 8, C <= 96 and fp32 runs the fused K3
  step kernel (``kernels/solve_step``); any other group solves with the
  K4 batched trisolve kernel (``kernels/trisolve``: B >= 32, C <= 96,
  fp32) or ``torch.linalg.solve_triangular``, then a batched matmul
  applies L21 (forward v = wb + L21 xc, backward y - L21^T xb).

In the w2 and inv sweeps, contributions move child -> parent along the
plan's pair classes through a pass-up heap (:func:`_heap_route`), laid
out by placement: each placement owns a contiguous span of heap rows, its
classes' child slots one after another. Forward, one ``index_copy_`` a
child group puts its pass-up vectors where the classes that read them
lie, and one ``index_add_`` a placement adds its span into the parent's
vector; backward, one ``index_select`` a placement gathers its rows of
the parent's x into its span of a second heap, and one a child group
takes its below rows from there (slots no class feeds read zero). The
placements are flat-row ``index_add_``s, so classes of different RU_c
need none of the reference's padding or one-hot matrices. The sweeps
take ``ROUTE``, "fused": one placement a parent group, after the
reference's ``_fused_route`` (``SSTPU_SOLVE_FUSE_ROUTE``); it ran at or
below the class-sorted route's wall in every w2 and inv cell measured on
the card. The reference's other two routings (``ROUTES``) stay as its
parity builders, reached only through the private ``_mf_dispatch``:

* ``"merged"``: one placement an exact-RU_c bucket, after the reference's
  ``_merged_route`` (``SSTPU_SOLVE_MERGE``), with the right-hand side
  gathered once a sweep (``_pb_pregather``; each group's rows a slice),
  which the reference, too, takes only there;
* ``"sorted"``: one a class, the reference's class-sorted route
  (``_sorted_route``, its default at nrhs <= 8).

Each route's index tensors are built once per device plan
(``DevicePlan.solve[route]``), over the route-independent ones that every
sweep reads (``DevicePlan.solve_base``); the sweeps' per-factor states
(W2, inv's W) do not depend on the route. On the CPU the fused route gives
the sorted route's bits (each row's sums in the same order); the merged
route adds a group's classes bucket by bucket, and on the card
``index_add_`` sums with atomics, so there the routes agree up to the
order of the sums.

The classic sweep routes a level at a time, after the reference's mf2
sweep (``SSTPU_SOLVE_MF2``, ``build_mf2_plan``): forward, the pass-up
vectors of every group live in one heap, each level writing its groups'
vectors by one slice copy, and each parent group takes its children's
rows by one gather from the heap and one ``index_add_`` into its vector
(the reference's one-hot placement matmul); backward, the solved x of
every group lives in a second heap, and each group gathers its below
rows from it once. No op is issued per pair class, so the routes above
add nothing there, and the classic sweep reads none of them.

A factor in the CHOLMOD px layout (``TorchPxFactor``, one that
``serialize.load_factor`` put on the device) takes the px sweep, the
reference's ``_solve_fn``: its own plan (``build_px_plan``: the
supernodes of each level bucketed by padded shape, each group gathering
its panels out of ``Lx``), the panels gathered once per factor, and per
group forward ``xc = L11^-1 y[cols]``, ``y[below] -= L21 xc``
(``index_add_``: a level's supernodes update shared ancestor rows),
backward ``xc = L11^-T (y[cols] - L21^T y[below])``; the triangles by K4
under the reference's gate, else ``solve_triangular``.

The sweeps run on the coarse solve plan (the reference's
``SSTPU_SOLVE_COARSE`` with its pow4 rungs): the supernodes re-bucketed
on pow4 rungs, about a quarter of the factor plan's groups and pair
classes for about 1.3x its cells, over a copy of ``Lx`` relaid into it
(``relayout_fn``: per pair of factor and solve group one gather of the
slots and the row moves of the gapped panels; no map the size of the
factor goes to the device). The copy is built at the first solve and
kept on the factor, tied to its ``Lx`` and its device plan. Where it
does not fit in the card's free memory (the reference's
``SSTPU_COARSE_MAX_CELLS`` gate), the sweeps run on the factor's own
plan (:func:`solve_ladder` says which plan a solve takes).

``solve_dispatch`` returns the sweep as a callable and its device
arguments, every cache filled, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT, SOLVE_MODES, Config
from ..device import fp32_precision, free_bytes
from ..kernels.bmatvec import bmatvec, bmv_fits
from ..kernels.pmatvec import pmatvec_t
from ..kernels.solve_step import solve_step_bwd, solve_step_fwd, step_fits
from ..kernels.trisolve import batched_trisolve, trisolve_fits
from ..sparse import CSC
from ..stats import OFF, count, span
from ..symbolic.supernodes import SupernodalSymbolic
from .supernodal import TorchPxFactor
from .supernodal_device import (_C_LADDER, _R_LADDER, DevicePlan, _bound_ms,
                                _cached_plan, _pad_to, _ranges,
                                _use_potrf_kernel, build_plan, compute_dtype)

__all__ = ["BMV_MIN_BATCH", "MF2Plan", "PMV_MIN_CELLS", "PxPlan", "ROUTE",
           "ROUTES",
           "SolvePlan", "build_mf2_plan", "build_px_plan",
           "build_solve_plan", "build_w2", "build_winv", "classic_route",
           "inv_route", "px_panels", "px_plan", "px_route", "relayout_fn",
           "relayout_map", "solve_device", "solve_dispatch", "solve_ladder",
           "solve_mode", "solve_px", "solve_report", "w2_route"]

# the reference's defaults of SSTPU_PMV_MIN_CELLS and SSTPU_BMV_BMIN
PMV_MIN_CELLS = 1 << 20   # K5 takes a group of at least this many cells
BMV_MIN_BATCH = 32        # K6 takes a group of at least this batch

# pow4 rungs of the coarse solve plan (the reference's _SOLVE_R_LADDER and
# _SOLVE_C_LADDER): far fewer sequential group steps than the factor's
# plan, for more padded panel cells
_SOLVE_R_LADDER = [16, 64, 256, 1024, 4096, 8192]
_SOLVE_C_LADDER = [16, 64, 256, 512]
_NO_TILES = 1 << 40       # tile_rmin no group reaches: a solve plan has no
#                           tile manifest
ROUTES = ("sorted", "fused", "merged")   # the reference's solve routings
# the one the w2 and inv sweeps take: at or below the sorted route's wall
# in every w2 and inv cell of ``chip_smoke.py``'s route_phase (nrhs 1, 8
# and 64, on the card; PERF.md)
ROUTE = "fused"


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


def _plans(S: SupernodalSymbolic) -> dict:
    """``S._solve_plans``: the solve plans built for ``S`` (the px plan,
    the coarse solve plan), as the reference caches them."""
    plans = getattr(S, "_solve_plans", None)
    if plans is None:
        plans = {}
        S._solve_plans = plans
    return plans


def _coarse_plan(S: SupernodalSymbolic):
    """The coarse solve plan of ``S`` (pow4 rungs), built once and cached
    on ``S._solve_plans["coarse"]``: the factor's ``build_plan`` on other
    rungs, without tile manifests and from an empty pattern (a solve reads
    no entry of A, so its groups, panels and pair classes are the plan's
    and its A scatter is empty)."""
    plans = _plans(S)
    if "coarse" not in plans:
        n = S.n
        empty = CSC(n, n, np.zeros(n + 1, dtype=np.int64),
                    np.empty(0, dtype=np.int64), np.empty(0), 1)
        plans["coarse"] = build_plan(
            S, empty, tile_rmin=_NO_TILES,
            ladders=(_SOLVE_R_LADDER, _SOLVE_C_LADDER))
    return plans["coarse"]


def _snode_panels(S: SupernodalSymbolic, plan):
    """Per-supernode (flat panel base, R, C) for a device plan."""
    base = np.zeros(S.nsuper, dtype=np.int64)
    Rs = np.zeros(S.nsuper, dtype=np.int64)
    Cs = np.zeros(S.nsuper, dtype=np.int64)
    for gl in plan.groups:
        for g in gl:
            for b, s in enumerate(g.snodes):
                base[s] = g.panel_base + b * g.R * g.C
                Rs[s] = g.R
                Cs[s] = g.C
    return base, Rs, Cs


def relayout_map(S: SupernodalSymbolic, plan1, plan2) -> np.ndarray:
    """int32 gather map: Lx2[i] = Lx1[map[i]] (sentinel plan1.dev_size for
    plan2 padding, which the padded source resolves to 0).

    Device panels are GAPPED row-major (R, C): supernode s's pivot rows sit
    at panel rows [0, nc) and its below rows at [C, C + nr - nc) — the gap
    [nc, C) is the dead-pivot padding region, which must stay zero. The
    reference's map, the oracle of :func:`relayout_fn`."""
    b1, R1, C1 = _snode_panels(S, plan1)
    b2, R2, C2 = _snode_panels(S, plan2)
    m = np.full(plan2.dev_size, plan1.dev_size, dtype=np.int64)
    for s in range(S.nsuper):
        nr = len(S.rows[s])
        nc = int(S.super_first[s + 1] - S.super_first[s])
        r1 = np.concatenate([np.arange(nc), C1[s] + np.arange(nr - nc)])
        r2 = np.concatenate([np.arange(nc), C2[s] + np.arange(nr - nc)])
        c = np.arange(nc, dtype=np.int64)[None, :]
        src = b1[s] + r1[:, None] * C1[s] + c
        dst = b2[s] + r2[:, None] * C2[s] + c
        m[dst.ravel()] = src.ravel()
    assert m.max() <= np.iinfo(np.int32).max
    return m.astype(np.int32)


def relayout_fn(S: SupernodalSymbolic, plan1, plan2):
    """``fn(Lx1) -> Lx2``: a factor in ``plan1``'s layout relaid into
    ``plan2``'s on ``Lx1``'s device, equal to :func:`relayout_map`'s
    gather (zero on every padded cell of ``plan2``).

    Each supernode keeps its gapped panel: its pivot rows at [0, nc), its
    below rows from C on. So for each (``plan1`` group g1, ``plan2`` group
    g2) whose supernodes meet, the move is shape-static: one gather of
    the slots out of g1's panels, then rows [0, min(C1, C2)) land at the
    top of g2's slots and rows [C1, C1 + min(RU1, RU2)) at [C2, ...),
    columns [0, min(C1, C2)), each by one ``index_put_`` (what is cut
    off is padding: nc <= min(C1, C2) and nr - nc <= min(RU1, RU2)).
    Only the slot vectors cross to the device, once a device."""
    g1s = [g for gl in plan1.groups for g in gl]
    gid = np.zeros(S.nsuper, dtype=np.int64)
    slot = np.zeros(S.nsuper, dtype=np.int64)
    for k, g in enumerate(g1s):
        gid[g.snodes] = k
        slot[g.snodes] = np.arange(g.B)
    moves = []
    for gl in plan2.groups:
        for g2 in gl:
            k1 = gid[g2.snodes]
            for k in np.unique(k1):
                dst = np.flatnonzero(k1 == k)
                moves.append((g1s[k], g2, slot[g2.snodes[dst]], dst))
    on_device: dict = {}

    def fn(lx: torch.Tensor) -> torch.Tensor:
        dev = lx.device
        if str(dev) not in on_device:
            on_device[str(dev)] = [
                (g1, g2, torch.as_tensor(src, device=dev),
                 torch.as_tensor(dst, device=dev))
                for g1, g2, src, dst in moves]
        out = lx.new_zeros(plan2.dev_size)
        for g1, g2, src, dst in on_device[str(dev)]:
            P = lx[g1.panel_base:g1.panel_base + g1.B * g1.R * g1.C].view(
                g1.B, g1.R, g1.C)[src]
            Q = out[g2.panel_base:g2.panel_base + g2.B * g2.R * g2.C].view(
                g2.B, g2.R, g2.C)
            c = min(g1.C, g2.C)
            nb = min(g1.R - g1.C, g2.R - g2.C)
            Q[dst, :c, :c] = P[:, :c, :c]
            if nb > 0:
                Q[dst, g2.C:g2.C + nb, :c] = P[:, g1.C:g1.C + nb, :c]
        return out

    return fn


def _coarse_entry(S: SupernodalSymbolic, dp: DevicePlan):
    """(the coarse solve plan's :class:`DevicePlan` on ``dp``'s device,
    the relayout of ``dp``'s layout into it), built once per (factor
    plan, coarse plan) and cached on ``dp.coarse``."""
    if dp.coarse is None:
        with span("solve.plan"):
            plan2 = _coarse_plan(S)
            dp.coarse = (DevicePlan(plan=plan2, device=dp.device,
                                    groups=None),
                         relayout_fn(S, dp.plan, plan2))
    return dp.coarse


def _coarse_copy(F):
    """The relayouted copy of ``F.Lx`` if it is built for this ``Lx`` and
    this device plan, else None."""
    c = F._solve.get(("relayout",))
    if c is not None and c[0] is F.Lx and c[1] is F.dplan:
        return c[2]
    return None


def _coarse_lx(F) -> torch.Tensor:
    """``F.Lx`` relaid into the coarse solve plan, built once and kept on
    ``F._solve[("relayout",)]``, tied to ``F.Lx`` and to ``F.dplan``: a
    new factor, or a factor whose device plan was swapped, rebuilds it
    (the reference's ``test_coarse_solve_after_distributed_swap``)."""
    lx2 = _coarse_copy(F)
    if lx2 is None:
        F._solve.pop(("relayout",), None)     # let the old copy go
        relayout = _coarse_entry(F.S, F.dplan)[1]
        with span("solve.relayout"):
            lx2 = relayout(F.Lx)
        count("relayout.build")
        F._solve[("relayout",)] = (F.Lx, F.dplan, lx2)
    return lx2


def _coarse_need(F) -> int:
    """Bytes the relayouted copy of ``F.Lx`` still asks of the device
    (0 where it is built)."""
    if _coarse_copy(F) is not None:
        return 0
    return _coarse_plan(F.S).dev_size * F.Lx.element_size()


def solve_ladder(F) -> str:
    """The plan the multifrontal sweeps of the device factor ``F`` take:
    ``"coarse"`` (the coarse solve plan, over the relayouted copy of
    ``Lx``) where that copy is built or fits in the card's free memory
    (the reference's ``SSTPU_COARSE_MAX_CELLS`` gate on the card's memory,
    as :func:`_w2_fits`; a CPU factor always fits), else ``"fine"`` (the
    factor's own plan)."""
    dev = F.Lx.device
    if dev.type != "cuda" or _coarse_need(F) <= free_bytes(dev):
        return "coarse"
    return "fine"


def _solve_target(F, ladder: str):
    """(the :class:`DevicePlan` the sweep walks, the panels it reads) of
    ``F`` on ``ladder``: the coarse plan's and the relayouted copy, or
    the factor's own."""
    if ladder == "fine":
        return F.dplan, F.Lx
    return _coarse_entry(F.S, F.dplan)[0], _coarse_lx(F)


@dataclasses.dataclass
class SolveBase:
    """The index tensors that every sweep of the multifrontal solve reads,
    whatever its route, on the plan's device: built once per device plan
    (``DevicePlan.solve_base``)."""

    splan: SolvePlan
    col_idx: list        # col_idx[d][gi]: (B*C,) rows of the permuted rhs
    xmap: torch.Tensor   # (n,) row of the concatenated xc holding column j
    heap: object = None  # the classic sweep's level routing
    #                      (:class:`MF2Routing`), built at its first solve


@dataclasses.dataclass
class SolveRouting:
    """Index tensors of the w2 and inv sweeps on one route, on the plan's
    device; ``splan``, ``col_idx`` and ``xmap`` are the plan's
    :class:`SolveBase`'s."""

    splan: SolvePlan
    col_idx: list
    xmap: torch.Tensor
    route: str
    # places[d][gi] = [(lo, hi, rows)], one a placement: it adds rows
    # lo:hi of the pass-up heap into the group's (B*R + 1) vector rows
    # ``rows`` (forward) and gathers those rows of its x back into heap
    # rows lo:hi (backward); hrows[child key]: the heap row of each of the
    # child group's (B*RU) pass-up rows (rows no class reads: the heap's
    # rows from ``ndata`` on, which the backward heap holds at zero);
    # ``nheap`` heap rows in all (:func:`_heap_route`)
    places: list
    hrows: dict
    ndata: int
    nheap: int
    # "merged": (the rhs rows of every group, concatenated; {(d, gi):
    # offset of its rows}) from :func:`_pb_pregather`, else None
    pregather: tuple | None = None


def _sorted_route(plan) -> tuple[dict, dict]:
    """The class-sorted routing maps of the factor plan ``plan``, after the
    reference's ``_sorted_route``: ({child key: (cat, inv, ncat)},
    {(d, gi, ci): (off, hi)}).

    ``cat`` lists a child group's slots in consuming-class order (the
    ``src`` of each class that reads the group, one after another, in plan
    order), so class ci of group (d, gi) reads rows off:hi of the sorted
    buffer; ``inv`` maps each slot to its row there, and a slot that no
    class reads to the zero pad row ``ncat``. The classes of one child
    group must read disjoint slots (the routing runs along tree edges);
    a plan where they do not raises ``ValueError``. The "sorted" route
    lays the same classes out on the pass-up heap (:func:`_heap_route`);
    the parity tests hold its spans to these maps."""
    order: dict = {}
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            for ci, (pc, (src, _dst, _idx)) in enumerate(
                    zip(g.pairs, g._pair_arrays)):
                order.setdefault((pc.src_level, pc.src_gi), []).append(
                    ((d, gi, ci), np.asarray(src, dtype=np.int64)))
    groups_map, class_map = {}, {}
    for key, lst in order.items():
        cat = np.concatenate([s for _pk, s in lst])
        if np.unique(cat).size != cat.size:
            raise ValueError(f"_sorted_route: the classes that read child "
                             f"group {key} share slots")
        inv = np.full(plan.groups[key[0]][key[1]].B, cat.size,
                      dtype=np.int64)
        inv[cat] = np.arange(cat.size)
        off = 0
        for pk, s in lst:
            class_map[pk] = (off, off + s.size)
            off += s.size
        groups_map[key] = (cat, inv, cat.size)
    return groups_map, class_map


def _merged_route(fg):
    """The pair classes of parent group ``fg`` bucketed by exact RU_c, the
    reference's ``_merged_route`` (a copy, cached on ``fg._solve_merged``):
    [(idxcat (npt, RU_c), dstcat (npt,), metas)] in order of each bucket's
    first class, metas = [(src_level, src_gi, src, k0, k1)], the classes
    of a bucket one after another along the pair axis."""
    mr = getattr(fg, "_solve_merged", None)
    if mr is None:
        byru: dict = {}
        for pc, (src, dst, idx) in zip(fg.pairs, fg._pair_arrays):
            byru.setdefault(pc.RU_c, []).append((pc, src, dst, idx))
        mr = []
        for _ru, lst in byru.items():
            k0, metas = 0, []
            for (pc, src, dst, idx) in lst:
                metas.append((pc.src_level, pc.src_gi, src, k0,
                              k0 + src.size))
                k0 += src.size
            mr.append((np.concatenate([idx for (_p, _s, _d, idx) in lst],
                                      axis=0),
                       np.concatenate([d for (_p, _s, d, _i) in lst]),
                       metas))
        fg._solve_merged = mr
    return mr


def _pb_pregather(splan: SolvePlan):
    """One gather of the right-hand side for a whole sweep, the
    reference's ``_pb_pregather`` (a copy, cached on
    ``splan._pb_pregather``): (every group's ``col_idx`` concatenated in
    plan order, {(d, gi): offset of the group's rows})."""
    pg = getattr(splan, "_pb_pregather", None)
    if pg is None:
        idxs, offs = [], {}
        off = 0
        for d, gl in enumerate(splan.groups):
            for gi, sg in enumerate(gl):
                idxs.append(sg.col_idx)
                offs[(d, gi)] = off
                off += sg.col_idx.size
        pg = (np.concatenate(idxs) if idxs else np.empty(0, np.int64), offs)
        splan._pb_pregather = pg
    return pg


def _fused_route(fg):
    """All pair classes of parent group ``fg`` in one placement, the
    reference's ``_fused_route`` (a copy, cached on ``fg._solve_fused``):
    (idxcat (NP, RUmax) int32 padded with -1, dstcat (NP,), metas, RUmax),
    metas = [(src_level, src_gi, src, k0, k1, RU_c)] in plan order; None
    for a group without classes. The port reads each class's RU_c columns
    of ``idxcat`` and builds no one-hot matrix."""
    fr = getattr(fg, "_solve_fused", None)
    if fr is None and fg.pairs:
        RUmax = max(pc.RU_c for pc in fg.pairs)
        idxs, dsts, metas = [], [], []
        k0 = 0
        for pc, (src, dst, idx) in zip(fg.pairs, fg._pair_arrays):
            idxs.append(np.pad(idx, ((0, 0), (0, RUmax - idx.shape[1])),
                               constant_values=-1))
            dsts.append(dst)
            metas.append((pc.src_level, pc.src_gi, src, k0, k0 + src.size,
                          pc.RU_c))
            k0 += src.size
        fr = (np.concatenate(idxs, axis=0), np.concatenate(dsts),
              metas, RUmax)
        fg._solve_fused = fr
    return fr


def _placements(g, route: str) -> list:
    """The placements of parent group ``g`` on ``route`` ("sorted": one a
    class, in plan order; "fused": one, :func:`_fused_route`; "merged":
    one an RU_c bucket, :func:`_merged_route`), each a list of its
    classes as (child key, src, dst, idx) in the placement's order."""
    if not g.pairs:
        return []
    if route == "sorted":
        return [[((pc.src_level, pc.src_gi), src, dst, idx)]
                for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays)]
    if route == "fused":
        idxcat, dstcat, metas, _RUmax = _fused_route(g)
        return [[((sl, sgi), src, dstcat[k0:k1], idxcat[k0:k1, :ruc])
                 for (sl, sgi, src, k0, k1, ruc) in metas]]
    return [[((sl, sgi), src, dstcat[k0:k1], idxcat[k0:k1])
             for (sl, sgi, src, k0, k1) in metas]
            for (idxcat, dstcat, metas) in _merged_route(g)]


def _heap_route(plan, route: str):
    """The pass-up heap of ``route`` (one of :data:`ROUTES`) on the factor
    plan ``plan``: (places, hrows, ndata, nheap) as :class:`SolveRouting`
    holds them, in numpy.

    Each placement owns a contiguous span of heap rows: its classes one
    after another, each class its pairs, each pair the RU rows of its
    child slot. A child group writes its pass-up vectors into the spans
    of the classes that read them with one scatter (``index_copy_``), so
    each placement reads its span as it lies; its rows no class reads go
    to rows of their own after the data. The classes of one child group
    must read disjoint slots (as :func:`_sorted_route`'s); a plan where
    they do not raises ``ValueError``."""
    places, hrows = [], {}
    off = 0
    for glist in plan.groups:
        row = []
        for g in glist:
            pl = []
            for members in _placements(g, route):
                lo, rows = off, []
                for key, src, dst, idx in members:
                    cg = plan.groups[key[0]][key[1]]
                    RU = cg.R - cg.C
                    h = hrows.setdefault(key, np.full(cg.B * RU, -1,
                                                      dtype=np.int64))
                    at = (np.asarray(src, dtype=np.int64)[:, None] * RU
                          + np.arange(RU)).ravel()
                    if (h[at] >= 0).any():
                        raise ValueError(f"_heap_route: the classes that "
                                         f"read child group {key} share "
                                         f"slots")
                    h[at] = off + np.arange(at.size)
                    off += at.size
                    rows.append(np.where(
                        idx >= 0, dst.astype(np.int64)[:, None] * g.R + idx,
                        g.B * g.R).ravel())
                pl.append((lo, off, np.concatenate(rows)))
            row.append(pl)
        places.append(row)
    ndata = off
    for h in hrows.values():
        free = np.flatnonzero(h < 0)
        h[free] = off + np.arange(free.size)
        off += free.size
    return places, hrows, ndata, off


def _t64(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)


def _solve_base(S, dp: DevicePlan) -> SolveBase:
    """The :class:`SolveBase` of ``dp``, built at its first solve and
    cached on ``dp.solve_base``."""
    if dp.solve_base is None:
        splan = build_solve_plan(S, dp.plan)
        dp.solve_base = SolveBase(
            splan=splan,
            col_idx=[[_t64(sg.col_idx, dp.device) for sg in sglist]
                     for sglist in splan.groups],
            xmap=_t64(_mf_xmap(S, dp.plan), dp.device))
    return dp.solve_base


def _routing(S, dp: DevicePlan, route: str = ROUTE) -> SolveRouting:
    """The routing of ``route`` (one of :data:`ROUTES`), built once per
    device plan and route and cached on ``dp.solve[route]`` (F3): the
    pass-up heap of :func:`_heap_route`, each placement's ``rows``
    flattening (dst, idx) into the parent's (B*R + 1) vector rows with
    idx < 0 sent to the last (dump) row, and for "merged" the rhs
    pre-gather (:func:`_pb_pregather`). The routes share the plan's
    :class:`SolveBase`."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route in dp.solve:
        return dp.solve[route]
    base = _solve_base(S, dp)
    dev = dp.device
    places, hrows, ndata, nheap = _heap_route(dp.plan, route)
    pregather = None
    if route == "merged":
        idx, offs = _pb_pregather(base.splan)
        pregather = (_t64(idx, dev), offs)
    dp.solve[route] = SolveRouting(
        splan=base.splan, col_idx=base.col_idx, xmap=base.xmap, route=route,
        places=[[[(lo, hi, _t64(rows, dev)) for lo, hi, rows in pl]
                 for pl in row] for row in places],
        hrows={k: _t64(h, dev) for k, h in hrows.items()}, ndata=ndata,
        nheap=nheap, pregather=pregather)
    return dp.solve[route]


def _split_panels(P: torch.Tensor, nc: np.ndarray):
    """(L11, L21) of a group's panels P (B, R, C) whose slot b holds nc[b]
    columns: L11 an identity-padded copy, L21 a view into P (batch stride
    R*C, contiguous rows)."""
    B, _R, C = P.shape
    ar = torch.arange(C, device=P.device)
    ncb = torch.as_tensor(nc, device=P.device).view(B, 1, 1)
    live = (ar[:, None] < ncb) & (ar[None, :] < ncb)
    eye = torch.eye(C, dtype=P.dtype, device=P.device)
    return torch.where(live, P[:, :C], eye), P[:, C:]


def _group_panels(Lx: torch.Tensor, sg, dtype):
    """(L11, L21) of one solve group of the device layout."""
    B, R, C = sg.B, sg.R, sg.C
    P = Lx[sg.panel_base:sg.panel_base + B * R * C].view(B, R, C).to(dtype)
    return _split_panels(P, sg.nc)


def build_w2(splan: SolvePlan, Lx: torch.Tensor, dtype) -> list:
    """W2[d][gi] = [W ; L21 W] (B, R, C), W = L11^{-1}, for every group.

    Built once per factor in true fp32 whatever the configured precision:
    an error baked into W2 reaches every later solve. Each W2 is contiguous
    (``solve_triangular`` returns column-major W), as the K5 and K6 kernels
    read it."""
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
                           if sg.R > sg.C else W.contiguous())
            out.append(row)
    return out


def inv_route(B: int, C: int, RU: int, nrhs: int,
              config: Config = DEFAULT) -> str:
    """Which code applies a group's W (B, C, C) and L21 (B, RU, C) in the
    inv sweep: ``"bmv"`` (K6 on both panels, both directions) or
    ``"matmul"`` (``torch.matmul``). The reference's ``_use_bmv`` without
    its W2 row count: ``config.solve_bmv``, fp32, B >= ``BMV_MIN_BATCH``,
    nrhs <= 8 and :func:`bmv_fits` for (C, C) and, with below rows, for
    (RU, C)."""
    if not config.solve_bmv or compute_dtype(config) != torch.float32 \
            or nrhs > 8 or B < BMV_MIN_BATCH:
        return "matmul"
    if bmv_fits(C, C, nrhs) and (RU == 0 or bmv_fits(RU, C, nrhs)):
        return "bmv"
    return "matmul"


def build_winv(splan: SolvePlan, Lx: torch.Tensor, dtype,
               config: Config = DEFAULT) -> list:
    """winv[d][gi] = (W, L21c) for every group: W = L11^{-1} (B, C, C),
    identity on padding and contiguous, as the reference's ``build_winv``
    with ``w2=False`` builds it; L21c a contiguous copy of the group's L21
    (B, RU, C) where :func:`inv_route` sends the group to K6 at nrhs = 1
    (the route of every nrhs <= 8 it admits), else None (the sweep reads
    the factor's own L21). Built once per factor in true fp32, as W2 is."""
    out = []
    with fp32_precision("highest"):
        for sglist in splan.groups:
            row = []
            for sg in sglist:
                L11, L21 = _group_panels(Lx, sg, dtype)
                eye = torch.eye(sg.C, dtype=dtype, device=Lx.device)
                W = torch.linalg.solve_triangular(
                    L11, eye.expand(sg.B, sg.C, sg.C), upper=False)
                RU = sg.R - sg.C
                bmv = inv_route(sg.B, sg.C, RU, 1, config) == "bmv"
                row.append((W.contiguous(),
                            L21.contiguous() if bmv and RU > 0 else None))
            out.append(row)
    return out


def w2_route(B: int, R: int, C: int, nrhs: int,
             config: Config = DEFAULT) -> str:
    """Which code applies a group's W2 (B, R, C) in the w2 sweep:
    ``"pmv"`` (K5), ``"bmv"`` (K6) or ``"matmul"`` (``torch.bmm``).

    The reference's gates in its order, pmv first (``build_winv``): pmv
    needs ``config.solve_pmv``, B <= 32, nrhs <= 8 and B*R*C >=
    ``PMV_MIN_CELLS``; bmv needs ``config.solve_bmv``, B >=
    ``BMV_MIN_BATCH``, nrhs <= 8 and :func:`bmv_fits`. Both kernels are
    fp32. The reference's padding-ratio and VMEM clauses (``_use_pmv``,
    ``_use_bmv``) are TPU layout and are dropped."""
    if compute_dtype(config) != torch.float32 or nrhs > 8:
        return "matmul"
    if config.solve_pmv and B <= 32 and B * R * C >= PMV_MIN_CELLS:
        return "pmv"
    if config.solve_bmv and B >= BMV_MIN_BATCH and bmv_fits(R, C, nrhs):
        return "bmv"
    return "matmul"


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


def build_w2t(splan: SolvePlan, W2: list, config: Config) -> list:
    """W2t[d][gi] = W2^T (B, C, R) for the groups ``w2_route`` sends to K5
    at nrhs = 1 (the route of every nrhs <= 8), else None: K5 reduces over
    the panel's leading axis, so its forward step reads W2^T."""
    return [[W2[d][gi].mT.contiguous()
             if w2_route(sg.B, sg.R, sg.C, 1, config) == "pmv" else None
             for gi, sg in enumerate(sglist)]
            for d, sglist in enumerate(splan.groups)]


def _w2_steps(splan: SolvePlan, W2: list, W2t: list, nrhs: int,
              config: Config):
    """(forward, backward) group steps of the w2 sweep at ``nrhs``."""
    routes = [[w2_route(sg.B, sg.R, sg.C, nrhs, config) for sg in sglist]
              for sglist in splan.groups]

    def fwd(d, gi, yc, wb):
        route = routes[d][gi]
        if route == "pmv":
            z = pmatvec_t(W2t[d][gi], yc)
        elif route == "bmv":
            z = bmatvec(W2[d][gi], yc)
        else:
            z = torch.bmm(W2[d][gi], yc)
        C = yc.shape[1]
        return z[:, :C], (None if wb is None else z[:, C:] + wb)

    def bwd(d, gi, yc, xb):
        yin = yc if xb is None else torch.cat([yc, -xb], dim=1)
        route = routes[d][gi]
        if route == "pmv":
            return pmatvec_t(W2[d][gi], yin)
        if route == "bmv":
            return bmatvec(W2[d][gi], yin, transpose=True)
        return torch.bmm(W2[d][gi].mT, yin)

    return fwd, bwd


def _inv_steps(splan: SolvePlan, Lx: torch.Tensor, winv: list, nrhs: int,
               config: Config):
    """(forward, backward) group steps of the inv sweep at ``nrhs``."""
    routes = [[inv_route(sg.B, sg.C, sg.R - sg.C, nrhs, config)
               for sg in sglist] for sglist in splan.groups]

    def L21_of(d, gi):
        sg = splan.groups[d][gi]
        L21c = winv[d][gi][1]
        if L21c is not None:
            return L21c
        return Lx[sg.panel_base:sg.panel_base + sg.B * sg.R * sg.C].view(
            sg.B, sg.R, sg.C)[:, sg.C:]

    def fwd(d, gi, yc, wb):
        W = winv[d][gi][0]
        if routes[d][gi] == "bmv":
            xc = bmatvec(W, yc.contiguous())
            v = None if wb is None else bmatvec(L21_of(d, gi), xc) + wb
            return xc, v
        xc = torch.matmul(W, yc)
        return xc, (None if wb is None
                    else torch.baddbmm(wb, L21_of(d, gi), xc))

    def bwd(d, gi, yc, xb):
        W = winv[d][gi][0]
        if routes[d][gi] == "bmv":
            if xb is not None:
                yc = yc - bmatvec(L21_of(d, gi), xb.contiguous(),
                                  transpose=True)
            return bmatvec(W, yc.contiguous(), transpose=True)
        if xb is not None:
            yc = torch.baddbmm(yc, L21_of(d, gi).mT, xb, alpha=-1)
        return torch.matmul(W.mT, yc)

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


def _rhs_reader(rt: SolveRouting, pb: torch.Tensor):
    """``rhs(d, gi)``: the rows of ``pb`` that group (d, gi) reads. With
    ``rt.pregather`` (the merged route) every group's rows are gathered
    here at once and each group's are a slice; else one gather a group."""
    if rt.pregather is None:
        return lambda d, gi: pb[rt.col_idx[d][gi]]
    idx, offs = rt.pregather
    pbcat = pb.index_select(0, idx)
    return lambda d, gi: pbcat[
        offs[(d, gi)]:offs[(d, gi)] + rt.col_idx[d][gi].numel()]


def _mf_solve_fn(dp: DevicePlan, rt: SolveRouting, pb: torch.Tensor,
                 fwd, bwd) -> torch.Tensor:
    """xcat (sum B*C, nrhs) from the permuted rhs ``pb`` (n+1, nrhs) whose
    last row is zero (the dump row that padded columns read), the pass-up
    vectors moving through the heap of ``rt``'s route (:func:`_heap_route`).

    ``fwd(d, gi, yc, wb) -> (xc, v)`` and ``bwd(d, gi, yc, xb) -> xc`` are
    one group's steps (wb, xb, v are None for a group without below rows).
    Forward, each group adds its placements' heap spans into its vector
    (one ``index_add_`` a placement) and scatters its own pass-up vectors
    into the heap (one ``index_copy_``); each group reads its rhs rows
    through :func:`_rhs_reader`.
    Backward, each placement gathers its rows of the group's x into its
    span of a second heap (one ``index_select``), and each child group
    gathers its below rows out of it (one ``index_select``; rows no class
    feeds read zero)."""
    plan = dp.plan
    nrhs = pb.shape[1]
    dtype, dev = pb.dtype, pb.device

    rhs = _rhs_reader(rt, pb)
    vheap = torch.empty(rt.nheap, nrhs, dtype=dtype, device=dev)
    yfwd: dict = {}
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            B, R, C = g.B, g.R, g.C
            w = torch.zeros(B * R + 1, nrhs, dtype=dtype, device=dev)
            for lo, hi, rows in rt.places[d][gi]:
                w.index_add_(0, rows, vheap[lo:hi])
            w = w[:-1].view(B, R, nrhs)
            yc = rhs(d, gi).view(B, C, nrhs) - w[:, :C]
            xc, v = fwd(d, gi, yc, w[:, C:] if R > C else None)
            yfwd[(d, gi)] = xc
            if (d, gi) in rt.hrows:
                vheap.index_copy_(0, rt.hrows[(d, gi)], v.reshape(-1, nrhs))

    xheap = torch.empty(rt.nheap, nrhs, dtype=dtype, device=dev)
    if rt.nheap > rt.ndata:
        xheap[rt.ndata:].zero_()
    xcs: dict = {}
    for d in range(len(plan.groups) - 1, -1, -1):
        for gi in range(len(plan.groups[d]) - 1, -1, -1):
            g = plan.groups[d][gi]
            B, R, C = g.B, g.R, g.C
            RU = R - C
            below = None
            if (d, gi) in rt.hrows:
                below = xheap.index_select(0, rt.hrows[(d, gi)]).view(
                    B, RU, nrhs)
            elif RU > 0:
                below = torch.zeros(B, RU, nrhs, dtype=dtype, device=dev)
            xc = bwd(d, gi, yfwd.pop((d, gi)), below)
            xcs[(d, gi)] = xc
            if not rt.places[d][gi]:
                continue
            fx = torch.cat([xc, below], dim=1) if RU > 0 else xc
            fx = torch.cat([fx.reshape(B * R, nrhs), fx.new_zeros(1, nrhs)])
            for lo, hi, rows in rt.places[d][gi]:
                torch.index_select(fx, 0, rows, out=xheap[lo:hi])
    return torch.cat([xcs[(d, gi)].reshape(-1, nrhs)
                      for d in range(len(plan.groups))
                      for gi in range(len(plan.groups[d]))])


@dataclasses.dataclass
class MF2Plan:
    """Per-level fused contribution routing of the reference's mf2 sweep,
    which the classic sweep takes (a copy).

    Forward: child pass-up vectors live in one global V-heap (rows =
    concatenated per-group (B*RU) blocks, schedule order, plus a zero dump
    row); each parent group reads its children's rows with one gather.

    Backward: solved x values live in an x-heap (concatenated per-group
    (B*C) blocks — exactly the ``_mf_xmap`` layout); each group PULLS its
    below-row values with one static gather (below rows are columns of
    ancestors, already solved when the backward sweep reaches the group)."""

    vbase: dict          # (d, gi) -> row base of the group's V block
    vrows: int           # total V-heap rows (excl. dump)
    lv_vbase: list       # level -> base row of the level's first group
    xbase: dict          # (d, gi) -> row base of the group's xc block
    xrows: int
    lv_xbase: list
    # per level, per group: (NP, RUmax) src rows into the V-heap, (NP,
    # RUmax) front coords (pad -1), (NP,) dst slots, or None
    lv_route: list
    # per group: (B*RU,) x-heap positions of its below rows (pad -> dump)
    xpos: dict


def build_mf2_plan(S: SupernodalSymbolic, plan) -> MF2Plan:
    """The :class:`MF2Plan` of the factor plan ``plan`` (the reference's
    ``build_mf2_plan``, a copy)."""
    vbase, xbase = {}, {}
    lv_vbase, lv_xbase = [], []
    voff = xoff = 0
    for d, glist in enumerate(plan.groups):
        lv_vbase.append(voff)
        lv_xbase.append(xoff)
        for gi, g in enumerate(glist):
            vbase[(d, gi)] = voff
            xbase[(d, gi)] = xoff
            voff += g.B * max(g.R - g.C, 0)
            xoff += g.B * g.C
    vrows, xrows = voff, xoff

    # column -> x-heap position (for below-row pulls)
    colpos = np.empty(S.n, dtype=np.int64)
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            for b, s in enumerate(g.snodes):
                f = int(S.super_first[s])
                nc = int(S.super_first[s + 1]) - f
                colpos[f:f + nc] = xbase[(d, gi)] + b * g.C + np.arange(nc)

    lv_route = []
    xpos = {}
    for d, glist in enumerate(plan.groups):
        # forward routing: one route per parent group, padded to the
        # group's own max child RU
        routes = []
        for gi, g in enumerate(glist):
            srcs, coords, dsts = [], [], []
            RUmax = 1
            for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays):
                cb = vbase[(pc.src_level, pc.src_gi)]
                RU_c = pc.RU_c
                RUmax = max(RUmax, RU_c)
                # V-heap rows of each pair's child block
                rows = (cb + src.astype(np.int64)[:, None] * RU_c
                        + np.arange(RU_c)[None, :])
                rows = np.where(idx >= 0, rows, vrows)   # pad -> dump row
                srcs.append(rows)
                coords.append(idx)
                dsts.append(dst.astype(np.int64))
            if not srcs:
                routes.append(None)
                continue
            NP = sum(a.shape[0] for a in srcs)
            sr = np.full((NP, RUmax), vrows, dtype=np.int64)
            co = np.full((NP, RUmax), -1, dtype=np.int32)
            k = 0
            for a, c in zip(srcs, coords):
                sr[k:k + a.shape[0], :a.shape[1]] = a
                co[k:k + a.shape[0], :c.shape[1]] = c
                k += a.shape[0]
            ds = np.concatenate(dsts)
            order = np.argsort(ds, kind="stable")
            routes.append((sr[order], co[order],
                           ds[order].astype(np.int32)))
        lv_route.append(routes)
        # backward pulls
        for gi, g in enumerate(glist):
            RU = g.R - g.C
            if RU <= 0:
                continue
            pos = np.full(g.B * RU, xrows, dtype=np.int64)
            for b, s in enumerate(g.snodes):
                nc = S.ncols(int(s))
                below = S.rows[s][nc:]
                pos[b * RU:b * RU + below.size] = colpos[below]
            xpos[(d, gi)] = pos
    return MF2Plan(vbase=vbase, vrows=vrows, lv_vbase=lv_vbase,
                   xbase=xbase, xrows=xrows, lv_xbase=lv_xbase,
                   lv_route=lv_route, xpos=xpos)


@dataclasses.dataclass
class MF2Routing:
    """The classic sweep's level routing (:class:`MF2Plan`) as index
    tensors on the plan's device."""

    nv: int              # rows of the V-heap (MF2Plan.vrows)
    nx: int              # rows of the x-heap (MF2Plan.xrows)
    # fwd[d][gi]: (V-heap rows, rows of the parent's (B*R) vector) of every
    # real child row that group (d, gi) takes in, or None
    fwd: list
    xpos: list           # xpos[d][gi]: x-heap rows of its below rows, or None
    vlevel: list         # vlevel[d]: (first, end) heap rows of level d's V
    xlevel: list         # xlevel[d]: (first, end) heap rows of level d's x


def _heap_routing(S, dp: DevicePlan, base: SolveBase) -> MF2Routing:
    """Built once per device plan (``base.heap``, on the plan's
    :class:`SolveBase`): :func:`build_mf2_plan`, each route's padded
    entries (front coordinate -1) dropped and the rest flattened to (heap
    row, parent row) pairs."""
    if base.heap is None:
        plan, dev = dp.plan, dp.device
        m2 = build_mf2_plan(S, plan)

        def t64(a):
            return _t64(a, dev)

        fwd, xpos, vlevel, xlevel = [], [], [], []
        for d, glist in enumerate(plan.groups):
            row = []
            for gi, g in enumerate(glist):
                route = m2.lv_route[d][gi]
                if route is None:
                    row.append(None)
                    continue
                sr, co, ds = route
                live = co >= 0
                dst = ds.astype(np.int64)[:, None] * g.R + co
                row.append((t64(sr[live]), t64(dst[live])))
            fwd.append(row)
            xpos.append([t64(m2.xpos[(d, gi)]) if (d, gi) in m2.xpos
                         else None for gi in range(len(glist))])
            vend = sum(g.B * max(g.R - g.C, 0) for g in glist)
            xend = sum(g.B * g.C for g in glist)
            vlevel.append((m2.lv_vbase[d], m2.lv_vbase[d] + vend))
            xlevel.append((m2.lv_xbase[d], m2.lv_xbase[d] + xend))
        base.heap = MF2Routing(nv=m2.vrows, nx=m2.xrows, fwd=fwd,
                               xpos=xpos, vlevel=vlevel, xlevel=xlevel)
    return base.heap


def _mf2_solve_fn(dp: DevicePlan, base: SolveBase, mr: MF2Routing,
                  pb: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """xcat (sum B*C, nrhs) from the permuted rhs ``pb`` (n+1, nrhs, last
    row zero) by the classic sweep's level routing (the module docstring,
    the reference's mf2 sweep); ``fwd`` and ``bwd`` are the classic
    sweep's group steps. Within a level no group reads another's V or x,
    so each level writes its own by one copy after its groups."""
    plan = dp.plan
    nrhs = pb.shape[1]
    dtype, dev = pb.dtype, pb.device

    vheap = torch.zeros(mr.nv, nrhs, dtype=dtype, device=dev)
    yfwd: dict = {}
    for d, glist in enumerate(plan.groups):
        vparts = []
        for gi, g in enumerate(glist):
            B, R, C = g.B, g.R, g.C
            w = torch.zeros(B * R, nrhs, dtype=dtype, device=dev)
            route = mr.fwd[d][gi]
            if route is not None:
                w.index_add_(0, route[1], vheap.index_select(0, route[0]))
            w = w.view(B, R, nrhs)
            yc = pb[base.col_idx[d][gi]].view(B, C, nrhs) - w[:, :C]
            xc, v = fwd(d, gi, yc, w[:, C:] if R > C else None)
            yfwd[(d, gi)] = xc
            if v is not None:
                vparts.append(v.reshape(-1, nrhs))
        lo, hi = mr.vlevel[d]
        if vparts:
            torch.cat(vparts, out=vheap[lo:hi])

    xheap = torch.zeros(mr.nx + 1, nrhs, dtype=dtype, device=dev)
    for d in range(len(plan.groups) - 1, -1, -1):
        xparts = []
        for gi, g in enumerate(plan.groups[d]):
            pos = mr.xpos[d][gi]
            xb = None if pos is None else \
                xheap.index_select(0, pos).view(g.B, g.R - g.C, nrhs)
            xc = bwd(d, gi, yfwd.pop((d, gi)), xb)
            xparts.append(xc.reshape(-1, nrhs))
        lo, hi = mr.xlevel[d]
        torch.cat(xparts, out=xheap[lo:hi])
    return xheap[:mr.nx]


def _w2_need(plan, dtype, config: Config) -> int:
    """Bytes the w2 state asks of the device: W2 (one more factor-sized
    buffer) plus the W2^T copies of the K5 groups, each counted twice (as
    much again must stay free for their build and the sweeps)."""
    cells = sum(g.B * g.R * g.C * (
        2 if w2_route(g.B, g.R, g.C, 1, config) == "pmv" else 1)
        for glist in plan.groups for g in glist)
    return 2 * cells * torch.empty((), dtype=dtype).itemsize


def _w2_fits(F, dtype, config: Config) -> bool:
    """The reference's W2 capacity gate (``_winv_fits`` and
    ``SSTPU_W2_MAX_CELLS``) on the card's memory: :func:`_w2_need` on the
    plan the solve takes (:func:`solve_ladder`), with the relayouted copy
    of the coarse plan where it is still to be built, out of the card's
    free memory (:func:`..device.free_bytes`). A CPU factor always
    fits."""
    dev = F.Lx.device
    if dev.type != "cuda":
        return True
    if solve_ladder(F) == "fine":
        need = _w2_need(F.dplan.plan, dtype, config)
    else:
        need = _w2_need(_coarse_plan(F.S), dtype, config) + _coarse_need(F)
    return need <= free_bytes(dev)


def solve_mode(F, config: Config = DEFAULT) -> str:
    """The sweep a solve of the device factor ``F`` takes: ``"w2"``,
    ``"inv"`` or ``"classic"`` (``config.solve_mode``; "auto" is w2 where
    W2 is already built for this factor or fits, else classic).

    The reference's order on its accelerator is w2, then inv (where W2 is
    over ``SSTPU_W2_MAX_CELLS`` but W fits), then classic. "auto" does not
    take inv: that waits for a benchmark cell that shows it faster than
    classic where W2 does not fit (ROADMAP item 4); ``solve_mode="inv"``
    asks for it."""
    mode = config.solve_mode
    if mode not in SOLVE_MODES:
        raise ValueError(f"solve_mode must be one of {SOLVE_MODES}, got "
                         f"{mode!r}")
    if mode in ("classic", "inv"):
        return mode
    dtype = compute_dtype(config)
    ladder = solve_ladder(F)
    src = F.Lx if ladder == "fine" else _coarse_copy(F)
    if src is not None and all(k in F._solve and F._solve[k][0] is src
                               for k in _w2_keys(dtype, config, ladder)):
        return "w2"
    return "w2" if _w2_fits(F, dtype, config) else "classic"


def _on(key: tuple, ladder: str) -> tuple:
    """A state key of the coarse solve plan, or with ``"fine"`` appended
    of the factor's own plan (F3)."""
    return key if ladder == "coarse" else key + (ladder,)


def _w2_keys(dtype, config: Config, ladder: str = "coarse") -> list:
    """``F._solve`` keys of the w2 state on ``ladder``'s plan: W2, and
    with ``solve_pmv`` the W2^T copies, keyed on what picks their groups
    (the K5 threshold; K6 reads W2 as it is, so its threshold changes no
    state)."""
    keys = [("w2", dtype)]
    if config.solve_pmv:
        keys.append(("w2t", dtype, PMV_MIN_CELLS))
    return [_on(k, ladder) for k in keys]


def _inv_key(dtype, config: Config, ladder: str = "coarse") -> tuple:
    """``F._solve`` key of the inv state on ``ladder``'s plan: the dtype
    and what picks the groups whose L21 is copied for K6 (``solve_bmv``
    and its batch threshold; F3)."""
    return _on(("inv", dtype, bool(config.solve_bmv), BMV_MIN_BATCH), ladder)


def _cached(F, key, build, src: torch.Tensor):
    """``build()``, cached on ``F._solve[key]`` and tied to the panels
    ``src`` it was built from (``F.Lx``, or its relayouted copy)."""
    c = F._solve.get(key)
    if c is None or c[0] is not src:
        with span("solve.state"):
            F._solve[key] = (src, build())
        count("solve_state.build")
    return F._solve[key][1]


def _solve_state(F, mode: str, dtype, splan: SolvePlan, config: Config,
                 ladder: str, Lx: torch.Tensor):
    """Per-factor state of a sweep on ``ladder``'s plan, built from its
    panels ``Lx`` and cached on ``F._solve``: for ``w2`` the pair (W2,
    W2^T copies or None), for ``inv`` the (W, L21 copy or None) of every
    group, for ``classic`` the identity-padded L11 copies. Every nrhs
    reads the same state; the routes are picked per call."""
    if mode == "inv":
        return _cached(F, _inv_key(dtype, config, ladder),
                       lambda: build_winv(splan, Lx, dtype, config), Lx)
    if mode == "classic":
        return _cached(F, _on(("classic", dtype), ladder), lambda: [
            [_group_panels(Lx, sg, dtype)[0].contiguous() for sg in sglist]
            for sglist in splan.groups], Lx)
    keys = _w2_keys(dtype, config, ladder)
    W2 = _cached(F, keys[0], lambda: build_w2(splan, Lx, dtype), Lx)
    W2t = None
    if config.solve_pmv:
        W2t = _cached(F, keys[1], lambda: build_w2t(splan, W2, config), Lx)
    return W2, W2t


@dataclasses.dataclass
class PxGroup:
    """One group of the px sweep: B supernodes of one level padded to
    (R, C) panels."""

    R: int
    C: int
    B: int
    panel_src: np.ndarray   # [B*R*C] gather map into Lx (pad -> lx_size)
    col_idx: np.ndarray     # [B*C] global column ids (pad -> n)
    below_idx: np.ndarray   # [B*max(RU,1)] global below-row ids (pad -> n)
    nc: np.ndarray          # per-slot actual column counts


@dataclasses.dataclass
class PxPlan:
    groups: list            # groups[level] = [PxGroup, ...]
    n: int
    lx_size: int
    # str(device) -> [[(col_idx, below_idx) on the device]], built at the
    # first solve on that device
    routing: dict = dataclasses.field(default_factory=dict)


def build_px_plan(S: SupernodalSymbolic) -> PxPlan:
    """The solve plan of a px-layout factor: the reference's
    ``build_solve_plan(S, "px")``. The supernodes of each level are
    bucketed by padded shape ((R, C) on the factor plan's ladders, not
    tightened); each group gathers its panels out of the px ``Lx`` through
    ``panel_src``, the column-major panel of supernode s landing row-major
    at (slot, row, column) with its L21 rows after C."""
    groups_all = []
    for level_nodes in S.levels:
        buckets: dict = {}
        for s in level_nodes:
            nr, nc = S.nrows(s), S.ncols(s)
            key = (_pad_to(nr - nc, _R_LADDER) + _pad_to(nc, _C_LADDER),
                   _pad_to(nc, _C_LADDER))
            buckets.setdefault(key, []).append(int(s))
        glist = []
        for (R, C), ss in sorted(buckets.items()):
            B = len(ss)
            RU = R - C
            cidx = np.full(B * C, S.n, dtype=np.int64)
            bidx = np.full(B * max(RU, 1), S.n, dtype=np.int64)
            nc_arr = np.zeros(B, dtype=np.int32)
            psrc = np.full(B * R * C, S.lnz, dtype=np.int64)
            for b, s in enumerate(ss):
                nr, nc = S.nrows(s), S.ncols(s)
                f = int(S.super_first[s])
                nc_arr[b] = nc
                cidx[b * C:b * C + nc] = np.arange(f, f + nc)
                if nr > nc:
                    bidx[b * max(RU, 1):b * max(RU, 1) + (nr - nc)] = \
                        S.rows[s][nc:]
                kk = np.repeat(np.arange(nc, dtype=np.int64),
                               nr - np.arange(nc))
                rp = _ranges(np.arange(nc, dtype=np.int64),
                             np.full(nc, nr, np.int64))
                rloc = np.where(rp < nc, rp, C + (rp - nc))
                psrc[b * R * C + rloc * C + kk] = S.Lpx[s] + kk * nr + rp
            glist.append(PxGroup(R=R, C=C, B=B, panel_src=psrc,
                                 col_idx=cidx, below_idx=bidx, nc=nc_arr))
        groups_all.append(glist)
    return PxPlan(groups=groups_all, n=S.n, lx_size=S.lnz)


def px_plan(S: SupernodalSymbolic) -> PxPlan:
    """:func:`build_px_plan`, built once and cached on
    ``S._solve_plans["px"]`` (as the reference caches it)."""
    plans = _plans(S)
    if "px" not in plans:
        plans["px"] = build_px_plan(S)
    return plans["px"]


def px_route(dtype: torch.dtype, B: int, C: int, nrhs: int) -> str:
    """Which code solves a px group's triangles: ``"trisolve"`` (K4) under
    the reference's gate (its ``_use_potrf_kernel`` and ``trisolve_fits``),
    else ``"library"`` (``torch.linalg.solve_triangular``)."""
    if _use_potrf_kernel(dtype, B, C) and trisolve_fits(C, nrhs):
        return "trisolve"
    return "library"


def _px_routing(plan: PxPlan, device: torch.device) -> list:
    """Each group's (col_idx, below_idx) on ``device``, built once."""
    key = str(device)
    if key not in plan.routing:
        plan.routing[key] = [
            [(torch.as_tensor(g.col_idx, device=device),
              torch.as_tensor(g.below_idx, device=device)) for g in glist]
            for glist in plan.groups]
    return plan.routing[key]


def px_panels(plan: PxPlan, Lx: torch.Tensor, dtype) -> list:
    """panels[d][gi] = (L11, L21) of every group: each group's panels
    gathered once out of the px ``Lx`` (an appended zero behind the pad
    entries of ``panel_src``, so L21's pad rows and columns are zero), L11
    with identity on padding. The gather maps stay on the host and cross
    one group at a time."""
    Lxp = torch.cat([Lx.to(dtype), Lx.new_zeros(1, dtype=dtype)])
    out = []
    for glist in plan.groups:
        row = []
        for g in glist:
            src = torch.as_tensor(g.panel_src, device=Lx.device)
            L11, L21 = _split_panels(Lxp[src].view(g.B, g.R, g.C), g.nc)
            row.append((L11.contiguous(), L21))
        out.append(row)
    return out


def _px_sweep(plan: PxPlan, routing: list, panels: list,
              y: torch.Tensor) -> torch.Tensor:
    """y = L^-T L^-1 y in place, for y (n+1, nrhs) whose last row is the
    dump row that the pad entries of col_idx and below_idx read and write:
    it is zeroed after each group's scatter, so no sum (and no 0 * inf)
    carries from one group to the next. Several supernodes of a level
    update the same ancestor row, so the forward scatter accumulates
    (``index_add_``)."""
    n, nrhs, dtype = plan.n, y.shape[1], y.dtype
    steps = [(d, gi) for d, glist in enumerate(plan.groups)
             for gi in range(len(glist))]
    for d, gi in steps:                                   # leaves -> root
        g = plan.groups[d][gi]
        cidx, bidx = routing[d][gi]
        L11, L21 = panels[d][gi]
        xc = _trisolve(px_route(dtype, g.B, g.C, nrhs), L11,
                       y[cidx].view(g.B, g.C, nrhs), False)
        y[cidx] = xc.reshape(-1, nrhs)
        if g.R > g.C:
            y.index_add_(0, bidx, torch.bmm(L21, xc).view(-1, nrhs),
                         alpha=-1)
        y[n] = 0
    for d, gi in reversed(steps):                         # root -> leaves
        g = plan.groups[d][gi]
        cidx, bidx = routing[d][gi]
        L11, L21 = panels[d][gi]
        yc = y[cidx].view(g.B, g.C, nrhs)
        if g.R > g.C:
            yc = torch.baddbmm(yc, L21.mT,
                               y[bidx].view(g.B, g.R - g.C, nrhs), alpha=-1)
        xc = _trisolve(px_route(dtype, g.B, g.C, nrhs), L11, yc, True)
        y[cidx] = xc.reshape(-1, nrhs)
        y[n] = 0
    return y[:n]


def _rhs(b: np.ndarray):
    """(b as (n, nrhs) fp64, whether b was 1-D), refusing complex b."""
    if np.iscomplexobj(b):
        raise ValueError("the device solve takes a real b; complex systems "
                         "run through cholsol's 2x2 real embedding")
    b = np.asarray(b, dtype=np.float64)
    return (b.reshape(-1, 1) if b.ndim == 1 else b), b.ndim == 1


def _upload_rhs(bb: np.ndarray, perm: np.ndarray, dev: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """b permuted on the host, a zero row appended (the sweeps' dump
    row), on ``dev`` in ``dtype``."""
    with span("solve.rhs"):
        pbp = np.concatenate([bb[perm], np.zeros((1, bb.shape[1]))], axis=0)
        count("h2d_bytes.rhs", pbp.nbytes)
        return torch.as_tensor(pbp, device=dev).to(dtype)


def _px_dispatch(F, bb: np.ndarray, config: Config):
    S = F.S
    dtype = compute_dtype(config)
    plan = px_plan(S)
    dev = F.Lx.device
    routing = _px_routing(plan, dev)
    panels = _cached(F, ("px", dtype), lambda: px_panels(plan, F.Lx, dtype),
                     F.Lx)
    y = _upload_rhs(bb, S.perm, dev, dtype)

    def fn(y):
        with fp32_precision(config.precision):
            return _px_sweep(plan, routing, panels, y.clone())

    return fn, (y,)


def _mf_dispatch(F, bb: np.ndarray, config: Config, route: str = ROUTE):
    """:func:`solve_dispatch` of a device-layout factor on the w2 and inv
    sweeps' pass-up ``route`` (:data:`ROUTES`): the sweeps take
    :data:`ROUTE`, and the parity checks reach the others here."""
    S = F.S
    dtype = compute_dtype(config)
    with span("solve.route"):
        mode = solve_mode(F, config)
        ladder = solve_ladder(F)
    dp, Lx = _solve_target(F, ladder)
    with span("solve.plan") if dp.solve_base is None else OFF:
        base = _solve_base(S, dp)
    state = _solve_state(F, mode, dtype, base.splan, config, ladder, Lx)
    nrhs = bb.shape[1]
    if mode == "w2":
        steps = _w2_steps(base.splan, *state, nrhs, config)
    elif mode == "inv":
        steps = _inv_steps(base.splan, Lx.to(dtype), state, nrhs, config)
    else:
        steps = _classic_steps(base.splan, Lx.to(dtype), state, dtype)
    pb = _upload_rhs(bb, S.perm, dp.device, dtype)
    if mode == "classic":
        with span("solve.plan") if base.heap is None else OFF:
            heap = _heap_routing(S, dp, base)

        def fn(pb):
            with fp32_precision(config.precision):
                return _mf2_solve_fn(dp, base, heap, pb, *steps)[base.xmap]
    else:
        with span("solve.plan") if route not in dp.solve else OFF:
            rt = _routing(S, dp, route)

        def fn(pb):
            with fp32_precision(config.precision):
                return _mf_solve_fn(dp, rt, pb, *steps)[base.xmap]

    return fn, (pb,)


def solve_dispatch(F, b: np.ndarray, config: Config = DEFAULT):
    """(fn, args) exactly as :func:`solve_device` runs them: ``fn(*args)``
    is the device part of the solve, and gives the permuted solution (n,
    nrhs) on the factor's device (x[S.perm] = that). Every cache the solve
    reads (routing, the sweep's per-factor state, the px plan and panels)
    is filled before it returns (the coarse plan and its relayouted copy
    of ``Lx`` among them), so that a caller who times ``fn`` times the
    sweep alone (the reference's ``solve_dispatch``). ``fn`` leaves its
    arguments as they were, so it can be called again."""
    if not F.ok:
        raise ValueError(f"solve_device: the factor failed at column "
                         f"{F.minor}")
    bb, _one_d = _rhs(b)
    if isinstance(F, TorchPxFactor):
        return _px_dispatch(F, bb, config)
    return _mf_dispatch(F, bb, config)


def _finish(F, yz: torch.Tensor, one_d: bool) -> np.ndarray:
    """x on the host from the permuted device solution ``yz`` (the copy
    waits for the sweep)."""
    with span("solve.finish"):
        count("d2h_bytes.x", yz.numel() * yz.element_size())
        yz = yz.cpu().numpy().astype(np.float64)
        x = np.empty_like(yz)
        x[F.S.perm] = yz
        return x[:, 0] if one_d else x


def solve_px(F, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """x = A \\ b through the px-layout factor ``F`` (a
    :class:`~.supernodal.TorchPxFactor`) on its device: the reference's
    ``_solve_fn``. The plan is cached on ``F.S``, the panels on ``F`` per
    dtype; the sweep's products run under ``config.precision``."""
    if not F.ok:
        raise ValueError(f"solve_px: the factor failed at column {F.minor}")
    bb, one_d = _rhs(b)
    fn, args = _px_dispatch(F, bb, config)
    with span("solve.sweep"):
        yz = fn(*args)
    return _finish(F, yz, one_d)


def solve_device(F, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """x = A \\ b through the device factor ``F`` (handles the permutation;
    ``b`` is (n,) or (n, nrhs) and real; complex systems run through
    ``cholsol``'s 2x2 real embedding). A px-layout factor (one loaded from
    a file) takes :func:`solve_px`."""
    if isinstance(F, TorchPxFactor):
        return solve_px(F, b, config)
    fn, args = solve_dispatch(F, b, config)
    with span("solve.sweep"):
        yz = fn(*args)
    return _finish(F, yz, np.asarray(b).ndim == 1)


def _solve_rows(plan, nrhs: int = 1, bytes_per_elt: int = 4) -> list:
    """One row a level of ``plan``: (level, steps, panel bytes, right-hand
    side bytes, flops), each for one sweep.

    Every sweep of the port reads each group's B R C panel cells once (the
    classic sweep L, w2 its W2, inv W and L21); the right-hand side's B R
    rows are gathered and scattered once; the flops are a dense panel
    matvec's, 2 B R C a column (the classic sweep's triangles do less)."""
    e = bytes_per_elt
    rows = []
    for d, glist in enumerate(plan.groups):
        cells = sum(g.B * g.R * g.C for g in glist)
        rhs = sum(g.B * g.R for g in glist)
        rows.append((d, len(glist), float(e * cells),
                     float(2 * e * rhs * nrhs), 2.0 * cells * nrhs))
    return rows


def solve_report(S: SupernodalSymbolic, nrhs: int = 1,
                 bytes_per_elt: int = 4, ladder: str = "fine") -> str:
    """Static accounting of the multifrontal solve (the counterpart of the
    reference's ``solve_report``, without its TPU step floor): a level's
    sequential group steps, the bytes and flops of one sweep
    (:func:`_solve_rows`) and the bound of the two sweeps on the card; the
    TOTAL sums the levels. ``ladder``: the factor's plan ("fine"; needs a
    plan of ``S``) or the coarse solve plan ("coarse", the plan a solve
    takes where its copy of the factor fits)."""
    from ..device import CARD, CARD_BYTES_S, CARD_FLOP_S

    plan = _cached_plan(S) if ladder == "fine" else _coarse_plan(S)
    rows = _solve_rows(plan, nrhs, bytes_per_elt)
    lines = [f"two sweeps at nrhs {nrhs}, bound: max(bytes / "
             f"{CARD_BYTES_S / 1e12:g} TB/s, flops / "
             f"{CARD_FLOP_S[bytes_per_elt] / 1e12:g} TFLOP/s) on the {CARD}",
             "level  steps  panel MB  rhs MB    MFLOP  bound_ms (2 sweeps)"]
    tot = [0, 0.0, 0.0, 0.0, 0.0]
    for d, steps, pan, rhs, fl in rows:
        ms = 2 * _bound_ms(fl, pan + rhs, bytes_per_elt)
        for i, v in enumerate((steps, pan, rhs, fl, ms)):
            tot[i] += v
        lines.append(f"{d:5d} {steps:6d} {pan / 1e6:9.2f} {rhs / 1e6:7.2f} "
                     f"{fl / 1e6:8.2f} {ms:9.4f}")
    lines.append(f"TOTAL {tot[0]:6d} {tot[1] / 1e6:9.2f} {tot[2] / 1e6:7.2f} "
                 f"{tot[3] / 1e6:8.2f} {tot[4]:9.4f}")
    return "\n".join(lines)
