"""Distributed supernodal Cholesky on torch.distributed: subtree-per-rank
leaf phase, one sum of the cut contributions, replicated crown.

Port of :mod:`suitesparse_tpu.parallel.dist2`. The plan builders
(:func:`build_dist_plan`, ``_build_v3``) are copies: pure numpy, every
per-device index array stacked as ``(ndev, ...)`` and padded with
out-of-bounds indices. The runtime is SPMD by rank: rank ``r`` is device
``r`` of those stacked arrays and takes row ``r`` of each, keeping only its
real entries (torch indexing raises on the pads, and K7 rejects them).

* :func:`partition_tree` cuts the supernode tree into flop-balanced
  subtrees and a TOP separator crown; the plan is rebuilt with the crown
  split out of the subtree groups, so every group is LEAF or TOP.
* **Flat schedule.** Each rank factors its own slots of every leaf group
  (``_group_compute``: A's scatter, K7 on the leaf pair classes, K1 under
  its gate on the rank's batch), whose extend-adds never leave the rank.
  K7 places the contributions that cross the cut into the rank's zero
  ``F0`` buffers; ONE ``all_reduce`` over the world sums them, and every
  rank factors the crown groups from their slice of ``F0``.
* **(host, chip) schedule** (:func:`partition_tree_topology`, nhost > 1):
  the leaf phase; K7 places the leaf->MID contributions into ``F1``, summed
  over the rank's HOST group only; every chip of a host factors the host's
  MID groups; the global crown receives the leaf contributions of every
  rank and the MID contributions of chip 0 of each host (the other chips
  skip the placement), ONE ``all_reduce`` over the world, then the crown.
* **Assembly.** Every rank writes its own cells of the canonical factor
  (its leaf slots; chip 0 of a host its host's MID slots; rank 0 the crown)
  into a zero buffer, and one world ``all_reduce`` gives every rank the
  same ``Lx`` in the split plan's single-card layout: each cell has one
  writer, so the sum is exact, and a failed tile's NaN reaches every rank
  (``minor`` agrees). The factor also solves through
  :func:`..numeric.supernodal_solve.solve_device`.
* :func:`dist_solve_v2` mirrors the factor: leaf forward sweeps per rank,
  one world sum of the crown's right-hand side, the crown's sweeps
  replicated, the leaf backward sweeps, x assembled by one world sum.

No tile manifest (K2) runs here: the leaf groups are re-sliced per rank,
and the reference's distributed path runs none. Every sum goes through
:func:`_all_reduce`, which records its phase, group and bytes on the
factor (:mod:`.diag` reads the record). Gloo takes CUDA tensors for
``all_reduce``; no ``all_gather`` is used. The updates stay in the compute
dtype whatever ``Config.update_dtype`` says: ``_group_compute`` runs with
its default, as the reference's ``dist2.py:558-875`` calls it without an
update dtype.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import DEFAULT, Config
from ..device import fp32_precision, resolve_device
from ..kernels.extend_add import build_work
from ..numeric import segmented
from ..numeric import supernodal_device as sd
from ..numeric.supernodal import TorchSupernodalFactor
from ..sparse import CSC
from ..symbolic.supernodes import SupernodalSymbolic
from .schedule import partition_tree, partition_tree_topology

__all__ = ["Collective", "DistFactor", "DistRun", "build_dist_plan",
           "dist_factorize_v2", "dist_solve_v2", "predicted_launches",
           "rank_plan"]

NO_TILES = 1 << 40    # tile_rmin no group reaches: the path builds no manifest


def build_dist_plan(S: SupernodalSymbolic, C_low: CSC, ndev: int,
                    topo: tuple | None = None):
    """Returns (plan, part, dist) where dist holds the per-device leaf
    schedule, cut routing, and canonical remap arrays.

    With ``topo=(nhost, nchip)`` the partition is the 2-level (host, chip)
    cut (schedule.partition_tree_topology) and ``dist["v3"]`` additionally
    holds the host-local MID phase structures: per-HOST mid group schedules
    (the leaf machinery one level up), leaf->mid halo routing (summed over
    the host's ranks only), and mid->top routing into the one sum over
    every rank.  The dist2-compatible structures (top = MID + global
    TOP, replicated) are still built — the distributed solve consumes them
    unchanged."""
    if topo is not None:
        nhost, nchip = topo
        assert nhost * nchip == ndev
        part = partition_tree_topology(S, nhost, nchip)
        split = part.split_key
    else:
        part = partition_tree(S, ndev)
        split = part.top
    plan = sd.build_plan(S, C_low, tile_rmin=NO_TILES, split_mask=split)

    # classify groups; global order
    leaf_groups, top_groups = [], []
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            if part.top[g.snodes[0]]:
                top_groups.append((d, gi))
            else:
                leaf_groups.append((d, gi))
    leaf_index = {k: i for i, k in enumerate(leaf_groups)}
    top_index = {k: i for i, k in enumerate(top_groups)}

    # top-front flat buffer layout
    top_base = {}
    off = 0
    for k in top_groups:
        g = plan.groups[k[0]][k[1]]
        top_base[k] = off
        off += g.B * g.R * g.R
    f0_cells = off

    # ---- per-device slot maps for leaf groups ----
    # slot (global b) -> (device, local slot); batches padded to Bd
    leaf_meta = []
    for k in leaf_groups:
        g = plan.groups[k[0]][k[1]]
        devs = part.own[g.snodes]
        assert np.all(devs >= 0)
        order = np.argsort(devs, kind="stable")
        counts = np.bincount(devs, minlength=ndev)
        Bd = int(counts.max()) if g.B else 1
        lslot = np.empty(g.B, dtype=np.int64)
        cur = np.zeros(ndev, dtype=np.int64)
        for b in order:
            d0 = devs[b]
            lslot[b] = cur[d0]
            cur[d0] += 1
        leaf_meta.append((devs, lslot, Bd))

    # ---- per-device index arrays ----
    # A-entry scatter: split g.adst by device, renumber slots, pad
    dist_groups = []     # per leaf group: dict of stacked (D, ...) arrays
    for li, k in enumerate(leaf_groups):
        g = plan.groups[k[0]][k[1]]
        devs, lslot, Bd = leaf_meta[li]
        R, C = g.R, g.C
        slot_of_entry = g.adst // (R * R)
        coord = g.adst % (R * R)
        edev = devs[slot_of_entry]
        eadst = lslot[slot_of_entry] * R * R + coord
        # per-device counts, pad to max
        ecnt = np.bincount(edev, minlength=ndev)
        emax = int(ecnt.max()) if g.adst.size else 0
        asrc_d = np.zeros((ndev, emax), dtype=np.int32)
        # distinct OOB pad indices keep the sorted+unique scatter contract
        adst_d = (Bd * R * R
                  + np.tile(np.arange(emax, dtype=np.int64), (ndev, 1)))
        for d0 in range(ndev):
            sel = edev == d0
            m = int(sel.sum())
            # keep sorted adst within device (stable selection preserves it)
            asrc_d[d0, :m] = g.asrc[sel]
            adst_d[d0, :m] = eadst[sel]
        nc_d = np.zeros((ndev, Bd), dtype=np.int32)
        for b in range(g.B):
            nc_d[devs[b], lslot[b]] = g.nc[b]
        # pairs: all children are leaf groups on the SAME device
        pair_sets = []
        for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays):
            ck = (pc.src_level, pc.src_gi)
            cli = leaf_index[ck]
            cdevs, clslot, cBd = leaf_meta[cli]
            pdev = devs[dst]
            assert np.array_equal(pdev, cdevs[src]), "cross-device leaf pair"
            pcnt = np.bincount(pdev, minlength=ndev)
            pmax = max(int(pcnt.max()), 1)
            # pads are OUT OF BOUNDS (dropped by the scatter) — a slot-0
            # pad would CLOBBER real data in the solve's .set push-down
            src_d = np.full((ndev, pmax), cBd, dtype=np.int32)
            dst_d = np.full((ndev, pmax), Bd, dtype=np.int32)
            idx_d = np.full((ndev, pmax, pc.RU_c), -1, dtype=np.int32)
            for d0 in range(ndev):
                sel = pdev == d0
                m = int(sel.sum())
                src_d[d0, :m] = clslot[src[sel]]
                dst_d[d0, :m] = lslot[dst[sel]]
                idx_d[d0, :m] = idx[sel]
            pair_sets.append((cli, pc.RU_c, pmax, src_d, dst_d, idx_d))
        dist_groups.append({
            "k": k, "R": R, "C": C, "Bd": Bd, "emax": emax,
            "asrc": asrc_d, "adst": adst_d, "nc": nc_d,
            "pairs": pair_sets,
        })

    # ---- cut routing: leaf-group updates -> top-front flat buffer ----
    # for each TOP group, its pairs whose child is a LEAF group move into
    # the cut set (placed + summed before the top phase)
    cut_sets = []       # (leaf li, RU_c, pmax, src_d, base_d, idx_d)
    top_plan = []       # per top group: ix dict with only top-child pairs
    for k in top_groups:
        g = plan.groups[k[0]][k[1]]
        R = g.R
        keep_pairs, keep_arrays = [], []
        for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays):
            ck = (pc.src_level, pc.src_gi)
            if ck in top_index:
                keep_pairs.append(pc)
                keep_arrays.append((src, dst, idx))
                continue
            cli = leaf_index[ck]
            cdevs, clslot, cBd = leaf_meta[cli]
            pdev = cdevs[src]           # device owning the child
            pcnt = np.bincount(pdev, minlength=ndev)
            pmax = max(int(pcnt.max()), 1)
            # OOB pads (see leaf pair_sets note)
            src_d = np.full((ndev, pmax), cBd, dtype=np.int32)
            dst_d = np.full((ndev, pmax), g.B, dtype=np.int32)
            idx_d = np.full((ndev, pmax, pc.RU_c), -1, dtype=np.int32)
            for d0 in range(ndev):
                sel = pdev == d0
                m = int(sel.sum())
                src_d[d0, :m] = clslot[src[sel]]
                dst_d[d0, :m] = dst[sel]
                idx_d[d0, :m] = idx[sel]
            cut_sets.append((cli, pc.RU_c, pmax, R, top_index[k],
                             src_d, dst_d, idx_d))
        top_plan.append((k, keep_pairs, keep_arrays))

    # ---- canonical remap (dist leaf layout -> canonical plan layout) ----
    # leaf panel cell (li, dev, lslot, r, c) <-> plan panel cell; built via
    # per-group vectorized index arithmetic
    leaf_cells = 0
    leaf_base = []
    for dg in dist_groups:
        leaf_base.append(leaf_cells)
        leaf_cells += dg["Bd"] * dg["R"] * dg["C"]
    # map: canonical dev-layout index <- (device, leaf-local index)
    can_src_dev = []
    can_src_pos = []
    can_dst = []
    for li, k in enumerate(leaf_groups):
        g = plan.groups[k[0]][k[1]]
        devs, lslot, Bd = leaf_meta[li]
        R, C = g.R, g.C
        cells = R * C
        cell = np.arange(cells, dtype=np.int64)
        for b in range(g.B):
            can_dst.append(g.panel_base + b * cells + cell)
            can_src_dev.append(np.full(cells, devs[b], dtype=np.int64))
            can_src_pos.append(leaf_base[li] + lslot[b] * cells + cell)
    dist = {
        "ndev": ndev, "leaf_groups": leaf_groups, "top_groups": top_groups,
        "dist_groups": dist_groups, "cut_sets": cut_sets,
        "top_plan": top_plan, "f0_cells": f0_cells,
        "leaf_cells": leaf_cells, "leaf_base": leaf_base,
        "can_dst": (np.concatenate(can_dst) if can_dst
                    else np.empty(0, np.int64)),
        "can_src_dev": (np.concatenate(can_src_dev) if can_src_dev
                        else np.empty(0, np.int64)),
        "can_src_pos": (np.concatenate(can_src_pos) if can_src_pos
                        else np.empty(0, np.int64)),
    }

    # ---- distributed-solve arrays (consumed by dist_solve_v2) ----
    # per leaf group: per-device global column ids (pad -> n) and per-device
    # canonical-panel gather maps (slot panels from the canonical Lx)
    n = S.n
    solve_leaf = []
    for li, k in enumerate(leaf_groups):
        g = plan.groups[k[0]][k[1]]
        devs, lslot, Bd = leaf_meta[li]
        R, C = g.R, g.C
        col_d = np.full((ndev, Bd * C), n, dtype=np.int64)
        pan_d = np.full((ndev, Bd * R * C), plan.dev_size, dtype=np.int64)
        cell = np.arange(R * C, dtype=np.int64)
        for b, s in enumerate(g.snodes):
            d0, ls = devs[b], lslot[b]
            f = int(S.super_first[s])
            nc = int(S.super_first[s + 1]) - f
            col_d[d0, ls * C:ls * C + nc] = np.arange(f, f + nc)
            pan_d[d0, ls * R * C:(ls + 1) * R * C] = \
                g.panel_base + b * R * C + cell
        solve_leaf.append({"col": col_d, "pan": pan_d})
    # x assembly: canonical x row for each (device, leaf group, slot, k)
    # laid out as the concat of per-device per-group xc buffers
    xrow_parts_dev = []
    xoff = 0
    xmap_dst, xmap_dev, xmap_pos = [], [], []
    for li, k in enumerate(leaf_groups):
        g = plan.groups[k[0]][k[1]]
        devs, lslot, Bd = leaf_meta[li]
        C = g.C
        for b, s in enumerate(g.snodes):
            f = int(S.super_first[s])
            nc = int(S.super_first[s + 1]) - f
            xmap_dst.append(np.arange(f, f + nc))
            xmap_dev.append(np.full(nc, devs[b], dtype=np.int64))
            xmap_pos.append(xoff + lslot[b] * C + np.arange(nc))
        xoff += Bd * C
    dist["solve_leaf"] = solve_leaf
    dist["x_cells_dev"] = xoff          # per-device xc concat length
    dist["xmap_dst"] = (np.concatenate(xmap_dst) if xmap_dst
                        else np.empty(0, np.int64))
    dist["xmap_dev"] = (np.concatenate(xmap_dev) if xmap_dev
                        else np.empty(0, np.int64))
    dist["xmap_pos"] = (np.concatenate(xmap_pos) if xmap_pos
                        else np.empty(0, np.int64))
    if topo is not None:
        dist["v3"] = _build_v3(S, plan, part, dist, leaf_meta, leaf_index,
                               topo)
    return plan, part, dist


def _build_v3(S, plan, part, dist, leaf_meta, leaf_index, topo):
    """Host-local MID phase structures for the (host, chip) topology."""
    nhost, nchip = topo
    ndev = nhost * nchip
    key_of = part.split_key

    mid_groups, gtop_groups = [], []
    for k in dist["top_groups"]:
        g = plan.groups[k[0]][k[1]]
        (mid_groups if key_of[g.snodes[0]] == 1 else gtop_groups).append(k)
    mid_index = {k: i for i, k in enumerate(mid_groups)}
    gtop_index = {k: i for i, k in enumerate(gtop_groups)}

    # MID front/panel buffer layouts (per-host, slots padded to Bh)
    mid_meta = []           # (hof, lslot, Bh)
    f1_base, pan_base = [], []
    f1_cells = pan_cells = 0
    for k in mid_groups:
        g = plan.groups[k[0]][k[1]]
        hof = part.mid_host[g.snodes]
        assert np.all(hof >= 0)
        counts = np.bincount(hof, minlength=nhost)
        Bh = max(int(counts.max()), 1)
        lslot = np.empty(g.B, dtype=np.int64)
        cur = np.zeros(nhost, dtype=np.int64)
        for b in np.argsort(hof, kind="stable"):
            lslot[b] = cur[hof[b]]
            cur[hof[b]] += 1
        mid_meta.append((hof, lslot, Bh))
        f1_base.append(f1_cells)
        f1_cells += Bh * g.R * g.R
        pan_base.append(pan_cells)
        pan_cells += Bh * g.R * g.C

    # GTOP front buffer layout (global; summed over every rank)
    f0_base = []
    f0_cells = 0
    for k in gtop_groups:
        g = plan.groups[k[0]][k[1]]
        f0_base.append(f0_cells)
        f0_cells += g.B * g.R * g.R

    # ---- per-host MID group schedules (leaf machinery, one level up) ----
    mid_dist = []
    leafmid_cut = []    # leaf child -> mid parent (devices place; host sum)
    for mi, k in enumerate(mid_groups):
        g = plan.groups[k[0]][k[1]]
        hof, lslot, Bh = mid_meta[mi]
        R, C = g.R, g.C
        slot_of_entry = g.adst // (R * R)
        coord = g.adst % (R * R)
        ehost = hof[slot_of_entry]
        eadst = lslot[slot_of_entry] * R * R + coord
        ecnt = np.bincount(ehost, minlength=nhost)
        emax = int(ecnt.max()) if g.adst.size else 0
        asrc_h = np.zeros((nhost, emax), dtype=np.int32)
        adst_h = (Bh * R * R
                  + np.tile(np.arange(emax, dtype=np.int64), (nhost, 1)))
        for h in range(nhost):
            sel = ehost == h
            m = int(sel.sum())
            asrc_h[h, :m] = g.asrc[sel]
            adst_h[h, :m] = eadst[sel]
        nc_h = np.zeros((nhost, Bh), dtype=np.int32)
        for b in range(g.B):
            nc_h[hof[b], lslot[b]] = g.nc[b]
        pair_sets = []      # mid child -> this mid parent (host-local)
        for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays):
            ck = (pc.src_level, pc.src_gi)
            if ck not in mid_index:
                # leaf child: routed through the F1 halo (host sum)
                cli = leaf_index[ck]
                cdevs, clslot, cBd = leaf_meta[cli]
                pdev = cdevs[src]               # device owning the child
                assert np.array_equal(pdev // nchip, hof[dst]), \
                    "leaf->mid pair crosses hosts"
                pcnt = np.bincount(pdev, minlength=ndev)
                pmax = max(int(pcnt.max()), 1)
                src_d = np.full((ndev, pmax), cBd, dtype=np.int32)
                dst_d = np.full((ndev, pmax), Bh, dtype=np.int32)
                idx_d = np.full((ndev, pmax, pc.RU_c), -1, dtype=np.int32)
                for d0 in range(ndev):
                    sel = pdev == d0
                    m = int(sel.sum())
                    src_d[d0, :m] = clslot[src[sel]]
                    dst_d[d0, :m] = lslot[dst[sel]]
                    idx_d[d0, :m] = idx[sel]
                leafmid_cut.append((cli, mi, pc.RU_c, pmax, R,
                                    src_d, dst_d, idx_d))
                continue
            cmi = mid_index[ck]
            chof, clslot, cBh = mid_meta[cmi]
            phost = hof[dst]
            assert np.array_equal(phost, chof[src]), "mid pair crosses hosts"
            pcnt = np.bincount(phost, minlength=nhost)
            pmax = max(int(pcnt.max()), 1)
            src_h = np.full((nhost, pmax), cBh, dtype=np.int32)
            dst_h = np.full((nhost, pmax), Bh, dtype=np.int32)
            idx_h = np.full((nhost, pmax, pc.RU_c), -1, dtype=np.int32)
            for h in range(nhost):
                sel = phost == h
                m = int(sel.sum())
                src_h[h, :m] = clslot[src[sel]]
                dst_h[h, :m] = lslot[dst[sel]]
                idx_h[h, :m] = idx[sel]
            pair_sets.append((cmi, pc.RU_c, pmax, src_h, dst_h, idx_h))
        mid_dist.append({
            "k": k, "R": R, "C": C, "Bh": Bh, "emax": emax,
            "asrc": asrc_h, "adst": adst_h, "nc": nc_h, "pairs": pair_sets,
        })

    # ---- GTOP routing ----
    gtop_cut = []       # leaf child -> gtop parent: devices place into F0
    midtop_cut = []     # mid child -> gtop parent: chip-0 places into F0
    gtop_plan = []      # per gtop group: only gtop-child pairs stay direct
    for gt, k in enumerate(gtop_groups):
        g = plan.groups[k[0]][k[1]]
        R = g.R
        keep_pairs, keep_arrays = [], []
        for pc, (src, dst, idx) in zip(g.pairs, g._pair_arrays):
            ck = (pc.src_level, pc.src_gi)
            if ck in gtop_index:
                keep_pairs.append(pc)
                keep_arrays.append((src, dst, idx))
            elif ck in mid_index:
                cmi = mid_index[ck]
                chof, clslot, cBh = mid_meta[cmi]
                phost = chof[src]               # host owning the child
                pcnt = np.bincount(phost, minlength=nhost)
                pmax = max(int(pcnt.max()), 1)
                src_h = np.full((nhost, pmax), cBh, dtype=np.int32)
                dst_h = np.full((nhost, pmax), g.B, dtype=np.int32)
                idx_h = np.full((nhost, pmax, pc.RU_c), -1, dtype=np.int32)
                for h in range(nhost):
                    sel = phost == h
                    m = int(sel.sum())
                    src_h[h, :m] = clslot[src[sel]]
                    dst_h[h, :m] = dst[sel]
                    idx_h[h, :m] = idx[sel]
                midtop_cut.append((cmi, pc.RU_c, pmax, R, gt,
                                   src_h, dst_h, idx_h))
            else:
                cli = leaf_index[ck]
                cdevs, clslot, cBd = leaf_meta[cli]
                pdev = cdevs[src]
                pcnt = np.bincount(pdev, minlength=ndev)
                pmax = max(int(pcnt.max()), 1)
                src_d = np.full((ndev, pmax), cBd, dtype=np.int32)
                dst_d = np.full((ndev, pmax), g.B, dtype=np.int32)
                idx_d = np.full((ndev, pmax, pc.RU_c), -1, dtype=np.int32)
                for d0 in range(ndev):
                    sel = pdev == d0
                    m = int(sel.sum())
                    src_d[d0, :m] = clslot[src[sel]]
                    dst_d[d0, :m] = dst[sel]
                    idx_d[d0, :m] = idx[sel]
                gtop_cut.append((cli, pc.RU_c, pmax, R, gt,
                                 src_d, dst_d, idx_d))
        gtop_plan.append((k, keep_pairs, keep_arrays))

    # ---- mid canonical remap: (host, per-host panel pos) -> canonical ----
    midcan_dst, midcan_host, midcan_pos = [], [], []
    for mi, k in enumerate(mid_groups):
        g = plan.groups[k[0]][k[1]]
        hof, lslot, Bh = mid_meta[mi]
        cells = g.R * g.C
        cell = np.arange(cells, dtype=np.int64)
        for b in range(g.B):
            midcan_dst.append(g.panel_base + b * cells + cell)
            midcan_host.append(np.full(cells, hof[b], dtype=np.int64))
            midcan_pos.append(pan_base[mi] + lslot[b] * cells + cell)
    e = np.empty(0, np.int64)
    return {
        "nhost": nhost, "nchip": nchip,
        "mid_groups": mid_groups, "gtop_groups": gtop_groups,
        "mid_dist": mid_dist, "mid_meta": mid_meta,
        "f1_base": f1_base, "f1_cells": f1_cells,
        "pan_base": pan_base, "pan_cells": pan_cells,
        "f0_base": f0_base, "f0_cells": f0_cells,
        "leafmid_cut": leafmid_cut, "gtop_cut": gtop_cut,
        "midtop_cut": midtop_cut, "gtop_plan": gtop_plan,
        "midcan_dst": (np.concatenate(midcan_dst) if midcan_dst else e),
        "midcan_host": (np.concatenate(midcan_host) if midcan_host else e),
        "midcan_pos": (np.concatenate(midcan_pos) if midcan_pos else e),
    }




# ---------------------------------------------------------------------------
# runtime: one rank's share of the distributed factor and solve
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Collective:
    """One ``all_reduce`` of a distributed factor or solve, on one rank."""

    phase: str       # halo, mid_halo, crown_halo, assembly, solve_up, solve_x
    group: str       # "world" or "host"
    ranks: int       # ranks in the group
    nbytes: int      # bytes this rank contributes (and receives)
    seconds: float   # wall of the call on this rank, device synchronized


@dataclasses.dataclass
class DistRun:
    """What one rank's distributed factor did: the rank plan it ran, its
    sums in order, the seconds of its phases, and the same for the last
    :func:`dist_solve_v2` of the factor."""

    plan: "RankPlan"
    topology: object
    collectives: list
    seconds: dict
    solve_collectives: list = dataclasses.field(default_factory=list)
    solve_seconds: float = 0.0


@dataclasses.dataclass(kw_only=True)
class DistFactor(TorchSupernodalFactor):
    """A :func:`dist_factorize_v2` factor: a single-card factor in the
    split plan's layout, with ``dist`` the rank's :class:`DistRun`."""

    dist: DistRun


@dataclasses.dataclass
class _Shape:
    """A group as ``_group_compute`` reads it (the reference's ``_Shim``):
    this rank's batch, no tile manifest."""

    B: int
    R: int
    C: int
    _tile: object = None
    _symm_u: bool = False


@dataclasses.dataclass
class _Step:
    """One group this rank factors."""

    shape: _Shape
    ix: object              # sd.GroupArrays on the device
    key: tuple              # the key of its update (see RankPlan)
    f0: int | None          # offset of its slice of the summed buffer
    write: tuple | None     # (panel_base, B, canonical slots, rank slots) of
    #                         the cells this rank writes at the assembly;
    #                         slots None: the whole panel; None: no cell
    classes: list           # [(key, src, dst, idx)] numpy, its pair classes


@dataclasses.dataclass
class RankPlan:
    """Rank ``rank``'s share of the distributed plan on ``device``.

    Update keys: a leaf group's is (0, its leaf index), a MID group's (1,
    its mid index), both in the ``halo`` namespace that the cut placements
    read; a crown group's is its plan key (level, gi), in the crown's own.
    ``f1_cut`` / ``f0_cut``: ``[(base, B, R, work)]``, the K7 placements
    into the summed buffers (F1 over the host, F0 over the world)."""

    plan: object
    dist: dict
    world: int
    rank: int
    topology: tuple | None   # (nhost, nchip) of the (host, chip) schedule
    device: torch.device
    dp: object               # sd.DevicePlan of the split plan (the factor's)
    leaf: list
    mid: list
    crown: list
    f1_cut: list
    f0_cut: list
    f1_cells: int
    f0_cells: int
    cut_classes: list        # solve: [(tgi, key, src, dst, idx)] into top
    solve: object = None     # the solve's routing, built at the first solve


def _t64(a, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _rows(classes, mask_of):
    """The real rows of stacked ``(src, dst, idx)`` per-device arrays."""
    out = []
    for key, src, dst, idx in classes:
        m = mask_of(dst)
        if m.any():
            out.append((key, src[m], dst[m], idx[m]))
    return out


def _arrays(asrc, adst, nc, B, R, classes):
    """A group's GroupArrays on the host: A's real entries, its slots'
    column counts and the K7 work list of its pair classes."""
    keep = adst < B * R * R
    return sd.GroupArrays(
        asrc=_t64(asrc[keep]), adst=_t64(adst[keep]),
        nc=_t64(nc).reshape(B, 1, 1), k7=None,
        k7_all=build_work(B, R, classes) if classes else None, tile=None,
        uslices=[])


def _slots(src_dev, src_pos, own, base, cells, B):
    """(canonical slots, rank slots) of one group out of the reference's
    canonical remap (``src_dev``, ``src_pos`` from the group's first
    entry, ``cells`` a slot): the slots whose owner is ``own``."""
    starts = np.arange(B, dtype=np.int64) * cells
    mine = np.flatnonzero(src_dev[starts] == own)
    return _t64(mine), _t64((src_pos[starts][mine] - base) // cells)


def _cut_works(targets, groups_B_R):
    """``[(base, B, R, work)]``: one K7 work list a target group, its
    classes in the order they were found."""
    out = []
    for t in sorted(targets):
        base, B, R = groups_B_R[t]
        out.append((base, B, R, build_work(B, R, targets[t])))
    return out


def rank_plan(A: CSC, S: SupernodalSymbolic, topo) -> RankPlan:
    """The distributed plan for ``S`` (the analysis of ``A``) and
    ``topo``'s rank, its index arrays on the device. Cached on ``S`` per
    world size, rank, schedule and device; nothing in it depends on the
    factor's dtype or precision (the fronts take theirs at run time)."""
    dev = resolve_device(topo.device)
    world, rank = topo.world, topo.rank
    schedule = (topo.nhost, topo.nchip) if topo.nhost > 1 else None
    key = (world, rank, schedule, str(dev))
    cache = getattr(S, "_torch_dist", None)
    if cache is None:
        cache = S._torch_dist = {}
    if key in cache:
        return cache[key]
    C_low = A.symperm(S.perm).transpose()
    plan, _part, dist = build_dist_plan(S, C_low, world, topo=schedule)
    groups = plan.groups

    def g_of(k):
        return groups[k[0]][k[1]]

    # leaf groups: this rank's row of each stacked array
    leaf = []
    off = 0
    for li, (k, dg) in enumerate(zip(dist["leaf_groups"],
                                     dist["dist_groups"])):
        g = g_of(k)
        Bd, R, C = dg["Bd"], dg["R"], dg["C"]
        classes = _rows([((0, cli), s[rank], d[rank], ix[rank])
                         for (cli, _ru, _pm, s, d, ix) in dg["pairs"]],
                        lambda d, Bd=Bd: d < Bd)
        cells = R * C
        can, mine = _slots(dist["can_src_dev"][off:],
                           dist["can_src_pos"][off:], rank,
                           dist["leaf_base"][li], cells, g.B)
        off += g.B * cells
        leaf.append(_Step(
            shape=_Shape(Bd, R, C),
            ix=_arrays(dg["asrc"][rank], dg["adst"][rank], dg["nc"][rank],
                       Bd, R, classes),
            key=(0, li), f0=None,
            write=(g.panel_base, g.B, can, mine) if can.numel() else None,
            classes=classes))

    cut_classes = [(tgi, (0, cli), *c[1:])
                   for (cli, _ru, _pm, _R, tgi, s, d, ix) in dist["cut_sets"]
                   for c in _rows([((0, cli), s[rank], d[rank], ix[rank])],
                                  lambda d, B=g_of(dist["top_groups"][tgi]).B:
                                  d < B)]

    def crown_steps(plan_rows, bases, write):
        steps = []
        for i, (k, keep_pairs, keep_arrays) in enumerate(plan_rows):
            g = g_of(k)
            classes = [((pc.src_level, pc.src_gi), *arr)
                       for pc, arr in zip(keep_pairs, keep_arrays)]
            steps.append(_Step(
                shape=_Shape(g.B, g.R, g.C),
                ix=_arrays(g.asrc, g.adst, g.nc, g.B, g.R, classes),
                key=k, f0=bases[i],
                write=(g.panel_base, g.B, None, None) if write else None,
                classes=classes))
        return steps

    mid, f1_cut, f1_cells = [], [], 0
    v3 = dist.get("v3")
    if v3 is None:
        top_base, b = [], 0
        for k in dist["top_groups"]:
            g = g_of(k)
            top_base.append(b)
            b += g.B * g.R * g.R
        targets: dict = {}
        for tgi, ck, src, dst, idx in cut_classes:
            targets.setdefault(tgi, []).append((ck, src, dst, idx))
        f0_cut = _cut_works(targets, {
            t: (top_base[t], g_of(dist["top_groups"][t]).B,
                g_of(dist["top_groups"][t]).R) for t in targets})
        crown = crown_steps(dist["top_plan"], top_base, rank == 0)
        f0_cells = dist["f0_cells"]
    else:
        nchip = v3["nchip"]
        host, chip = divmod(rank, nchip)
        for mi, (k, md) in enumerate(zip(v3["mid_groups"], v3["mid_dist"])):
            g = g_of(k)
            Bh, R, C = md["Bh"], md["R"], md["C"]
            classes = _rows([((1, cmi), s[host], d[host], ix[host])
                             for (cmi, _ru, _pm, s, d, ix) in md["pairs"]],
                            lambda d, Bh=Bh: d < Bh)
            write = None
            if chip == 0:
                n0 = sum(g_of(kk).B * g_of(kk).R * g_of(kk).C
                         for kk in v3["mid_groups"][:mi])
                can, mine = _slots(v3["midcan_host"][n0:],
                                   v3["midcan_pos"][n0:], host,
                                   v3["pan_base"][mi], R * C, g.B)
                if can.numel():
                    write = (g.panel_base, g.B, can, mine)
            mid.append(_Step(
                shape=_Shape(Bh, R, C),
                ix=_arrays(md["asrc"][host], md["adst"][host],
                           md["nc"][host], Bh, R, classes),
                key=(1, mi), f0=v3["f1_base"][mi], write=write,
                classes=classes))
        f1_targets: dict = {}
        for (cli, mi, _ru, _pm, _R, s, d, ix) in v3["leafmid_cut"]:
            Bh = v3["mid_dist"][mi]["Bh"]
            for c in _rows([((0, cli), s[rank], d[rank], ix[rank])],
                           lambda d, Bh=Bh: d < Bh):
                f1_targets.setdefault(mi, []).append(c)
        f1_cut = _cut_works(f1_targets, {
            mi: (v3["f1_base"][mi], v3["mid_dist"][mi]["Bh"],
                 v3["mid_dist"][mi]["R"]) for mi in f1_targets})
        f1_cells = v3["f1_cells"]
        f0_targets: dict = {}
        for (cli, _ru, _pm, _R, gt, s, d, ix) in v3["gtop_cut"]:
            B = g_of(v3["gtop_groups"][gt]).B
            for c in _rows([((0, cli), s[rank], d[rank], ix[rank])],
                           lambda d, B=B: d < B):
                f0_targets.setdefault(gt, []).append(c)
        if chip == 0:
            # MID updates are chip-replicated: chip 0 of each host alone
            # places them (the other chips skip, so no 0 x NaN)
            for (cmi, _ru, _pm, _R, gt, s, d, ix) in v3["midtop_cut"]:
                B = g_of(v3["gtop_groups"][gt]).B
                for c in _rows([((1, cmi), s[host], d[host], ix[host])],
                               lambda d, B=B: d < B):
                    f0_targets.setdefault(gt, []).append(c)
        f0_cut = _cut_works(f0_targets, {
            gt: (v3["f0_base"][gt], g_of(v3["gtop_groups"][gt]).B,
                 g_of(v3["gtop_groups"][gt]).R) for gt in f0_targets})
        crown = crown_steps(v3["gtop_plan"], v3["f0_base"], rank == 0)
        f0_cells = v3["f0_cells"]

    # every index array onto the device at once
    steps = leaf + mid + crown
    moved = segmented.to_device(
        [[s.ix for s in steps], [w for (_b, _B, _R, w) in f1_cut],
         [w for (_b, _B, _R, w) in f0_cut]], dev)
    for s, ix in zip(steps, moved[0]):
        s.ix = ix
    f1_cut = [c[:3] + (w,) for c, w in zip(f1_cut, moved[1])]
    f0_cut = [c[:3] + (w,) for c, w in zip(f0_cut, moved[2])]
    for s in steps:
        if s.write is not None and s.write[2] is not None:
            s.write = (*s.write[:2], s.write[2].to(dev), s.write[3].to(dev))
    rp = RankPlan(plan=plan, dist=dist, world=world, rank=rank,
                  topology=schedule, device=dev,
                  dp=sd.DevicePlan(plan=plan, device=dev, groups=None),
                  leaf=leaf, mid=mid, crown=crown, f1_cut=f1_cut,
                  f0_cut=f0_cut, f1_cells=f1_cells, f0_cells=f0_cells,
                  cut_classes=cut_classes)
    cache[key] = rp
    return rp


def predicted_launches(rp: RankPlan, dtype: torch.dtype) -> dict:
    """K1 and K7 launches of one factor on this rank: K1 once a group its
    gate takes at the rank's batch, K7 once a part of every work list."""
    steps = rp.leaf + rp.mid + rp.crown
    works = [s.ix.k7_all for s in steps if s.ix.k7_all is not None] + \
        [w for (_b, _B, _R, w) in rp.f1_cut + rp.f0_cut]
    k7 = sum(sum(1 for p in w.parts if p[2].numel()) for w in works)
    return {"potrf_trsm": sum(sd._use_potrf_kernel(dtype, s.shape.B,
                                                   s.shape.C) for s in steps),
            "extend_add_f64" if dtype == torch.float64 else "extend_add": k7}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_reduce(t: torch.Tensor, phase: str, group: str, ranks: int, pg,
                log: list) -> None:
    """Sum ``t`` in place over the process group ``pg`` (None: the world)
    of ``ranks`` ranks, named ``group`` in the record, and record it: the
    port's one collective. Without a process group a world of one rank
    sums nothing (and records the sum all the same); a subgroup of one
    rank sums nothing either."""
    import torch.distributed as tdist

    t0 = time.perf_counter()
    if tdist.is_available() and tdist.is_initialized():
        if pg is None or ranks > 1:
            tdist.all_reduce(t, group=pg)
    elif ranks > 1:
        raise RuntimeError(f"dist2: a {group} sum over {ranks} ranks needs "
                           f"an initialized process group")
    _sync(t.device)
    log.append(Collective(phase, group, ranks, t.numel() * t.element_size(),
                          time.perf_counter() - t0))


def _last_reads(phases: list) -> dict:
    """key -> the last step that reads it; ``phases`` lists, step by step,
    the keys each step reads."""
    last = {}
    for pos, keys in enumerate(phases):
        for k in keys:
            last[k] = pos
    return last


def _keys(step: _Step) -> list:
    return [] if step.ix.k7_all is None else list(step.ix.k7_all.keys)


def _cut_keys(cuts) -> list:
    return [k for (_b, _B, _R, w) in cuts for k in w.keys]


def _place(cuts, cells: int, updates: dict, dtype, dev) -> torch.Tensor:
    """A zero buffer of ``cells`` with the K7 placements ``cuts`` in it."""
    from ..kernels.extend_add import extend_add_group

    buf = torch.zeros(cells, dtype=dtype, device=dev)
    for base, B, R, work in cuts:
        extend_add_group(buf[base:base + B * R * R].view(B, R, R),
                         [updates[k] for k in work.keys], work)
    return buf


def _factor_groups(steps, Cdata, updates: dict, dtype, last: dict,
                   pos: int, fbuf=None):
    """Factor ``steps`` in order; returns (panels, the next step)."""
    panels = []
    for st in steps:
        g = st.shape
        f0 = None if st.f0 is None else \
            fbuf[st.f0:st.f0 + g.B * g.R * g.R]
        panel, U = sd._group_compute(g, st.ix, Cdata, updates, dtype, f0)
        panels.append(panel)
        if U is not None and st.key in last:
            updates[st.key] = U
        _free(updates, last, pos)
        pos += 1
    return panels, pos


def _free(updates: dict, last: dict, pos: int) -> None:
    """Drop the updates that no step after ``pos`` reads."""
    for k in [k for k in updates if last.get(k, -1) <= pos]:
        del updates[k]


def _write(Lx: torch.Tensor, steps, panels) -> None:
    """This rank's cells of the canonical factor."""
    for st, panel in zip(steps, panels):
        if st.write is None:
            continue
        base, B, can, mine = st.write
        if can is None:
            Lx[base:base + panel.numel()] = panel.reshape(-1)
        else:
            cells = st.shape.R * st.shape.C
            Lx[base:base + B * cells].view(B, cells)[can] = \
                panel.reshape(-1, cells)[mine]


def dist_factorize_v2(A: CSC, S: SupernodalSymbolic, topo,
                      config: Config = DEFAULT) -> DistFactor:
    """A(p,p) = L L^T over the ranks of ``topo`` (a
    :class:`.multihost.Topology`; every rank calls with the same A and S).

    The flat schedule, or the (host, chip) one where ``topo.nhost > 1``.
    Returns a :class:`DistFactor` on ``topo.device`` in the split plan's
    single-card layout (``dplan`` holds that plan), the same bits on every
    rank, with ``F.dist`` the rank's :class:`DistRun`. Single-card factors
    of the same ``S`` keep their own plan. dtype: ``compute_dtype(config)``,
    under ``config.precision``."""
    seconds = {}
    t0 = time.perf_counter()
    rp = rank_plan(A, S, topo)
    seconds["plan"] = time.perf_counter() - t0
    dev = rp.device
    dtype = sd.compute_dtype(config)
    log: list = []
    Cdata = torch.as_tensor(sd._clow_data(A, S), device=dev).to(dtype)

    phases = [_keys(s) for s in rp.leaf]
    if rp.topology is not None:
        phases += [_cut_keys(rp.f1_cut)] + [_keys(s) for s in rp.mid]
    phases.append(_cut_keys(rp.f0_cut))
    last = _last_reads(phases)
    crown_last = _last_reads([_keys(s) for s in rp.crown])
    halo: dict = {}

    def lap(name, t):
        _sync(dev)
        seconds[name] = time.perf_counter() - t
        return time.perf_counter()

    with fp32_precision(config.precision):
        t = time.perf_counter()
        leaf_panels, pos = _factor_groups(rp.leaf, Cdata, halo, dtype, last,
                                          0)
        t = lap("leaf", t)
        mid_panels = []
        if rp.topology is not None:
            F1 = _place(rp.f1_cut, rp.f1_cells, halo, dtype, dev)
            _free(halo, last, pos)
            pos += 1
            _all_reduce(F1, "mid_halo", "host", topo.nchip, topo.host_group,
                        log)
            t = lap("mid_halo", t)
            mid_panels, pos = _factor_groups(rp.mid, Cdata, halo, dtype,
                                             last, pos, F1)
            del F1
            t = lap("mid", t)
        F0 = _place(rp.f0_cut, rp.f0_cells, halo, dtype, dev)
        halo.clear()
        _all_reduce(F0, "crown_halo" if rp.topology is not None else "halo",
                    "world", topo.world, None, log)
        t = lap("halo", t)
        crown_panels, _ = _factor_groups(rp.crown, Cdata, {}, dtype,
                                         crown_last, 0, F0)
        del F0
        t = lap("crown", t)
        Lx = torch.zeros(rp.plan.dev_size, dtype=dtype, device=dev)
        _write(Lx, rp.leaf, leaf_panels)
        _write(Lx, rp.mid, mid_panels)
        _write(Lx, rp.crown, crown_panels)
        del leaf_panels, mid_panels, crown_panels
        _all_reduce(Lx, "assembly", "world", topo.world, None, log)
        lap("assembly", t)
    minor = S.n
    if not bool(torch.isfinite(Lx).all()):
        minor = sd._find_minor(S, rp.plan, Lx.cpu().numpy())
    return DistFactor(
        S=S, Lx=Lx, minor=minor, dplan=rp.dp,
        dist=DistRun(plan=rp, topology=topo, collectives=log,
                     seconds=seconds))


@dataclasses.dataclass
class _SolveRouting:
    """The distributed solve's index tensors for one rank: per leaf group
    (its columns, pads n; its panel cells, pads dev_size; its pair routes),
    the cut routes into the crown's right-hand side, and per crown group
    (the group, its columns, its routes, its first row)."""

    leaf: list
    cut: list
    top: list
    wtop_rows: int


def _route_rows(dst, idx, R: int, base: int, dump: int) -> np.ndarray:
    """Flat rows ``base + dst * R + idx`` of a class's pairs, ``dump``
    where idx < 0."""
    return np.where(idx >= 0, base + dst.astype(np.int64)[:, None] * R + idx,
                    dump).ravel()


def _solve_routing(rp: RankPlan, S: SupernodalSymbolic) -> _SolveRouting:
    if rp.solve is None:
        dev, dist, plan = rp.device, rp.dist, rp.plan

        def t(a):
            return _t64(a, dev)

        leaf = []
        for st, sl in zip(rp.leaf, dist["solve_leaf"]):
            R, Bd = st.shape.R, st.shape.B
            leaf.append((t(sl["col"][rp.rank]), t(sl["pan"][rp.rank]),
                         [(key, t(src), t(_route_rows(dst, idx, R, 0,
                                                      Bd * R)))
                          for key, src, dst, idx in st.classes]))
        top_of = {k: i for i, k in enumerate(dist["top_groups"])}
        bases, rows = [], 0
        for k in dist["top_groups"]:
            g = plan.groups[k[0]][k[1]]
            bases.append(rows)
            rows += g.B * g.R
        cut = []
        for tgi, key, src, dst, idx in rp.cut_classes:
            g = plan.groups[dist["top_groups"][tgi][0]][
                dist["top_groups"][tgi][1]]
            cut.append((key, t(src), t(_route_rows(dst, idx, g.R, bases[tgi],
                                                   rows))))
        top = []
        for ti, (k, keep_pairs, keep_arrays) in enumerate(dist["top_plan"]):
            g = plan.groups[k[0]][k[1]]
            cols = np.full(g.B * g.C, S.n, dtype=np.int64)
            for b, s in enumerate(g.snodes):
                f = int(S.super_first[s])
                nc = int(S.super_first[s + 1]) - f
                cols[b * g.C:b * g.C + nc] = np.arange(f, f + nc)
            top.append((g, t(cols), bases[ti],
                        [(top_of[(pc.src_level, pc.src_gi)], t(src),
                          t(_route_rows(dst, idx, g.R, 0, g.B * g.R)))
                         for pc, (src, dst, idx) in zip(keep_pairs,
                                                        keep_arrays)]))
        rp.solve = _SolveRouting(leaf=leaf, cut=cut, top=top,
                                 wtop_rows=rows)
    return rp.solve


def _l11_l21(P: torch.Tensor, nc: torch.Tensor):
    """(L11 with identity on the padding, L21) of panels P (B, R, C)."""
    C = P.shape[2]
    ar = torch.arange(C, device=P.device)
    live = (ar[:, None] < nc) & (ar[None, :] < nc)
    eye = torch.eye(C, dtype=P.dtype, device=P.device)
    return torch.where(live, P[:, :C], eye), P[:, C:]


def _solve_panels(F, rp: RankPlan, rt: _SolveRouting, dtype):
    """The leaf panels of this rank and the crown's panels, gathered out
    of ``F.Lx`` once a factor and dtype (cached on ``F._solve``)."""
    key = ("dist", dtype)
    if key not in F._solve or F._solve[key][0] is not F.Lx:
        Lx = F.Lx.to(dtype)
        Lxp = torch.cat([Lx, Lx.new_zeros(1)])
        leaf = [_l11_l21(Lxp[pan].view(st.shape.B, st.shape.R, st.shape.C),
                         st.ix.nc)
                for st, (_col, pan, _r) in zip(rp.leaf, rt.leaf)]
        top = [_l11_l21(Lx[g.panel_base:g.panel_base + g.B * g.R * g.C]
                        .view(g.B, g.R, g.C),
                        _t64(g.nc, rp.device).reshape(g.B, 1, 1))
               for (g, _c, _b, _r) in rt.top]
        F._solve[key] = (F.Lx, (leaf, top))
    return F._solve[key][1]


def _push(fx: torch.Tensor, routes, bufs: dict, shape_of) -> None:
    """Backward: each child gathers its below rows out of the parent's
    ``fx`` (rows, nrhs; last row zero) by its routes."""
    nrhs = fx.shape[1]
    for key, src, rows in routes:
        B_c, RU_c = shape_of(key)
        buf = bufs.get(key)
        if buf is None:
            buf = bufs[key] = fx.new_zeros(B_c, RU_c, nrhs)
        buf[src] = fx[rows].view(src.numel(), RU_c, nrhs)


def _forward(w, routes, updates: dict, L11, L21, rhs):
    """One forward step of a group: ``w`` (B R rows and a last, dump row)
    takes its children's updates by their routes, then x_c = L11^-1 (rhs
    - w_c). Returns (x_c, the group's update w_below + L21 x_c for its
    parent; None where the group has no rows below)."""
    nrhs = w.shape[1]
    for key, src, rows in routes:
        w.index_add_(0, rows, updates[key][src].reshape(-1, nrhs))
    B, C = L11.shape[:2]
    R = C + L21.shape[1]
    w = w[:-1].view(B, R, nrhs)
    xc = torch.linalg.solve_triangular(L11, rhs - w[:, :C], upper=False)
    return xc, (torch.baddbmm(w[:, C:], L21, xc) if R > C else None)


def _backward(y, below, L11, L21, routes, bufs: dict, shape_of):
    """One backward step of a group: x_c = L11^-T (y - L21^T below), with
    ``below`` (None: zero) the x of its rows below; its children then
    gather their below rows out of [x_c; below] (:func:`_push`). Returns
    (x_c, [x_c; below] as (B R, nrhs) rows)."""
    B, C = L11.shape[:2]
    R, nrhs = C + L21.shape[1], y.shape[2]
    if R > C:
        if below is None:
            below = y.new_zeros(B, R - C, nrhs)
        y = torch.baddbmm(y, L21.mT, below, alpha=-1)
    xc = torch.linalg.solve_triangular(L11.mT, y, upper=True)
    fx = (xc if R == C else torch.cat([xc, below], dim=1)).reshape(B * R,
                                                                    nrhs)
    if routes:
        _push(torch.cat([fx, fx.new_zeros(1, nrhs)]), routes, bufs, shape_of)
    return xc, fx


def dist_solve_v2(F, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """x = A \\ b through a :func:`dist_factorize_v2` factor, every rank
    calling with the same b ((n,) or (n, nrhs)); every rank returns the
    same x.

    Leaf forward sweeps per rank, ONE world sum of the crown's right-hand
    side, the crown's forward and backward sweeps replicated, the leaf
    backward sweeps, x assembled by ONE world sum (each rank writes its
    leaf rows, rank 0 the crown's). Triangles by ``solve_triangular``,
    products by ``baddbmm``, routing by ``index_add_`` and gathers."""
    if not isinstance(F, DistFactor):
        raise ValueError("dist_solve_v2: the factor is not from "
                         "dist_factorize_v2")
    if not F.ok:
        raise ValueError(f"dist_solve_v2: the factor failed at column "
                         f"{F.minor}")
    run = F.dist
    rp, topo, S = run.plan, run.topology, F.S
    b = np.asarray(b, dtype=np.float64)
    one_d = b.ndim == 1
    bb = b.reshape(-1, 1) if one_d else b
    n, nrhs = S.n, bb.shape[1]
    dtype, dev = sd.compute_dtype(config), rp.device
    t0 = time.perf_counter()
    rt = _solve_routing(rp, S)
    leaf_p, top_p = _solve_panels(F, rp, rt, dtype)
    log: list = []
    pb = torch.as_tensor(np.concatenate([bb[S.perm], np.zeros((1, nrhs))]),
                         device=dev).to(dtype)

    def top_shape(cti):
        cg = rt.top[cti][0]
        return cg.B, cg.R - cg.C

    def leaf_shape(key):
        sh = rp.leaf[key[1]].shape
        return sh.B, sh.R - sh.C

    with fp32_precision(config.precision):
        # ---- leaf forward (this rank's subtrees) ----
        V, yfwd = {}, []
        for st, (col, _pan, routes), (L11, L21) in zip(rp.leaf, rt.leaf,
                                                       leaf_p):
            Bd, R, C = st.shape.B, st.shape.R, st.shape.C
            w = torch.zeros(Bd * R + 1, nrhs, dtype=dtype, device=dev)
            xc, V[st.key] = _forward(w, routes, V, L11, L21,
                                     pb[col].view(Bd, C, nrhs))
            yfwd.append(xc)
        wtop = torch.zeros(rt.wtop_rows + 1, nrhs, dtype=dtype, device=dev)
        for key, src, rows in rt.cut:
            wtop.index_add_(0, rows, V[key][src].reshape(-1, nrhs))
        del V
        _all_reduce(wtop, "solve_up", "world", topo.world, None, log)

        # ---- crown forward and backward (replicated) ----
        up, tf = {}, []
        for ti, ((g, cols, base, routes), (L11, L21)) in enumerate(
                zip(rt.top, top_p)):
            w = torch.cat([wtop[base:base + g.B * g.R],
                           wtop.new_zeros(1, nrhs)])
            xc, up[ti] = _forward(w, routes, up, L11, L21,
                                  pb[cols].view(g.B, g.C, nrhs))
            tf.append(xc)
        del up, wtop
        fxtop = torch.zeros(rt.wtop_rows + 1, nrhs, dtype=dtype, device=dev)
        txb: dict = {}
        txc = [None] * len(rt.top)
        for ti in range(len(rt.top) - 1, -1, -1):
            (g, _cols, base, routes), (L11, L21) = rt.top[ti], top_p[ti]
            txc[ti], fx = _backward(tf[ti], txb.pop(ti, None), L11, L21,
                                    routes, txb, top_shape)
            fxtop[base:base + g.B * g.R] = fx

        # ---- leaf backward, then x ----
        xb: dict = {}
        _push(fxtop, rt.cut, xb, leaf_shape)
        x = torch.zeros(n + 1, nrhs, dtype=dtype, device=dev)
        for li in range(len(rp.leaf) - 1, -1, -1):
            st, (col, _pan, routes), (L11, L21) = rp.leaf[li], rt.leaf[li], \
                leaf_p[li]
            xc, _fx = _backward(yfwd[li], xb.pop(st.key, None), L11, L21,
                                routes, xb, leaf_shape)
            x[col] = xc.reshape(-1, nrhs)
        if rp.rank == 0:
            for (g, cols, _b, _r), xs in zip(rt.top, txc):
                x[cols] = xs.reshape(-1, nrhs)
        _all_reduce(x, "solve_x", "world", topo.world, None, log)
    yz = x[:n].cpu().numpy().astype(np.float64)
    run.solve_collectives = log
    run.solve_seconds = time.perf_counter() - t0
    out = np.empty_like(yz)
    out[S.perm] = yz
    return out[:, 0] if one_d else out
