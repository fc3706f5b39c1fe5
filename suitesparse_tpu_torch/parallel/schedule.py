"""Static subtree-per-device schedule for the distributed factorization.

Copy of :mod:`suitesparse_tpu.parallel.schedule` (numpy only). The
supernode tree is cut into flop-balanced subtrees, one set a rank, and a
TOP separator crown above them (:func:`partition_tree`); the (host, chip)
form cuts twice, by host and then by chip, and leaves a MID layer between
the two cuts that each host factors on its own
(:func:`partition_tree_topology`). :func:`model_scaling` models the
strong-scaling table of a set of topologies from rates the caller gives:
the port states no default rate.

Reference analog: SPQR's TBB task tree (``spqr_parallel.cpp:8-94``), as a
STATIC ownership partition: every supernode below the cut belongs to
exactly one subtree, each subtree root is assigned to one rank by LPT
bin packing on exact subtree flops, and each rank factors its own
subtrees with the same group schedule (classes unified across ranks,
per-rank batches padded to the class maximum; dummy slots factor identity
fronts).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..symbolic.supernodes import SupernodalSymbolic

__all__ = ["partition_tree", "partition_tree_topology", "TreePartition",
           "model_scaling"]


@dataclasses.dataclass
class TreePartition:
    ndev: int
    own: np.ndarray        # snode -> device, or -1 for TOP snodes
    top: np.ndarray        # bool mask of top snodes
    dev_fl: np.ndarray     # per-device leaf flops (balance diagnostic)
    top_fl: float
    # ---- 2-level (host, chip) topology fields (partition_tree_topology) ----
    nhost: int = 1
    nchip: int = 0         # 0 = flat partition (no topology)
    mid_host: np.ndarray | None = None   # snode -> host for MID snodes, -1 else
    host_fl: np.ndarray | None = None    # per-host leaf+mid flops
    mid_fl: float = 0.0                  # total MID flops (host-replicated work)

    @property
    def split_key(self) -> np.ndarray:
        """Per-snode int group-split key for build_plan: 0 = leaf, 1 = MID
        (host-local; slots distributed across hosts within each group the
        same way leaf slots distribute across devices), 2 = global TOP."""
        key = np.zeros(self.own.size, dtype=np.int64)
        if self.mid_host is not None:
            key[self.mid_host >= 0] = 1
        key[self.top & (key == 0)] = 2
        return key


def _snode_fl(S: SupernodalSymbolic) -> np.ndarray:
    fl = np.zeros(S.nsuper)
    for s in range(S.nsuper):
        nc = S.ncols(s)
        nr = S.nrows(s)
        fl[s] = nc**3 / 3 + (nr - nc) * nc * nc + (nr - nc) ** 2 * nc
    return fl


def partition_tree(S: SupernodalSymbolic, ndev: int,
                   oversub: int = 8) -> TreePartition:
    """Cut the supernode tree into >= ndev subtrees balanced by flops."""
    ns = S.nsuper
    fl = _snode_fl(S)
    sub_fl = fl.copy()
    for s in range(ns):            # postorder: children before parents
        p = S.sparent[s]
        if p >= 0:
            sub_fl[p] += sub_fl[s]
    total = float(sub_fl[np.flatnonzero(S.sparent < 0)].sum()) or 1.0
    grain = total / max(ndev * oversub, 1)

    # top-down cut: a subtree becomes a unit when its flops fit the grain;
    # otherwise its root joins TOP and we recurse into the children
    children: list = [[] for _ in range(ns)]
    roots = []
    for s in range(ns):
        p = S.sparent[s]
        if p >= 0:
            children[p].append(s)
        else:
            roots.append(s)
    top = np.zeros(ns, dtype=bool)
    units = []                      # subtree-root snodes
    stack = list(roots)
    while stack:
        s = stack.pop()
        if sub_fl[s] <= grain or not children[s]:
            units.append(s)
        else:
            top[s] = True
            stack.extend(children[s])
    # LPT assignment of units to devices
    units.sort(key=lambda s: -sub_fl[s])
    load = np.zeros(ndev)
    own = np.full(ns, -1, dtype=np.int64)
    for u in units:
        d = int(np.argmin(load))
        load[d] += sub_fl[u]
        # assign the whole subtree of u
        st = [u]
        while st:
            v = st.pop()
            own[v] = d
            st.extend(children[v])
    return TreePartition(ndev=ndev, own=own, top=top, dev_fl=load,
                         top_fl=float(fl[top].sum()))


def _tree_arrays(S: SupernodalSymbolic):
    ns = S.nsuper
    fl = _snode_fl(S)
    sub_fl = fl.copy()
    for s in range(ns):            # postorder: children before parents
        p = S.sparent[s]
        if p >= 0:
            sub_fl[p] += sub_fl[s]
    children: list = [[] for _ in range(ns)]
    roots = []
    for s in range(ns):
        p = S.sparent[s]
        if p >= 0:
            children[p].append(s)
        else:
            roots.append(s)
    return fl, sub_fl, children, roots


def _cut(sub_fl, children, roots, grain):
    """Top-down cut: returns (units, above) where every snode is either in
    exactly one unit subtree or in the ABOVE set."""
    units, above = [], []
    stack = list(roots)
    while stack:
        s = stack.pop()
        if sub_fl[s] <= grain or not children[s]:
            units.append(s)
        else:
            above.append(s)
            stack.extend(children[s])
    return units, above


def _lpt(units, sub_fl, nbins):
    """LPT bin packing; returns (bin_of_unit dict, loads)."""
    order = sorted(units, key=lambda s: -sub_fl[s])
    load = np.zeros(nbins)
    binof = {}
    for u in order:
        b = int(np.argmin(load))
        load[b] += sub_fl[u]
        binof[u] = b
    return binof, load


def partition_tree_topology(S: SupernodalSymbolic, nhost: int, nchip: int,
                            oversub: int = 8,
                            host_oversub: int = 4) -> TreePartition:
    """Two-level (host, chip) cut of the supernode tree.

    Host grain: the tree is first cut into >= nhost subtrees at a coarse
    flop grain and LPT-packed onto HOSTS; everything above this cut is the
    global TOP (separator crown), assembled by the one sum over every
    rank. Chip grain: each host's subtrees are cut again at a fine grain
    and LPT-packed onto that host's CHIPS; snodes between the two cuts are
    MID, factored host-locally (their halo sum runs over the host's ranks
    only). Flat device ids are host-major (dev = host * nchip + chip).
    """
    ns = S.nsuper
    fl, sub_fl, children, roots = _tree_arrays(S)
    total = float(sub_fl[np.asarray(roots, dtype=np.int64)].sum()) or 1.0

    top = np.zeros(ns, dtype=bool)
    mid_host = np.full(ns, -1, dtype=np.int64)
    own = np.full(ns, -1, dtype=np.int64)
    dev_fl = np.zeros(nhost * nchip)
    host_fl = np.zeros(nhost)

    # host cut
    grain_h = total / max(nhost * host_oversub, 1)
    hunits, gtop = _cut(sub_fl, children, roots, grain_h)
    for s in gtop:
        top[s] = True
    hof, hload = _lpt(hunits, sub_fl, nhost)

    # chip cut within each host
    for h in range(nhost):
        h_units = [u for u in hunits if hof[u] == h]
        h_total = float(sub_fl[np.asarray(h_units, dtype=np.int64)].sum()) \
            if h_units else 0.0
        host_fl[h] = h_total
        grain_c = h_total / max(nchip * oversub, 1) if h_total else 1.0
        cunits, mid = _cut(sub_fl, children, h_units, grain_c)
        if nhost > 1:
            for s in mid:
                top[s] = True
                mid_host[s] = h
        else:
            # single host: no host-local phase exists; between-cut snodes
            # join the global top (flat dist2 behavior)
            for s in mid:
                top[s] = True
        cof, cload = _lpt(cunits, sub_fl, nchip)
        for u in cunits:
            d = h * nchip + cof[u]
            st = [u]
            while st:
                v = st.pop()
                own[v] = d
                st.extend(children[v])
        dev_fl[h * nchip:(h + 1) * nchip] = cload

    mid_mask = mid_host >= 0
    return TreePartition(
        ndev=nhost * nchip, own=own, top=top, dev_fl=dev_fl,
        top_fl=float(fl[top & ~mid_mask].sum()),
        nhost=nhost, nchip=nchip, mid_host=mid_host, host_fl=host_fl,
        mid_fl=float(fl[mid_mask].sum()))


def model_scaling(S: SupernodalSymbolic, topologies, *, rate_flops: float,
                  ici_bw: float, dcn_bw: float, dtype_bytes: int = 4):
    """Modeled strong-scaling table: per topology, the leaf phase is the
    max per-device subtree flop load, the MID phase is the max per-host
    host-local flop load (chip-replicated), the TOP phase is the
    separator-crown critical path with front rows panel-sharded over the
    fleet, the intra-host traffic (``ici``) is the per-host mid-front halo
    sum, and the inter-host traffic (``dcn``) is the one global top-front
    sum.

    Returns a list of dict rows (the reference's keys). The rates are
    required: ``rate_flops`` (flop/s of one device), ``ici_bw`` (bytes/s
    of the link between two devices of a host) and ``dcn_bw`` (bytes/s
    between hosts); the table is only as good as the rates the caller
    measured for its own devices.
    """
    fl, sub_fl, children, roots = _tree_arrays(S)
    nr_all = np.array([S.nrows(s) for s in range(S.nsuper)], dtype=np.int64)
    cells = nr_all.astype(np.float64) ** 2
    total = float(fl.sum())
    rows = []
    for (nhost, nchip) in topologies:
        part = partition_tree_topology(S, nhost, nchip)
        ndev = nhost * nchip
        mid_mask = part.mid_host >= 0
        gtop_mask = part.top & ~mid_mask
        t_leaf = float(part.dev_fl.max()) / rate_flops if ndev else 0.0
        # mid fronts: computed chip-replicated within the owning host
        mid_fl_h = np.zeros(nhost)
        mid_cells_h = np.zeros(nhost)
        for s in np.flatnonzero(mid_mask):
            mid_fl_h[part.mid_host[s]] += fl[s]
            mid_cells_h[part.mid_host[s]] += cells[s]
        t_mid = float(mid_fl_h.max()) / rate_flops if nhost else 0.0
        # top chain: sequential in snodes; rows sharded over the fleet —
        # model panel efficiency as min(1, nr/(128*ndev)) per front
        t_top = 0.0
        for s in np.flatnonzero(gtop_mask):
            speedup = max(1.0, min(ndev, nr_all[s] / 128.0))
            t_top += fl[s] / (rate_flops * speedup)
        ici_bytes = float(mid_cells_h.max()) * dtype_bytes
        dcn_bytes = float(cells[gtop_mask].sum()) * dtype_bytes
        t_ici = ici_bytes * (nchip - 1) / max(nchip, 1) / ici_bw
        t_dcn = (dcn_bytes / dcn_bw) if nhost > 1 else \
            (dcn_bytes * (ndev - 1) / max(ndev, 1) / ici_bw)
        t_total = t_leaf + t_mid + t_top + t_ici + t_dcn
        t1 = total / rate_flops
        rows.append({
            "nhost": nhost, "nchip": nchip, "ndev": ndev,
            "t_leaf_s": t_leaf, "t_mid_s": t_mid, "t_top_s": t_top,
            "t_ici_s": t_ici, "t_dcn_s": t_dcn, "t_total_s": t_total,
            "ici_mbytes": ici_bytes / 1e6, "dcn_mbytes": dcn_bytes / 1e6,
            "leaf_balance": float(part.dev_fl.max()
                                  / max(part.dev_fl.mean(), 1.0)),
            "speedup": t1 / t_total if t_total else float("inf"),
            "efficiency": (t1 / t_total / ndev) if t_total and ndev else 0.0,
            "top_share": float(fl[gtop_mask].sum()) / max(total, 1.0),
            "mid_share": float(fl[mid_mask].sum()) / max(total, 1.0),
        })
    return rows
