"""The sharded multifrontal factor over a (tree, panel) mesh of ranks, on
``torch.distributed``.

Port of :mod:`suitesparse_tpu.parallel.dist`. The reference runs the
single-card plan under GSPMD with one sharding hint a group
(``_make_cstr``); the port runs the same plan SPMD by rank, and each rank
does its share of each group by the same rule:

* **tree** (the group batches several fronts, B > 1): rank ``(t, p)``
  takes a contiguous range of the group's slots, the same range for every
  ``p``. It scatters A's entries of those slots, places by K7 the pair
  classes whose parent slot is its own (one launch a group), and factors
  them with K1 under the group's whole-batch gate, so that the mesh takes
  the single card's route; then the group's update blocks U are gathered
  over the tree group (the ranks that share ``p``).
* **panel** (one front, R >= 256 rows): every rank assembles the whole
  front (its inputs are replicated) and factors F11, as GSPMD replicates
  it; rank ``p`` of the panel group (the ranks that share ``t``) solves
  its block of L21's rows, L21 is gathered over the panel group, the rank
  forms its rows of U = F22 - L21 L21^T, and U's rows are gathered over
  the panel group for the parent. The trsm and the update product are
  plain products outside any kernel in the reference, so they stay
  library calls here (``solve_triangular``, ``baddbmm``).
* **otherwise** the group runs whole on every rank.

The factor keeps the single-card layout (``dev_size`` cells): every rank
writes the cells it alone owns (rank ``(t, 0)`` its tree slots, rank 0 the
other groups) into a zero buffer, and one world sum gives every rank the
same ``Lx``, a failed tile's NaN included (``minor`` agrees). A gather is
also such a sum, of a zero buffer with one writer a cell: gloo has no CUDA
``all_gather``, and one path serves both backends. Every sum goes through
:func:`.dist2._all_reduce`, which records it for
:func:`.diag.collective_census`.

K2's tile manifests fold a whole group's slots, so this path places every
pair class by K7, as :mod:`.dist2` does. The reference skips its tile
kernel and K1 on this path only because ``pallas_call`` does not partition
under GSPMD; the port's kernels run on every rank. The factor runs in one
piece (no segments) and solves through
:func:`..numeric.supernodal_solve.solve_device` on each rank's card. It
holds its updates in the compute dtype whatever ``Config.update_dtype``
says: ``_group_compute`` runs with its default, as the reference's
``dist.py:89`` calls ``_run_plan`` without an update dtype.
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
from .dist2 import _Shape, _all_reduce, _sync

__all__ = ["MeshFactor", "MeshRun", "SolverMesh", "dist_factorize_device",
           "make_solver_mesh", "mesh_plan", "predicted_launches"]

PANEL_ROWS = 256      # the reference's row threshold of the panel axis


@dataclasses.dataclass
class SolverMesh:
    """This rank's place in a (tree, panel) mesh of ``tree * panel``
    ranks, laid out row-major (``rank = t * panel + p``, the reference's
    ``reshape(tree, panel)``). ``tree_group``: the process group of the
    ranks that share ``p``; ``panel_group``: of those that share ``t``
    (None without a process group)."""

    tree: int
    panel: int
    rank: int
    t: int
    p: int
    tree_group: object
    panel_group: object
    device: torch.device

    @property
    def world(self) -> int:
        return self.tree * self.panel


def _split(world: int, tree: int | None = None,
           panel: int | None = None) -> tuple[int, int]:
    """(tree, panel) of a world: the reference's default (panel 2 where
    the world is even, else 1) unless both are given."""
    if tree is None or panel is None:
        panel = 2 if world % 2 == 0 and world >= 2 else 1
        tree = world // panel
    if tree < 1 or panel < 1 or tree * panel != world:
        raise ValueError(f"make_solver_mesh: {tree} x {panel} ranks for a "
                         f"world of {world}")
    return tree, panel


def make_solver_mesh(tree: int | None = None, panel: int | None = None,
                     device=None) -> SolverMesh:
    """This rank's (tree, panel) :class:`SolverMesh` over the initialized
    process group (:func:`.multihost.initialize`; a world of one rank
    without one). Every rank must call it with the same arguments: it
    creates one process group a row and a column of the mesh, all in the
    same order. ``device``: by default ``cuda:{local rank % device
    count}`` (it raises where there is no card); the CPU tests pass
    ``"cpu"``."""
    import torch.distributed as tdist

    from .multihost import _default_device

    init = tdist.is_available() and tdist.is_initialized()
    world = tdist.get_world_size() if init else 1
    rank = tdist.get_rank() if init else 0
    tree, panel = _split(world, tree, panel)
    t, p = divmod(rank, panel)
    tree_group = panel_group = None
    if init:
        panels = [tdist.new_group([tt * panel + pp for pp in range(panel)])
                  for tt in range(tree)]
        trees = [tdist.new_group([tt * panel + pp for tt in range(tree)])
                 for pp in range(panel)]
        panel_group, tree_group = panels[t], trees[p]
    return SolverMesh(tree=tree, panel=panel, rank=rank, t=t, p=p,
                      tree_group=tree_group, panel_group=panel_group,
                      device=resolve_device(_default_device() if device is None
                                            else device))


def _axis(g, panel_rows: int) -> str | None:
    """The reference's ``_make_cstr`` rule for group ``g``: "tree" (batch
    sharded), "panel" (rows sharded) or None (replicated)."""
    if g.B > 1:
        return "tree"
    if g.R >= panel_rows:
        return "panel"
    return None


def _range(n: int, parts: int, i: int) -> tuple[int, int]:
    """Part ``i`` of ``parts`` contiguous, near-equal parts of ``range(n)``."""
    return n * i // parts, n * (i + 1) // parts


@dataclasses.dataclass
class _Step:
    """One group of the plan as this rank runs it."""

    g: object               # the plan's GroupPlan
    key: tuple              # (level, gi)
    axis: str | None        # "tree", "panel" or None
    lo: int                 # tree: this rank's slots; panel: its rows of
    hi: int                 #   L21 and U (0 <= lo <= hi <= RU)
    shape: object           # what _group_compute reads (tree: the share)
    ix: object              # sd.GroupArrays on the device (None: no share)
    write: bool             # this rank writes its cells of the factor


@dataclasses.dataclass
class MeshPlan:
    """Rank ``mesh.rank``'s share of the single-card plan (``dp``)."""

    dp: object              # sd.DevicePlan (the single card's, shared)
    steps: list
    last: dict              # update key -> the last step that reads it


def _share_arrays(g, lo: int, hi: int) -> sd.GroupArrays:
    """Slots ``lo:hi`` of group ``g`` as a group of their own (host
    arrays): A's entries of those slots, their column counts and the K7
    work of the pairs whose parent slot lies there, children read from the
    whole child groups."""
    RR = g.R * g.R
    a0, a1 = np.searchsorted(g.adst, [lo * RR, hi * RR])
    classes = []
    for key, src, dst, idx in sd.k7_classes(g):
        m = (dst >= lo) & (dst < hi)
        if m.any():
            classes.append((key, src[m], dst[m] - lo, idx[m]))
    return sd.GroupArrays(
        asrc=torch.as_tensor(np.asarray(g.asrc[a0:a1], dtype=np.int64)),
        adst=torch.as_tensor(np.asarray(g.adst[a0:a1], dtype=np.int64)
                             - lo * RR),
        nc=torch.as_tensor(np.asarray(g.nc[lo:hi], dtype=np.int64))
        .reshape(hi - lo, 1, 1),
        k7=None, k7_all=build_work(hi - lo, g.R, classes) if classes
        else None, tile=None, uslices=[])


def mesh_plan(A: CSC, S: SupernodalSymbolic, mesh: SolverMesh,
              panel_rows: int = PANEL_ROWS) -> MeshPlan:
    """This rank's share of the single-card plan for ``S`` (the analysis
    of ``A``), its index arrays on the mesh's device. Cached on ``S`` per
    mesh shape, rank, device and threshold; nothing in it depends on the
    factor's dtype."""
    dev = mesh.device
    key = (mesh.tree, mesh.panel, mesh.rank, str(dev), int(panel_rows))
    cache = getattr(S, "_torch_mesh", None)
    if cache is None:
        cache = S._torch_mesh = {}
    if key in cache:
        return cache[key]
    dp = sd._plan_entry(A, S, dev, sd.TILE_RMIN, False)
    plan = dp.plan
    steps, host = [], []
    flat = iter(dp.host)
    for d, glist in enumerate(plan.groups):
        for gi, g in enumerate(glist):
            hx = next(flat)
            axis = _axis(g, panel_rows)
            if axis == "tree":
                lo, hi = _range(g.B, mesh.tree, mesh.t)
                ix = _share_arrays(g, lo, hi) if hi > lo else None
                shape = _Shape(hi - lo, g.R, g.C)
                write = mesh.p == 0 and hi > lo
            else:
                lo, hi = (_range(g.R - g.C, mesh.panel, mesh.p)
                          if axis == "panel" else (0, g.R - g.C))
                ix = dataclasses.replace(hx, k7=None, tile=None, uslices=[])
                shape, write = g, mesh.rank == 0
            steps.append(_Step(g=g, key=(d, gi), axis=axis, lo=lo, hi=hi,
                               shape=shape, ix=None, write=write))
            host.append(ix)
    for st, ix in zip(steps, segmented.to_device(host, dev)):
        st.ix = ix
    _order, last = sd._update_consumers(plan)
    mp = MeshPlan(dp=dp, steps=steps, last=last)
    cache[key] = mp
    return mp


def predicted_launches(mp: MeshPlan, dtype: torch.dtype) -> dict:
    """K1 and K7 launches of one factor on this rank: K1 once a group
    whose share is not empty and whose whole batch passes the gate, K7
    once a part of every work list this rank runs."""
    k1 = sum(st.ix is not None and sd._use_potrf_kernel(dtype, st.g.B,
                                                        st.g.C)
             for st in mp.steps)
    k7 = sum(sum(1 for part in st.ix.k7_all.parts if part[2].numel())
             for st in mp.steps
             if st.ix is not None and st.ix.k7_all is not None)
    return {"potrf_trsm": k1,
            "extend_add_f64" if dtype == torch.float64 else "extend_add": k7}


@dataclasses.dataclass
class MeshRun:
    """What one rank's mesh factor did: its share of the plan, its sums in
    order (:class:`.dist2.Collective`), the seconds of its phases.
    ``solve_collectives`` stays empty for :func:`.diag.collective_census`:
    the factor solves on each rank's card, with no sum."""

    plan: MeshPlan
    mesh: SolverMesh
    collectives: list
    seconds: dict
    solve_collectives: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(kw_only=True)
class MeshFactor(TorchSupernodalFactor):
    """A :func:`dist_factorize_device` factor: a single-card factor in the
    single card's layout, with ``dist`` the rank's :class:`MeshRun`."""

    dist: MeshRun


def _gather_rows(part: torch.Tensor, rows: int, lo: int, phase: str,
                 group: str, ranks: int, pg, log: list) -> torch.Tensor:
    """The (B, rows, ...) block whose rows ``lo:lo + part.shape[1]`` this
    rank holds in ``part``, the others held by the other ranks of ``pg``:
    a zero buffer, this rank's rows written, one sum."""
    B = part.shape[0]
    buf = part.new_zeros((B, rows) + tuple(part.shape[2:]))
    buf[:, lo:lo + part.shape[1]] = part
    _all_reduce(buf, phase, group, ranks, pg, log)
    return buf


def _panel_compute(g, ix, Cdata, updates: dict, dtype, lo: int, hi: int,
                   mesh: SolverMesh, log: list):
    """One front with its rows sharded over the panel group: the whole
    front assembled and F11 factored on every rank, this rank's rows
    ``lo:hi`` of L21 and of U, each gathered over the panel group.
    Returns (panel (1, R, C), U (1, RU, RU))."""
    C, RU = g.C, g.R - g.C
    F, _skip = sd._assemble(g, ix, Cdata, updates, dtype)
    live, eye, F11m = sd._pivots(F, ix.nc, C)
    # B = 1: the K1 gate (B >= 32) never passes, as on the single card
    L11 = sd._chol(F11m, live)
    L21p = torch.linalg.solve_triangular(
        torch.where(live, L11, eye).mT, F[:, C + lo:C + hi, :C].contiguous(),
        upper=True, left=False)
    L21 = _gather_rows(L21p, RU, lo, "panel_l21", "panel", mesh.panel,
                       mesh.panel_group, log)
    Up = torch.baddbmm(F[:, C + lo:C + hi, C:], L21p, L21.mT, alpha=-1)
    U = _gather_rows(Up, RU, lo, "panel_u", "panel", mesh.panel,
                     mesh.panel_group, log)
    return torch.cat([L11, L21], dim=1), U


def dist_factorize_device(A: CSC, S: SupernodalSymbolic, mesh: SolverMesh,
                          config: Config = DEFAULT,
                          _panel_rows: int = PANEL_ROWS) -> MeshFactor:
    """A(p,p) = L L^T over the ranks of ``mesh`` (a :class:`SolverMesh`;
    every rank calls with the same A and S), each group sharded by the
    reference's rule (the module's docstring). Returns a :class:`MeshFactor`
    on ``mesh.device`` in the single card's padded layout, the same bits on
    every rank; ``minor`` is the first column of the first supernode whose
    panel is not finite, or n. dtype: ``compute_dtype(config)``, under
    ``config.precision``. ``_panel_rows``: the panel axis's row threshold
    (the reference's 256)."""
    seconds = {}
    t0 = time.perf_counter()
    mp = mesh_plan(A, S, mesh, _panel_rows)
    seconds["plan"] = time.perf_counter() - t0
    dev = mesh.device
    dtype = sd.compute_dtype(config)
    plan = mp.dp.plan
    log: list = []
    updates: dict = {}
    t0 = time.perf_counter()
    Cdata = torch.as_tensor(sd._clow_data(A, S), device=dev).to(dtype)
    with fp32_precision(config.precision):
        Lx = torch.zeros(plan.dev_size, dtype=dtype, device=dev)
        for pos, st in enumerate(mp.steps):
            g = st.g
            RU = g.R - g.C
            panel = U = None
            if st.axis == "panel" and RU > 0:
                panel, U = _panel_compute(g, st.ix, Cdata, updates, dtype,
                                          st.lo, st.hi, mesh, log)
            elif st.axis == "tree":
                if st.ix is not None:
                    panel, U = sd._group_compute(st.shape, st.ix, Cdata,
                                                 updates, dtype, gate_B=g.B)
                if RU > 0 and st.key in mp.last:
                    part = U if U is not None else Cdata.new_zeros(0, RU, RU)
                    U = _gather_rows(part.unsqueeze(0), g.B, st.lo, "tree_u",
                                     "tree", mesh.tree, mesh.tree_group,
                                     log)[0]
            else:
                panel, U = sd._group_compute(g, st.ix, Cdata, updates, dtype)
            if st.write:
                base = g.panel_base + st.lo * g.R * g.C \
                    if st.axis == "tree" else g.panel_base
                Lx[base:base + panel.numel()] = panel.reshape(-1)
            if U is not None and st.key in mp.last:
                updates[st.key] = U
            for k in [k for k in updates if mp.last[k] <= pos]:
                del updates[k]
        _sync(dev)
        seconds["groups"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _all_reduce(Lx, "assembly", "world", mesh.world, None, log)
        seconds["assembly"] = time.perf_counter() - t0
    minor = S.n
    if not bool(torch.isfinite(Lx).all()):
        minor = sd._find_minor(S, plan, Lx.cpu().numpy())
    return MeshFactor(S=S, Lx=Lx, minor=minor, dplan=mp.dp,
                      dist=MeshRun(plan=mp, mesh=mesh, collectives=log,
                                   seconds=seconds))
