"""Info accounting and the report_* family of the port: the UMFPACK
``Info[90]`` / ``umfpack_report_*`` analog (``umfpack.h:38``) and CHOLMOD's
``cholmod_print_common``. Port of the JAX package's ``report.py``.

``Info`` has the reference's fields in its ``as_array`` order. The
structural fields (sizes, nnz(L), flops and their split, supernodes and
levels) are the reference's. The device fields read the port's own plan
and working-set estimate: ``factor_cells`` is the plan's ``dev_size`` (a
factor's stored cells where one is given), ``peak_cells`` / ``peak_bytes``
come from the factor's per-group working set (``_work_bytes``) in the
factor's dtype, ``nsegments`` / ``seg_budget_cells`` from how the factor
ran (``F.segments``, and the budget of :mod:`.numeric.segmented`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sparse import CSC

__all__ = ["Info", "info_from_symbolic", "info_from_factor",
           "report_matrix", "report_symbolic", "report_factor",
           "report_info", "report_perm"]


@dataclasses.dataclass
class Info:
    """Accounting record (umfpack Info[] analog, typed)."""

    n_row: int = 0
    n_col: int = 0
    nnz_a: int = 0
    strategy: str = ""            # "supernodal-ll" / "simplicial"
    ordering: str = ""            # ordering actually used
    nnz_l: int = 0                # nnz(L) (panel cells for supernodal)
    nnz_u: int = 0                # nnz(U) (LU paths; 0 for Cholesky)
    flops: float = 0.0            # factorization flop count
    nsuper: int = 0
    nlevels: int = 0
    peak_cells: int = 0           # largest group working set (cells)
    factor_cells: int = 0         # device factor buffer size
    analyze_seconds: float = 0.0
    factor_seconds: float = 0.0
    chol_flops: float = 0.0       # dense-diagonal-block factorizations
    trsm_flops: float = 0.0       # panel triangular solves
    syrk_flops: float = 0.0       # Schur-complement updates
    assembly_cells: float = 0.0   # extend-add traffic (child update cells)
    pad_ratio: float = 0.0        # device panel cells / strict lnz
    ngroups: int = 0              # group steps of the device plan
    npair_classes: int = 0        # extend-add pair classes
    nsegments: int = 0            # segments of a segmented factor (0: one
    #                               piece)
    seg_budget_cells: int = 0     # that factor's budget, in cells
    peak_bytes: float = 0.0       # estimated peak device bytes
    ir_steps: int = 0             # iterative-refinement sweeps configured

    def as_array(self) -> np.ndarray:
        """Flat double array for UMFPACK-style consumers (the reference's
        order)."""
        return np.array([
            self.n_row, self.n_col, self.nnz_a, self.nnz_l, self.nnz_u,
            self.flops, self.nsuper, self.nlevels, self.peak_cells,
            self.factor_cells, self.analyze_seconds, self.factor_seconds,
            self.chol_flops, self.trsm_flops, self.syrk_flops,
            self.assembly_cells, self.pad_ratio, self.ngroups,
            self.npair_classes, self.nsegments, self.seg_budget_cells,
            self.peak_bytes, self.ir_steps,
        ], dtype=np.float64)


def _symbolic_plan(S):
    """The first device plan built for ``S`` (``S._torch_plan``), or None."""
    cache = getattr(S, "_torch_plan", None)
    return next(iter(cache.values()), None) if cache else None


def _device_fields(info: Info, dp, dtype: torch.dtype) -> None:
    """The fields of the port's device plan ``dp`` for a factor in
    ``dtype``."""
    from .numeric.supernodal_device import _work_bytes

    plan = dp.plan
    groups = [g for gl in plan.groups for g in gl]
    work = max((_work_bytes(g, dtype) for g in groups), default=0)
    info.factor_cells = int(plan.dev_size)
    info.peak_cells = work // dtype.itemsize
    info.pad_ratio = float(plan.dev_size) / max(info.nnz_l, 1)
    info.ngroups = len(groups)
    info.npair_classes = sum(len(g.pairs) for g in groups)
    info.peak_bytes = float(plan.dev_size * dtype.itemsize + work)


def info_from_symbolic(S, A: CSC | None = None) -> Info:
    """Info of a supernodal (or simplicial) analysis; the device fields,
    for an fp32 factor, where a device plan was built for ``S``."""
    info = Info()
    if A is not None:
        info.n_row, info.n_col, info.nnz_a = A.nrow, A.ncol, A.nnz
    n = getattr(S, "n", 0)
    info.n_row = info.n_row or n
    info.n_col = info.n_col or n
    info.nnz_l = int(getattr(S, "lnz", 0))
    info.flops = float(getattr(S, "fl", 0.0))
    info.nsuper = int(getattr(S, "nsuper", 0))
    levels = getattr(S, "levels", None)
    info.nlevels = len(levels) if levels is not None else 0
    info.strategy = "supernodal-ll" if info.nsuper else "simplicial"
    # per-phase flop split: chol = nc^3/3 per supernode, trsm = ru*nc^2,
    # syrk = ru^2*nc
    if info.nsuper and hasattr(S, "super_first"):
        nc = (np.asarray(S.super_first[1:])
              - np.asarray(S.super_first[:-1])).astype(np.float64)
        nr = np.array([S.nrows(s) for s in range(info.nsuper)],
                      dtype=np.float64)
        ru = nr - nc
        info.chol_flops = float((nc ** 3 / 3).sum())
        info.trsm_flops = float((ru * nc * nc).sum())
        info.syrk_flops = float((ru * ru * nc).sum())
        info.assembly_cells = float((ru * ru).sum())
    dp = _symbolic_plan(S)
    if dp is not None:
        _device_fields(info, dp, torch.float32)
    return info


def info_from_factor(F, A: CSC | None = None) -> Info:
    """Info of a factor: its analysis's, with the device fields of the
    factor's own plan and dtype (a device factor), its stored cells, and
    how it ran (segments and their budget)."""
    inner = getattr(F, "F", F)
    S = getattr(inner, "S", None)
    info = info_from_symbolic(S, A) if S is not None else Info()
    lx = getattr(inner, "Lx", None)
    dp = getattr(inner, "dplan", None)
    if dp is not None:
        _device_fields(info, dp, lx.dtype)
        segs = getattr(inner, "segments", 1)
        if segs > 1:
            info.nsegments = segs
            info.seg_budget_cells = int(dp.schedule[0][-1]) \
                // lx.element_size()
    if isinstance(lx, torch.Tensor):
        info.factor_cells = int(lx.numel())
    elif lx is not None and hasattr(lx, "size"):
        info.factor_cells = int(lx.size)
    return info


def _p(prl: int, level: int, line: str, out: list) -> None:
    if prl >= level:
        out.append(line)


def report_matrix(A: CSC, name: str = "A", prl: int = 3) -> str:
    """umfpack_report_matrix / cholmod_print_sparse analog."""
    out: list = []
    _p(prl, 1, f"{name}: {A.nrow}-by-{A.ncol}, nnz {A.nnz}, "
       f"sym {A.sym}, dtype {A.data.dtype}", out)
    if prl >= 2 and A.nnz:
        degs = np.diff(A.indptr)
        _p(prl, 2, f"  col degrees: min {degs.min()} max {degs.max()} "
           f"mean {degs.mean():.1f}", out)
        _p(prl, 2, f"  |a|: min {np.abs(A.data).min():.3e} "
           f"max {np.abs(A.data).max():.3e}", out)
    if prl >= 4:
        k = min(A.ncol, 4)
        for j in range(k):
            lo, hi = A.indptr[j], A.indptr[j + 1]
            _p(prl, 4, f"  col {j}: rows {A.indices[lo:hi][:8].tolist()} "
               f"vals {np.asarray(A.data[lo:hi][:4]).tolist()}", out)
    return "\n".join(out)


def report_symbolic(S, prl: int = 3) -> str:
    """umfpack_report_symbolic analog."""
    info = info_from_symbolic(S)
    out: list = []
    _p(prl, 1, f"symbolic: n {info.n_col}, strategy {info.strategy}, "
       f"nnz(L) {info.nnz_l}, flops {info.flops:.3e}", out)
    _p(prl, 2, f"  supernodes {info.nsuper}, tree levels {info.nlevels}", out)
    if info.peak_cells:
        _p(prl, 2, f"  device factor cells {info.factor_cells}, "
           f"largest group working set {info.peak_cells}", out)
    return "\n".join(out)


def report_factor(F, prl: int = 3) -> str:
    """umfpack_report_numeric / cholmod_print_factor analog."""
    info = info_from_factor(F)
    ok = getattr(F, "ok", None)
    minor = getattr(F, "minor", None)
    out: list = []
    _p(prl, 1, f"factor: n {info.n_col}, ok {ok}, minor {minor}, "
       f"stored cells {info.factor_cells}", out)
    return "\n".join(out)


def report_perm(p: np.ndarray, prl: int = 3) -> str:
    """umfpack_report_perm analog (with validity check)."""
    p = np.asarray(p)
    n = p.size
    valid = bool(np.array_equal(np.sort(p), np.arange(n)))
    head = p[: min(n, 8)].tolist()
    return f"perm: length {n}, valid {valid}, head {head}"


def report_info(info: Info, prl: int = 3) -> str:
    """umfpack_report_info analog."""
    out: list = []
    _p(prl, 1, f"Info: {info.n_row}-by-{info.n_col}, nnz(A) {info.nnz_a}", out)
    _p(prl, 1, f"  strategy {info.strategy or '-'}  ordering "
       f"{info.ordering or '-'}", out)
    _p(prl, 1, f"  nnz(L) {info.nnz_l}  nnz(U) {info.nnz_u}  "
       f"flops {info.flops:.3e}", out)
    _p(prl, 2, f"  supernodes {info.nsuper}  levels {info.nlevels}", out)
    _p(prl, 2, f"  factor cells {info.factor_cells}  peak group cells "
       f"{info.peak_cells}", out)
    _p(prl, 2, f"  analyze {info.analyze_seconds:.3f}s  factor "
       f"{info.factor_seconds:.3f}s", out)
    if info.chol_flops:
        _p(prl, 2, f"  flop split: chol {info.chol_flops:.3e}  trsm "
           f"{info.trsm_flops:.3e}  syrk {info.syrk_flops:.3e}", out)
        _p(prl, 2, f"  assembly cells {info.assembly_cells:.3e}", out)
    if info.ngroups:
        _p(prl, 2, f"  groups {info.ngroups}  pair classes "
           f"{info.npair_classes}  pad ratio {info.pad_ratio:.2f}", out)
        _p(prl, 2, f"  est peak device bytes {info.peak_bytes:.3e}", out)
    if info.nsegments:
        _p(prl, 2, f"  segments {info.nsegments}  budget cells "
           f"{info.seg_budget_cells}", out)
    return "\n".join(out)
