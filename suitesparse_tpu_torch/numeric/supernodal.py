"""Supernodal Cholesky factors of the port, and the factorize dispatcher.

Port of :mod:`suitesparse_tpu.numeric.supernodal`. Problems with enough
flops (``S.fl >= 5e6``, the reference's rule) factor on the device through
:mod:`.supernodal_device` into a :class:`TorchSupernodalFactor`; smaller
ones take the numpy multifrontal :func:`factorize_host` into a
:class:`SupernodalFactor` (CHOLMOD px layout). A factor loaded from a file
past the same rule is a :class:`TorchPxFactor` (px layout on a device).
Each is wrapped in a :class:`SupernodalFactorAdapter`, so the host solvers
and ``to_csc`` read it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT, Config
from ..device import resolve_device
from ..sparse import CSC
from ..stats import span
from ..symbolic.supernodes import SupernodalSymbolic, analyze_supernodal
from . import supernodal_device

__all__ = ["SupernodalFactor", "TorchSupernodalFactor", "TorchPxFactor",
           "SupernodalFactorAdapter", "factorize", "factorize_host",
           "factor_from_arrays", "supernodal_symbolic", "to_csc"]


def _panel(F, s: int) -> np.ndarray:
    S = F.S
    nr, nc = S.nrows(s), S.ncols(s)
    return F.lx_host()[S.Lpx[s]:S.Lpx[s + 1]].reshape(nr, nc, order="F")


@dataclasses.dataclass
class SupernodalFactor:
    """Host supernodal factor A(p,p) = L L': panel s is column-major
    (nrows, ncols) at ``S.Lpx[s] : S.Lpx[s+1]`` of ``Lx`` (reference
    ``L->px`` layout, ``cholmod_core.h:1659-1668``)."""

    S: SupernodalSymbolic
    Lx: np.ndarray
    minor: int      # = n on success

    @property
    def ok(self) -> bool:
        return self.minor == self.S.n

    @property
    def perm(self) -> np.ndarray:
        return self.S.perm

    def lx_host(self) -> np.ndarray:
        return self.Lx

    panel = _panel


@dataclasses.dataclass
class TorchSupernodalFactor:
    """Numeric supernodal factor held as a torch tensor in the padded device
    layout of its plan (see :mod:`.supernodal_device`)."""

    S: SupernodalSymbolic
    Lx: torch.Tensor
    minor: int
    dplan: "supernodal_device.DevicePlan"
    segments: int = 1   # the factor ran in this many segments
    _lx_px: np.ndarray | None = None
    # per-mode solve state, see supernodal_solve.solve_device
    _solve: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.minor == self.S.n

    @property
    def perm(self) -> np.ndarray:
        return self.S.perm

    def lx_host(self) -> np.ndarray:
        """Host copy in the CHOLMOD px layout (cached)."""
        if self._lx_px is None:
            plan = self.dplan.plan
            Lh = self.Lx.detach().cpu().numpy().astype(np.float64)
            px = np.zeros(plan.lnz)
            px[plan.px_dst] = Lh[plan.px_src]
            self._lx_px = px
        return self._lx_px

    panel = _panel


@dataclasses.dataclass
class TorchPxFactor:
    """A supernodal factor held as a torch tensor in the CHOLMOD px layout
    (``S.lnz`` values, panel s column-major at ``S.Lpx[s]``), e.g. one that
    :func:`suitesparse_tpu_torch.serialize.load_factor` put on a device.
    It solves through the px sweep (:func:`.supernodal_solve.solve_px`),
    the reference's solve of a factor with ``layout == "px"``."""

    S: SupernodalSymbolic
    Lx: torch.Tensor
    minor: int
    _lx_px: np.ndarray | None = None
    # per-dtype panels of the px sweep, see supernodal_solve.solve_px
    _solve: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.minor == self.S.n

    @property
    def perm(self) -> np.ndarray:
        return self.S.perm

    def lx_host(self) -> np.ndarray:
        """Host fp64 copy of the panels (cached)."""
        if self._lx_px is None:
            self._lx_px = self.Lx.detach().cpu().numpy().astype(np.float64)
        return self._lx_px

    panel = _panel


def to_csc(F) -> CSC:
    """Supernodal panels -> CSC lower-triangular L (diagonal first)."""
    S = F.S
    n = S.n
    counts = np.zeros(n, dtype=np.int64)
    for s in range(S.nsuper):
        f, l = S.super_first[s], S.super_first[s + 1]
        counts[f:l] = S.nrows(s) - np.arange(l - f)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int64)
    data = np.empty(indptr[-1])
    for s in range(S.nsuper):
        f, l = S.super_first[s], S.super_first[s + 1]
        P = F.panel(s)
        rr = S.rows[s]
        for k, j in enumerate(range(f, l)):
            lo = indptr[j]
            m = len(rr) - k
            indices[lo:lo + m] = rr[k:]
            data[lo:lo + m] = P[k:, k]
    return CSC(n, n, indptr, indices, data, 0)


def _assemble_front_host(C_low: CSC, S: SupernodalSymbolic, s: int,
                         updates: dict) -> np.ndarray:
    """Frontal matrix of supernode s: A's entries + children's extend-add."""
    rows = S.rows[s]
    f, l = S.super_first[s], S.super_first[s + 1]
    pos = {int(r): i for i, r in enumerate(rows)}
    Fm = np.zeros((len(rows), len(rows)))
    for k, j in enumerate(range(f, l)):
        lo, hi = C_low.indptr[j], C_low.indptr[j + 1]
        for r, v in zip(C_low.indices[lo:hi], C_low.data[lo:hi]):
            Fm[pos[int(r)], k] += v
    for (rows_c, U) in updates.pop(s, []):
        idx = np.searchsorted(rows, rows_c)
        Fm[np.ix_(idx, idx)] += U
    return Fm


def factorize_host(A: CSC, S: SupernodalSymbolic,
                   config: Config = DEFAULT) -> SupernodalFactor:
    """Numpy multifrontal factorization (the small-problem path)."""
    C_low = A.symperm(S.perm).transpose()
    Lx = np.zeros(S.lnz)
    updates: dict = {}
    minor = S.n
    for s in range(S.nsuper):
        nc = S.ncols(s)
        Fm = _assemble_front_host(C_low, S, s, updates)
        F11 = np.tril(Fm[:nc, :nc]) + np.tril(Fm[:nc, :nc], -1).T
        try:
            L11 = np.linalg.cholesky(F11)
        except np.linalg.LinAlgError:
            minor = int(S.super_first[s])
            break
        F21 = Fm[nc:, :nc]
        L21 = np.linalg.solve(L11, F21.T).T if F21.size else F21
        Lx[S.Lpx[s]:S.Lpx[s + 1]] = np.concatenate([L11, L21]).ravel(
            order="F")
        p = S.sparent[s]
        if p != -1 and len(S.rows[s]) > nc:
            updates.setdefault(p, []).append(
                (S.rows[s][nc:], Fm[nc:, nc:] - L21 @ L21.T))
    return SupernodalFactor(S=S, Lx=Lx, minor=minor)


def _should_use_device(S: SupernodalSymbolic, config: Config) -> bool:
    """The device pays off once panels carry real flops; below this the
    numpy multifrontal wins on dispatch overhead (the reference makes the
    same call with its GPU thresholds, cholmod_gpu.h:33-35)."""
    return S.fl >= 5e6


@dataclasses.dataclass
class SupernodalFactorAdapter:
    """A supernodal factor behind the simplicial Factor solve interface."""

    F: SupernodalFactor | TorchSupernodalFactor | TorchPxFactor
    _Lcsc: CSC | None = None

    @property
    def ok(self) -> bool:
        return self.F.ok

    @property
    def minor(self) -> int:
        return self.F.minor

    @property
    def perm(self) -> np.ndarray:
        return self.F.perm

    @property
    def d(self):
        return None

    @property
    def L(self) -> CSC:
        if self._Lcsc is None:
            self._Lcsc = to_csc(self.F)
        return self._Lcsc


def supernodal_symbolic(A: CSC, S_or_simpl,
                        config: Config = DEFAULT) -> SupernodalSymbolic:
    """The supernodal analysis for ``S_or_simpl`` (run once, then cached on
    the simplicial analysis, as the reference does)."""
    if isinstance(S_or_simpl, SupernodalSymbolic):
        return S_or_simpl
    S = getattr(S_or_simpl, "_super", None)
    if S is None:
        S = analyze_supernodal(A, S_or_simpl.perm, config)
        S_or_simpl._super = S
    return S


def factorize(A: CSC, S_or_simpl, config: Config = DEFAULT,
              device="cuda") -> SupernodalFactorAdapter:
    if np.iscomplexobj(A.data):
        raise ValueError(
            "the supernodal factor is real-only: complex Hermitian input "
            "takes cholsol (the 2x2 real embedding on the device, the host "
            "LL^H below its size) or factorize (the host LL^H)")
    dev = resolve_device(device)
    with span("factor.symbolic"):
        S = supernodal_symbolic(A, S_or_simpl, config)
    if _should_use_device(S, config):
        F = supernodal_device.factorize_device(A, S, config, dev)
    else:
        F = factorize_host(A, S, config)
    return SupernodalFactorAdapter(F)


def factor_from_arrays(A: CSC, S: SupernodalSymbolic, Lx: np.ndarray,
                       minor: int, device="cuda",
                       tile_rmin: int = supernodal_device.TILE_RMIN
                       ) -> TorchSupernodalFactor:
    """A device factor of ``A`` from the padded-layout values ``Lx`` of the
    port's plan for the analysis ``S`` (``dev_size`` entries), e.g. a factor
    computed elsewhere and carried across as a numpy array."""
    dp = supernodal_device.device_plan(A, S, resolve_device(device),
                                       tile_rmin)
    Lx = np.asarray(Lx)
    if Lx.shape != (dp.plan.dev_size,):
        raise ValueError(f"factor_from_arrays: Lx has shape {Lx.shape}, the "
                         f"plan's layout holds {dp.plan.dev_size} entries")
    return TorchSupernodalFactor(S=S, Lx=torch.tensor(Lx, device=dp.device),
                                 minor=int(minor), dplan=dp)
