"""Supernodal Cholesky factor of the port, and the factorize dispatcher.

Port of :mod:`suitesparse_tpu.numeric.supernodal`. Problems with enough
flops (``S.fl >= 5e6``, the reference's rule) factor on the device through
:mod:`.supernodal_device`; smaller ones take the reference's numpy
``factorize_host``. Either result is wrapped in the reference's
``SupernodalFactorAdapter``, so the host solvers and ``to_csc`` read it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from suitesparse_tpu.config import DEFAULT, Config
from suitesparse_tpu.numeric.supernodal import (
    SupernodalFactorAdapter, _should_use_device, factorize_host)
from suitesparse_tpu.sparse import CSC
from suitesparse_tpu.symbolic.supernodes import (
    SupernodalSymbolic, analyze_supernodal)

from ..device import resolve_device
from . import supernodal_device

__all__ = ["TorchSupernodalFactor", "factorize", "from_jax_factor",
           "supernodal_symbolic"]


@dataclasses.dataclass
class TorchSupernodalFactor:
    """Numeric supernodal factor held as a torch tensor in the padded device
    layout of its plan (see :mod:`.supernodal_device`)."""

    S: SupernodalSymbolic
    Lx: torch.Tensor
    minor: int
    dplan: "supernodal_device.DevicePlan"
    _lx_px: np.ndarray | None = None
    _w2: tuple | None = None     # (Lx, dtype, W2 panels) of the solve

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

    def panel(self, s: int) -> np.ndarray:
        S = self.S
        nr, nc = S.nrows(s), S.ncols(s)
        return self.lx_host()[S.Lpx[s]:S.Lpx[s + 1]].reshape(nr, nc,
                                                             order="F")


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
        raise NotImplementedError(
            "complex Hermitian factorization (the 2x2 real embedding) is not "
            "in the port yet (ROADMAP queue 1 item 6)")
    dev = resolve_device(device)
    S = supernodal_symbolic(A, S_or_simpl, config)
    if _should_use_device(S, config):
        F = supernodal_device.factorize_device(A, S, config, dev)
    else:
        F = factorize_host(A, S, config)
    return SupernodalFactorAdapter(F)


def from_jax_factor(F_jax, A: CSC, device="cuda",
                    tile_rmin: int = supernodal_device.TILE_RMIN
                    ) -> TorchSupernodalFactor:
    """Carry a reference device-layout ``SupernodalFactor`` of ``A`` across.

    Its ``Lx`` becomes a tensor on ``device``; the port's plan for the same
    symbolic analysis must have the same groups and size (the tile placement
    does not change the layout)."""
    if F_jax.layout != "device":
        raise ValueError("from_jax_factor: needs a device-layout factor")
    S = F_jax.S
    dp = supernodal_device.device_plan(A, S, resolve_device(device),
                                       tile_rmin)
    ref = S._device_plan

    def shapes(plan):
        return [[(g.R, g.C, g.B, g.panel_base) for g in gl]
                for gl in plan.groups]

    if shapes(dp.plan) != shapes(ref) or dp.plan.dev_size != ref.dev_size:
        raise ValueError("from_jax_factor: the port's plan does not match "
                         "the reference factor's layout")
    Lx = torch.as_tensor(np.array(F_jax.Lx), device=dp.device)
    return TorchSupernodalFactor(S=S, Lx=Lx, minor=F_jax.minor, dplan=dp)
