"""suitesparse_tpu_torch — the supernodal Cholesky path on PyTorch and CUDA.

A port of :mod:`suitesparse_tpu` to PyTorch for NVIDIA Hopper cards. The
host side (orderings, symbolic analysis, plan building, small problems) is
the reference package's own numpy code, imported; the device side (the
multifrontal factor and the w2 solve) runs on torch tensors, with the two
TPU kernels of that path rewritten in CUDA C++ (``kernels/csrc``).

    >>> import suitesparse_tpu_torch as sstt
    >>> A = sstt.fixtures.laplacian_3d(20)
    >>> x = sstt.cholsol(A, b)                      # on the CUDA card
    >>> x = sstt.cholsol(A, b, device="cpu")        # plain versions, CPU
    >>> S = sstt.analyze(A)
    >>> F = sstt.factorize(A, S, device="cuda")
    >>> x = sstt.solve(F, b)

The device is CUDA unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises ``RuntimeError``.
"""

from __future__ import annotations

import numpy as np

from suitesparse_tpu import analyze
from suitesparse_tpu.config import DEFAULT, Config, FactorKind, Ordering
from suitesparse_tpu.io import fixtures
from suitesparse_tpu.numeric import simplicial
from suitesparse_tpu.numeric.simplicial import SymbolicChol, chol_solve
from suitesparse_tpu.numeric.supernodal import SupernodalFactorAdapter
from suitesparse_tpu.sparse import CSC, residual_norm
from suitesparse_tpu.stats import timed

from .device import resolve_device
from .numeric import supernodal, supernodal_solve
from .numeric.supernodal import TorchSupernodalFactor

__all__ = [
    "CSC", "Config", "DEFAULT", "FactorKind", "Ordering", "fixtures",
    "residual_norm", "resolve_device", "analyze", "factorize", "solve",
    "cholsol", "lusol", "qrsol",
]


def factorize(A: CSC, S: SymbolicChol, config: Config = DEFAULT,
              device="cuda"):
    """Numeric Cholesky factorization on ``device`` (cholmod_factorize).

    The reference's choice of factor kind: supernodal iff
    flops / nnz(L) >= ``config.supernodal_switch``. A supernodal factor with
    ``S.fl >= 5e6`` runs on the device; the rest on the host."""
    if np.iscomplexobj(A.data):
        raise NotImplementedError(
            "complex Hermitian input is not in the port yet (ROADMAP queue 1 "
            "item 6)")
    dev = resolve_device(device)
    kind = config.factor_kind
    if kind is FactorKind.AUTO:
        kind = (FactorKind.SUPERNODAL_LL
                if S.fl / max(S.lnz, 1) >= config.supernodal_switch
                else FactorKind.SIMPLICIAL_LDL)
    with timed("factorize"):
        if kind is FactorKind.SIMPLICIAL_LL:
            F = simplicial.chol_up(A, S)
        elif kind is FactorKind.SIMPLICIAL_LDL:
            F = simplicial.ldl_up(A, S, dbound=config.dbound)
        elif kind is FactorKind.SUPERNODAL_LL:
            F = supernodal.factorize(A, S, config, dev)
        else:
            raise ValueError(f"unsupported factor kind {kind}")
    if not F.ok and config.error_handler is not None:
        config.error_handler(
            f"factorization not positive definite at column {F.minor}")
    return F


def solve(F, b: np.ndarray, config: Config = DEFAULT,
          sys: str = "A") -> np.ndarray:
    """x from a Cholesky factor (cholmod_solve). A device factor solves
    A x = b on its device; other factors and systems use the host solvers."""
    with timed("solve"):
        if (isinstance(F, SupernodalFactorAdapter)
                and isinstance(F.F, TorchSupernodalFactor) and sys == "A"):
            return supernodal_solve.solve_device(F.F, b, config)
        if sys == "A":
            return chol_solve(F, b)
        return simplicial.solve_system(F, b, sys)


def cholsol(A: CSC, b: np.ndarray, config: Config = DEFAULT,
            device="cuda") -> np.ndarray:
    """One-call SPD solve (cs_cholsol): analyze, factorize, solve."""
    S = analyze(A, config)
    F = factorize(A, S, config, device)
    return solve(F, b, config)


def lusol(A: CSC, b: np.ndarray, config: Config = DEFAULT, device="cuda"):
    raise NotImplementedError(
        "lusol is not in the port yet (ROADMAP queue 1 items 8-9)")


def qrsol(A: CSC, b: np.ndarray, config: Config = DEFAULT, device="cuda"):
    raise NotImplementedError(
        "qrsol is not in the port yet (ROADMAP queue 1 item 7)")
