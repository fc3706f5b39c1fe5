"""suitesparse_tpu_torch — sparse Cholesky and QR on PyTorch and CUDA.

A port of :mod:`suitesparse_tpu` to PyTorch for NVIDIA Hopper cards, and a
package of its own: it imports neither JAX nor the JAX package. The host
side (orderings, symbolic analysis, plan building, small problems) is the
port's own copy of the reference's numpy and C++ code (``native/``, built by
``g++`` at first use); the device side (the multifrontal factor and the
multifrontal solve, w2 or classic sweep) runs on torch tensors, with the
TPU kernels of that path rewritten in CUDA C++ (``kernels/csrc``). The
least-squares ``qrsol`` runs the multifrontal QR (COLAMD, the front tree of
A'A, batched Householder fronts with Q'b, the backward sweep) on the device
past a size, the host Householder QR below it. The general square solve:
``lusol`` is the KLU-class host LU; ``numeric.multifrontal_lu.mflusol``
sends strongly unsymmetric patterns to the matched-front multifrontal LU on
the device (weighted matching, batched partial-pivot LU of the fronts with
the right-hand side riding along, the backward sweep, a QR repair and the
host LU as its last rungs). Complex input runs through each of these:
the host complex kernels below a size (LL^H, KLU, Householder QR), the
card's real pipelines on the 2x2 real embedding above it
(:mod:`.numeric.complex_embed`). Matrices come in from Matrix Market and
Rutherford-Boeing files (:mod:`.io`); factors and analyses go to disk and
back (:mod:`.serialize`: a supernodal factor is saved in the CHOLMOD px
layout and loads onto the card, where ``solve`` runs the px sweep);
:mod:`.report` gives the ``Info`` accounting and the ``report_*`` texts,
:mod:`.check` validates objects, :mod:`.diagnostics` estimates condition.

    >>> import suitesparse_tpu_torch as sstt
    >>> A = sstt.fixtures.laplacian_3d(20)
    >>> x = sstt.cholsol(A, b)                      # on the CUDA card
    >>> x = sstt.cholsol(A, b, device="cpu")        # plain versions, CPU
    >>> S = sstt.analyze(A)
    >>> F = sstt.factorize(A, S, device="cuda")
    >>> x = sstt.solve(F, b)
    >>> x = sstt.solve(F, b, sstt.DEFAULT.replace(solve_mode="classic"))
    >>> x = sstt.solve_refined(F, A, b)             # fp64-class residual
    >>> G = sstt.fixtures.grid_gradient_3d(32)      # 95,559 x 32,768
    >>> y = sstt.qrsol(G, np.ones(G.nrow))          # min ||Gy - 1||
    >>> from suitesparse_tpu_torch.numeric.multifrontal_lu import mflusol
    >>> x = mflusol(M, b)                           # general square M
    >>> x = sstt.lusol(M, b)                        # host KLU-class LU
    >>> x = sstt.cholsol(H, z)                      # complex Hermitian H
    >>> A = sstt.io.read_matrix_market("A.mtx")     # or io.read_rb
    >>> info = sstt.report.info_from_factor(F, A)    # UMFPACK-style Info
    >>> sstt.serialize.save_factor("F.npz", F)
    >>> F = sstt.serialize.load_factor("F.npz", device="cuda")
    >>> x = sstt.solve(F, b)                        # the px sweep on the card

The device is CUDA unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises ``RuntimeError``.
"""

from __future__ import annotations

import numpy as np

from . import (check, diagnostics, io, native, ordering, report, serialize,
               symbolic)
from .config import DEFAULT, Config, FactorKind, Ordering
from .device import resolve_device
from .io import fixtures
from .numeric import (complex_embed, lu, qr, simplicial, supernodal,
                      supernodal_solve)
from .numeric.simplicial import Factor, SymbolicChol, chol_solve
from .numeric.supernodal import (SupernodalFactorAdapter, TorchPxFactor,
                                 TorchSupernodalFactor)
from .sparse import CSC, eye, from_dense, from_triplets, residual_norm
from .stats import GLOBAL_STATS, span, timed

__all__ = [
    "CSC", "Config", "DEFAULT", "Factor", "FactorKind", "Ordering",
    "SymbolicChol", "check", "diagnostics", "fixtures", "io", "native",
    "ordering", "report", "serialize", "symbolic", "eye", "from_dense",
    "from_triplets", "residual_norm", "resolve_device", "analyze",
    "factorize", "solve", "solve_refined", "cholsol", "lusol", "qrsol",
]


def _fill_reducing_perm(A: CSC, config: Config) -> np.ndarray:
    if config.ordering is Ordering.NATURAL:
        return np.arange(A.ncol, dtype=np.int64)
    if config.ordering is Ordering.AMD:
        return ordering.amd_order(A, config)
    if config.ordering is Ordering.COLAMD:
        return ordering.colamd_order(A, config)
    if config.ordering in (Ordering.METIS, Ordering.NESDIS):
        return ordering.nested_dissection_order(A, config)
    if config.ordering is Ordering.BEST:
        # AMD and ND, keep the lower nnz(L) (cholmod_analyze.c:451-486)
        best_perm, best_lnz = None, None
        for method in (Ordering.AMD, Ordering.NESDIS):
            p = _fill_reducing_perm(A, config.replace(ordering=method))
            lnz = simplicial.symbolic_cholesky(A, p).lnz
            if best_lnz is None or lnz < best_lnz:
                best_perm, best_lnz = p, lnz
        return best_perm
    raise ValueError(f"unsupported ordering {config.ordering}")


def analyze(A: CSC, config: Config = DEFAULT,
            perm: np.ndarray | None = None) -> SymbolicChol:
    """Symbolic Cholesky analysis: ordering + etree + counts
    (cholmod_analyze). ``perm`` skips the ordering."""
    if config.check_inputs and A.sym != 1:
        raise ValueError("analyze expects upper-stored symmetric (sym=1)")
    with timed("analyze"):
        if perm is None:
            with span("analyze.order"):
                perm = _fill_reducing_perm(A, config)
        with span("analyze.symbolic"):
            S = simplicial.symbolic_cholesky(A, perm)
    if config.record_stats:
        GLOBAL_STATS.record("lnz", S.lnz)
        GLOBAL_STATS.record("fl", S.fl)
        GLOBAL_STATS.record("anz", A.nnz)
    return S


def factorize(A: CSC, S: SymbolicChol, config: Config = DEFAULT,
              device="cuda"):
    """Numeric Cholesky factorization on ``device`` (cholmod_factorize).

    The reference's choice of factor kind: supernodal iff
    flops / nnz(L) >= ``config.supernodal_switch``. A supernodal factor with
    ``S.fl >= 5e6`` runs on the device; the rest on the host. Complex
    Hermitian input takes the host LL^H (the reference's rule: LDL' and the
    supernodal kernels are real-only; :func:`cholsol` sends big complex
    problems to the device through the embedding)."""
    dev = resolve_device(device)
    kind = config.factor_kind
    if kind is FactorKind.AUTO:
        kind = (FactorKind.SUPERNODAL_LL
                if S.fl / max(S.lnz, 1) >= config.supernodal_switch
                else FactorKind.SIMPLICIAL_LDL)
        if np.iscomplexobj(A.data) and kind is FactorKind.SIMPLICIAL_LDL:
            kind = FactorKind.SIMPLICIAL_LL
    if np.iscomplexobj(A.data) and kind is FactorKind.SUPERNODAL_LL:
        kind = FactorKind.SIMPLICIAL_LL
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
    A x = b on its device: the factor of ``factorize`` through the sweep
    ``config.solve_mode`` picks, a px-layout factor (``load_factor``'s)
    through the px sweep. Other factors and systems use the host
    solvers."""
    dev_F = F.F if isinstance(F, SupernodalFactorAdapter) else F
    with timed("solve"):
        if isinstance(dev_F, (TorchSupernodalFactor, TorchPxFactor)) \
                and sys == "A":
            return supernodal_solve.solve_device(dev_F, b, config)
        if sys == "A":
            return chol_solve(F, b)
        return simplicial.solve_system(F, b, sys)


def solve_refined(F, A: CSC, b: np.ndarray, iters: int = 2,
                  config: Config = DEFAULT) -> np.ndarray:
    """x = A \\ b with ``iters`` steps of host-fp64 iterative refinement
    (the UMFPACK IRSTEP pattern, ``umfpack_solve.c:102``, applied to
    Cholesky): fp64-class residuals from an fp32 factor."""
    b = np.asarray(b)
    b = b.astype(np.complex128 if np.iscomplexobj(b) else np.float64)
    x = solve(F, b, config)
    for _ in range(max(iters, 0)):
        x = x + solve(F, b - A.matvec(x), config)
    return x


def cholsol(A: CSC, b: np.ndarray, config: Config = DEFAULT,
            device="cuda") -> np.ndarray:
    """One-call SPD solve (cs_cholsol): analyze, factorize, solve.

    Complex Hermitian A with ``S.fl >= CPLX_DEVICE_FL`` runs on ``device``
    through the 2x2 real embedding (the supernodal factor and solve of the
    embedded SPD matrix, :mod:`.numeric.complex_embed`); smaller ones take
    the host LL^H."""
    S = analyze(A, config)
    if np.iscomplexobj(A.data) and S.fl >= complex_embed.CPLX_DEVICE_FL:
        return complex_embed.cholsol_complex_device(A, b, config,
                                                    perm=S.perm,
                                                    device=device)
    F = factorize(A, S, config, device)
    return solve(F, b, config)


def lusol(A: CSC, b: np.ndarray, config: Config = DEFAULT) -> np.ndarray:
    """One-call general square solve via BTF + left-looking LU (cs_lusol /
    klu analog, :func:`.numeric.lu.lusol`). Nothing on this path runs on a
    device, as in the reference (KLU uses no BLAS); the card's
    unsymmetric LU is :func:`.numeric.multifrontal_lu.mflusol`."""
    with timed("lusol"):
        return lu.lusol(A, b, config)


def qrsol(A: CSC, b: np.ndarray, config: Config = DEFAULT,
          device="cuda") -> np.ndarray:
    """Least squares min ||Ax - b|| (m >= n) or the minimum-norm solution
    (m < n), cs_qrsol / SuiteSparseQR analog: the multifrontal QR on
    ``device`` for least-squares problems with m * n >= 65,536, the host
    Householder QR otherwise (:func:`.numeric.qr.qrsol`)."""
    with timed("qrsol"):
        return qr.qrsol(A, b, config, device)
