"""Complex input on the card through the 2x2 real embedding.

The port of the JAX package's ``numeric/complex_embed.py``. The reference
ships every solver in four value types (CHOLMOD's complex and zomplex
instantiations, UMFPACK's zi/zl, SPQR's ``<Complex>``); the device
pipelines of the port stay real, as the reference's do, and a complex
problem runs through the isomorphism

    x + iy  ->  [[x, -y], [y, x]]

with Re_j at 2j and Im_j at 2j+1:

  * Hermitian positive definite A -> a real SPD M of order 2n: the
    supernodal factor and solve on the device (the hand kernels K1, K2 and
    K7 in the factor, K3 and K4 in the classic sweep) take it as it is.
    The ordering is computed on the n-node pattern and expanded so that
    each conjugate pair stays adjacent; the supernodes then hold whole 2x2
    blocks;
  * general square A -> a real 2n x 2n M for the unsymmetric multifrontal
    LU on the device;
  * rectangular A: ||M e(x) - e(b)||_2 = ||A x - b||_2 and e is a bijection,
    so the device QR of M gives the least-squares x (and the minimum-norm
    one, since ||e(x)||_2 = ||x||_2).

The embedding is structural: a zero real or imaginary part stays in M's
pattern, so M's pattern, and every analysis and plan cached for it, depend
on A's pattern alone. Cost: twice the memory and twice the flops of a
three-multiply complex kernel.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..config import DEFAULT, Config
from ..sparse import CSC, from_triplets

__all__ = ["CPLX_DEVICE_FL", "embed_matrix", "embed_vec", "unembed_vec",
           "expand_perm", "cholsol_complex_device", "lusol_complex_device",
           "qrsol_complex_device"]

# ``cholsol`` sends complex Hermitian input with at least this many factor
# flops (of the n-node analysis) to the device embedding, the rest to the
# host LL^H (the reference's threshold, ``suitesparse_tpu/__init__.py``)
CPLX_DEVICE_FL = 2e6


def _embedding(A: CSC) -> tuple[CSC, np.ndarray]:
    """The pattern of A's embedding M and where each entry of M comes
    from: ``M.data = _parts(A)[src]``. It reads A's pattern only."""
    cols = np.repeat(np.arange(A.ncol, dtype=np.int64), np.diff(A.indptr))
    rows = A.indices
    r = np.concatenate([2 * rows, 2 * rows + 1, 2 * rows, 2 * rows + 1])
    c = np.concatenate([2 * cols, 2 * cols + 1, 2 * cols + 1, 2 * cols])
    src = np.arange(r.size, dtype=np.float64)
    if A.sym == 1:
        keep = r <= c
        r, c, src = r[keep], c[keep], src[keep]
    P = from_triplets(2 * A.nrow, 2 * A.ncol, r, c, src, sym=A.sym)
    return P, P.data.astype(np.int64)


def _parts(A: CSC) -> np.ndarray:
    """The values of [[x, -y], [y, x]] for every entry of A, in
    :func:`_embedding`'s source order."""
    x, y = np.real(A.data), np.imag(A.data)
    return np.concatenate([x, x, -y, y]).astype(np.float64)


def embed_matrix(A: CSC) -> CSC:
    """The real embedding of A (real or complex). ``sym=1`` input (upper
    Hermitian) gives an upper-stored symmetric M; general input stays
    general. Zero parts stay in the pattern; only the stored-triangle
    filter is applied."""
    P, src = _embedding(A)
    return CSC(P.nrow, P.ncol, P.indptr, P.indices, _parts(A)[src], P.sym)


def embed_vec(b: np.ndarray) -> np.ndarray:
    """Re and Im interleaved along axis 0 (b is (n,) or (n, k))."""
    b = np.asarray(b)
    out = np.empty((2 * b.shape[0],) + b.shape[1:], dtype=np.float64)
    out[0::2] = np.real(b)
    out[1::2] = np.imag(b)
    return out


def unembed_vec(z: np.ndarray) -> np.ndarray:
    return z[0::2] + 1j * z[1::2]


def expand_perm(p: np.ndarray) -> np.ndarray:
    """An n-permutation as the 2n-permutation that keeps conjugate pairs
    adjacent."""
    p = np.asarray(p, dtype=np.int64)
    q = np.empty(2 * p.size, dtype=np.int64)
    q[0::2] = 2 * p
    q[1::2] = 2 * p + 1
    return q


def _analysis_key(A: CSC, config: Config, perm) -> tuple:
    """Everything the embedded analysis of A reads: A's pattern, the
    ordering and its knobs, the supernode relaxation, and the caller's
    ordering where one is passed (the reference keys on the pattern only,
    so a second call with another ordering reused the first's analysis)."""
    pcrc = None if perm is None else zlib.crc32(
        np.ascontiguousarray(perm, dtype=np.int64))
    return (A.pattern_key(), config.ordering, config.amd_dense,
            config.amd_aggressive, config.nd_small, tuple(config.nrelax),
            tuple(config.zrelax), pcrc)


def embedded_analysis(A: CSC, config: Config = DEFAULT,
                      perm: np.ndarray | None = None):
    """The supernodal analysis of ``embed_matrix(A)`` under the expanded
    fill-reducing order of A (``perm``, or ``config``'s ordering on the
    n-node pattern), cached on A under :func:`_analysis_key` with the
    embedding's pattern and source map."""
    return _embedded(A, config, perm)[0]


def _embedded(A: CSC, config: Config, perm):
    """(analysis, embedding pattern, source map), cached on A."""
    from .. import _fill_reducing_perm
    from ..symbolic.supernodes import analyze_supernodal

    key = _analysis_key(A, config, perm)
    cache = getattr(A, "_embed_chol", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    A._embed_chol = None             # let the old analysis go first
    if perm is None:
        # the orderings read the pattern; |A| + 1 keeps every entry and
        # gives them real values
        perm = _fill_reducing_perm(
            CSC(A.nrow, A.ncol, A.indptr, A.indices, np.abs(A.data) + 1.0,
                A.sym), config)
    P, src = _embedding(A)
    S = analyze_supernodal(P, expand_perm(perm), config)
    A._embed_chol = (key, (S, P, src))
    return A._embed_chol[1]


def cholsol_complex_device(A: CSC, b: np.ndarray, config: Config = DEFAULT,
                           perm: np.ndarray | None = None,
                           device="cuda") -> np.ndarray:
    """x = A \\ b for Hermitian positive definite A (``sym=1``, upper
    stored) by the supernodal factor and solve of the embedded SPD matrix
    on ``device``.

    ``perm``: a fill-reducing order of A's n-node pattern that the caller
    already has (``cholsol`` passes its analysis's). The embedded analysis
    is cached on A (:func:`embedded_analysis`); the values are embedded
    again on every call, so a change of ``A.data`` in place flows through.
    Raises ``ValueError`` when the factor fails (A not positive definite
    in the compute dtype)."""
    from .supernodal_device import factorize_device
    from .supernodal_solve import solve_device

    if A.sym != 1:
        raise ValueError("cholsol_complex_device expects upper-stored "
                         "Hermitian input (sym=1)")
    S, P, src = _embedded(A, config, perm)
    M = CSC(P.nrow, P.ncol, P.indptr, P.indices, _parts(A)[src], 1)
    F = factorize_device(M, S, config, device)
    if not F.ok:
        raise ValueError(f"the embedded factorization failed at column "
                         f"{F.minor} (A is not Hermitian positive definite)")
    return unembed_vec(solve_device(F, embed_vec(b), config))


def lusol_complex_device(A: CSC, b: np.ndarray, config: Config = DEFAULT,
                         device="cuda") -> np.ndarray:
    """x = A \\ b for general square complex A by the unsymmetric
    multifrontal LU of the embedded matrix on ``device`` (its whole
    ladder: refinement, the QR repair, the host LU)."""
    from .mflu_unsym import mflusol_unsym

    M = embed_matrix(A.to_full_storage())
    return unembed_vec(mflusol_unsym(M, embed_vec(b), config, device))


def qrsol_complex_device(A: CSC, b: np.ndarray, config: Config = DEFAULT,
                         device="cuda") -> np.ndarray:
    """Complex least squares min ||Ax - b||_2 (m >= n) by the device
    multifrontal QR of the embedded matrix."""
    from .mfqr_device import mfqrsol_device

    M = embed_matrix(A.to_full_storage())
    return unembed_vec(mfqrsol_device(M, embed_vec(b), config,
                                      device=device))
