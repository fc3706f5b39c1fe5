"""The port's CSC matrix operations, ``Stats`` and ``panel`` against the
JAX package's.

Each CSC method runs on the same seeded matrices in both packages (numpy
``default_rng``, with explicit zeros and entries below 0.1 in the pattern):
a rectangular 7 x 5 and a square 6 x 6 in general storage, and a symmetric
6 x 6 stored upper. Where a method makes a matrix, its ``indptr``,
``indices`` and ``data`` must equal the reference's exactly; the norms
must agree to 1e-15 relative. ``Stats.gflops``, ``report`` and ``clear``
are held to the reference's on the same timings and values, and a factor's
``panel(s)`` to the reference's on ``laplacian_3d(6)``: the host factor,
a device factor in fp64 and the px-layout factor of the same values.
"""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu import sparse as ref_sparse
from suitesparse_tpu import stats as ref_stats
from suitesparse_tpu.numeric import supernodal as ref_supernodal
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import sparse as port_sparse
from suitesparse_tpu_torch import stats as port_stats
from suitesparse_tpu_torch.numeric import supernodal, supernodal_device
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal
from test_torch_host import _reference_native

NORM_TOL = 1e-15


def _triplets(m, n, seed, sym=False):
    """Seeded (rows, cols, vals) with duplicates, zeros and small values."""
    rng = np.random.default_rng(seed)
    k = 3 * max(m, n)
    r = rng.integers(0, m, k)
    c = rng.integers(0, n, k)
    if sym:
        r, c = np.minimum(r, c), np.maximum(r, c)
        r, c = np.concatenate([r, np.arange(n)]), np.concatenate(
            [c, np.arange(n)])
    v = rng.standard_normal(r.size)
    v[::7] = 0.0
    v[3::11] *= 0.05
    return r, c, v


MATRICES = {"rect": (7, 5, 1, False), "square": (6, 6, 2, False),
            "sym_upper": (6, 6, 3, True)}


def _pair(kind):
    """The same matrix in the reference and in the port."""
    m, n, seed, sym = MATRICES[kind]
    r, c, v = _triplets(m, n, seed, sym)
    return (ref_sparse.from_triplets(m, n, r, c, v, sym=int(sym)),
            port_sparse.from_triplets(m, n, r, c, v, sym=int(sym)))


def _same(a, b):
    """Both outputs equal: CSC field by field, arrays and tuples entrywise,
    norms to NORM_TOL."""
    if isinstance(b, port_sparse.CSC):
        assert (a.nrow, a.ncol, a.sym) == (b.nrow, b.ncol, b.sym)
        for f in ("indptr", "indices", "data"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    elif isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    elif isinstance(b, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert isinstance(b, float)
        assert abs(a - b) <= NORM_TOL * abs(a), (a, b)


GENERAL = ("rect", "square")
ALL = ("rect", "square", "sym_upper")
rng_p = np.random.default_rng(11)
P7, P6, Q5, Q6 = (rng_p.permutation(k) for k in (7, 6, 5, 6))


def _perm(A):
    return {7: P7, 6: P6, 5: Q5}[A.nrow], {5: Q5, 6: Q6}[A.ncol]


# method -> (matrices it takes, call on a matrix of either package, with
# the other matrix of the same kind and package for the two-matrix ops)
CASES = {
    "copy": (ALL, lambda A, O: A.copy()),
    "col_lengths": (ALL, lambda A, O: A.col_lengths()),
    "permuted": (GENERAL, lambda A, O: A.permuted(*_perm(A))),
    "permuted_rows": (GENERAL, lambda A, O: A.permuted(_perm(A)[0], None)),
    "permuted_map": (GENERAL, lambda A, O: A.permuted_map(*_perm(A))),
    "drop_zeros": (ALL, lambda A, O: A.drop_zeros(0.1)),
    "band": (ALL, lambda A, O: A.band(-1, 2)),
    "tril": (ALL, lambda A, O: A.tril(-1)),
    "triu": (ALL, lambda A, O: A.triu(1)),
    "add": (ALL, lambda A, O: A.add(O, 2.0, -0.5)),
    "matmat": (ALL, lambda A, O: A.matmat(O.transpose()
                                          if O.sym == 0 else O)),
    "norm_inf": (ALL, lambda A, O: A.norm_inf()),
    "norm_fro": (ALL, lambda A, O: A.norm_fro()),
    "scale": (ALL, lambda A, O: A.scale(
        1.0 + np.arange(A.nrow), None if A.sym else 2.0 - np.arange(A.ncol))),
    "submatrix": (ALL, lambda A, O: A.submatrix(
        np.array([3, 0, 3, A.nrow - 1]), np.array([A.ncol - 1, 1, 1]))),
    "ata_pattern": (GENERAL, lambda A, O: A.ata_pattern()),
    "to_csr_arrays": (ALL, lambda A, O: A.to_csr_arrays()),
}


@pytest.mark.parametrize("method", list(CASES))
def test_csc_method_matches_reference(method):
    _reference_native()
    kinds, call = CASES[method]
    for kind in kinds:
        ra, pa = _pair(kind)
        m, n, seed, sym = MATRICES[kind]
        r, c, v = _triplets(m, n, seed + 10, sym)
        ro = ref_sparse.from_triplets(m, n, r, c, v, sym=int(sym))
        po = port_sparse.from_triplets(m, n, r, c, v, sym=int(sym))
        _same(call(ra, ro), call(pa, po))


def test_stats_and_panel_match_reference():
    rs, ps = ref_stats.Stats(), port_stats.Stats()
    for s in (rs, ps):
        s.add_time("factorize", 0.25)
        s.add_time("factorize", 0.5)
        s.add_time("analyze", 0.125)
        s.record("lnz", 1234)
        s.record("backend", "cuda")
    assert ps.report() == rs.report()
    assert ps.gflops("factorize", 3e9) == rs.gflops("factorize", 3e9) == 4.0
    assert ps.gflops("solve", 1e9) == rs.gflops("solve", 1e9) == 0.0
    for s in (rs, ps):
        s.clear()
    assert ps.report() == rs.report() and not ps.times and not ps.values

    A = sst.io.fixtures.laplacian_3d(6)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fr = ref_supernodal.factorize_host(A, S)
    At = sstt.fixtures.laplacian_3d(6)
    St = port_analyze_supernodal(At, S.perm)
    Fh = supernodal.factorize_host(At, St)
    Fd = supernodal_device.factorize_device(
        At, St, sstt.DEFAULT.replace(compute_dtype="float64"), "cpu")
    Fp = supernodal.TorchPxFactor(S=St, Lx=torch.tensor(Fr.lx_host()),
                                  minor=Fr.minor)
    assert Fr.ok and Fh.ok and Fd.ok and St.nsuper == S.nsuper
    for s in range(S.nsuper):
        ref = Fr.panel(s)
        scale = np.abs(ref).max()
        assert np.array_equal(Fp.panel(s), ref)
        for F in (Fh, Fd):
            got = F.panel(s)
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 1e-12 * scale
