"""The port's Matrix Market and Rutherford-Boeing I/O against the JAX
package's, on the same files.

Matrices come from the seeded generators of ``io/fixtures.py`` (each
package's own copy, which give the same matrix) and from short hand-written
files for the headers the writers do not emit (pattern, integer, complex,
Hermitian, skew-symmetric, array). Each file is read by both packages'
readers, and the two CSC results must have identical arrays (indptr,
indices, data, shape, sym); a written file must also read back to the
matrix it came from, exactly (values are written with 17 significant
digits). Mirrors ``tests/test_diagnostics_io.py:83-110`` and
``tests/test_dmperm_rb.py:47-74``."""

import gzip
import io

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.io import matrix_market as ref_mm
from suitesparse_tpu.io import rutherford_boeing as ref_rb
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.io import matrix_market, rutherford_boeing


def _same(A, B) -> None:
    """A (port) and B (reference) are the same CSC, array for array."""
    assert (A.nrow, A.ncol, A.sym) == (B.nrow, B.ncol, B.sym)
    for a, b in ((A.indptr, B.indptr), (A.indices, B.indices),
                 (A.data, B.data)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


MATRICES = {
    "general": lambda pkg: pkg.io.fixtures.random_sparse(
        20, 15, density=0.2, seed=3, ensure_full_diag=False),
    "symmetric": lambda pkg: pkg.io.fixtures.laplacian_2d(6),
    "fem_spd": lambda pkg: pkg.io.fixtures.fem_mesh_spd(200, seed=4),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_matrix_market_round_trip_matches_the_reference(tmp_path, name,
                                                        suffix):
    A = MATRICES[name](sstt)
    Aj = MATRICES[name](sst)
    p, pj = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    matrix_market.write_matrix_market(p, A, comment="seeded\nfixture")
    ref_mm.write_matrix_market(pj, Aj)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(p, "rt") as f, opener(pj, "rt") as fj:
        body, bodyj = f.read().splitlines(), fj.read().splitlines()
    assert body[0] == bodyj[0] and body[3:] == bodyj[1:]
    B = matrix_market.read_matrix_market(p)
    _same(B, ref_mm.read_matrix_market(p))
    _same(matrix_market.read_matrix_market(pj), ref_mm.read_matrix_market(pj))
    _same(B, A)
    assert B.sym == (1 if name != "general" else 0)


MM_TEXTS = {
    "pattern_general": """%%MatrixMarket matrix coordinate pattern general
3 4 3
1 1
2 2
3 4
""",
    "integer_symmetric": """%%MatrixMarket matrix coordinate integer symmetric
% lower triangle stored
3 3 4
1 1 4
2 1 -1
3 2 -2
3 3 5
""",
    "complex_hermitian": """%%MatrixMarket matrix coordinate complex hermitian
3 3 4
1 1 4.0 0.0
2 1 -1.0 0.5
3 3 2.0 0.0
3 2 0.25 -1.5
""",
    "real_skew": """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 1.5
3 1 -2.0
""",
    "array_general": """%%MatrixMarket matrix array real general
2 3
1.0
2.0
0.0
4.0
5.0
6.0
""",
    "array_symmetric": """%%MatrixMarket matrix array real symmetric
3 3
1.0
2.0
3.0
4.0
5.0
6.0
""",
}


@pytest.mark.parametrize("name", sorted(MM_TEXTS))
def test_matrix_market_headers_read_as_the_reference_reads_them(name):
    text = MM_TEXTS[name]
    A = matrix_market.read_matrix_market(io.StringIO(text))
    _same(A, ref_mm.read_matrix_market(io.StringIO(text)))
    if name == "pattern_general":
        assert A.shape == (3, 4) and A.nnz == 3 and A.to_dense()[2, 3] == 1
    if name == "complex_hermitian":
        D = A.to_dense()
        assert np.array_equal(D, D.conj().T) and D[1, 0] == -1 + 0.5j


def test_matrix_market_rejects_what_it_does_not_read():
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        matrix_market.read_matrix_market(io.StringIO("3 3 1\n1 1 1\n"))
    with pytest.raises(ValueError, match="unsupported object"):
        matrix_market.read_matrix_market(
            io.StringIO("%%MatrixMarket vector coordinate real general\n"))


RB_MATRICES = {
    "general": lambda pkg: pkg.io.fixtures.random_sparse(
        15, 11, density=0.3, seed=1, ensure_full_diag=False),
    "symmetric": lambda pkg: pkg.io.fixtures.laplacian_2d(7),
}


@pytest.mark.parametrize("name", sorted(RB_MATRICES))
def test_rutherford_boeing_round_trip_matches_the_reference(tmp_path, name):
    A, Aj = RB_MATRICES[name](sstt), RB_MATRICES[name](sst)
    p, pj = tmp_path / "port.rb", tmp_path / "ref.rb"
    rutherford_boeing.write_rb(p, A)
    ref_rb.write_rb(pj, Aj)
    assert p.read_text() == pj.read_text()
    B = rutherford_boeing.read_rb(p)
    _same(B, ref_rb.read_rb(p))
    assert B.sym == (1 if name == "symmetric" else 0)
    assert np.allclose(B.to_dense(), A.to_dense(), rtol=1e-15, atol=0)


RB_TEXTS = {
    "pattern": (f"{'t':<72}{'k':<8}\n"
                f"{2:14d}{1:14d}{1:14d}{0:14d}\n"
                f"pua           {3:14d}{3:14d}{3:14d}{0:14d}\n"
                "(8I10) (8I10) (4E24.16)\n"
                "         1         2         3         4\n"
                "         1         2         3\n"),
    # packed fixed-width pointers (5-digit fields touching) and D exponents
    "packed_real_symmetric": (f"{'t':<72}{'k':<8}\n"
                              f"{4:14d}{1:14d}{1:14d}{2:14d}\n"
                              f"rsa           {3:14d}{3:14d}{4:14d}"
                              f"{0:14d}\n"
                              "(16I5) (16I5) (3D22.14)\n"
                              "    1    3    4    5\n"
                              "    1    2    2    3\n"
                              "  4.00000000000000D+00 -1.00000000000000D+00"
                              "  2.50000000000000D+00\n"
                              "  3.00000000000000D+00\n"),
    "complex_hermitian": (f"{'t':<72}{'k':<8}\n"
                          f"{4:14d}{1:14d}{1:14d}{2:14d}\n"
                          f"cha           {2:14d}{2:14d}{3:14d}{0:14d}\n"
                          "(8I10) (8I10) (4E24.16)\n"
                          "         1         3         4\n"
                          "         1         2         2\n"
                          "  4.0000000000000000E+00  0.0000000000000000E+00"
                          "  1.0000000000000000E+00  2.0000000000000000E+00\n"
                          "  3.0000000000000000E+00  0.0000000000000000E+00"
                          "\n"),
}


@pytest.mark.parametrize("name", sorted(RB_TEXTS))
def test_rutherford_boeing_files_read_as_the_reference_reads_them(name):
    text = RB_TEXTS[name]
    A = rutherford_boeing.read_rb(io.StringIO(text))
    _same(A, ref_rb.read_rb(io.StringIO(text)))
    if name == "pattern":
        assert np.array_equal(A.to_dense(), np.eye(3))
    if name == "complex_hermitian":
        assert A.sym == 1 and A.to_dense()[0, 1] == 1 - 2j


def test_io_is_exported_as_the_reference_exports_it():
    for fn in ("read_matrix_market", "write_matrix_market", "read_rb",
               "write_rb"):
        assert getattr(sstt.io, fn) is not None and hasattr(sst.io, fn)
    assert sstt.io.read_matrix_market is matrix_market.read_matrix_market
    assert sstt.io.read_rb is rutherford_boeing.read_rb
