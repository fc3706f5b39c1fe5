"""The last host functions of the JAX package copied into the port, each
against the reference on the CPU: the host multifrontal QR
(``MFQRFactor``, ``factorize_qr_host``, ``qr_mf_solve``, ``mfqrsol``),
``extract_lu`` / ``sort_lu``, the fixtures' file readers and generators
(``REFERENCE_ROOT``, ``have_reference``, ``load_triplet_file``,
``load_demo``, ``pattern_amplifier``, ``banded_spd``, ``arrow_spd``) and
the ``Supernode`` alias. No test reads a demo matrix of a reference tree:
``load_demo`` reads a tree made here."""

import importlib

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.io import fixtures as ref_fixtures
from suitesparse_tpu.numeric import lu as ref_lu
from suitesparse_tpu.numeric import multifrontal_qr as ref_mfqr
from suitesparse_tpu.symbolic import supernodes as ref_supernodes
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.io import fixtures
from suitesparse_tpu_torch.numeric import lu
from suitesparse_tpu_torch.numeric import multifrontal_qr as mfqr
from suitesparse_tpu_torch.symbolic import supernodes

from test_torch_host import _reference_native


def _same_csc(a, b) -> None:
    assert (a.nrow, a.ncol, a.sym) == (b.nrow, b.ncol, b.sym)
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _ref(A):
    """The reference's CSC of the port's A (the same triplets)."""
    return sst.sparse.CSC(A.nrow, A.ncol, A.indptr.copy(), A.indices.copy(),
                          A.data.copy(), A.sym)


# ---------------------------------------------------------------------------
# the host multifrontal QR
# ---------------------------------------------------------------------------

def _ls(seed):
    """A tall random least-squares matrix from both generators (equal)."""
    A = fixtures.random_sparse(240, 90, density=0.04, seed=seed,
                               ensure_full_diag=False)
    Aj = ref_fixtures.random_sparse(240, 90, density=0.04, seed=seed,
                                    ensure_full_diag=False)
    _same_csc(A, Aj)
    return A, Aj


@pytest.mark.parametrize("seed", [0, 3])
def test_mfqrsol_matches_the_reference(seed):
    _reference_native()
    A, Aj = _ls(seed)
    b = np.random.default_rng(seed).standard_normal(A.nrow)
    x = mfqr.mfqrsol(A, b)
    x_ref = ref_mfqr.mfqrsol(Aj, b)
    assert x.shape == x_ref.shape == (A.ncol,)
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    # least squares: the normal equations hold
    r = b - A.to_dense() @ x
    assert np.abs(A.to_dense().T @ r).max() <= 1e-9 * np.abs(b).max()


def test_factorize_qr_host_panels_equal_the_reference():
    """The same front tree (one column order for both): every R panel and
    Q'B panel bit-equal, the rank and x at nrhs 3 equal."""
    A, Aj = _ls(1)
    q = sstt.ordering.colamd_order(A)
    SQ = mfqr.analyze_mfqr(A, q=q)
    SQj = ref_mfqr.analyze_mfqr(Aj, q=q)
    assert np.array_equal(SQ.q, SQj.q)
    B = np.random.default_rng(2).standard_normal((A.nrow, 3))
    F = mfqr.factorize_qr_host(A, SQ, B)
    Fj = ref_mfqr.factorize_qr_host(Aj, SQj, B)
    assert isinstance(F, mfqr.MFQRFactor) and F.rank_est == Fj.rank_est
    for mine, theirs in ((F.Rpanels, Fj.Rpanels), (F.Ypanels, Fj.Ypanels)):
        assert len(mine) == len(theirs)
        for p, pj in zip(mine, theirs):
            assert np.array_equal(p, pj)
    assert np.array_equal(mfqr.qr_mf_solve(F), ref_mfqr.qr_mf_solve(Fj))


# ---------------------------------------------------------------------------
# extract_lu and sort_lu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx", [4, 6])
def test_extract_lu_identity_matches_the_reference(nx):
    _reference_native()
    A = fixtures.fem_unsym(nx)
    Aj = _ref(A)
    N = lu.factor_lu(A, lu.analyze_lu(A))
    Nj = ref_lu.factor_lu(Aj, ref_lu.analyze_lu(Aj))
    assert N.ok and Nj.ok
    assert lu.sort_lu(N) is N
    ref_lu.sort_lu(Nj)
    L, U, Off, P, Q, Rs = lu.extract_lu(N)
    Lj, Uj, Offj, Pj, Qj, Rsj = ref_lu.extract_lu(Nj)
    for mine, theirs in ((L, Lj), (U, Uj), (Off, Offj)):
        _same_csc(mine, theirs)
    for mine, theirs in ((P, Pj), (Q, Qj), (Rs, Rsj)):
        assert np.array_equal(mine, theirs)
    # diag(1/Rs[P]) A[P, Q] = L U + F_off
    Ad = A.to_dense()
    lhs = (Ad[np.ix_(P, Q)].T / Rs[P]).T
    rhs = L.to_dense() @ U.to_dense() + Off.to_dense()
    assert np.abs(lhs - rhs).max() <= 1e-10 * np.abs(lhs).max()
    # sorted factors: strictly ascending rows in every column
    for M in (L, U):
        for j in range(M.ncol):
            assert np.all(np.diff(M.indices[M.indptr[j]:M.indptr[j + 1]]) > 0)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,seed", [(4, 0), (8, 5)])
def test_pattern_amplifier_equals_the_reference(block, seed):
    base = fixtures.laplacian_2d(6)
    A = fixtures.pattern_amplifier(base, block, seed)
    Aj = ref_fixtures.pattern_amplifier(_ref(base), block, seed)
    _same_csc(A, Aj)
    assert A.ncol == base.ncol * block


@pytest.mark.parametrize("n,bw,seed", [(50, 3, 0), (200, 12, 7)])
def test_banded_spd_equals_the_reference(n, bw, seed):
    _same_csc(fixtures.banded_spd(n, bw, seed),
              ref_fixtures.banded_spd(n, bw, seed))


@pytest.mark.parametrize("n,heads", [(40, 1), (90, 3)])
def test_arrow_spd_equals_the_reference(n, heads):
    _same_csc(fixtures.arrow_spd(n, heads), ref_fixtures.arrow_spd(n, heads))


_REAL = "0 0 4.5\n2 0 -1.25\n1 1 3\n2 2 7.5\n0 2 0.5\n\n3 1 2\n"
_CPLX = "0 0 4 0\n1 0 1.5 -2\n1 1 3 0.25\n2 1 -1 1\n2 2 5 0\n"


@pytest.mark.parametrize("text", [_REAL, _CPLX])
@pytest.mark.parametrize("sym", [0, 1])
def test_load_triplet_file_equals_the_reference(tmp_path, text, sym):
    path = tmp_path / "m.txt"
    path.write_text(text)
    _same_csc(fixtures.load_triplet_file(str(path), sym),
              ref_fixtures.load_triplet_file(str(path), sym))


def test_load_demo_and_have_reference(tmp_path, monkeypatch):
    """A tree of three demo files, read by both packages."""
    (tmp_path / "CSparse" / "Matrix").mkdir(parents=True)
    (tmp_path / "CXSparse" / "Matrix").mkdir(parents=True)
    (tmp_path / "CSparse" / "Matrix" / "bcsstk01").write_text(
        "0 0 4\n1 0 -1\n1 1 4\n2 1 -1\n2 2 4\n")
    (tmp_path / "CSparse" / "Matrix" / "t1").write_text(_REAL)
    (tmp_path / "CXSparse" / "Matrix" / "c4").write_text(_CPLX)
    for mod in (fixtures, ref_fixtures):
        monkeypatch.setattr(mod, "REFERENCE_ROOT", str(tmp_path / "none"))
        assert not mod.have_reference()
        monkeypatch.setattr(mod, "REFERENCE_ROOT", str(tmp_path))
        assert mod.have_reference()
    for name in ("bcsstk01", "t1", "c4"):
        _same_csc(fixtures.load_demo(name), ref_fixtures.load_demo(name))
    assert fixtures.load_demo("bcsstk01").sym == 1


def test_reference_root_from_the_environment(tmp_path, monkeypatch):
    """``REFERENCE_ROOT`` is ``$SUITESPARSE_REFERENCE``, as the
    reference's; unset, the port has no tree (the reference's fixed mount
    path is not copied) and ``load_demo`` says so."""
    try:
        monkeypatch.setenv("SUITESPARSE_REFERENCE", str(tmp_path))
        assert importlib.reload(fixtures).REFERENCE_ROOT == str(tmp_path)
        monkeypatch.delenv("SUITESPARSE_REFERENCE")
        assert importlib.reload(fixtures).REFERENCE_ROOT is None
        assert not fixtures.have_reference()
        with pytest.raises(FileNotFoundError):
            fixtures.load_demo("t1")
    finally:
        monkeypatch.undo()
        importlib.reload(fixtures)


def test_supernode_alias():
    assert supernodes.Supernode is supernodes.SupernodalSymbolic
    assert ref_supernodes.Supernode is ref_supernodes.SupernodalSymbolic
    assert "Supernode" in supernodes.__all__
    assert set(ref_fixtures.__all__) <= set(fixtures.__all__) | {
        "REFERENCE_ROOT"}
    assert "REFERENCE_ROOT" in fixtures.__all__
