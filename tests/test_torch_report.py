"""The port's Info accounting, report_* texts, checks and diagnostics
against the JAX package's.

``Info``'s structural fields (sizes, nnz(L), flops and their split,
supernodes, levels) must equal the reference's on the same analysis, and
the device plan's counts (``factor_cells`` = ``dev_size``, groups, pair
classes, pad ratio) the reference's on the same plan. The working-set
fields are the port's own by design: ``peak_cells`` / ``peak_bytes`` come
from ``_work_bytes`` in the factor's dtype, ``nsegments`` /
``seg_budget_cells`` from how a factor ran. The ``report_*`` texts must
match the reference's where the two Info agree. ``rcond_from_factor``,
``condest``, ``determinant_from_lu`` and ``rgrowth`` must give the
reference's values on the same host factors (the same fp64 arithmetic:
1e-12 relative)."""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu import check as ref_check
from suitesparse_tpu import diagnostics as ref_diag
from suitesparse_tpu import report as ref_report
from suitesparse_tpu.numeric import lu as ref_lu
from suitesparse_tpu.numeric import simplicial as ref_simplicial
from suitesparse_tpu.numeric import supernodal as ref_supernodal
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.ordering import amd_order, nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import check, diagnostics, report, serialize
from suitesparse_tpu_torch.numeric import lu, simplicial, supernodal, \
    supernodal_device
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

REL = 1e-12
STRUCTURAL = ("n_row", "n_col", "nnz_a", "strategy", "ordering", "nnz_l",
              "nnz_u", "flops", "nsuper", "nlevels", "chol_flops",
              "trsm_flops", "syrk_flops", "assembly_cells", "ir_steps")
PLAN_FIELDS = ("factor_cells", "ngroups", "npair_classes", "pad_ratio")


def _supernodal(nx):
    Aj = sst.io.fixtures.laplacian_3d(nx)
    Sj = analyze_supernodal(Aj, nested_dissection_order(Aj, sst.DEFAULT))
    A = sstt.fixtures.laplacian_3d(nx)
    return Aj, Sj, A, port_analyze_supernodal(A, Sj.perm)


def test_info_fields_and_order_match_the_reference():
    names = [f.name for f in report.Info.__dataclass_fields__.values()]
    assert names == list(ref_report.Info.__dataclass_fields__)
    info = report.Info(**{n: i + 1 for i, n in enumerate(names)
                          if n not in ("strategy", "ordering")})
    ref = ref_report.Info(**{n: i + 1 for i, n in enumerate(names)
                             if n not in ("strategy", "ordering")})
    assert np.array_equal(info.as_array(), ref.as_array())


def test_info_of_an_analysis_matches_the_reference():
    Aj, Sj, A, S = _supernodal(8)
    info, ref = report.info_from_symbolic(S, A), \
        ref_report.info_from_symbolic(Sj, Aj)
    for f in STRUCTURAL:
        assert getattr(info, f) == getattr(ref, f), f
    assert info.factor_cells == ref.factor_cells == 0
    assert report.report_symbolic(S) == ref_report.report_symbolic(Sj)
    assert report.report_info(info) == ref_report.report_info(ref)
    for prl in (1, 2, 3):
        assert report.report_info(info, prl) == \
            ref_report.report_info(ref, prl)
    Ssim = simplicial.symbolic_cholesky(A, Sj.perm)
    Ssim_j = ref_simplicial.symbolic_cholesky(Aj, Sj.perm)
    i2, r2 = report.info_from_symbolic(Ssim), \
        ref_report.info_from_symbolic(Ssim_j)
    assert [getattr(i2, f) for f in STRUCTURAL] == \
        [getattr(r2, f) for f in STRUCTURAL]


def test_device_fields_read_the_ports_plan():
    """The counts equal the reference's plan; the working set is the
    port's ``_work_bytes`` in the factor's dtype."""
    Aj, Sj, A, S = _supernodal(11)
    Sj._device_plan = ref_device.build_plan(
        Sj, Aj.symperm(Sj.perm).transpose())
    ref = ref_report.info_from_symbolic(Sj, Aj)
    for dt in (torch.float32, torch.float64):
        F = supernodal_device.factorize_device(
            A, S, sstt.DEFAULT.replace(
                compute_dtype=str(dt).split(".")[1]), "cpu")
        info = report.info_from_factor(supernodal.SupernodalFactorAdapter(F),
                                       A)
        for f in STRUCTURAL + PLAN_FIELDS:
            assert getattr(info, f) == getattr(ref, f), f
        work = max(supernodal_device._work_bytes(g, dt)
                   for gl in F.dplan.plan.groups for g in gl)
        assert info.peak_cells == work // dt.itemsize
        assert info.peak_bytes == F.dplan.plan.dev_size * dt.itemsize + work
        assert info.nsegments == info.seg_budget_cells == 0
    assert report.info_from_symbolic(S).peak_cells == \
        max(supernodal_device._work_bytes(g, torch.float32)
            for gl in F.dplan.plan.groups for g in gl) // 4


def test_info_of_a_segmented_factor_counts_its_segments():
    A = sstt.fixtures.laplacian_3d(6)
    Ssim = sstt.analyze(A)
    S = supernodal.supernodal_symbolic(A, Ssim)
    F = supernodal_device.factorize_device(
        A, S, sstt.DEFAULT.replace(segment_bytes=20_000), "cpu")
    assert F.segments > 1
    info = report.info_from_factor(F)
    assert info.nsegments == F.segments
    assert info.seg_budget_cells == 20_000 // 4
    assert f"segments {F.segments}  budget cells 5000" in \
        report.report_info(info)


def test_factor_cells_count_what_a_factor_stores(tmp_path):
    for lx in (np.zeros(7), torch.zeros(7)):
        bare = type("B", (), {"Lx": lx})()
        assert report.info_from_factor(bare).factor_cells == 7
    Aj, Sj, A, S = _supernodal(11)
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu")
    p = tmp_path / "f.npz"
    serialize.save_factor(p, F)
    G = serialize.load_factor(p, device="cpu")
    info = report.info_from_factor(G, A)
    assert info.factor_cells == S.lnz and info.ngroups == 0
    assert report.report_factor(G) == (
        f"factor: n {A.ncol}, ok True, minor {A.ncol}, stored cells "
        f"{S.lnz}")


def test_report_texts_match_the_reference():
    Aj = sst.io.fixtures.fem_mesh_spd(300, seed=2)
    A = sstt.fixtures.fem_mesh_spd(300, seed=2)
    for prl in (0, 1, 2, 3, 4):
        assert report.report_matrix(A, "K", prl) == \
            ref_report.report_matrix(Aj, "K", prl)
    perm = amd_order(Aj)
    assert report.report_perm(perm) == ref_report.report_perm(perm)
    assert report.report_perm(perm[::-1][1:]) == \
        ref_report.report_perm(perm[::-1][1:])
    Fj = ref_simplicial.chol_up(Aj, ref_simplicial.symbolic_cholesky(Aj, perm))
    F = simplicial.chol_up(A, simplicial.symbolic_cholesky(A, perm))
    assert report.report_factor(F) == ref_report.report_factor(Fj)
    Sj = analyze_supernodal(Aj, perm)
    S = port_analyze_supernodal(A, perm)
    Hj = ref_supernodal.SupernodalFactorAdapter(
        ref_supernodal.factorize_host(Aj, Sj))
    H = supernodal.SupernodalFactorAdapter(supernodal.factorize_host(A, S))
    assert report.report_factor(H) == ref_report.report_factor(Hj)
    assert check.sprint(A, "K", 7) == ref_check.sprint(Aj, "K", 7)


def test_check_accepts_every_factor_of_the_port(tmp_path):
    Aj, Sj, A, S = _supernodal(11)
    F = supernodal_device.factorize_device(A, S, sstt.DEFAULT, "cpu")
    p = tmp_path / "f.npz"
    serialize.save_factor(p, F)
    G = serialize.load_factor(p, device="cpu")
    H = supernodal.factorize_host(A, S)
    Ssim = simplicial.symbolic_cholesky(A, S.perm)
    factors = [simplicial.chol_up(A, Ssim), simplicial.ldl_up(A, Ssim), F,
               H, G.F, G] + [supernodal.SupernodalFactorAdapter(x)
                             for x in (F, H)]
    for f in factors:
        check.check_factor(f)
    ref_check.check_factor(supernodal.SupernodalFactorAdapter(H))
    check.check_symbolic(Ssim)
    check.check_sparse(A)
    check.check_perm(S.perm, A.ncol)
    bad = simplicial.chol_up(A, Ssim)
    bad.L.indices = bad.L.indices.copy()
    bad.L.indices[bad.L.indptr[5]] = 6
    with pytest.raises(AssertionError, match="column 5: diagonal not first"):
        check.check_factor(bad)
    with pytest.raises(AssertionError, match="not a permutation"):
        check.check_perm(np.zeros(A.ncol, dtype=np.int64), A.ncol)
    U = sstt.CSC(3, 2, np.array([0, 2, 3]), np.array([1, 0, 2]),
                 np.ones(3), 0)
    with pytest.raises(AssertionError, match="col 0 unsorted"):
        check.check_sparse(U)


def test_rcond_and_condest_match_the_reference():
    Aj = sst.io.fixtures.fem_mesh_spd(300, seed=2)
    A = sstt.fixtures.fem_mesh_spd(300, seed=2)
    perm = amd_order(Aj)
    Fj = ref_simplicial.chol_up(Aj, ref_simplicial.symbolic_cholesky(Aj, perm))
    F = simplicial.chol_up(A, simplicial.symbolic_cholesky(A, perm))
    Lj = ref_simplicial.ldl_up(Aj, ref_simplicial.symbolic_cholesky(Aj, perm))
    L = simplicial.ldl_up(A, simplicial.symbolic_cholesky(A, perm))
    for f, fj in ((F, Fj), (L, Lj)):
        rc, rcj = diagnostics.rcond_from_factor(f), \
            ref_diag.rcond_from_factor(fj)
        assert 0 < rc <= 1 and abs(rc - rcj) <= REL * rcj
    est = diagnostics.condest(A, lambda b: simplicial.chol_solve(F, b))
    estj = ref_diag.condest(Aj, lambda b: ref_simplicial.chol_solve(Fj, b))
    assert est > 1 and abs(est - estj) <= REL * estj
    D = A.to_dense()
    true = np.linalg.norm(D, 1) * np.linalg.norm(np.linalg.inv(D), 1)
    assert true / 50 <= est <= true * 1.001


def test_determinant_and_growth_of_the_ports_lu_match_the_reference():
    rng = np.random.default_rng(1)
    D = rng.standard_normal((30, 30)) * (rng.random((30, 30)) < 0.3)
    np.fill_diagonal(D, np.abs(D).sum(axis=1) + 1.0)
    M, Mj = sstt.from_triplets(*_triplets(D)), sst.from_triplets(*_triplets(D))
    N = lu.factor_lu(M, lu.analyze_lu(M))
    Nj = ref_lu.factor_lu(Mj, ref_lu.analyze_lu(Mj))
    mant, expo = diagnostics.determinant_from_lu(N)
    mj, ej = ref_diag.determinant_from_lu(Nj)
    assert expo == ej and abs(mant - mj) <= REL * abs(mj)
    assert np.isclose(mant * 10.0 ** expo, np.linalg.det(D), rtol=1e-8)
    g, gj = diagnostics.rgrowth(M, N), ref_diag.rgrowth(Mj, Nj)
    assert 0 < g <= 1 + 1e-12 and abs(g - gj) <= REL * gj


def _triplets(D):
    r, c = np.nonzero(D)
    return D.shape[0], D.shape[1], r, c, D[r, c]
