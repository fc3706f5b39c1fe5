"""Segmented execution of the port's device factors, on the CPU.

Counterparts of the JAX package's own segmented tests
(``tests/test_fault_injection.py``, ``tests/test_complex_device.py``):

- the Cholesky forced into segments (``Config.segment_bytes``) gives the
  one-piece factor's ``Lx`` bit for bit, and matches the JAX factor run
  segmented (``SSTPU_SEGMENT=1``, ``SSTPU_SEG_CELLS``) at the Cholesky
  parity tolerances (fp32 1e-5, fp64 1e-10 of max|Lx|); the port reads no
  ``SSTPU_SEG*`` variable;
- the QR and the LU forced into segments give the one-piece x bit for bit
  and match the JAX package's segmented runs to 1e-8 (fp64);
- a group that raises in a mid-schedule segment leaves the analysis
  reusable: the next call equals the first;
- a segmented QR plan at another nrhs reuses no stale schedule;
- the schedule keeps the plan order and no segment of two groups or more
  passes the budget.
"""

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import mflu_unsym as ref_mu
from suitesparse_tpu.numeric import mfqr_device as ref_md
from suitesparse_tpu.numeric import supernodal_device as ref_sd
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import mflu_unsym as mu
from suitesparse_tpu_torch.numeric import mfqr_device as md
from suitesparse_tpu_torch.numeric import multifrontal_qr as mq
from suitesparse_tpu_torch.numeric import segmented
from suitesparse_tpu_torch.numeric import supernodal_device as sd
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

from test_torch_host import _reference_native

CPU = torch.device("cpu")
TOL = {"float32": 1e-5, "float64": 1e-10}
CFG64 = sstt.DEFAULT.replace(compute_dtype="float64")
REF64 = sst.DEFAULT.replace(compute_dtype="float64")
# budgets that cut each small plan below into several segments
CHOL_BYTES = 20_000
QRLU_BYTES = 200_000


def _ref_segmented(monkeypatch, cells: int) -> None:
    monkeypatch.setenv("SSTPU_SEGMENT", "1")
    monkeypatch.setenv("SSTPU_SEG_CELLS", str(cells))


def _chol(dtype):
    """laplacian_3d(6): the reference's analysis (nested dissection) and
    the port's on its perm."""
    A = sst.io.fixtures.laplacian_3d(6)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    At = sstt.fixtures.laplacian_3d(6)
    return A, S, At, port_analyze_supernodal(At, S.perm)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cholesky_segmented_equals_one_piece_and_the_reference(dtype,
                                                               monkeypatch):
    A, S, At, St = _chol(dtype)
    cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
    # the reference's environment forces its runner; the port's default
    # on the CPU runs in one piece all the same
    _ref_segmented(monkeypatch, 2000)
    Fj = ref_sd.factorize_device(A, S, sst.DEFAULT.replace(
        compute_dtype=dtype))
    assert len(S._seg_cache[1]) > 1
    F1 = sd.factorize_device(At, St, cfg, CPU)
    Fs = sd.factorize_device(At, St, cfg.replace(segment_bytes=CHOL_BYTES),
                             CPU)
    assert F1.segments == 1 and Fs.segments >= 3
    assert Fs.ok and torch.equal(Fs.Lx, F1.Lx)
    lj = np.asarray(Fj.Lx, dtype=np.float64)
    lt = Fs.Lx.numpy().astype(np.float64)
    assert np.abs(lt - lj).max() <= TOL[dtype] * np.abs(lj).max()
    # the plan's cache does not keep the one-piece upload of a plan that
    # ran segmented; a one-piece factor uploads it again
    dp = St._torch_plan[(sd.TILE_RMIN, False, "cpu", 0, 0.0)]
    assert dp.groups is None and dp.schedule[0][-1] == CHOL_BYTES
    # groups assembled through tile manifests (fp32: K2 and K7 on the
    # unfolded classes) take their arrays a segment at a time too
    T1 = sd.factorize_device(At, St, cfg, CPU, tile_rmin=32)
    Ts = sd.factorize_device(At, St, cfg.replace(segment_bytes=CHOL_BYTES),
                             CPU, tile_rmin=32)
    assert Ts.segments >= 3 and torch.equal(Ts.Lx, T1.Lx)
    assert any(g._tile is not None for gl in Ts.dplan.plan.groups
               for g in gl)
    b = np.ones(At.ncol)
    x = sstt.solve(sstt.numeric.supernodal.SupernodalFactorAdapter(Fs), b,
                   cfg)
    assert sstt.residual_norm(At, x, b) < 1e-5


def test_qr_and_lu_segmented_equal_one_piece_and_the_reference(monkeypatch):
    """The counterpart of ``test_fault_injection.py:129``: the QR on
    ``grid_gradient_3d(6)`` and the LU on ``fem_unsym(6)``."""
    _reference_native()
    A = sstt.fixtures.grid_gradient_3d(6)
    Aj = sst.CSC(A.nrow, A.ncol, A.indptr.copy(), A.indices.copy(),
                 A.data.copy(), 0)
    b = np.random.default_rng(7).standard_normal(A.nrow)
    SQ = mq.analyze_mfqr(A, CFG64)
    seg = CFG64.replace(segment_bytes=QRLU_BYTES)
    x1 = md.qr_solve_device(md.factorize_qr_device(A, SQ, b, CFG64, CPU))
    Fs = md.factorize_qr_device(A, SQ, b, seg, CPU)
    assert len(Fs.segments) >= 3 and Fs.groups is None
    xs = md.qr_solve_device(Fs)
    assert np.array_equal(xs, x1)
    L = sstt.fixtures.fem_unsym(6)
    Lj = sst.CSC(L.nrow, L.ncol, L.indptr.copy(), L.indices.copy(),
                 L.data.copy(), 0)
    bl = np.random.default_rng(2).standard_normal(L.nrow)
    SL = mu.analyze_mflu_unsym(L, CFG64)
    y1 = mu.lu_unsym_solve_device(L, bl, CFG64, SL, CPU)
    ys = mu.lu_unsym_solve_device(L, bl, seg, SL, CPU)
    assert len(SL._torch_lu[1].schedule[1]) >= 3
    assert np.array_equal(ys, y1)
    _ref_segmented(monkeypatch, 300_000)
    assert np.allclose(xs[:, 0], ref_md.mfqrsol_device(Aj, b, REF64),
                       atol=1e-8)
    assert np.allclose(ys, ref_mu.lu_unsym_solve_device(Lj, bl, REF64),
                       atol=1e-8)
    assert np.allclose(ys, np.linalg.solve(L.to_dense(), bl), atol=1e-8)


class _Injected(RuntimeError):
    pass


@pytest.mark.parametrize("path", ["cholesky", "lu"])
def test_group_failure_mid_schedule_leaves_the_analysis_reusable(
        path, monkeypatch):
    """The counterpart of ``test_fault_injection.py:61``: a group body
    raises inside a mid-schedule segment; the error reaches the caller (no
    one-piece rerun), and the next call on the same analysis equals the
    first."""
    if path == "cholesky":
        _A, _S, At, St = _chol("float32")
        cfg = sstt.DEFAULT.replace(segment_bytes=CHOL_BYTES)
        mod, name = sd, "_group_compute"

        def run():
            F = sd.factorize_device(At, St, cfg, CPU)
            return F.segments, F.Lx
    else:
        L = sstt.fixtures.fem_unsym(6)
        St = mu.analyze_mflu_unsym(L)
        cfg = sstt.DEFAULT.replace(segment_bytes=QRLU_BYTES)
        mod, name = mu, "_factor_group"

        def run():
            F = mu.factorize_lu_unsym_device(L, St, np.ones(L.ncol), cfg,
                                             CPU)
            return len(F.segments), F.pool

    nseg, first = run()
    assert nseg >= 3
    dp = next(iter(St._torch_plan.values())) if path == "cholesky" \
        else St._torch_lu[1]
    fail_at = len(dp.host) // 2
    calls = {"n": 0}
    orig = getattr(mod, name)

    def inject(*a, **k):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise _Injected(f"injected at group {fail_at}")
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, inject)
    with pytest.raises(_Injected):
        run()
    monkeypatch.setattr(mod, name, orig)
    nseg2, again = run()
    assert nseg2 == nseg and torch.equal(again, first)


def test_nrhs_change_on_a_segmented_qr_plan_reuses_no_stale_schedule():
    """The counterpart of ``test_complex_device.py:137``: the plan is
    rebuilt at another nrhs, and its schedule with it."""
    A = sstt.fixtures.grid_gradient_3d(5)
    rng = np.random.default_rng(9)
    SQ = mq.analyze_mfqr(A, CFG64)
    seg = CFG64.replace(segment_bytes=50_000)
    D = A.to_dense()
    for nrhs in (1, 4):
        B = rng.standard_normal((A.nrow, nrhs))
        Fs = md.factorize_qr_device(A, SQ, B, seg, CPU)
        X = md.qr_solve_device(Fs)
        dp = SQ._torch_qr[1]
        key = dp.schedule[0]
        assert len(Fs.segments) > 1 and Fs.dplan is dp
        assert dp.plan.nrhs == nrhs and key[:2] == (id(dp.plan), nrhs)
        assert np.allclose(X, np.linalg.lstsq(D, B, rcond=None)[0],
                           atol=1e-8)
        X1 = md.qr_solve_device(md.factorize_qr_device(A, SQ, B, CFG64,
                                                       CPU))
        assert np.array_equal(X, X1)


def test_schedule_keeps_the_order_and_the_budget():
    rng = np.random.default_rng(0)
    for trial in range(200):
        n = int(rng.integers(1, 40))
        costs = [(int(i), int(w)) for i, w in
                 zip(rng.integers(0, 1000, n), rng.integers(0, 5000, n))]
        budget = int(rng.integers(1, 20_000))
        segs = segmented.schedule(costs, budget)
        assert [p for s in segs for p in s] == list(range(n))
        for s in segs:
            held = sum(costs[p][0] for p in s) + max(costs[p][1] for p in s)
            assert len(s) == 1 or held <= budget, (trial, s)
        # greedy: the next segment's first group would have passed
        for s, t in zip(segs, segs[1:]):
            nxt = s + t[:1]
            assert sum(costs[p][0] for p in nxt) + \
                max(costs[p][1] for p in nxt) > budget
    assert segmented.schedule([], 10) == []


def test_budget_switch():
    cfg = sstt.DEFAULT
    assert segmented.budget(cfg, CPU, 10**9) == 0      # auto, CPU: one piece
    assert segmented.budget(cfg.replace(segment_bytes=123), CPU, 10**9) \
        == 123
    with pytest.raises(ValueError, match="segment_bytes"):
        segmented.budget(cfg.replace(segment_bytes=-1), CPU, 0)
    assert segmented.one_piece_bytes(100, [(5, 7), (9, 30)]) == 130
