"""The port's multifrontal QR against the JAX package, on the CPU.

- The front-tree analysis and the plan equal the reference's exactly, with
  COLAMD and with the natural order.
- Each front cell has at most one source, and the one gather a group
  assembles what the reference's scatter plus placement assembles.
- The R panels (with Q'b in their right-hand-side columns) equal the
  reference's ``_run_qr_plan`` in every row the plan reads: each row
  normalised by the sign of its first significant entry up to a front's
  first pivot that is zero up to rounding, then the Gram matrix of the
  rows after it; 1e-10 of the largest entry in fp64, 1e-4 in fp32.
- Solutions equal the reference's ``mfqrsol_device`` and ``lstsq`` at
  ``tests/test_mfqr.py``'s cases, atol 1e-8 in fp64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import mfqr_device as ref_md
from suitesparse_tpu.numeric import multifrontal_qr as ref_mq
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import mfqr_device as md
from suitesparse_tpu_torch.numeric import multifrontal_qr as mq

from test_torch_host import _reference_native

CFG64 = sstt.DEFAULT.replace(compute_dtype="float64")
REF64 = sst.DEFAULT.replace(compute_dtype="float64")
# tests/test_mfqr.py's cases (m, n, density, seed)
CASES = [(40, 25, 0.3, 3), (200, 120, 0.05, 4), (600, 400, 0.02, 5)]


def make_case(m, n, dens, seed):
    """``tests/test_mfqr.py``'s fixture as (port CSC, reference CSC,
    dense)."""
    rng = np.random.default_rng(seed)
    D = sstt.fixtures.random_sparse(m, n, density=dens, seed=seed,
                                    ensure_full_diag=False).to_dense()
    for j in range(n):
        if np.abs(D[:, j]).sum() < 1e-12:
            D[rng.integers(m), j] = 1.0
    D[np.arange(n), np.arange(n)] += 2.0
    r, c = np.nonzero(D)
    return (sstt.from_triplets(m, n, r, c, D[r, c]),
            sst.from_triplets(m, n, r, c, D[r, c]), D)


def both(name):
    """(port, reference) fixture of the QR slice."""
    if name == "grid6":
        A = sstt.fixtures.grid_gradient_3d(6)
    elif name == "lc600":
        A = sstt.fixtures.local_coupling_ls(600, 200)
    else:
        return make_case(*CASES[int(name[-1])])[:2]
    return A, sst.CSC(A.nrow, A.ncol, A.indptr.copy(), A.indices.copy(),
                      A.data.copy(), 0)


NAMES = ["case0", "case1", "case2", "grid6", "lc600"]


def test_random_sparse_equals_the_reference():
    A = sstt.fixtures.random_sparse(50, 30, 0.1, seed=4,
                                    ensure_full_diag=False)
    Aj = sst.io.fixtures.random_sparse(50, 30, 0.1, seed=4,
                                       ensure_full_diag=False)
    B = sstt.fixtures.random_sparse(40, 40, 0.1, seed=5)
    Bj = sst.io.fixtures.random_sparse(40, 40, 0.1, seed=5)
    for X, Xj in ((A, Aj), (B, Bj)):
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(X, f), getattr(Xj, f))


def test_grid_gradient_3d():
    k = 5
    A = sstt.fixtures.grid_gradient_3d(k)
    ne = 3 * k * k * (k - 1)
    assert A.shape == (ne + 1, k ** 3) and A.nnz == 2 * ne + 1
    D = A.to_dense()
    # an edge row: -w at its lower node, +w at the upper, w in [0.5, 2)
    assert np.allclose(D[:ne].sum(axis=1), 0.0)
    w = D[:ne].max(axis=1)
    assert (w >= 0.5).all() and (w < 2.0).all()
    assert D[0, 0] == -w[0] and D[0, k * k] == w[0]      # axis 0 first
    assert np.linalg.matrix_rank(D) == k ** 3
    B = sstt.fixtures.grid_gradient_3d(k)
    assert np.array_equal(A.data, B.data)                # seeded


@pytest.mark.parametrize("ordering", ["colamd", "natural"])
@pytest.mark.parametrize("name", NAMES)
def test_analysis_equals_the_reference(name, ordering):
    _reference_native()
    cfg, cfgj = sstt.DEFAULT, sst.DEFAULT
    if ordering == "natural":
        cfg = cfg.replace(ordering=sstt.Ordering.NATURAL)
        cfgj = cfgj.replace(ordering=sst.Ordering.NATURAL)
    A, Aj = both(name)
    SQ, SQj = mq.analyze_mfqr(A, cfg), ref_mq.analyze_mfqr(Aj, cfgj)
    for f in ("q", "row_front", "front_m", "front_k", "cb_rows"):
        assert np.array_equal(getattr(SQ, f), getattr(SQj, f)), f
    assert len(SQ.front_arows) == len(SQj.front_arows) == SQ.S.nsuper
    assert all(np.array_equal(a, b)
               for a, b in zip(SQ.front_arows, SQj.front_arows))
    assert np.array_equal(SQ.S.super_first, SQj.S.super_first)
    assert all(np.array_equal(a, b) for a, b in zip(SQ.S.rows, SQj.S.rows))


def _plans(name, nrhs):
    A, Aj = both(name)
    SQ, SQj = mq.analyze_mfqr(A), ref_mq.analyze_mfqr(Aj)
    return (A, SQ, md.build_qr_plan(SQ, A.permuted(None, SQ.q), nrhs),
            Aj, SQj, ref_md.build_qr_plan(SQj, Aj.permuted(None, SQj.q),
                                          nrhs))


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_plan_equals_the_reference(name, nrhs):
    _reference_native()
    _A, _SQ, P, _Aj, _SQj, Pj = _plans(name, nrhs)
    assert (P.pool_data, P.pool_size, P.nrhs, P.n) == \
        (Pj.pool_data, Pj.pool_size, Pj.nrhs, Pj.n)
    assert [len(gl) for gl in P.groups] == [len(gl) for gl in Pj.groups]
    for g, gj in zip((g for gl in P.groups for g in gl),
                     (g for gl in Pj.groups for g in gl)):
        assert (g.M, g.N, g.K, g.B, g.panel_base) == \
            (gj.M, gj.N, gj.K, gj.B, gj.panel_base)
        for f in ("snodes", "asrc", "adst", "nc", "col_idx", "row_col"):
            assert np.array_equal(getattr(g, f), getattr(gj, f)), f
        assert len(g.pairs) == len(gj.pairs)
        for p, pj in zip(g.pairs, gj.pairs):
            assert p[:4] == pj[:4]
            assert all(np.array_equal(a, b) for a, b in zip(p[4:], pj[4:]))


@pytest.mark.parametrize("name", NAMES)
def test_one_gather_assembles_what_the_reference_places(name):
    """Every front cell has at most one source, and ``pool[gidx]`` equals
    the reference's assembly (A and b entries set, then each child's
    contribution block added through its row and column maps) on a pool of
    random values."""
    A, SQ, P, *_ = _plans(name, 2)
    rng = np.random.default_rng(0)
    pool = rng.standard_normal(P.pool_size)
    pool[P.pool_data - 1] = 0.0
    for gl in P.groups:
        for g in gl:
            gidx = md.gather_index(P, g)
            F = np.zeros(g.B * g.M * g.N)
            F[g.adst] = pool[g.asrc]
            F = F.reshape(g.B, g.M, g.N)
            n_src = g.adst.size
            for dc, gc, Kc, Nc, psrc, pdst, rowmap, colmap in g.pairs:
                base = P.groups[dc][gc].panel_base
                child = pool[base:base + P.groups[dc][gc].B * Kc * Nc] \
                    .reshape(-1, Kc, Nc)
                for p in range(psrc.size):
                    rr = np.flatnonzero(rowmap[p] >= 0)
                    cc = np.flatnonzero(colmap[p] >= 0)
                    F[pdst[p]][np.ix_(rowmap[p][rr], colmap[p][cc])] += \
                        child[psrc[p]][np.ix_(rr, cc)]
                    n_src += rr.size * cc.size
            assert np.count_nonzero(gidx != P.pool_data - 1) == n_src
            assert np.array_equal(pool[gidx].reshape(F.shape), F)


def test_a_cell_with_two_sources_is_refused():
    _A, _SQ, P, *_ = _plans("case1", 1)
    g = next(g for gl in P.groups for g in gl if g.pairs)
    dc, gc, Kc, Nc, psrc, pdst, rowmap, colmap = g.pairs[0]
    r = int(np.flatnonzero(rowmap[0] >= 0)[0])
    c = int(np.flatnonzero(colmap[0] >= 0)[0])
    cell = (int(pdst[0]) * g.M + int(rowmap[0, r])) * g.N + int(colmap[0, c])
    g.adst = np.append(g.adst, cell)             # an A entry on a child cell
    g.asrc = np.append(g.asrc, 0)
    with pytest.raises(RuntimeError, match="two sources"):
        md.gather_index(P, g)


def _slots(flat, plan, SQ):
    """(stored R rows the plan reads, front columns) of every front: a
    front's first nc + cb rows (its R rows and its contribution block; the
    rows below come from Householders of the right-hand-side columns and
    no one reads them)."""
    for gl in plan.groups:
        for g in gl:
            o = g.panel_base - plan.pool_data
            R = np.asarray(flat[o:o + g.B * g.K * g.N], np.float64) \
                .reshape(g.B, g.K, g.N)
            for b, s in enumerate(g.snodes):
                yield R[b, :g.nc[b] + SQ.cb_rows[s]], len(SQ.S.rows[s])


def _signed(R):
    """Each row times the sign of its first entry above 1e-3 of the row's
    largest."""
    mag = np.abs(R)
    first = np.argmax(mag > 1e-3 * mag.max(axis=1, keepdims=True), axis=1)
    sgn = np.sign(R[np.arange(R.shape[0]), first])
    return R * np.where(sgn == 0, 1.0, sgn)[:, None]


def assert_panels_match(got, want, want64, plan, SQ, tol):
    """Householder QR's R is unique up to row signs while its pivots stay
    nonzero. A front whose staircase is rank deficient (a pivot zero up to
    rounding in the fp64 reference: a wide front whose rows leave a column
    empty) makes its later rows a rotation that depends on the rounding;
    there the rows' Gram matrix over the front's own columns is what is
    unique. Both within ``tol`` of the largest entry (squared for Gram)."""
    n_rows = n_gram = 0
    for (R, nf), (Rw, _nf), (R64, _) in zip(_slots(got, plan, SQ),
                                            _slots(want, plan, SQ),
                                            _slots(want64, plan, SQ)):
        scale = max(np.abs(Rw).max(initial=0.0), 1e-300)
        d = np.abs(np.diagonal(R64))
        dead = np.flatnonzero(d <= 1e-9 * max(d.max(initial=0.0), 1e-300))
        i0 = int(dead[0]) if dead.size else R.shape[0]
        assert np.abs(_signed(R[:i0]) - _signed(Rw[:i0])).max(initial=0.0) \
            <= tol * scale
        G, Gw = R[i0:].T @ R[i0:], Rw[i0:].T @ Rw[i0:]
        assert np.abs(G[:nf] - Gw[:nf]).max(initial=0.0) <= tol * scale ** 2
        n_rows += i0
        n_gram += R.shape[0] - i0
    assert n_rows > n_gram


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-4)])
@pytest.mark.parametrize("name", NAMES)
def test_panels_equal_the_reference_up_to_row_signs(name, dtype, tol):
    _reference_native()
    A, SQ, P, Aj, SQj, Pj = _plans(name, 2)
    b = np.random.default_rng(1).standard_normal((A.nrow, 2))
    F = md.factorize_qr_device(A, SQ, b, CFG64.replace(compute_dtype=dtype),
                               device="cpu")
    assert F.ok and F.pool.dtype == getattr(torch, dtype)
    ad = jnp.asarray(Aj.permuted(None, SQj.q).data)
    ref = {dt: np.asarray(ref_md._run_qr_plan(
        Pj, ad, jnp.asarray(b.ravel()), getattr(jnp, dt)))
        for dt in {dtype, "float64"}}
    assert_panels_match(F.panels.numpy(), ref[dtype], ref["float64"], P, SQ,
                        tol)


@pytest.mark.parametrize("name", NAMES)
def test_solution_equals_the_reference_and_lstsq(name):
    """The device path against the reference's, ``lstsq`` and the
    reference's host multifrontal QR (its numpy oracle)."""
    _reference_native()
    A, Aj = both(name)
    b = np.random.default_rng(2).standard_normal(A.nrow)
    x = md.mfqrsol_device(A, b, CFG64, device="cpu")
    xj = ref_md.mfqrsol_device(Aj, b, REF64)
    x_ref = np.linalg.lstsq(A.to_dense(), b, rcond=None)[0]
    assert x.shape == (A.ncol,)
    assert np.allclose(x, xj, atol=1e-8)
    assert np.allclose(x, x_ref, atol=1e-8)
    assert np.allclose(x, ref_mq.mfqrsol(Aj, b, REF64), atol=1e-8)


def test_fp32_solution():
    A, _Aj, D = make_case(*CASES[2])
    b = np.random.default_rng(3).standard_normal(A.nrow)
    x = md.mfqrsol_device(A, b, sstt.DEFAULT, device="cpu")
    x_ref = np.linalg.lstsq(D, b, rcond=None)[0]
    assert np.abs(x - x_ref).max() <= 1e-4 * np.abs(x_ref).max()


def test_three_right_hand_sides_then_one_rebuilds_the_plan():
    A, Aj, D = make_case(60, 35, 0.2, 6)
    SQ = mq.analyze_mfqr(A)
    B = np.random.default_rng(7).standard_normal((60, 3))
    X = md.mfqrsol_device(A, B, CFG64, SQ=SQ, device="cpu")
    assert X.shape == (35, 3) and SQ._torch_qr[0][0] == 3
    assert np.allclose(X, np.linalg.lstsq(D, B, rcond=None)[0], atol=1e-8)
    assert np.allclose(X, ref_md.mfqrsol_device(Aj, B, REF64), atol=1e-8)
    plan3 = SQ._torch_qr[1]
    x = md.mfqrsol_device(A, B[:, 1], CFG64, SQ=SQ, device="cpu")
    assert SQ._torch_qr[0][0] == 1 and SQ._torch_qr[1] is not plan3
    assert np.allclose(x, X[:, 1], atol=1e-10)
    # the same nrhs again reuses the plan
    plan1 = SQ._torch_qr[1]
    md.mfqrsol_device(A, B[:, 2], CFG64, SQ=SQ, device="cpu")
    assert SQ._torch_qr[1] is plan1


def test_pattern_cache_keys_on_the_ordering_and_dtype_follows_config():
    """F10: the reference's pattern cache keys on the pattern alone, so a
    second ordering reuses the first one's column order. The port's key
    holds the ordering: each call runs its own order; and the dtype and
    precision, applied at each call, follow the config on a cached plan."""
    A, _Aj, D = make_case(*CASES[1])
    b = np.random.default_rng(8).standard_normal(A.nrow)
    x_ref = np.linalg.lstsq(D, b, rcond=None)[0]
    md._SQ_CACHE.clear()
    natural = CFG64.replace(ordering=sstt.Ordering.NATURAL)
    colamd = CFG64.replace(ordering=sstt.Ordering.COLAMD)
    x1 = md.mfqrsol_device(A, b, natural, device="cpu")
    x2 = md.mfqrsol_device(A, b, colamd, device="cpu")
    assert len(md._SQ_CACHE) == 2
    q = {k[3]: SQ.q for k, SQ in md._SQ_CACHE.items()}
    assert np.array_equal(q[sstt.Ordering.NATURAL],
                          mq.analyze_mfqr(A, natural).q)
    assert np.array_equal(q[sstt.Ordering.COLAMD],
                          mq.analyze_mfqr(A, colamd).q)
    assert not np.array_equal(q[sstt.Ordering.NATURAL],
                              q[sstt.Ordering.COLAMD])
    assert np.allclose(x1, x_ref, atol=1e-8)
    assert np.allclose(x2, x_ref, atol=1e-8)
    # the same key again: the cached analysis
    SQ = md._SQ_CACHE[md._analysis_key(A, colamd)]
    md.mfqrsol_device(A, b, colamd, device="cpu")
    assert md._SQ_CACHE[md._analysis_key(A, colamd)] is SQ
    # new values on the same pattern flow through the cached analysis
    A2 = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, 2.0 * A.data)
    x3 = md.mfqrsol_device(A2, b, colamd, device="cpu")
    assert np.allclose(x3, x_ref / 2.0, atol=1e-8)
    # fp32 then fp64 on one cached plan: each in its own dtype
    for cfg, dt in ((colamd.replace(compute_dtype="float32"), torch.float32),
                    (colamd.replace(precision="high"), torch.float64)):
        F = md.factorize_qr_device(A, SQ, b, cfg, device="cpu")
        assert F.pool.dtype == dt and F.precision == cfg.precision


@pytest.mark.parametrize("name", ["grid6", "lc600"])
def test_qrsol_end_to_end(name):
    A, Aj = both(name)
    b = np.random.default_rng(7).standard_normal(A.nrow)
    calls = md.device_factors
    x = sstt.qrsol(A, b, CFG64, device="cpu")
    assert md.device_factors == calls + 1
    D = A.to_dense()
    x_ref = np.linalg.lstsq(D, b, rcond=None)[0]
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    assert np.allclose(x, sst.qrsol(Aj, b, REF64), atol=1e-8)
    r = b - D @ x
    assert np.abs(D.T @ r).max() / (np.abs(D).max() * np.abs(r).max()) \
        < 1e-12
    x32 = sstt.qrsol(A, b, device="cpu")
    assert np.abs(x32 - x).max() <= 1e-4 * np.abs(x).max()


def _contiguous_sweep(F):
    """The backward sweep as it was before it took its positions from the
    plan: the right-hand sides at front column nf + j, the beyond-pivot
    columns at [nc, nf), R11 from the first K columns."""
    dp, S = F.dplan, F.SQ.S
    n, nrhs = dp.plan.n, dp.plan.nrhs
    x = torch.zeros((n + 1, nrhs), dtype=F.pool.dtype)
    groups = [g for gl in dp.plan.groups for g in gl]
    for g, ga in zip(reversed(groups), reversed(dp.groups)):
        B, K, N = g.B, g.K, g.N
        nf = np.array([len(S.rows[s]) for s in g.snodes], np.int64)
        nc = g.nc.astype(np.int64)
        yidx = ((np.arange(B)[:, None, None] * K + np.arange(K)[None, :, None])
                * N + nf[:, None, None] + np.arange(nrhs)[None, None, :])
        ar_n = np.arange(N)
        beyond = (ar_n[None, :] >= nc[:, None]) & (ar_n[None, :] < nf[:, None])
        xidx = np.where(beyond.ravel(), g.col_idx, n)
        assert torch.equal(ga.yidx, torch.from_numpy(yidx.ravel()))
        assert torch.equal(ga.xidx, torch.from_numpy(xidx))
        flat = F.pool[g.panel_base:g.panel_base + B * K * N]
        R = flat.view(B, K, N)
        y = flat.index_select(0, torch.from_numpy(yidx.ravel())) \
            .view(B, K, nrhs)
        xg = x.index_select(0, torch.from_numpy(xidx)).view(B, N, nrhs)
        rhs = torch.baddbmm(y, R, xg, alpha=-1.0)
        R11 = torch.where(ga.live, R[:, :, :K], ga.eye)
        xs = torch.linalg.solve_triangular(R11, rhs, upper=True)
        x.index_copy_(0, ga.cols,
                      xs.reshape(B * K, nrhs).index_select(0, ga.rows))
    xh = x[:n].double().numpy()
    xout = np.empty_like(xh)
    xout[F.SQ.q] = xh
    return xout


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_generalised_sweep_is_bit_equal_to_the_contiguous_one(name, dtype):
    """The sweep takes every position from the plan (the LU's gapped
    panels share it); on QR plans its index arrays and its x are bit for
    bit those of the contiguous-layout sweep it replaced."""
    A, _Aj = both(name)
    SQ = mq.analyze_mfqr(A)
    b = np.random.default_rng(9).standard_normal((A.nrow, 2))
    F = md.factorize_qr_device(A, SQ, b, CFG64.replace(compute_dtype=dtype),
                               device="cpu")
    assert all(g.K <= g.N for gl in F.dplan.plan.groups for g in gl)
    assert np.array_equal(md.qr_solve_device(F), _contiguous_sweep(F))


def test_householder_flops():
    A, _ = both("case1")
    SQ = mq.analyze_mfqr(A)
    total = 0.0
    for s in range(SQ.S.nsuper):
        M, N = int(SQ.front_m[s]), len(SQ.S.rows[s]) + 2
        k = min(M, N)
        total += 2.0 * k * k * (max(M, N) - k / 3.0)
    assert md.householder_flops(SQ, 2) == pytest.approx(total, rel=1e-12)
