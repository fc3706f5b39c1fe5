"""The port's unsymmetric multifrontal LU against the JAX package, on the CPU.

- The analysis (``rowpre``, ``home``, ``enter``, ``front_rows``,
  ``nforeign``) and the plan (the port's lists each front's children
  once; the reference's scans every lower supernode) equal the
  reference's exactly, field for field: the FEM fixture of
  ``demos/bench_unsym.py`` at nx = 6 and 8, its upwind variant at nx = 8,
  the random cases of ``tests/test_mflu_unsym.py`` and a hand-made front
  whose foreign rows outnumber its columns (K > N).
- Every front cell has one source at most, and the one gather a group
  assembles what the reference's scatter plus placement assembles.
- The permutation of ``lu_factor_ex``'s swaps equals ``lax.linalg.lu``'s,
  also on home blocks with dead padded rows.
- The panels equal the reference's ``_run_lu_unsym_plan`` at tau 1e-6 in
  every row the sweep reads (the U rows and the CB rows): 1e-10 of the
  largest entry in fp64, 1e-4 in fp32. Solutions equal the reference's
  ``lu_unsym_solve_device`` to 1e-8 in fp64.
- ``mflusol_unsym`` meets the reference's gates on its random cases
  (< 1e-10), the singular-home-block case (< 1e-12 through the device QR
  rung, never the host LU) and the tiny-diagonal case (no rung past the
  LU); the router ``mflusol`` picks the reference's strategy; complex
  input solves (``tests/test_torch_complex.py`` holds it against the
  reference) and a tiny ``segment_bytes`` runs the plan in segments.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import suitesparse_tpu as sst
from suitesparse_tpu.numeric import mflu_unsym as ref_mu
from suitesparse_tpu.numeric import mfqr_device as ref_md
from suitesparse_tpu.numeric import multifrontal_lu as ref_ml
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import lu as port_lu
from suitesparse_tpu_torch.numeric import mflu_unsym as mu
from suitesparse_tpu_torch.numeric import mfqr_device as md
from suitesparse_tpu_torch.numeric import multifrontal_lu as ml

from test_torch_host import _reference_native

CFG64 = sstt.DEFAULT.replace(compute_dtype="float64")
REF64 = sst.DEFAULT.replace(compute_dtype="float64")
# tests/test_mflu_unsym.py's random cases (n, density, seed)
RANDOM = [(30, 0.15, 1), (80, 0.08, 2), (150, 0.04, 3)]


def rand_unsym(n, density, seed, diag=3.0):
    """``tests/test_mflu_unsym.py``'s ``_rand_unsym``."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, n))
    D[rng.random((n, n)) > density] = 0.0
    D += np.diag(diag + rng.random(n))
    return D


def ref_csc(A):
    return sst.CSC(A.nrow, A.ncol, A.indptr.copy(), A.indices.copy(),
                   A.data.copy(), 0)


def both(name):
    """(port, reference) fixture of the LU slice."""
    if name.startswith("fem"):
        A = sstt.fixtures.fem_unsym(int(name[3:]))
    elif name.startswith("upwind"):
        A = sstt.fixtures.upwind_unsym(int(name[6:]))
    else:
        A = sstt.sparse.from_dense(rand_unsym(*RANDOM[int(name[-1])]))
    return A, ref_csc(A)


NAMES = ["fem6", "fem8", "upwind8", "rand0", "rand1", "rand2"]


def test_fixtures_are_bench_unsym_s():
    """``fem_unsym`` is ``demos/bench_unsym.py``'s matrix built with the
    JAX package; ``upwind_unsym`` drops strictly upper entries of it."""
    nx = 5
    rng = np.random.default_rng(1)
    M = sst.io.fixtures.laplacian_3d(nx).to_full_storage()
    want = M.data + 0.2 * rng.standard_normal(M.nnz)
    A = sstt.fixtures.fem_unsym(nx)
    assert np.array_equal(A.indptr, M.indptr)
    assert np.array_equal(A.indices, M.indices)
    assert np.array_equal(A.data, want)
    U = sstt.fixtures.upwind_unsym(nx)
    D, Du = A.to_dense(), U.to_dense()
    low = np.tril(np.ones_like(D, dtype=bool))
    assert np.array_equal(Du[low], D[low])
    assert set(np.unique(Du[~low] - D[~low] * (Du[~low] != 0))) == {0.0}
    assert 0.2 < U.symmetry()["structural"] < 0.6
    assert A.symmetry()["structural"] == 1.0


@pytest.mark.parametrize("name", NAMES)
def test_analysis_equals_the_reference(name):
    _reference_native()
    A, Aj = both(name)
    SL, SLj = mu.analyze_mflu_unsym(A), ref_mu.analyze_mflu_unsym(Aj)
    for f in ("rowpre", "home", "enter", "nforeign"):
        assert np.array_equal(getattr(SL, f), getattr(SLj, f)), f
    assert np.array_equal(SL.SQ.q, SLj.SQ.q)
    assert len(SL.front_rows) == len(SLj.front_rows) == SL.SQ.S.nsuper
    assert all(np.array_equal(a, b)
               for a, b in zip(SL.front_rows, SLj.front_rows))


def _overfull(SL, SLj, nrhs):
    """Foreign rows added to one front of both analyses until they
    outnumber its columns (K > N in its group): rows homed at the root and
    on no front of the path from a front with a parent up to the root
    transit every front of that path. The analysis never yields this (a
    foreign row's home column lies in the front's pattern); both plans
    and the sweep handle it."""
    S = SL.SQ.S
    root = int(np.flatnonzero(S.sparent == -1)[-1])
    f0 = int(S.super_first[root])
    for s in range(S.nsuper):
        path = [s]
        while S.sparent[path[-1]] not in (-1, root):
            path.append(int(S.sparent[path[-1]]))
        if S.sparent[path[-1]] != root:
            continue
        nc, w = S.ncols(s), len(S.rows[s]) - S.ncols(s)
        Cg = mu._pad8(nc, lo=4)
        on_path = set(np.concatenate([SL.front_rows[p] for p in path]))
        extra = [int(r) for r in SL.SQ.q[f0:f0 + S.ncols(root)]
                 if int(r) not in on_path]
        need = Cg + mu._pad8(w + nrhs) + 1 - nc - int(SL.nforeign[s])
        if need <= 0 or len(extra) < need:
            continue
        for X in (SL, SLj):
            X.front_rows = list(X.front_rows)
            X.nforeign = X.nforeign.copy()
            for p in path:
                X.front_rows[p] = np.concatenate(
                    [X.front_rows[p], np.asarray(extra[:need], np.int64)])
                X.nforeign[p] += need
        return s
    raise AssertionError("no front to overfill")


def _plans(name, nrhs, overfull=False):
    A, Aj = both(name)
    SL, SLj = mu.analyze_mflu_unsym(A), ref_mu.analyze_mflu_unsym(Aj)
    if overfull:
        _overfull(SL, SLj, nrhs)
    P = mu.build_lu_unsym_plan(SL, A.permuted(SL.rowpre, SL.SQ.q), nrhs)
    Pj = ref_mu.build_lu_unsym_plan(SLj, Aj.permuted(SLj.rowpre, SLj.SQ.q),
                                    nrhs)
    return A, SL, P, Aj, SLj, Pj


def assert_plans_equal(P, Pj):
    assert (P.pool_data, P.pool_size, P.nrhs, P.n) == \
        (Pj.pool_data, Pj.pool_size, Pj.nrhs, Pj.n)
    assert [len(gl) for gl in P.groups] == [len(gl) for gl in Pj.groups]
    for g, gj in zip((g for gl in P.groups for g in gl),
                     (g for gl in Pj.groups for g in gl)):
        assert (g.M, g.N, g.K, g.B, g.panel_base, g.Cg) == \
            (gj.M, gj.N, gj.K, gj.B, gj.panel_base, gj.Cg)
        for f in ("snodes", "asrc", "adst", "nc", "fm", "col_idx", "row_col"):
            assert np.array_equal(getattr(g, f), getattr(gj, f)), f
        # the reference's float masks, as the port's positions
        b, c, j = np.nonzero(gj.rhs_onehot)
        assert np.array_equal(g.rhs_col[b, j], c)
        assert np.array_equal(np.sort(g.beyond),
                              np.flatnonzero(gj.beyond[:, 0, :].ravel()))
        assert len(g.pairs) == len(gj.pairs)
        for p, pj in zip(g.pairs, gj.pairs):
            assert p[:4] == pj[:4]
            assert all(np.array_equal(a, b) for a, b in zip(p[4:], pj[4:]))


@pytest.mark.parametrize("nrhs", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_plan_equals_the_reference(name, nrhs):
    _reference_native()
    *_, P, _Aj, _SLj, Pj = _plans(name, nrhs)
    assert_plans_equal(P, Pj)


def test_overfull_plan_equals_the_reference_and_its_sweep_pads(monkeypatch):
    """A group with K > N: the plans agree, and the sweep (R11 padded
    with zero columns past N) gives the reference's ``_qr_solve_sweep``
    on the same random panels. (The added rows reach the root twice, so
    the plan has no factor: the upload's gather index is stubbed.)"""
    _reference_native()
    A, SL, P, _Aj, _SLj, Pj = _plans("rand1", 1, overfull=True)
    assert_plans_equal(P, Pj)
    assert any(g.K > g.N for gl in P.groups for g in gl)
    rng = np.random.default_rng(5)
    pool = np.zeros(P.pool_size)
    pool[P.pool_data:] = 0.1 * rng.standard_normal(P.pool_size - P.pool_data)
    for gl in P.groups:
        for g in gl:
            R = pool[g.panel_base:g.panel_base + g.B * g.K * g.N] \
                .reshape(g.B, g.K, g.N)        # a view: diagonals set in place
            for b in range(g.B):
                R[b, np.arange(g.nc[b]), np.arange(g.nc[b])] += 2.0
    monkeypatch.setattr(md, "gather_index",
                        lambda plan, g: np.zeros(g.B * g.M * g.N, np.int64))
    dp = md._upload(md.QRDevicePlan(plan=P, device=torch.device("cpu"),
                                    host=md._host_arrays(P)))
    F = md.MFQRDeviceFactor(SQ=SL.SQ, dplan=dp, pool=torch.from_numpy(pool),
                            ok=True, precision="highest", groups=dp.groups)
    x = md.qr_solve_device(F)
    xj = np.asarray(ref_md._qr_solve_sweep(
        Pj, SL.SQ.S, jnp.asarray(pool[P.pool_data:]), jnp.float64))
    xout = np.empty_like(xj)
    xout[SL.SQ.q] = xj
    assert np.abs(x - xout).max() <= 1e-12 * np.abs(xout).max()


@pytest.mark.parametrize("name", ["fem6", "upwind8", "rand2"])
def test_one_gather_assembles_what_the_reference_places(name):
    """Every front cell has at most one source, and ``pool[gidx]`` equals
    the reference's assembly (A and b entries set, then each child's
    contribution rows added through its row and column maps) on a pool of
    random values."""
    *_, P, _Aj, _SLj, _Pj = _plans(name, 2)
    rng = np.random.default_rng(0)
    pool = rng.standard_normal(P.pool_size)
    pool[P.pool_data - 1] = 0.0
    for gl in P.groups:
        for g in gl:
            gidx = md.gather_index(P, g)
            F = np.zeros(g.B * g.M * g.N)
            F[g.adst] = pool[g.asrc]
            F = F.reshape(g.B, g.M, g.N)
            for dc, gc, Kc, Nc, psrc, pdst, rowmap, colmap in g.pairs:
                base = P.groups[dc][gc].panel_base
                child = pool[base:base + P.groups[dc][gc].B * Kc * Nc] \
                    .reshape(-1, Kc, Nc)
                for p in range(psrc.size):
                    rr = np.flatnonzero(rowmap[p] >= 0)
                    cc = np.flatnonzero(colmap[p] >= 0)
                    F[pdst[p]][np.ix_(rowmap[p][rr], colmap[p][cc])] += \
                        child[psrc[p]][np.ix_(rr, cc)]
            assert np.array_equal(pool[gidx].reshape(F.shape), F)


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lu_perm_equals_lax_lu(dtype, singular):
    """Home blocks of 5 slots, 24 columns, live on their first nc and dead
    unit pivots after (one slot with an exactly singular live block): the
    permutation of the swaps equals ``lax.linalg.lu``'s, and partial
    pivoting never takes a dead row."""
    rng = np.random.default_rng(3)
    B, Cg = 5, 24
    nc = np.array([24, 20, 13, 7, 1])
    H = rng.standard_normal((B, Cg, Cg))
    for b in range(B):
        H[b, nc[b]:, :] = 0.0
        H[b, :, nc[b]:] = 0.0
        H[b, np.arange(nc[b], Cg), np.arange(nc[b], Cg)] = 1.0
    if singular:
        H[1, 3, :] = 2.0 * H[1, 0, :]
        H[1, :, 5] = 0.0
    H = H.astype(dtype)
    LU, piv, info = torch.linalg.lu_factor_ex(torch.from_numpy(H))
    perm = mu.lu_perm(LU, piv).numpy()
    assert np.array_equal(perm, np.asarray(jax.lax.linalg.lu(
        jnp.asarray(H))[2]))
    assert (int(info[1]) > 0) == singular
    for b in range(B):
        assert np.array_equal(np.sort(perm[b, :nc[b]]), np.arange(nc[b]))


def _row_slices(flat, plan, SL):
    """The stored rows the sweep and the parents read, per front: the U
    rows and the contribution rows (nc + nforeign of them)."""
    for gl in plan.groups:
        for g in gl:
            o = g.panel_base - plan.pool_data
            R = np.asarray(flat[o:o + g.B * g.K * g.N], np.float64) \
                .reshape(g.B, g.K, g.N)
            for b, s in enumerate(g.snodes):
                yield R[b, :g.nc[b] + SL.nforeign[s]]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-4)])
@pytest.mark.parametrize("name", NAMES)
def test_panels_equal_the_reference(name, dtype, tol):
    _reference_native()
    A, SL, P, Aj, SLj, Pj = _plans(name, 2)
    b = np.random.default_rng(1).standard_normal((A.nrow, 2))
    F = mu.factorize_lu_unsym_device(A, SL, b,
                                     CFG64.replace(compute_dtype=dtype),
                                     device="cpu")
    assert F.ok and F.pool.dtype == getattr(torch, dtype)
    ad = jnp.asarray(Aj.permuted(SLj.rowpre, SLj.SQ.q).data)
    run = jax.jit(lambda a, bf: ref_mu._run_lu_unsym_plan(
        Pj, a, bf, getattr(jnp, dtype), tau_rel=1e-6))
    want = np.asarray(run(ad, jnp.asarray(b[SLj.rowpre].ravel())))
    n_rows = 0
    for R, Rw in zip(_row_slices(F.panels.numpy(), P, SL),
                     _row_slices(want, P, SL)):
        scale = max(np.abs(Rw).max(initial=0.0), 1e-300)
        assert np.abs(R - Rw).max(initial=0.0) <= tol * scale
        n_rows += R.shape[0]
    assert n_rows == A.ncol + int(SL.nforeign.sum())


@pytest.mark.parametrize("name", NAMES)
def test_solution_equals_the_reference(name):
    _reference_native()
    A, Aj = both(name)
    b = np.random.default_rng(2).standard_normal(A.nrow)
    x = mu.lu_unsym_solve_device(A, b, CFG64, device="cpu")
    xj = ref_mu.lu_unsym_solve_device(Aj, b, REF64)
    assert x.shape == (A.ncol,)
    assert np.allclose(x, xj, atol=1e-8)
    assert np.allclose(x, np.linalg.solve(A.to_dense(), b), atol=1e-8)


def test_multi_rhs_and_plan_cache():
    """``tests/test_mflu_unsym.py``'s multi-RHS case; the plan is cached on
    the analysis per nrhs, the value map once."""
    D = rand_unsym(40, 0.12, 5)
    A = sstt.sparse.from_dense(D)
    B = np.random.default_rng(6).standard_normal((40, 3))
    SL = mu.analyze_mflu_unsym(A)
    X = mu.lu_unsym_solve_device(A, B, SL=SL, device="cpu")
    assert X.shape == (40, 3)
    assert np.abs(D @ X - B).max() < 1e-3
    plan3, vmap = SL._torch_lu[1], SL._vmap
    X64 = mu.lu_unsym_solve_device(A, B, CFG64, SL=SL, device="cpu")
    assert SL._torch_lu[1] is plan3 and SL._vmap is vmap
    assert np.allclose(X64, np.linalg.solve(D, B), atol=1e-10)
    x = mu.lu_unsym_solve_device(A, B[:, 1], CFG64, SL=SL, device="cpu")
    assert SL._torch_lu[0][0] == 1 and SL._vmap is vmap
    assert np.allclose(x, X64[:, 1], atol=1e-12)


def _ladder(A, b, cfg=sstt.DEFAULT):
    """x, the rung that answered and the device factors it ran."""
    rungs, calls = dict(mu.rungs), mu.device_factors
    x = mu.mflusol_unsym(A, b, cfg, device="cpu")
    moved = [k for k in rungs if mu.rungs[k] != rungs[k]]
    assert len(moved) == 1 and mu.rungs[moved[0]] == rungs[moved[0]] + 1
    return x, moved[0], mu.device_factors - calls


@pytest.mark.parametrize("case", RANDOM)
def test_mflusol_unsym_random(case):
    """fp32 device factor < 1e-4, the ladder < 1e-10 on the LU rung, which
    refines with whole factors: 3 device factors at ir_steps = 2."""
    D = rand_unsym(*case)
    A = sstt.sparse.from_dense(D)
    b = np.random.default_rng(case[2] + 10).standard_normal(case[0])
    x = mu.lu_unsym_solve_device(A, b, device="cpu")
    assert sstt.residual_norm(A, x, b) < 1e-4
    x2, rung, factors = _ladder(A, b)
    assert sstt.residual_norm(A, x2, b) < 1e-10
    assert rung == "lu" and factors == 3
    xj = ref_mu.mflusol_unsym(sst.sparse.from_dense(D), b)
    assert np.allclose(x2, xj, atol=1e-10)


def test_singular_home_block_repaired_by_the_device_qr(monkeypatch):
    """``tests/test_mflu_unsym.py``'s manufactured case: the home block of
    a mid-tree front made EXACTLY singular while A stays well conditioned.
    The LU's zero pivot is bumped without an exception; where refinement
    stalls (as it does in the reference on the same seeds) the device QR
    rung answers, always below 1e-12; the host LU never runs."""
    klu0, qr0 = mu.rungs["klu"], mu.rungs["qr"]
    ntot = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = 60
        M = np.where(rng.random((n, n)) < 0.08,
                     rng.standard_normal((n, n)), 0.0) \
            + np.diag(rng.random(n) + 1)
        A = sstt.sparse.from_dense(M)
        SL = mu.analyze_mflu_unsym(A)
        S = SL.SQ.S
        target = None
        for s in range(S.nsuper):
            if S.ncols(s) >= 3 and S.sparent[s] != -1:
                target = s
        if target is None:
            continue
        s = target
        hr = SL.front_rows[s][:S.ncols(s)]
        orig_rows = [SL.rowpre[int(r)] for r in hr]
        cols = [int(SL.SQ.q[S.super_first[s] + k]) for k in range(S.ncols(s))]
        M2 = M.copy()
        M2[orig_rows[1], cols] = 2.0 * M2[orig_rows[0], cols]
        M2[orig_rows[2], cols] = -3.0 * M2[orig_rows[0], cols]
        if np.linalg.cond(M2) > 1e10:
            continue
        ntot += 1
        A2 = sstt.sparse.from_dense(M2)
        b = M2 @ np.ones(n)
        x, rung, _ = _ladder(A2, b)
        assert sstt.residual_norm(A2, x, b) < 1e-12, seed
        calls = []
        orig = ref_md.mfqrsol_device
        monkeypatch.setattr(ref_md, "mfqrsol_device",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        ref_mu.mflusol_unsym(sst.sparse.from_dense(M2), b)
        monkeypatch.setattr(ref_md, "mfqrsol_device", orig)
        assert rung == ("qr" if calls else "lu"), seed
    assert ntot >= 3
    assert mu.rungs["qr"] >= qr0 + 2
    assert mu.rungs["klu"] == klu0


def test_tiny_diagonal_stays_on_the_lu_rung():
    """A structural transversal would pick 1e-14 pivots; the weighted
    matching avoids them: no rung past the LU."""
    rng = np.random.default_rng(0)
    n = 60
    M = np.where(rng.random((n, n)) < 0.1, rng.standard_normal((n, n)), 0.0) \
        + np.diag(np.full(n, 1e-14))
    A = sstt.sparse.from_dense(M)
    b = M @ np.ones(n)
    x, rung, _ = _ladder(A, b)
    assert sstt.residual_norm(A, x, b) < 1e-10
    assert rung == "lu"


def test_structurally_singular_falls_to_the_host_lu():
    """No full transversal: the analysis raises ``ValueError``, the QR
    rung's panels are non-finite, and the host LU answers (and reports
    the singular factor as the reference's does, by raising)."""
    D = rand_unsym(20, 0.2, 4)
    D[:, 7] = 0.0
    D[:, 11] = 0.0
    A = sstt.sparse.from_dense(D)
    with pytest.raises(ValueError, match="structurally singular"):
        mu.analyze_mflu_unsym(A)
    klu0 = mu.rungs["klu"]
    with pytest.raises(ValueError, match="singular"):
        mu.mflusol_unsym(A, np.ones(20), device="cpu")
    assert mu.rungs["klu"] == klu0 + 1


@pytest.mark.parametrize("name,strategy", [("fem6", "symmetric"),
                                           ("upwind8", "unsymmetric")])
def test_router_picks_the_reference_strategy(name, strategy, monkeypatch):
    """``mflusol`` on the FEM matrix (symmetric pattern) takes the host
    symmetric strategy, on the upwind one the device LU, as the
    reference's does; both solve."""
    A, Aj = both(name)
    b = np.ones(A.ncol)
    seen = []
    orig = ref_mu.mflusol_unsym
    monkeypatch.setattr(ref_mu, "mflusol_unsym",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    xj = ref_ml.mflusol(Aj, b)
    calls = mu.device_factors
    x = ml.mflusol(A, b, device="cpu")
    took = "unsymmetric" if mu.device_factors > calls else "symmetric"
    assert took == strategy == ("unsymmetric" if seen else "symmetric")
    assert sstt.residual_norm(A, x, b) < 1e-10
    assert np.allclose(x, xj, atol=1e-8)


@pytest.mark.parametrize("name", ["upwind8", "rand0"])
def test_find_singletons_equals_the_reference(name):
    A, Aj = both(name)
    D = A.to_dense()
    D[:, 3] = 0.0
    D[3, 3] = 1.0                      # a column singleton
    D[5, :] = 0.0
    D[5, 5] = 2.0                      # a row singleton
    A, Aj = sstt.sparse.from_dense(D), sst.sparse.from_dense(D)
    got, want = ml.find_singletons(A), ref_ml.find_singletons(Aj)
    assert got[0] == want[0] and len(got[0]) >= 2
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])


def test_complex_input_and_the_segmented_switch_raise(monkeypatch):
    """Complex input, once refused, now solves (through the 2x2 real
    embedding on the device routes, the host KLU's complex kernel in
    ``lusol``); the device factor itself refuses it and names
    ``mflusol_unsym``. The segmented switch, which raised once, now runs
    the plan in segments: a tiny ``segment_bytes`` answers through
    ``lu_unsym_solve_device`` and ``mflusol_unsym``, equal to the
    one-piece factor's."""
    D = rand_unsym(30, 0.15, 1)
    A = sstt.sparse.from_dense(D)
    Ac = sstt.CSC(A.nrow, A.ncol, A.indptr, A.indices, A.data * (1 + 1j), 0)
    b = np.ones(30) + 1j * np.arange(30) / 30
    for call in (lambda: mu.mflusol_unsym(Ac, b, device="cpu"),
                 lambda: ml.mflusol(Ac, b, device="cpu"),
                 lambda: sstt.lusol(Ac, b)):
        x = call()
        assert np.abs(D * (1 + 1j) @ x - b).max() < 1e-10 * np.abs(b).max()
    with pytest.raises(ValueError, match="mflusol_unsym"):
        mu.lu_unsym_solve_device(A, np.ones(30) * 1j, device="cpu")
    tiny = sstt.DEFAULT.replace(segment_bytes=1)
    seg0 = mu.segmented_factors
    x1 = mu.lu_unsym_solve_device(A, np.ones(30), device="cpu")
    xs = mu.lu_unsym_solve_device(A, np.ones(30), tiny, device="cpu")
    assert mu.segmented_factors == seg0 + 1
    assert np.array_equal(xs, x1)
    assert np.abs(D @ xs - 1.0).max() < 1e-3
    x2 = mu.mflusol_unsym(A, np.ones(30), device="cpu")
    xs2 = mu.mflusol_unsym(A, np.ones(30), tiny, device="cpu")
    assert mu.segmented_factors > seg0 + 1
    assert np.array_equal(xs2, x2)
    assert sstt.residual_norm(A, xs2, np.ones(30)) < 1e-10


def test_plan_cells_and_flops():
    A, Aj = both("fem6")
    SL = mu.analyze_mflu_unsym(A)
    P = mu.build_lu_unsym_plan(SL, A.permuted(SL.rowpre, SL.SQ.q), 1)
    from suitesparse_tpu.numeric.segmented import qrplan_total_cells
    SLj = ref_mu.analyze_mflu_unsym(Aj)
    Pj = ref_mu.build_lu_unsym_plan(SLj, Aj.permuted(SLj.rowpre, SLj.SQ.q), 1)
    assert mu.plan_cells(P) == qrplan_total_cells(Pj)
    S = SL.SQ.S
    total = 0.0
    for s in range(S.nsuper):
        m, nf = S.ncols(s) + SL.nforeign[s], len(S.rows[s])
        total += sum(2.0 * (m - k - 1) * (nf - k) for k in range(S.ncols(s)))
    assert mu.lu_flops(SL) == pytest.approx(total, rel=1e-12)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    A = sstt.sparse.from_dense(rand_unsym(30, 0.15, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        mu.lu_unsym_solve_device(A, np.ones(30))
    assert port_lu.lusol(A, np.ones(30)).shape == (30,)
