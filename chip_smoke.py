#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (suitesparse_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``suitesparse_tpu_torch/kernels/csrc``.
2. Kernel phase: builds the plans of the 3-D Laplacian model problem
   ``laplacian_3d(50)`` (n = 125,000, nested dissection) and of a forest of
   512 independent ``laplacian_3d(6)`` blocks (n = 110,592), and runs each
   kernel and its plain PyTorch version on the card at the shapes those
   plans give it, from a numpy seed: potrf_trsm (K1) at the three largest
   groups of its gate, the tiled extend-add (K2) on the largest tile
   manifest, the solve steps (K3, forward and backward) at the four largest
   groups of their gate at 1 and 64 right-hand sides, the batched trisolve
   (K4) at the forest's (512, 64) root group and the (45, 48) L11 shape,
   plain and transposed, at 1 and 64 right-hand sides; the two-piece
   extend-add (K2b) on the two-piece manifest of K2's group, timed in turns
   with K2 on the same inputs; the streaming panel matvec (K5) at the four
   largest groups of its w2 route, with M = W2^T and M = W2, and the
   batched matvec (K6) at the four largest groups of its route, forward and
   transposed, both at 1 and 8 right-hand sides, and at three shapes off
   the plan's ladders at 1 and 3 (``K6_OFF_PLAN``: one whose rows take K6's
   plain-load path, one of few long panels that takes its cluster and its
   ring of stages, one of wide panels whose forward X (at NR 3) stays in
   device memory and whose transposed columns span several blocks); the
   extend-add (K7) on
   three pair classes of the factor's slowest placement group,
   (B, R) = (114, 224), padded by ``pad_pairs``. Tolerances, relative to the largest plain entry (fp32
   sums in another order): 1e-5, 1e-6 for K2 and K2b. Each kernel's time is
   printed beside its plain version's, the least time the card could take
   (bytes at 3.35 TB/s or fp32 flops at 67 TFLOP/s, whichever is larger; a
   triangular tile counts its lower triangle only) and one PyTorch call
   that computes the same function where there is one (and the kernel's
   time over that call's):
   ``torch.linalg.solve_triangular`` for K4, ``torch.bmm`` for K5 and K6,
   the factor's ``_place`` (one ``index_put_``, on the class's real pairs)
   for K7. K5, K6 and their library calls are timed with the L2 cache
   flushed before each call, as a sweep finds its panels. Every call is
   timed on the device alone: a spin kernel holds the device while the
   host enqueues the call.
3. Main path: ``analyze`` -> ``factorize`` -> ``solve`` (1 and 64
   right-hand sides, w2 sweep) through the package's entry points on the
   card. K1 and K2 must launch during the factorization; residuals must
   stay below 1e-5. ``solve_mode="auto"`` must pick w2 on the fresh factor
   and classic once the reported free memory leaves no room for W2. Also a
   small problem whose card factor must match the
   CPU factor entry by entry and whose solution must match the host
   simplicial solve.
4. Classic sweep: the same factor solved with ``solve_mode="classic"`` at 1
   and 64 right-hand sides; K3 must launch, residuals below 1e-5, x within
   1e-4 * max|x| of the w2 solve's x.
5. Forest: the 512-block forest through ``cholsol`` with
   ``solve_mode="classic"`` and ``factor_kind=SUPERNODAL_LL`` (its
   flops per nonzero of L, 28.6, sit below the automatic supernodal switch
   of 40); K3 and K4 must launch, residual below 1e-5.
6. Refinement: ``solve_refined`` on the model problem, residual below 1e-12.
7. Kernel path: the model problem factored with ``tile_pair=True`` (K2b and
   K1 must launch, L within 1e-5 * max|L| of the default factor's), then
   solved through the w2 sweep with ``solve_pmv=True, solve_bmv=True`` at
   1 and 8 right-hand sides (K5 and both K6 kernels must launch, residuals
   below 1e-5, x within 1e-4 * max|x| of the default w2 solve's x), each
   timed beside the default.

Every kernel count is set to 0 just before each path and read just after;
K7, which no path runs, reports the launches of its kernel phase.
Any failure raises (exit code != 0). Without a CUDA device the script exits
with code 2 before doing anything. The last line is the device JSON.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np

K1_TOL = 1e-5
K2_TOL = 1e-6
K34_TOL = 1e-5
K567_TOL = 1e-5
RESID_TOL = 1e-5
REFINED_TOL = 1e-12
SEED = 0
SIZE = 50          # laplacian_3d(50): n = 125,000, the model problem
FOREST = (512, 6)  # 512 blocks of laplacian_3d(6): n = 110,592
NRHS = 64
NRHS_K = 8         # right-hand sides of the w2 kernel routes (K5, K6)
K7_GROUP = (114, 224)   # (B, R) of the factor's slowest placement group
K7_CLASSES = ((75, 128), (15, 168), (59, 64))   # its (npairs, RU) classes
# (B, R, C) of K6 off the plan's ladders, at 1 and 3 right-hand sides: rows
# that are not 16-byte multiples (plain loads); few long panels
# (transposed: a cluster of 8 blocks a panel, a ring of stages); wide
# panels (forward: slices of each row, a ring, X read from device memory
# at NR 3; transposed: 24 column tiles)
K6_OFF_PLAN = ((37, 45, 13), (4, 6000, 52), (16, 16, 6000))
L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2 cache
SPIN_CYCLES = 2_000_000  # about 1 ms of device spin before each timed call
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOP_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
SRC = "suitesparse_tpu_torch/kernels/csrc/"


def _cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds per call of fn(*setup()) (after one warm
    call), timed with CUDA events around each call. A spin kernel queued
    just before the start event keeps the device busy while the host
    enqueues the call, so a call whose host side takes less than the spin
    is timed without its launch overhead. Python's garbage collector is
    held off meanwhile: a host stall between the two events that outlasts
    the spin would be timed as device time."""
    import torch

    fn(*(setup() if setup else ()))
    total = 0.0
    gc.disable()
    try:
        for _ in range(reps):
            args = setup() if setup else ()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
    finally:
        gc.enable()
    return total / reps


def _best_s(fn, reps: int = 3) -> float:
    """Minimum seconds of reps calls (CUDA events, after a warm call)."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel_err(got, ref) -> tuple[float, float]:
    """(max abs difference, that over the largest plain entry)."""
    d = (got - ref).abs().max().item()
    return d, d / ref.abs().max().item()


def _record(rec, name, shape, err, dabs, ms, plain_ms, nbytes, flops,
            library_ms=None, tol=K34_TOL):
    """Print one kernel measurement, check it against ``tol`` and fold it
    into ``rec[name]`` (largest errors; the first shape is the reported
    one)."""
    bound_ms, bound_by = _bound(nbytes, flops)
    lib = "" if library_ms is None else \
        f" library_ms={library_ms:.4f} kernel/library={ms / library_ms:.2f}"
    print(f"{name} {shape} rel_err={err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({bound_by}){lib}", flush=True)
    assert np.isfinite(err) and err <= tol, \
        f"{name} disagrees at {shape}: {err}"
    r = rec.setdefault(name, {"err": 0.0, "abs": 0.0})
    r["err"], r["abs"] = max(r["err"], err), max(r["abs"], dabs)
    if "ms" not in r:
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms, shape=shape)


def forest(k: int, nx: int):
    """k independent copies of laplacian_3d(nx) on the block diagonal: the
    many-subdomain systems (block Jacobi, domain decomposition) whose
    solve tree is a forest."""
    import suitesparse_tpu_torch as sstt

    A = sstt.fixtures.laplacian_3d(nx)
    n = A.ncol
    cols = np.repeat(np.arange(n), np.diff(A.indptr))
    return sstt.from_triplets(
        k * n, k * n, np.concatenate([A.indices + i * n for i in range(k)]),
        np.concatenate([cols + i * n for i in range(k)]), np.tile(A.data, k),
        sym=1)


def factor_kernels(dp, dpp, dev, rng):
    """K1, K2 and K2b against their plain versions on the model plan
    (``dpp``: the same plan with two-piece manifests)."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add_tiles import (
        TILE, extend_add_tiles, extend_add_tiles_plain)
    from suitesparse_tpu_torch.kernels.potrf import (
        potrf_trsm, potrf_trsm_plain)
    from suitesparse_tpu_torch.numeric.supernodal_device import \
        _use_potrf_kernel

    groups = [g for gl in dp.plan.groups for g in gl]
    k1_groups = sorted((g for g in groups
                        if _use_potrf_kernel(torch.float32, g.B, g.C)),
                       key=lambda g: g.B * g.R * g.C, reverse=True)[:3]
    assert k1_groups, "no group passes the potrf_trsm gate"
    k1 = {"err": 0.0, "abs": 0.0}
    for i, g in enumerate(k1_groups):
        B, C, RU = g.B, g.C, g.R - g.C
        M = rng.standard_normal((B, C, C), dtype=np.float32)
        f11 = torch.as_tensor(M @ np.swapaxes(M, 1, 2)
                              + C * np.eye(C, dtype=np.float32), device=dev)
        f21 = torch.as_tensor(rng.standard_normal((B, RU, C),
                                                  dtype=np.float32),
                              device=dev) if RU else None
        L11, L21 = potrf_trsm(f11, f21)
        P11, P21 = potrf_trsm_plain(f11, f21)
        torch.cuda.synchronize()
        d11, err = _rel_err(L11, P11)
        if RU:
            d21, e21 = _rel_err(L21, P21)
            err, d11 = max(err, e21), max(d11, d21)
        assert np.isfinite(err) and err <= K1_TOL, \
            f"potrf_trsm disagrees at (B,C,RU)=({B},{C},{RU}): {err}"
        ms = _cuda_ms(lambda: potrf_trsm(f11, f21), 10)
        plain_ms = _cuda_ms(lambda: potrf_trsm_plain(f11, f21), 2)
        # F11 read and L11 written as lower triangles, F21 read, L21 written
        bound_ms, bound_by = _bound(4.0 * B * (C * (C + 1) + 2 * RU * C),
                                    B * (C ** 3 / 3 + RU * C * C))
        print(f"potrf_trsm (B,C,RU)=({B},{C},{RU}) rel_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        k1["err"] = max(k1["err"], err)
        k1["abs"] = max(k1["abs"], d11)
        if i == 0:
            k1.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)

    # K2 on the largest one-piece manifest, K2b on the two-piece manifest of
    # the same group, same inputs; timed in turns (K2, K2b, K2b, K2)
    ti = max((i for i, g in enumerate(groups) if g._tile is not None),
             key=lambda i: groups[i]._tile.man.shape[0])
    tg = groups[ti]
    pg = [g for gl in dpp.plan.groups for g in gl][ti]
    tm, pm = tg._tile, pg._tile
    assert (pg.B, pg.R, pm.nslots, pm.RUp) == (tg.B, tg.R, tm.nslots, tm.RUp)
    assert tm.man.shape[1] == 10 and pm.man.shape[1] == 14
    F0 = torch.as_tensor(rng.standard_normal((tg.B, tg.R, tg.R),
                                             dtype=np.float32), device=dev)
    U = rng.standard_normal((max(tm.nslots, 1), tm.RUp, tm.RUp),
                            dtype=np.float32)
    upper = np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)
    U[(rng.random(U.shape, dtype=np.float32) < 0.05) & upper] = np.nan
    U = torch.as_tensor(U, device=dev)
    pieces = {"extend_add_tiles": tg, "extend_add_tiles_pair": pg}
    rec, args, out = {}, {}, {}
    for name, g in pieces.items():
        args[name] = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                           for a in (g._tile.man, g._tile.rowmap,
                                     g._tile.colmap, g._tile_runs))
        out[name] = extend_add_tiles(F0.clone(), U, *args[name])
        Fp = extend_add_tiles_plain(F0.clone(), U, *args[name][:3])
        torch.cuda.synchronize()
        d, e = _rel_err(out[name], Fp)
        assert np.isfinite(e) and e <= K2_TOL, f"{name} disagrees: {e}"
        bound_ms, bound_by = _tile_bound(g)
        rec[name] = {"err": e, "abs": d, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "plain_ms": _cuda_ms(
                         lambda F: extend_add_tiles_plain(
                             F, U, *args[name][:3]), 3,
                         setup=lambda: (F0.clone(),))}
    ms = {name: [] for name in pieces}
    for name in ("extend_add_tiles", "extend_add_tiles_pair",
                 "extend_add_tiles_pair", "extend_add_tiles"):
        ms[name].append(_cuda_ms(
            lambda F: extend_add_tiles(F, U, *args[name]), 10,
            setup=lambda: (F0.clone(),)))
    for name, g in pieces.items():
        r = rec[name]
        r["ms"] = sum(ms[name]) / len(ms[name])
        print(f"{name} (B,R)=({g.B},{g.R}) steps={g._tile.man.shape[0]} "
              f"tiles={len(g._tile_runs) - 1} RUp={g._tile.RUp} "
              f"rel_err={r['err']:.3e} kernel_ms={r['ms']:.4f} "
              f"(in turns: {ms[name][0]:.4f}, {ms[name][1]:.4f}) "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    same = torch.equal(*out.values())
    print(f"two-piece result equals one-piece result bit for bit: {same}",
          flush=True)
    return k1, rec["extend_add_tiles"], rec["extend_add_tiles_pair"]


def _tile_bound(g) -> tuple[float, str]:
    """The bound of a manifest's extend-add: each piece reads its valid
    child cells and adds them once; each visited tile of F is read and
    written once; the step table and the maps are read once."""
    from suitesparse_tpu_torch.kernels.extend_add_tiles import TILE

    tm = g._tile
    piece_cells = float(((tm.rowmap >= 0).sum(2)
                         * (tm.colmap >= 0).sum(2)).sum())
    starts = tm.man[g._tile_runs[:-1]]
    tile_cells = float((np.minimum(TILE, g.R - starts[:, 1] * TILE)
                        * np.minimum(TILE, g.R - starts[:, 2] * TILE)).sum())
    return _bound(4.0 * piece_cells + 8.0 * tile_cells + 4.0 * tm.man.size
                  + 4.0 * (tm.rowmap.size + tm.colmap.size), piece_cells)


def _tri_tiles(rng, B, C, dev):
    """B well-conditioned lower tiles: diagonal in [1, 2], off-diagonal
    entries below 1/C."""
    import torch

    L = np.tril(rng.uniform(-1.0, 1.0, (B, C, C)) / C, -1)
    L += np.eye(C) * rng.uniform(1.0, 2.0, (B, 1, C))
    return torch.as_tensor(L.astype(np.float32), device=dev)


def solve_kernels(dp, dpf, dev, rng):
    """K3 (forward, backward) and K4 against their plain versions at the
    shapes of the model plan and the forest plan."""
    import torch

    from suitesparse_tpu_torch.kernels.solve_step import (
        solve_step_bwd, solve_step_bwd_plain, solve_step_fwd,
        solve_step_fwd_plain)
    from suitesparse_tpu_torch.kernels.trisolve import (
        batched_trisolve, batched_trisolve_plain)
    from suitesparse_tpu_torch.numeric.supernodal_solve import classic_route

    rec: dict = {}
    groups = [g for gl in dp.plan.groups for g in gl]
    k3 = sorted((g for g in groups if classic_route(
        torch.float32, g.B, g.C, g.R - g.C, 1) == "solve_step"),
        key=lambda g: g.B * g.R * g.C, reverse=True)[:4]
    assert len(k3) == 4, "fewer than four groups pass the solve_step gate"
    for g in k3:
        B, R, C, RU = g.B, g.R, g.C, g.R - g.C
        # L21 and the (B, RU, NR) vectors as the sweep passes them: views
        # into a packed (B, R, C) panel and a (B, R, NR) work buffer
        P = torch.empty(B, R, C, device=dev)
        L11 = _tri_tiles(rng, B, C, dev)
        P[:, C:] = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, RU, C))
                                   .astype(np.float32) / C, device=dev)
        L21 = P[:, C:]
        for nr in (1, NRHS):
            Y = torch.as_tensor(rng.standard_normal((B, C, nr),
                                                    dtype=np.float32),
                                device=dev)
            W = torch.as_tensor(rng.standard_normal((B, R, nr),
                                                    dtype=np.float32),
                                device=dev)
            WB = W[:, C:]
            shape = f"(B,C,RU,NR)=({B},{C},{RU},{nr})"
            # L11's lower triangle and L21, read once
            io = 4.0 * B * (C * (C + 1) / 2 + RU * C)
            flops = float(B * nr * (C * C + 2 * RU * C))
            xc, v = solve_step_fwd(L11, L21, Y, WB)
            pxc, pv = solve_step_fwd_plain(L11, L21, Y, WB)
            torch.cuda.synchronize()
            d1, e1 = _rel_err(xc, pxc)
            d2, e2 = _rel_err(v, pv)
            _record(
                rec, "solve_step_fwd", shape, max(e1, e2), max(d1, d2),
                _cuda_ms(lambda: solve_step_fwd(L11, L21, Y, WB), 10),
                _cuda_ms(lambda: solve_step_fwd_plain(L11, L21, Y, WB), 2),
                io + 8.0 * (B * C * nr + B * RU * nr), flops)
            xb = solve_step_bwd(L11, L21, Y, WB)
            pxb = solve_step_bwd_plain(L11, L21, Y, WB)
            torch.cuda.synchronize()
            d, e = _rel_err(xb, pxb)
            _record(
                rec, "solve_step_bwd", shape, e, d,
                _cuda_ms(lambda: solve_step_bwd(L11, L21, Y, WB), 10),
                _cuda_ms(lambda: solve_step_bwd_plain(L11, L21, Y, WB), 2),
                io + 4.0 * (2 * B * C * nr + B * RU * nr), flops)

    root = [g for gl in dpf.plan.groups for g in gl
            if classic_route(torch.float32, g.B, g.C, g.R - g.C, 1)
            == "trisolve"]
    assert [(g.B, g.C) for g in root] == [(FOREST[0], 64)], root
    for B, C in ((FOREST[0], 64), (45, 48)):
        L = _tri_tiles(rng, B, C, dev)
        for nr in (1, NRHS):
            Y = torch.as_tensor(rng.standard_normal((B, C, nr),
                                                    dtype=np.float32),
                                device=dev)
            for transpose in (False, True):
                X = batched_trisolve(L, Y, transpose)
                PX = batched_trisolve_plain(L, Y, transpose)
                torch.cuda.synchronize()
                d, e = _rel_err(X, PX)
                A_ = L.mT if transpose else L
                _record(
                    rec, "batched_trisolve",
                    f"(B,C,NR)=({B},{C},{nr}) transpose={transpose}", e, d,
                    _cuda_ms(lambda: batched_trisolve(L, Y, transpose), 10),
                    _cuda_ms(lambda: batched_trisolve_plain(L, Y, transpose),
                             2),
                    4.0 * B * (C * (C + 1) / 2 + 2 * C * nr),
                    float(B * nr * C * C),
                    library_ms=_cuda_ms(
                        lambda: torch.linalg.solve_triangular(
                            A_, Y, upper=transpose), 10))
    return rec


def w2_kernels(dp, dev, rng):
    """K5 and K6 against their plain versions at the four largest groups
    (B * R * C) that the w2 kernel routes send to each in the model plan,
    with the L2 cache flushed before every timed call."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels.bmatvec import bmatvec, bmatvec_plain
    from suitesparse_tpu_torch.kernels.pmatvec import (pmatvec_t,
                                                       pmatvec_t_plain)
    from suitesparse_tpu_torch.numeric.supernodal_solve import w2_route

    cfg = sstt.DEFAULT.replace(solve_pmv=True, solve_bmv=True)
    groups = [g for gl in dp.plan.groups for g in gl]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    def cold():
        flush.zero_()
        return ()

    def top(route):
        gs = sorted((g for g in groups
                     if w2_route(g.B, g.R, g.C, 1, cfg) == route),
                    key=lambda g: g.B * g.R * g.C, reverse=True)[:4]
        assert len(gs) == 4, f"fewer than four groups on the {route} route"
        return gs

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev)

    rec: dict = {}
    for g in top("pmv"):
        W2 = randn(g.B, g.R, g.C)
        for M, orient in ((W2.mT.contiguous(), "W2^T"), (W2, "W2")):
            B, K, N = M.shape
            for nr in (1, NRHS_K):
                X = randn(B, K, nr)
                Z, P = pmatvec_t(M, X), pmatvec_t_plain(M, X)
                torch.cuda.synchronize()
                d, e = _rel_err(Z, P)
                _record(
                    rec, "pmatvec_t",
                    f"(B,K,N,NR)=({B},{K},{N},{nr}) M={orient}", e, d,
                    _cuda_ms(lambda: pmatvec_t(M, X), 10, cold),
                    _cuda_ms(lambda: pmatvec_t_plain(M, X), 2, cold),
                    4.0 * B * (K * N + K * nr + N * nr),
                    2.0 * B * K * N * nr,
                    library_ms=_cuda_ms(lambda: torch.bmm(M.mT, X), 10,
                                        cold), tol=K567_TOL)
    k6 = [((g.B, g.R, g.C), (1, NRHS_K)) for g in top("bmv")] + \
        [(shape, (1, 3)) for shape in K6_OFF_PLAN]
    for (B, R, C), nrs in k6:
        W2 = randn(B, R, C)
        for transpose in (False, True):
            K, N = (R, C) if transpose else (C, R)
            Mk = W2.mT if transpose else W2
            for nr in nrs:
                X = randn(B, K, nr)
                Z = bmatvec(W2, X, transpose)
                P = bmatvec_plain(W2, X, transpose)
                torch.cuda.synchronize()
                d, e = _rel_err(Z, P)
                _record(
                    rec, "bmatvec_t" if transpose else "bmatvec",
                    f"(B,R,C,NR)=({B},{R},{C},{nr}) transpose={transpose}",
                    e, d,
                    _cuda_ms(lambda: bmatvec(W2, X, transpose), 10, cold),
                    _cuda_ms(lambda: bmatvec_plain(W2, X, transpose), 2,
                             cold),
                    4.0 * B * (R * C + K * nr + N * nr),
                    2.0 * B * R * C * nr,
                    library_ms=_cuda_ms(lambda: torch.bmm(Mk, X), 10, cold),
                    tol=K567_TOL)
    return rec


def extend_add_kernel(dp, dev, rng):
    """K7 against its plain version on the K7_CLASSES pair classes of the
    factor's (B, R) = K7_GROUP group, with their real row maps and
    destinations padded by ``pad_pairs``. The library call is the factor's
    own placement of the class, ``_place`` (one
    ``index_put_(accumulate=True)``), on the real pairs: the dummy pairs add
    nothing, and ``_place`` would send all their cells to its one dump
    cell."""
    import torch

    from suitesparse_tpu_torch.kernels.extend_add import (
        extend_add, extend_add_plain, pad_pairs)
    from suitesparse_tpu_torch.numeric.supernodal_device import _place

    (g,) = [g for gl in dp.plan.groups for g in gl
            if (g.B, g.R) == K7_GROUP]
    B, R = g.B, g.R
    shapes = [(pc.npairs, pc.RU_c) for pc in g.pairs]
    rec: dict = {}
    for ci in [shapes.index(c) for c in K7_CLASSES]:
        _src, dst, idx = g._pair_arrays[ci]
        npairs, RU = idx.shape
        dstf, idxf, order = pad_pairs(B, dst, idx)
        child = np.zeros((dstf.size, RU, RU), np.float32)
        child[order >= 0] = rng.standard_normal((npairs, RU, RU),
                                                dtype=np.float32)[
                                                    order[order >= 0]]
        F0 = torch.as_tensor(rng.standard_normal((B, R, R), dtype=np.float32),
                             device=dev)
        ch = torch.as_tensor(child, device=dev)
        it = torch.as_tensor(np.ascontiguousarray(idxf, np.int32), device=dev)
        dt = torch.as_tensor(np.ascontiguousarray(dstf, np.int32), device=dev)
        real = torch.as_tensor(np.flatnonzero(order >= 0), device=dev)
        lib_args = (ch[real], dt[real].long(), it[real].long(), R)
        Fk = extend_add(F0.clone(), ch, it, dt)
        Fp = extend_add_plain(F0.clone(), ch, it, dt)
        Fl = torch.cat([F0.reshape(-1), F0.new_zeros(1)])
        _place(Fl, *lib_args)
        torch.cuda.synchronize()
        d, e = _rel_err(Fk, Fp)
        e_lib = _rel_err(Fl[:-1].view(B, R, R), Fp)[1]
        assert e_lib <= K567_TOL, f"_place disagrees with K7's plain: {e_lib}"
        # this input's work: each valid child cell read and added once, each
        # parent cell it reaches read and written once, maps read once
        ok = idxf >= 0
        cells = float((ok.sum(1) ** 2).sum())
        touched = np.unique(np.concatenate([
            (int(dstf[p]) * R + idxf[p][ok[p]][:, None]) * R
            + idxf[p][ok[p]][None, :] for p in range(dstf.size)],
            axis=None))
        _record(
            rec, "extend_add",
            f"(B,R)=({B},{R}) (np,RU)=({npairs},{RU}) padded np={dstf.size}",
            e, d,
            _cuda_ms(lambda F: extend_add(F, ch, it, dt), 10,
                     setup=lambda: (F0.clone(),)),
            _cuda_ms(lambda F: extend_add_plain(F, ch, it, dt), 3,
                     setup=lambda: (F0.clone(),)),
            4.0 * cells + 8.0 * touched.size + 4.0 * (idxf.size + dstf.size),
            cells,
            library_ms=_cuda_ms(lambda F: _place(F, *lib_args), 10,
                                setup=lambda: (Fl.clone(),)),
            tol=K567_TOL)
    return rec


def small_check(dev):
    """Card factor == CPU factor entry by entry, and the card solve matches
    the host simplicial (fp64) solve, on a problem small enough to check."""
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import (supernodal,
                                               supernodal_device,
                                               supernodal_solve)

    A = sstt.fixtures.laplacian_3d(12)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    S = supernodal.supernodal_symbolic(A, sstt.analyze(A, cfg), cfg)
    Fg = supernodal_device.factorize_device(A, S, cfg, dev, tile_rmin=32)
    Fc = supernodal_device.factorize_device(A, S, cfg, "cpu", tile_rmin=32)
    assert Fg.ok and Fc.ok
    lg, lc = Fg.Lx.cpu().numpy(), Fc.Lx.numpy()
    lx_err = np.abs(lg - lc).max() / np.abs(lc).max()
    assert lx_err <= 1e-5, f"card factor differs from CPU factor: {lx_err}"
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    x = supernodal_solve.solve_device(Fg, b, cfg)
    host = sstt.factorize(A, sstt.analyze(A, cfg), cfg.replace(
        factor_kind=sstt.FactorKind.SIMPLICIAL_LL), device="cpu")
    x_ref = sstt.solve(host, b)
    x_err = np.abs(x - x_ref).max() / np.abs(x_ref).max()
    assert x.shape == (n,) and x_err <= 1e-4, f"small solve off: {x_err}"
    # an indefinite matrix: the non-finite pivots must name the same minor
    Ai = sstt.fixtures.laplacian_3d(8, shift=-3.0)
    Si = supernodal.supernodal_symbolic(Ai, sstt.analyze(Ai, cfg), cfg)
    mg = supernodal_device.factorize_device(Ai, Si, cfg, dev).minor
    mc = supernodal_device.factorize_device(Ai, Si, cfg, "cpu").minor
    assert mg == mc < Ai.ncol, (mg, mc)
    print(f"small check n={n}: lx_rel_err={lx_err:.3e} "
          f"x_rel_err_vs_host={x_err:.3e} indefinite_minor={mg}", flush=True)


def auto_fallback(F) -> None:
    """solve_mode="auto" on a card factor with no W2 built yet: w2 with the
    card's real free memory, classic once the free memory reported by
    ``torch.cuda.mem_get_info`` leaves no room for W2 (the capacity gate's
    own arithmetic, PyTorch's cached blocks included)."""
    import torch

    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import supernodal_solve

    dev_F = F.F if isinstance(F, sstt.SupernodalFactorAdapter) else F
    assert not dev_F._solve, "the factor already holds a solve state"
    assert supernodal_solve.solve_mode(dev_F, sstt.DEFAULT) == "w2"
    torch.cuda.empty_cache()
    need = 2 * 4 * dev_F.dplan.plan.dev_size
    cached = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    real = torch.cuda.mem_get_info
    short = max(need - 1 - cached, 0)     # one byte short of W2's room
    torch.cuda.mem_get_info = lambda device=None: (short, real(device)[1])
    try:
        mode = supernodal_solve.solve_mode(dev_F, sstt.DEFAULT)
    finally:
        torch.cuda.mem_get_info = real
    assert cached < need and mode == "classic", (cached, need, mode)
    print(f"auto solve_mode: w2 with the card's free memory, classic with "
          f"{short} B free and {cached} B cached (W2 needs {need} B)",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels import _build
    from suitesparse_tpu_torch.kernels.bmatvec import bmatvec
    from suitesparse_tpu_torch.kernels.extend_add import extend_add
    from suitesparse_tpu_torch.kernels.extend_add_tiles import \
        extend_add_tiles
    from suitesparse_tpu_torch.kernels.pmatvec import pmatvec_t
    from suitesparse_tpu_torch.kernels.potrf import potrf_trsm
    from suitesparse_tpu_torch.kernels.solve_step import (solve_step_bwd,
                                                          solve_step_fwd)
    from suitesparse_tpu_torch.kernels.trisolve import batched_trisolve
    from suitesparse_tpu_torch.numeric import supernodal, supernodal_device

    # kernel -> (wrapper, attribute holding its launch count)
    counters = {"potrf_trsm": (potrf_trsm, "launches"),
                "extend_add_tiles": (extend_add_tiles, "launches"),
                "extend_add_tiles_pair": (extend_add_tiles, "pair_launches"),
                "solve_step_fwd": (solve_step_fwd, "launches"),
                "solve_step_bwd": (solve_step_bwd, "launches"),
                "batched_trisolve": (batched_trisolve, "launches"),
                "pmatvec_t": (pmatvec_t, "launches"),
                "bmatvec": (bmatvec, "launches"),
                "bmatvec_t": (bmatvec, "transposed_launches"),
                "extend_add": (extend_add, "launches")}

    def zero_counts():
        for w, attr in counters.values():
            setattr(w, attr, 0)

    def counts():
        return {k: getattr(w, attr) for k, (w, attr) in counters.items()}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build and load {time.perf_counter() - t0:.2f} s",
          flush=True)

    A = sstt.fixtures.laplacian_3d(SIZE)
    n = A.ncol
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    classic = cfg.replace(solve_mode="classic")
    t0 = time.perf_counter()
    Ssim = sstt.analyze(A, cfg)
    S = supernodal.supernodal_symbolic(A, Ssim, cfg)
    analyze_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = supernodal_device.device_plan(A, S, dev)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dpp = supernodal_device.device_plan(A, S, dev, tile_pair=True)
    pair_plan_s = time.perf_counter() - t0
    groups = [g for gl in dp.plan.groups for g in gl]
    steps = [sum(g._tile.man.shape[0] for gl in p.plan.groups for g in gl
                 if g._tile is not None) for p in (dp, dpp)]
    print(f"n={n} fl={S.fl:.4g} lnz={S.lnz} dev_size={dp.plan.dev_size} "
          f"groups={len(groups)} "
          f"tile_groups={sum(g._tile is not None for g in groups)} "
          f"tile_steps={steps[0]} two_piece_steps={steps[1]} "
          f"analyze_s={analyze_s:.2f} (first call: includes building the "
          f"host C++ library) plan_s={plan_s:.2f} "
          f"pair_plan_s={pair_plan_s:.2f}", flush=True)
    Af = forest(*FOREST)
    t0 = time.perf_counter()
    Sf = supernodal.supernodal_symbolic(Af, sstt.analyze(Af, cfg), cfg)
    dpf = supernodal_device.device_plan(Af, Sf, dev)
    print(f"forest {FOREST[0]} x laplacian_3d({FOREST[1]}): n={Af.ncol} "
          f"fl={Sf.fl:.4g} groups={sum(len(gl) for gl in dpf.plan.groups)} "
          f"analyze_and_plan_s={time.perf_counter() - t0:.2f}", flush=True)

    rng = np.random.default_rng(SEED)
    k1, k2, k2b = factor_kernels(dp, dpp, dev, rng)
    ks = solve_kernels(dp, dpf, dev, rng)
    kw = w2_kernels(dp, dev, rng)
    zero_counts()
    k7 = extend_add_kernel(dp, dev, rng)["extend_add"]
    torch.cuda.synchronize()
    k7_launches = counts()["extend_add"]
    small_check(dev)

    # ---- main path, through the package's entry points ----
    zero_counts()
    t0 = time.perf_counter()
    F = sstt.factorize(A, Ssim, cfg, device="cuda")
    torch.cuda.synchronize()
    first_factor_s = time.perf_counter() - t0
    factor_launches = counts()
    assert F.ok, f"factorization failed at column {F.minor}"
    assert factor_launches["potrf_trsm"] > 0 and \
        factor_launches["extend_add_tiles"] > 0, factor_launches
    auto_fallback(F)
    b = 1.0 + np.arange(n) / n
    B64 = np.tile(b.reshape(-1, 1), (1, NRHS)) * (1.0 + np.arange(NRHS) / NRHS)
    x = sstt.solve(F, b, cfg)
    x64 = sstt.solve(F, B64, cfg)
    resid = sstt.residual_norm(A, x, b)
    resid64 = sstt.residual_norm(A, x64[:, 0], B64[:, 0])
    assert x.shape == (n,) and x64.shape == (n, NRHS)
    assert np.isfinite(x).all() and np.isfinite(x64).all()
    assert resid < RESID_TOL and resid64 < RESID_TOL, (resid, resid64)

    # ---- classic sweep on the same factor ----
    zero_counts()
    xc = sstt.solve(F, b, classic)
    xc64 = sstt.solve(F, B64, classic)
    torch.cuda.synchronize()
    classic_launches = counts()
    assert classic_launches["solve_step_fwd"] > 0 and \
        classic_launches["solve_step_bwd"] > 0, classic_launches
    cresid = sstt.residual_norm(A, xc, b)
    cresid64 = max(sstt.residual_norm(A, xc64[:, k], B64[:, k])
                   for k in (0, NRHS - 1))
    assert np.isfinite(xc).all() and np.isfinite(xc64).all()
    assert cresid < RESID_TOL and cresid64 < RESID_TOL, (cresid, cresid64)
    dx = np.abs(xc - x).max() / np.abs(x).max()
    dx64 = np.abs(xc64 - x64).max() / np.abs(x64).max()
    assert dx <= 1e-4 and dx64 <= 1e-4, (dx, dx64)

    # ---- forest through cholsol, classic sweep ----
    bf = 1.0 + np.arange(Af.ncol) / Af.ncol
    forest_cfg = classic.replace(factor_kind=sstt.FactorKind.SUPERNODAL_LL)
    zero_counts()
    t0 = time.perf_counter()
    xf = sstt.cholsol(Af, bf, forest_cfg, device="cuda")
    torch.cuda.synchronize()
    forest_s = time.perf_counter() - t0
    forest_launches = counts()
    assert forest_launches["batched_trisolve"] > 0 and \
        forest_launches["solve_step_fwd"] > 0 and \
        forest_launches["solve_step_bwd"] > 0, forest_launches
    fresid = sstt.residual_norm(Af, xf, bf)
    assert np.isfinite(xf).all() and fresid < RESID_TOL, fresid

    # ---- refinement ----
    xr = sstt.solve_refined(F, A, b, config=cfg)
    rresid = sstt.residual_norm(A, xr, b)
    assert rresid < REFINED_TOL, rresid

    # ---- kernel path: two-piece tile steps, then the w2 kernel routes ----
    pair_cfg = cfg.replace(tile_pair=True)
    kern_cfg = cfg.replace(solve_pmv=True, solve_bmv=True)
    zero_counts()
    Fk = sstt.factorize(A, Ssim, pair_cfg, device="cuda")
    torch.cuda.synchronize()
    pair_launches = counts()
    assert Fk.ok, f"two-piece factorization failed at column {Fk.minor}"
    assert pair_launches["extend_add_tiles_pair"] > 0 and \
        pair_launches["potrf_trsm"] > 0 and \
        pair_launches["extend_add_tiles"] == 0, pair_launches
    lx = F.F.Lx
    pair_lx_err = ((Fk.F.Lx - lx).abs().max() / lx.abs().max()).item()
    assert pair_lx_err <= 1e-5, pair_lx_err
    B8 = np.ascontiguousarray(B64[:, :NRHS_K])
    x8 = sstt.solve(F, B8, cfg)
    w2k_launches, w2k_resid, w2k_dx = {}, {}, {}
    for nr, rhs, ref in ((1, b, x), (NRHS_K, B8, x8)):
        zero_counts()
        xk = sstt.solve(Fk, rhs, kern_cfg)
        torch.cuda.synchronize()
        w2k_launches[nr] = c = counts()
        assert c["pmatvec_t"] > 0 and c["bmatvec"] > 0 and \
            c["bmatvec_t"] > 0, (nr, c)
        assert xk.shape == rhs.shape and np.isfinite(xk).all()
        cols = [(xk, rhs)] if nr == 1 else \
            [(xk[:, k], rhs[:, k]) for k in (0, nr - 1)]
        w2k_resid[nr] = max(sstt.residual_norm(A, xc_, bc_)
                            for xc_, bc_ in cols)
        w2k_dx[nr] = np.abs(xk - ref).max() / np.abs(ref).max()
        assert w2k_resid[nr] < RESID_TOL and w2k_dx[nr] <= 1e-4, \
            (nr, w2k_resid[nr], w2k_dx[nr])
    print(f"kernel path: two-piece factor lx_rel_err={pair_lx_err:.3e} "
          f"launches={pair_launches}; w2 kernel routes residual "
          f"{w2k_resid[1]:.3e} / {w2k_resid[NRHS_K]:.3e}, x vs default w2 "
          f"{w2k_dx[1]:.3e} / {w2k_dx[NRHS_K]:.3e} at nrhs 1 / {NRHS_K}",
          flush=True)

    factor_s = _best_s(lambda: sstt.factorize(A, Ssim, cfg, device="cuda"))
    pair_factor_s = _best_s(lambda: sstt.factorize(A, Ssim, pair_cfg,
                                                   device="cuda"))
    solve_s = _best_s(lambda: sstt.solve(F, b, cfg))
    w2k_solve_s = _best_s(lambda: sstt.solve(Fk, b, kern_cfg))
    solve8_s = _best_s(lambda: sstt.solve(F, B8, cfg))
    w2k_solve8_s = _best_s(lambda: sstt.solve(Fk, B8, kern_cfg))
    solve64_s = _best_s(lambda: sstt.solve(F, B64, cfg))
    classic_solve_s = _best_s(lambda: sstt.solve(F, b, classic))
    classic_solve64_s = _best_s(lambda: sstt.solve(F, B64, classic))
    print(json.dumps({
        "card": card, "n": n, "flops": S.fl,
        "factor_s": factor_s, "gflops": S.fl / factor_s / 1e9,
        "first_factor_s": first_factor_s, "pair_factor_s": pair_factor_s,
        "solve_s": solve_s, "solve8_s": solve8_s,
        "w2k_solve_s": w2k_solve_s, "w2k_solve8_s": w2k_solve8_s,
        "solve64_s": solve64_s, "classic_solve_s": classic_solve_s,
        "classic_solve64_s": classic_solve64_s,
        # panel bytes the two classic sweeps must read at least
        "classic_floor_s": 2 * 4 * dp.plan.dev_size / HBM_BYTES_S,
        "residual": resid, "residual64": resid64,
        "classic_residual": cresid, "classic_residual64": cresid64,
        "classic_vs_w2": max(dx, dx64), "refined_residual": rresid,
        "pair_lx_err": pair_lx_err, "w2k_residual": w2k_resid[1],
        "w2k_residual8": w2k_resid[NRHS_K],
        "w2k_vs_w2": max(w2k_dx.values()),
        "forest_n": Af.ncol, "forest_cholsol_s": forest_s,
        "forest_residual": fresid,
        "launches": {"factor": factor_launches, "classic": classic_launches,
                     "forest": forest_launches, "pair_factor": pair_launches,
                     "w2k1": w2k_launches[1],
                     "w2k8": w2k_launches[NRHS_K]},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)

    def entry(name, replaces, src, k, launches):
        return {"name": name, "route": "cuda", "source": SRC + src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["abs"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms")}

    print(json.dumps({"kernels": [
        entry("potrf_trsm", "suitesparse_tpu/kernels/potrf.py:108",
              "potrf_trsm.cu", k1, factor_launches["potrf_trsm"]),
        entry("extend_add_tiles",
              "suitesparse_tpu/kernels/extend_add_tiles.py:381",
              "extend_add_tiles.cu", k2, factor_launches["extend_add_tiles"]),
        entry("extend_add_tiles_pair",
              "suitesparse_tpu/kernels/extend_add_tiles.py:359",
              "extend_add_tiles.cu", k2b,
              pair_launches["extend_add_tiles_pair"]),
        entry("solve_step_fwd", "suitesparse_tpu/kernels/solve_step.py:96",
              "solve_step.cu", ks["solve_step_fwd"],
              classic_launches["solve_step_fwd"]),
        entry("solve_step_bwd", "suitesparse_tpu/kernels/solve_step.py:108",
              "solve_step.cu", ks["solve_step_bwd"],
              classic_launches["solve_step_bwd"]),
        entry("batched_trisolve", "suitesparse_tpu/kernels/trisolve.py:89",
              "trisolve.cu", ks["batched_trisolve"],
              forest_launches["batched_trisolve"]),
        entry("pmatvec_t", "suitesparse_tpu/kernels/pmatvec.py:91",
              "pmatvec.cu", kw["pmatvec_t"],
              sum(c["pmatvec_t"] for c in w2k_launches.values())),
        entry("bmatvec", "suitesparse_tpu/kernels/bmatvec.py:138",
              "bmatvec.cu", kw["bmatvec"],
              sum(c["bmatvec"] for c in w2k_launches.values())),
        entry("bmatvec_t", "suitesparse_tpu/kernels/bmatvec.py:138",
              "bmatvec.cu", kw["bmatvec_t"],
              sum(c["bmatvec_t"] for c in w2k_launches.values())),
        entry("extend_add", "suitesparse_tpu/kernels/extend_add.py:110",
              "extend_add.cu", k7, k7_launches),
    ]}))
    leaked = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "jaxlib", "suitesparse_tpu")]
    assert not leaked, f"the port imported {leaked}"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
