#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (suitesparse_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``suitesparse_tpu_torch/kernels/csrc``.
2. Kernel phase: builds the plan of the 3-D Laplacian model problem
   ``laplacian_3d(50)`` (n = 125,000, nested dissection) and runs each kernel and its plain
   PyTorch version on the card at the shapes that plan gives it, from a
   numpy seed: potrf_trsm at the three largest groups of its gate, the
   tiled extend-add on the largest tile manifest. Tolerances (relative to
   the largest output entry, fp32 sums in another order): 1e-5 and 1e-6.
3. Main path: ``analyze`` → ``factorize`` → ``solve`` (1 and 64 right-hand
   sides) through the package's entry points on the card. Both kernels
   must launch during the factorization; residuals must stay below 1e-5.
   Also a small problem whose card factor must match the CPU factor entry
   by entry and whose solution must match the host simplicial solve.

Any failure raises (exit code != 0). Without a CUDA device the script
exits with code 2 before doing anything. The last line is the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

K1_TOL = 1e-5
K2_TOL = 1e-6
RESID_TOL = 1e-5
SEED = 0
SIZE = 50          # laplacian_3d(50): n = 125,000, the model problem


def _cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds per call of fn(*setup()) (after one warm
    call), timed with CUDA events around each call."""
    import torch

    fn(*(setup() if setup else ()))
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
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


def kernel_phase(dp, dev):
    import torch

    from suitesparse_tpu_torch.kernels.extend_add_tiles import (
        extend_add_tiles, extend_add_tiles_plain)
    from suitesparse_tpu_torch.kernels.potrf import (
        potrf_trsm, potrf_trsm_plain)
    from suitesparse_tpu_torch.numeric.supernodal_device import \
        _use_potrf_kernel

    rng = np.random.default_rng(SEED)
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
        d11 = (L11 - P11).abs().max().item()
        err = d11 / P11.abs().max().item()
        if RU:
            d21 = (L21 - P21).abs().max().item()
            err = max(err, d21 / P21.abs().max().item())
            d11 = max(d11, d21)
        assert np.isfinite(err) and err <= K1_TOL, \
            f"potrf_trsm disagrees at (B,C,RU)=({B},{C},{RU}): {err}"
        ms = _cuda_ms(lambda: potrf_trsm(f11, f21), 10)
        plain_ms = _cuda_ms(lambda: potrf_trsm_plain(f11, f21), 2)
        print(f"potrf_trsm (B,C,RU)=({B},{C},{RU}) rel_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        k1["err"] = max(k1["err"], err)
        k1["abs"] = max(k1["abs"], d11)
        if i == 0:
            k1.update(ms=ms, plain_ms=plain_ms, shape=(B, C, RU))

    tg = max((g for g in groups if g._tile is not None),
             key=lambda g: g._tile.man.shape[0])
    tm = tg._tile
    F0 = torch.as_tensor(rng.standard_normal((tg.B, tg.R, tg.R),
                                             dtype=np.float32), device=dev)
    U = rng.standard_normal((max(tm.nslots, 1), tm.RUp, tm.RUp),
                            dtype=np.float32)
    upper = np.triu(np.ones((tm.RUp, tm.RUp), bool), 1)
    U[(rng.random(U.shape, dtype=np.float32) < 0.05) & upper] = np.nan
    U = torch.as_tensor(U, device=dev)
    man, rmap, cmap, runs = (torch.as_tensor(np.ascontiguousarray(a),
                                             device=dev)
                             for a in (tm.man, tm.rowmap, tm.colmap,
                                       tg._tile_runs))
    Fk = extend_add_tiles(F0.clone(), U, man, rmap, cmap, runs)
    Fp = extend_add_tiles_plain(F0.clone(), U, man, rmap, cmap)
    torch.cuda.synchronize()
    k2_abs = (Fk - Fp).abs().max().item()
    k2_err = k2_abs / Fp.abs().max().item()
    assert np.isfinite(k2_err) and k2_err <= K2_TOL, \
        f"extend_add_tiles disagrees: {k2_err}"
    k2_ms = _cuda_ms(lambda F: extend_add_tiles(F, U, man, rmap, cmap, runs),
                     10, setup=lambda: (F0.clone(),))
    k2_plain = _cuda_ms(lambda F: extend_add_tiles_plain(F, U, man, rmap,
                                                         cmap),
                        3, setup=lambda: (F0.clone(),))
    print(f"extend_add_tiles (B,R)=({tg.B},{tg.R}) steps={tm.man.shape[0]} "
          f"tiles={len(tg._tile_runs) - 1} RUp={tm.RUp} "
          f"rel_err={k2_err:.3e} kernel_ms={k2_ms:.4f} "
          f"plain_ms={k2_plain:.4f}", flush=True)
    return k1, {"err": k2_err, "abs": k2_abs, "ms": k2_ms,
                "plain_ms": k2_plain}


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.kernels import _build
    from suitesparse_tpu_torch.kernels.extend_add_tiles import \
        extend_add_tiles
    from suitesparse_tpu_torch.kernels.potrf import potrf_trsm
    from suitesparse_tpu_torch.numeric import supernodal, supernodal_device

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
    t0 = time.perf_counter()
    Ssim = sstt.analyze(A, cfg)
    S = supernodal.supernodal_symbolic(A, Ssim, cfg)
    analyze_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = supernodal_device.device_plan(A, S, dev)
    plan_s = time.perf_counter() - t0
    groups = [g for gl in dp.plan.groups for g in gl]
    print(f"n={n} fl={S.fl:.4g} lnz={S.lnz} dev_size={dp.plan.dev_size} "
          f"groups={len(groups)} "
          f"tile_groups={sum(g._tile is not None for g in groups)} "
          f"analyze_s={analyze_s:.2f} (first call: includes building the "
          f"host C++ library) plan_s={plan_s:.2f}", flush=True)

    k1, k2 = kernel_phase(dp, dev)
    small_check(dev)

    # ---- main path, through the package's entry points ----
    potrf_trsm.launches = 0
    extend_add_tiles.launches = 0
    t0 = time.perf_counter()
    F = sstt.factorize(A, Ssim, cfg, device="cuda")
    torch.cuda.synchronize()
    first_factor_s = time.perf_counter() - t0
    assert F.ok, f"factorization failed at column {F.minor}"
    b = 1.0 + np.arange(n) / n
    x = sstt.solve(F, b, cfg)
    NR = 64
    B64 = np.tile(b.reshape(-1, 1), (1, NR)) * (1.0 + np.arange(NR) / NR)
    x64 = sstt.solve(F, B64, cfg)
    launches = {"potrf_trsm": potrf_trsm.launches,
                "extend_add_tiles": extend_add_tiles.launches}
    assert all(v > 0 for v in launches.values()), launches
    resid = sstt.residual_norm(A, x, b)
    resid64 = sstt.residual_norm(A, x64[:, 0], B64[:, 0])
    assert x.shape == (n,) and x64.shape == (n, NR)
    assert np.isfinite(x).all() and np.isfinite(x64).all()
    assert resid < RESID_TOL and resid64 < RESID_TOL, (resid, resid64)

    factor_s = _best_s(lambda: sstt.factorize(A, Ssim, cfg, device="cuda"))
    solve_s = _best_s(lambda: sstt.solve(F, b, cfg))
    solve64_s = _best_s(lambda: sstt.solve(F, B64, cfg))
    print(json.dumps({
        "card": card, "n": n, "flops": S.fl,
        "factor_s": factor_s, "gflops": S.fl / factor_s / 1e9,
        "first_factor_s": first_factor_s, "solve_s": solve_s,
        "solve64_s": solve64_s, "residual": resid, "residual64": resid64,
        "launches": launches, "peak_mem_gb":
            torch.cuda.max_memory_allocated() / 1e9}), flush=True)

    src = "suitesparse_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": "potrf_trsm", "route": "cuda",
         "source": src + "potrf_trsm.cu",
         "replaces": "suitesparse_tpu/kernels/potrf.py:108",
         "launches": launches["potrf_trsm"], "max_abs_err": k1["abs"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "extend_add_tiles", "route": "cuda",
         "source": src + "extend_add_tiles.cu",
         "replaces": "suitesparse_tpu/kernels/extend_add_tiles.py:381",
         "launches": launches["extend_add_tiles"], "max_abs_err": k2["abs"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]}))
    assert "jax" not in sys.modules, "the port imported jax"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
