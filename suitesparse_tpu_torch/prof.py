"""Device-time profile of the port's main path on one CUDA card.

    python3 -m suitesparse_tpu_torch.prof

On the model problem ``laplacian_3d(50)`` (n = 125,000, nested dissection,
fp32, default tile threshold) it profiles ``factorize`` (``factor``,
``factor_pair`` with the two-piece tile steps, ``tile_pair=True``,
``factor64`` in fp64, ``compute_dtype="float64"``, and ``factor_bf16``
with bfloat16 child updates, ``update_dtype="bfloat16"``), and
``solve`` at 1 and at 64 right-hand sides through the w2 sweep (the
default; ``solve1``, ``solve64``) and through the classic sweep
(``solve_mode="classic"``; ``classic1``, ``classic64``), at 1 and 8
through the w2 sweep with its plain matmul (``solve8``) and with the K5 and
K6 kernel routes (``solve_pmv=True, solve_bmv=True``; ``w2k1``, ``w2k8``),
and at 1 and 8 through the inv sweep (``solve_mode="inv"``; ``inv1``,
``inv8``), each on the plan the solve takes (the coarse solve plan,
where its copy of the factor fits; the warm call builds that copy);
``solve_profile()`` runs the model problem's solve phases alone.
Then the multifrontal QR: a pattern-cached ``qrsol`` (b from seed 7) on
``local_coupling_ls(6000, 2000)`` (``qr_lc``) and on
``grid_gradient_3d(32)`` in fp32 (``qr_grid``) and fp64 (``qr_grid64``).
Then the unsymmetric multifrontal LU: ``lu_unsym_solve_device`` (factor
and sweep, the analysis cached) on ``fem_unsym(30)`` (the fixture of
``demos/bench_unsym.py``, b = ones) in fp32 (``lu_fem``) and fp64
(``lu_fem64``). Then the complex Hermitian cell through the 2x2 real
embedding (``cplx_chol``, ``cplx_chol64``: ``complex_profile()``). Each
phase gets one warm call, the minimum of 3 unprofiled calls (host clock
around the call, synchronized), then one call under ``torch.profiler``.
Per phase it prints one JSON line:

- ``wall_s``: the unprofiled minimum; ``prof_wall_s``: the profiled call;
- ``device_busy_s``: the union of the device intervals (kernels, copies,
  memsets) of the profiled call, without the device-side rows the
  profiler files for a user annotation (a ``record_function`` range);
  ``device_idle_share`` = 1 - busy / prof_wall_s;
- ``n_device_ops`` and ``top``: the 8 largest rows of ``key_averages()``
  by self device time, as (name, ms, calls);
- ``hand_kernels``: device ms and launches of each hand-written kernel of
  ``kernels/csrc`` in the call, by its function name (all its instances).

It then times every ``_group_compute`` of one factorization with a device
synchronize after each group and prints the 25 slowest groups, and every
group of the grid's fp32 and fp64 QR factor (``_factor_group``: the
gather, the batched QR, the write) the same way, and every group of the
LU factor in fp32 and fp64 (``mflu_unsym._factor_group``: the gather, the
batched LU, the solves, the CB update, the write). The full tables go to
``prof_out/`` in the checkout: ``prof_<phase>.txt``, ``prof_groups.txt``,
``prof_qr_groups.txt``, ``prof_lu_groups.txt`` and
``prof_cplx_groups.txt``; ``lu_profile()`` and ``complex_profile()`` run
the LU's and the complex cell's phases alone.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import (CSC, DEFAULT, Ordering, analyze, factorize, fixtures, qrsol,
               solve)
from .numeric import mflu_unsym, mfqr_device, supernodal_device
from .numeric.supernodal import supernodal_symbolic

SIZE = 50
NRHS = 64
CPLX_K = 40      # the complex cell: the magnetic Laplacian of a 40^3 grid
CPLX_SEED = 0
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "prof_out")
# CUPTI bookkeeping rows that the profiler files under the device but that
# are no device work
_NOT_DEVICE_WORK = {"Command Buffer Full", "Activity Buffer Request"}
# the __global__ functions of kernels/csrc (a template matches by its name
# before "<": potrf_trsm_kernel<8> to <96> are all K1)
HAND_KERNELS = ("potrf_trsm_kernel", "extend_add_tiles_kernel",
                "extend_add_kernel", "solve_step_fwd_kernel",
                "solve_step_bwd_kernel", "trisolve_kernel", "pmatvec_kernel",
                "bmatvec_kernel")


def _sync_wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_work(e) -> bool:
    """Whether a profiler event is device work: a device row that is not
    CUPTI's bookkeeping and not a user annotation's device-side row."""
    return e.device_type == torch.autograd.DeviceType.CUDA \
        and e.name not in _NOT_DEVICE_WORK \
        and not getattr(e, "is_user_annotation", False)


def _busy_s(events) -> tuple[float, int]:
    """Seconds covered by the device intervals of ``events`` and their
    number."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if _device_work(e))
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6, len(spans)


def profile_phase(name: str, fn) -> dict:
    fn()
    wall = min(_sync_wall(fn) for _ in range(3))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = _sync_wall(fn)
    busy, nops = _busy_s(prof.events())
    rows = sorted(prof.key_averages(),
                  key=lambda r: r.self_device_time_total, reverse=True)
    with open(os.path.join(OUT_DIR, f"prof_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60,
            max_name_column_width=90))
    hand = {}
    for r in rows:
        for k in HAND_KERNELS:
            if f"{k}<" in r.key or f"{k}(" in r.key:
                ms, n = hand.get(k, (0.0, 0))
                hand[k] = (ms + r.self_device_time_total / 1e3, n + r.count)
    rec = {"phase": name, "wall_s": wall, "prof_wall_s": prof_wall,
           "device_busy_s": busy, "device_idle_share": 1 - busy / prof_wall,
           "n_device_ops": nops,
           "top": [(r.key[:70], r.self_device_time_total / 1e3, r.count)
                   for r in rows[:8]],
           "hand_kernels": hand}
    print(json.dumps(rec), flush=True)
    return rec


def group_times(A, S, cfg, fname: str = "prof_groups.txt") -> None:
    """Each group of one factorization, synchronized before and after;
    the table goes to ``prof_out/<fname>``."""
    times = []
    inner = supernodal_device._group_compute

    def timed(g, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(g, *args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    supernodal_device._group_compute = timed
    try:
        F = factorize(A, S, cfg, device="cuda")
    finally:
        supernodal_device._group_compute = inner
    assert F.ok
    plan = F.F.dplan.plan
    rows = []
    walk = [(d, gi, g) for d, gl in enumerate(plan.groups)
            for gi, g in enumerate(gl)]
    for t, (d, gi, g) in zip(times, walk, strict=True):
        k1 = supernodal_device._use_potrf_kernel(torch.float32, g.B, g.C)
        rows.append((t, f"{t:.5f} d={d} gi={gi} B={g.B} R={g.R} C={g.C} "
                        f"classes={len(g.pairs)} tile={g._tile is not None} "
                        f"k1={k1}"))
    rows.sort(reverse=True)
    text = [f"per-group sum {sum(times):.4f} s over {len(times)} groups"]
    text += [r for _t, r in rows]
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write("\n".join(text) + "\n")
    print("\n".join(text[:26]), flush=True)


def qr_group_times(A, b) -> None:
    """Each group of the QR factor of ``A`` in fp32 and fp64, synchronized
    before and after (the analysis is ``qrsol``'s cached one)."""
    inner = mfqr_device._factor_group
    text = []
    for dtype in ("float32", "float64"):
        cfg = DEFAULT.replace(compute_dtype=dtype)
        SQ = mfqr_device._SQ_CACHE[mfqr_device._analysis_key(A, cfg)]
        times = []

        def timed(g, pool):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(g, pool)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0, g))

        mfqr_device._factor_group = timed
        try:
            mfqr_device.factorize_qr_device(A, SQ, b, cfg, device="cuda")
        finally:
            mfqr_device._factor_group = inner
        times.sort(key=lambda tg: tg[0], reverse=True)
        text.append(f"{dtype}: per-group sum "
                    f"{sum(t for t, _g in times):.4f} s over {len(times)} "
                    f"groups")
        text += [f"{t:.5f} B={g.B} M={g.M} N={g.N} K={g.K}"
                 for t, g in times]
    with open(os.path.join(OUT_DIR, "prof_qr_groups.txt"), "w") as f:
        f.write("\n".join(text) + "\n")
    print("\n".join(t for t in text if "per-group" in t), flush=True)


def lu_group_times(A, b, SL) -> None:
    """Each group of the LU factor of ``A`` in fp32 and fp64 (the pass at
    tau 1e-6), synchronized before and after."""
    inner = mflu_unsym._factor_group
    text = []
    for dtype in ("float32", "float64"):
        times = []

        def timed(g, lg, pool, tau_rel):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(g, lg, pool, tau_rel)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0, g, lg))

        mflu_unsym._factor_group = timed
        try:
            mflu_unsym.factorize_lu_unsym_device(
                A, SL, b, DEFAULT.replace(compute_dtype=dtype), "cuda")
        finally:
            mflu_unsym._factor_group = inner
        times.sort(key=lambda t: t[0], reverse=True)
        text.append(f"{dtype}: per-group sum "
                    f"{sum(t for t, _g, _l in times):.4f} s over "
                    f"{len(times)} groups")
        text += [f"{t:.5f} B={g.B} M={g.M} N={g.N} K={g.K} Cg={lg.Cg}"
                 for t, g, lg in times]
    with open(os.path.join(OUT_DIR, "prof_lu_groups.txt"), "w") as f:
        f.write("\n".join(text) + "\n")
    print("\n".join(t for t in text if "per-group" in t), flush=True)


def lu_profile() -> None:
    """The LU's phases (``lu_fem``, ``lu_fem64``) and its per-group
    factor times."""
    os.makedirs(OUT_DIR, exist_ok=True)
    A = fixtures.fem_unsym(30)
    b = np.ones(A.ncol)
    SL = mflu_unsym.analyze_mflu_unsym(A)
    profile_phase("lu_fem", lambda: mflu_unsym.lu_unsym_solve_device(
        A, b, DEFAULT, SL))
    fp64 = DEFAULT.replace(compute_dtype="float64")
    profile_phase("lu_fem64", lambda: mflu_unsym.lu_unsym_solve_device(
        A, b, fp64, SL))
    lu_group_times(A, b, SL)


def magnetic_laplacian(k: int, seed: int = CPLX_SEED):
    """``laplacian_3d(k)`` with each strictly-upper entry times e^{i theta},
    theta ~ U(-pi, pi) from ``default_rng(seed)`` in storage order: a
    connection Laplacian plus the Dirichlet boundary, Hermitian positive
    definite (the complex cell of ``chip_smoke.py``)."""
    A = fixtures.laplacian_3d(k)
    cols = np.repeat(np.arange(A.ncol), np.diff(A.indptr))
    off = A.indices < cols
    theta = np.random.default_rng(seed).uniform(-np.pi, np.pi,
                                                int(off.sum()))
    data = A.data.astype(np.complex128)
    data[off] *= np.exp(1j * theta)
    return CSC(A.nrow, A.ncol, A.indptr, A.indices, data, 1)


def complex_profile() -> None:
    """The complex Hermitian cell: the magnetic Laplacian of a 40^3 grid
    (n = 64,000, 128,000 real unknowns embedded), b = 1 + i k/n, through
    ``cholsol_complex_device`` (the embedded factor and the w2 solve, the
    analysis cached) in fp32 (``cplx_chol``) and fp64 (``cplx_chol64``),
    and the embedded factor's per-group times (``prof_cplx_groups.txt``)."""
    from .numeric import complex_embed

    os.makedirs(OUT_DIR, exist_ok=True)
    H = magnetic_laplacian(CPLX_K)
    n = H.ncol
    b = 1 + 1j * np.arange(n) / n
    perm = analyze(H).perm
    profile_phase("cplx_chol", lambda: complex_embed.cholsol_complex_device(
        H, b, DEFAULT, perm))
    fp64 = DEFAULT.replace(compute_dtype="float64")
    profile_phase("cplx_chol64",
                  lambda: complex_embed.cholsol_complex_device(
                      H, b, fp64, perm))
    S = complex_embed.embedded_analysis(H, DEFAULT, perm)
    group_times(complex_embed.embed_matrix(H), S, DEFAULT,
                "prof_cplx_groups.txt")


def _header() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"linalg {torch.backends.cuda.preferred_linalg_library()}",
          flush=True)


def _model():
    """(A, config, analysis, factor on the card) of the model problem."""
    A = fixtures.laplacian_3d(SIZE)
    cfg = DEFAULT.replace(ordering=Ordering.METIS)
    Ssim = analyze(A, cfg)
    supernodal_symbolic(A, Ssim, cfg)
    F = factorize(A, Ssim, cfg, device="cuda")
    assert F.ok
    return A, cfg, Ssim, F


def solve_phases(A, F, cfg) -> None:
    """The solve phases of the module docstring on the factor ``F``."""
    n = A.ncol
    b = 1.0 + np.arange(n) / n
    B64 = np.tile(b.reshape(-1, 1), (1, NRHS)) * (1.0 + np.arange(NRHS) / NRHS)
    B8 = B64[:, :8].copy()
    profile_phase("solve1", lambda: solve(F, b, cfg))
    profile_phase("solve64", lambda: solve(F, B64, cfg))
    classic = cfg.replace(solve_mode="classic")
    profile_phase("classic1", lambda: solve(F, b, classic))
    profile_phase("classic64", lambda: solve(F, B64, classic))
    kernels = cfg.replace(solve_pmv=True, solve_bmv=True)
    profile_phase("solve8", lambda: solve(F, B8, cfg))
    profile_phase("w2k1", lambda: solve(F, b, kernels))
    profile_phase("w2k8", lambda: solve(F, B8, kernels))
    inv = cfg.replace(solve_mode="inv")
    profile_phase("inv1", lambda: solve(F, b, inv))
    profile_phase("inv8", lambda: solve(F, B8, inv))


def solve_profile() -> None:
    """The model problem's solve phases alone."""
    os.makedirs(OUT_DIR, exist_ok=True)
    _header()
    A, cfg, _Ssim, F = _model()
    solve_phases(A, F, cfg)


def main() -> int:
    if not torch.cuda.is_available():
        print("prof: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    _header()
    A, cfg, Ssim, F = _model()
    profile_phase("factor", lambda: factorize(A, Ssim, cfg, device="cuda"))
    pair = cfg.replace(tile_pair=True)
    profile_phase("factor_pair",
                  lambda: factorize(A, Ssim, pair, device="cuda"))
    fp64 = cfg.replace(compute_dtype="float64")
    profile_phase("factor64", lambda: factorize(A, Ssim, fp64, device="cuda"))
    profile_phase("factor_bf16", lambda: factorize(
        A, Ssim, cfg.replace(update_dtype="bfloat16"), device="cuda"))
    solve_phases(A, F, cfg)
    group_times(A, Ssim, cfg)

    Alc = fixtures.local_coupling_ls(6000, 2000)
    Ag = fixtures.grid_gradient_3d(32)
    blc = np.random.default_rng(7).standard_normal(Alc.nrow)
    bg = np.random.default_rng(7).standard_normal(Ag.nrow)
    profile_phase("qr_lc", lambda: qrsol(Alc, blc))
    profile_phase("qr_grid", lambda: qrsol(Ag, bg))
    qr64 = DEFAULT.replace(compute_dtype="float64")
    profile_phase("qr_grid64", lambda: qrsol(Ag, bg, qr64))
    qr_group_times(Ag, bg)
    lu_profile()
    complex_profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
