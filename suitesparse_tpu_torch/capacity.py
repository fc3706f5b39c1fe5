"""Capacity row of the port: the 3-D Laplacian on the card.

    python3 -m suitesparse_tpu_torch.capacity [--nx 80]

The port's counterpart of ``demos/capacity.py``'s regular row
(``laplacian3d_80``, n = 512,000): nested dissection and the supernodal
analysis on the host, then the factor under the default configuration,
whose auto segment budget (``Config.segment_bytes = 0``) decides whether
the factor runs in one piece or in segments; a w2 solve of b = 1 + k/n.
Prints the card's name and power limit, then one JSON line: the sizes,
the analysis and plan seconds, the first factor (with the upload of its
index arrays), the steady factor (CUDA events, min of 3 after a warm
call, garbage collector off), the segment count, the peak memory
(``max_memory_allocated`` over the first factor and solve), the one-piece
byte estimate beside the auto budget, and the residual.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np
import torch

from . import DEFAULT, Ordering, analyze, residual_norm
from .io import fixtures
from .numeric import segmented, supernodal, supernodal_device
from .numeric.supernodal_solve import solve_device


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=80)
    nx = ap.parse_args().nx
    if not torch.cuda.is_available():
        raise SystemExit("capacity: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg = DEFAULT.replace(ordering=Ordering.METIS)
    A = fixtures.laplacian_3d(nx)
    t0 = time.perf_counter()
    S = supernodal.supernodal_symbolic(A, analyze(A, cfg), cfg)
    analyze_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = supernodal_device._plan_entry(A, S, dev,
                                       supernodal_device.TILE_RMIN, False)
    plan_s = time.perf_counter() - t0
    print(f"laplacian_3d({nx}): n={A.ncol} fl={S.fl:.4g} lnz={S.lnz} "
          f"dev_size={dp.plan.dev_size} analyze_s={analyze_s:.2f} "
          f"plan_s={plan_s:.2f}", flush=True)
    gc.disable()
    try:
        torch.cuda.reset_peak_memory_stats()
        # the auto budget as the first factor reads it
        budget = segmented.budget(cfg, dev, dp.plan.dev_size * 4)
        t0 = time.perf_counter()
        F = supernodal_device.factorize_device(A, S, cfg, dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if not F.ok:
            raise SystemExit(f"capacity: the factor failed at column "
                             f"{F.minor}")
        b = 1.0 + np.arange(A.ncol) / A.ncol
        x = solve_device(F, b, cfg)
        resid = residual_norm(A, x, b)
        peak = torch.cuda.max_memory_allocated() / 1e9
        est = segmented.one_piece_bytes(dp.index_bytes,
                                        dp.costs[torch.float32,
                                                 torch.float32])
        segments = F.segments
        del F, x
        best = float("inf")
        supernodal_device.factorize_device(A, S, cfg, dev)
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            supernodal_device.factorize_device(A, S, cfg, dev)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    finally:
        gc.enable()
    print(json.dumps({
        "matrix": f"laplacian3d_{nx}", "card": card, "n": A.ncol,
        "nnzA": A.nnz, "flops": S.fl, "lnz": S.lnz, "nsuper": S.nsuper,
        "dev_size": dp.plan.dev_size,
        "groups": sum(len(gl) for gl in dp.plan.groups),
        "analyze_s": analyze_s, "plan_s": plan_s,
        "first_factor_s": first_s, "factor_s": best,
        "gflops": S.fl / best / 1e9, "segments": segments,
        "segmented": segments > 1, "one_piece_bytes": est,
        "auto_budget_bytes": budget, "index_bytes": dp.index_bytes,
        "peak_mem_gb": peak, "residual": resid}), flush=True)


if __name__ == "__main__":
    main()
