"""Time K4 over its launch plans, beside ``solve_triangular``, on one card.

    python3 -m suitesparse_tpu_torch.kernels.trisolve_sweep

At the shapes ``chip_smoke.py`` runs K4 ((B, C) = (512, 64), the forest's
root group, and (45, 48)), in both directions at 1 and 64 right-hand
sides, it times the kernel with the plan :func:`trisolve_geometry` picks
and with forced plans (columns a warp, warps a tile, tiles a block), and
one ``torch.linalg.solve_triangular`` on the same inputs; each result is
held against ``batched_trisolve_plain`` (1e-5 of the largest entry). Times
as ``chip_smoke.py`` takes K4's: device milliseconds, the mean of 20
calls, a spin kernel ahead of each so that the host's launch is not timed,
the L2 cache as the previous call left it. One line per case, after the
card's name and power limit.
"""

from __future__ import annotations

import gc
import subprocess
import sys

import numpy as np
import torch

from .trisolve import _launch, batched_trisolve_plain, trisolve_geometry

SHAPES = ((512, 64), (45, 48))
# forced (columns a warp, warps a tile, tiles a block) at NR 1 and at NR 64
FORCED = {1: ((1, 1, 2), (1, 1, 4), (1, 1, 8)),
          64: ((8, 2, 1), (8, 4, 1), (8, 4, 2), (1, 8, 1))}
REPS = 20
TOL = 1e-5
SPIN_CYCLES = 2_000_000     # about 1 ms of device spin before each call


def _device_ms(fn) -> float:
    """Mean device milliseconds of fn() over REPS calls, after a warm one."""
    fn()
    total = 0.0
    gc.disable()
    try:
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
    finally:
        gc.enable()
    return total / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("trisolve_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for B, C in SHAPES:
        Ln = np.tril(rng.uniform(-1.0, 1.0, (B, C, C)) / C, -1)
        Ln += np.eye(C) * rng.uniform(1.0, 2.0, (B, 1, C))
        L = torch.as_tensor(Ln.astype(np.float32), device=dev)
        for nr, forced in FORCED.items():
            Y = torch.as_tensor(rng.standard_normal((B, C, nr),
                                                    dtype=np.float32),
                                device=dev)
            for transpose in (False, True):
                ref = batched_trisolve_plain(L, Y, transpose)
                plans = {"plan": trisolve_geometry(B, C, nr, transpose)}
                plans.update((f"cpw{c}/wpt{w}/tpb{t}", trisolve_geometry(
                    B, C, nr, transpose, cpw=c, wpt=w, tpb=t))
                    for c, w, t in forced)
                out = []
                for name, g in plans.items():
                    X = torch.empty_like(Y)
                    _launch(L, Y, X, transpose, g)
                    torch.cuda.synchronize()
                    err = ((X - ref).abs().max() / ref.abs().max()).item()
                    assert err <= TOL, (B, C, nr, transpose, name, err)
                    ms = _device_ms(lambda: _launch(L, Y, X, transpose, g))
                    out.append(f"{name}[cpw {g.cpw} wpt {g.wpt} tpb "
                               f"{g.tpb}]={ms:.4f}")
                A = L.mT if transpose else L
                lib = _device_ms(lambda: torch.linalg.solve_triangular(
                    A, Y, upper=transpose))
                print(f"(B,C,NR)=({B},{C},{nr}) transpose={transpose} "
                      + " ".join(out) + f" solve_triangular={lib:.4f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
