"""Time K6 over its blocks-per-panel choices, beside ``torch.bmm``, on one card.

    python3 -m suitesparse_tpu_torch.kernels.bmv_sweep

For the four largest K6 groups of the n = 125k model plan and the two
off-plan shapes of ``chip_smoke.py`` (W2 of shape (B, R, C)), in both
directions at 1 and 8 right-hand sides, it times the kernel with the plan
:func:`bmv_geometry` picks and with ``split`` = 1, 2, 4 and 8 blocks a
panel (transposed: a cluster of that size), and one ``torch.bmm`` on the
same inputs; each result is held against ``bmatvec_plain`` (1e-5 of the
largest entry). Times as ``chip_smoke.py`` takes them: device
milliseconds, the mean of 20 calls, the L2 cache flushed before each and a
spin kernel ahead of each, so that the host's launch is not timed. One
line per case, after the card's name and power limit.
"""

from __future__ import annotations

import gc
import subprocess
import sys

import numpy as np
import torch

from .bmatvec import _launch, bmatvec_plain, bmv_geometry

SHAPES = ((8735, 16, 8), (45, 432, 48), (114, 224, 32), (40, 424, 48),
          (37, 45, 13), (4, 6000, 52))
SPLITS = (1, 2, 4, 8)
REPS = 20
TOL = 1e-5
L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2 cache
SPIN_CYCLES = 2_000_000     # about 1 ms of device spin before each call


def _device_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Mean device milliseconds of fn() over ``reps`` calls, after a warm
    one."""
    fn()
    total = 0.0
    gc.disable()
    try:
        for _ in range(reps):
            flush.zero_()
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
    return total / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("bmv_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    for B, R, C in SHAPES:
        W2 = torch.as_tensor(rng.standard_normal((B, R, C), dtype=np.float32),
                             device=dev)
        for transpose in (False, True):
            Mk = W2.mT if transpose else W2
            for nr in (1, 8):
                X = torch.as_tensor(rng.standard_normal(
                    (B, R if transpose else C, nr), dtype=np.float32),
                    device=dev)
                ref = bmatvec_plain(W2, X, transpose)
                plans = {"plan": bmv_geometry(B, R, C, nr, transpose)}
                plans.update((f"split{s}", bmv_geometry(
                    B, R, C, nr, transpose, split=s)) for s in SPLITS)
                out = []
                for name, g in plans.items():
                    Z = torch.empty_like(ref)
                    _launch(W2, X, Z, transpose, g)
                    torch.cuda.synchronize()
                    err = ((Z - ref).abs().max() / ref.abs().max()).item()
                    assert err <= TOL, (B, R, C, nr, transpose, name, err)
                    ms = _device_ms(
                        lambda: _launch(W2, X, Z, transpose, g), flush)
                    out.append(f"{name}(split {g.split})={ms:.4f}")
                bmm = _device_ms(lambda: torch.bmm(Mk, X), flush)
                print(f"(B,R,C,NR)=({B},{R},{C},{nr}) transpose={transpose} "
                      + " ".join(out) + f" bmm={bmm:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
