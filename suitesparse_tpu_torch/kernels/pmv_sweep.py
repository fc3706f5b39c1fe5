"""Time K5 over its blocks-per-tile choices, beside ``torch.bmm``, on one card.

    python3 -m suitesparse_tpu_torch.kernels.pmv_sweep

For the 14 groups that the w2 route sends to K5 in the n = 125k model plan
(W2 of shape (B, R, C)), in both orientations (forward M = W2^T (B, C, R),
backward M = W2) at 1 and 8 right-hand sides, it times the kernel with the
plan :func:`pmv_geometry` picks and with ``split`` = 1, 2, 4 and 8 blocks a
column tile (a cluster of that size), and one ``torch.bmm(M.mT, X)`` on
the same inputs; each result is held against ``pmatvec_t_plain`` (1e-5 of
the largest entry). Times as ``chip_smoke.py`` takes them: device
milliseconds, the mean of 20 calls, the L2 cache flushed before each and a
spin kernel ahead of each, so that the host's launch is not timed (the
timer of ``bmv_sweep``). One line per case, after the card's name and
power limit, with the byte bound (3.35 TB/s).
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .bmv_sweep import L2_FLUSH_BYTES, _device_ms
from .pmatvec import _launch, pmatvec_t_plain, pmv_geometry

# (B, R, C) of the 14 K5 groups of the n = 125k plan, largest first
GROUPS = ((1, 3864, 3864), (5, 2712, 696), (3, 3288, 664), (1, 3912, 1408),
          (8, 1608, 352), (13, 1512, 192), (15, 936, 168), (1, 2792, 672),
          (8, 1064, 176), (12, 888, 128), (2, 2208, 304), (1, 2176, 552),
          (10, 896, 128), (1, 2168, 504))
SPLITS = (1, 2, 4, 8)
TOL = 1e-5
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate


def main() -> int:
    if not torch.cuda.is_available():
        print("pmv_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    for B, R, C in GROUPS:
        W2 = torch.as_tensor(rng.standard_normal((B, R, C), dtype=np.float32),
                             device=dev)
        for M, orient in ((W2.mT.contiguous(), "W2^T"), (W2, "W2")):
            _, K, N = M.shape
            for nr in (1, 8):
                X = torch.as_tensor(rng.standard_normal((B, K, nr),
                                                        dtype=np.float32),
                                    device=dev)
                ref = pmatvec_t_plain(M, X)
                plans = {"plan": pmv_geometry(B, K, N, nr)}
                plans.update((f"split{s}", pmv_geometry(B, K, N, nr, split=s))
                             for s in SPLITS)
                out = []
                for name, g in plans.items():
                    Z = torch.empty_like(ref)
                    _launch(M, X, Z, g)
                    torch.cuda.synchronize()
                    err = ((Z - ref).abs().max() / ref.abs().max()).item()
                    assert err <= TOL, (B, K, N, nr, name, err)
                    ms = _device_ms(lambda: _launch(M, X, Z, g), flush)
                    out.append(f"{name}(tw {g.tw} warps {g.warps} split "
                               f"{g.split})={ms:.4f}")
                bmm = _device_ms(lambda: torch.bmm(M.mT, X), flush)
                bound = 4.0 * B * (K * N + K * nr + N * nr) / HBM_BYTES_S * 1e3
                print(f"(B,K,N,NR)=({B},{K},{N},{nr}) M={orient} "
                      + " ".join(out) + f" bmm={bmm:.4f} bound={bound:.4f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
