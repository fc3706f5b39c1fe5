#!/usr/bin/env python3
"""SHA-256 of the model problem's factor on one card, fp32 and fp64.

    python3 lx_digest.py

Factors ``laplacian_3d(50)`` (n = 125,000, METIS ordering, the default
configuration) through ``factorize`` on the card in fp32 and in fp64
(``compute_dtype="float64"``), and prints, after the card's name and power
limit, one JSON line: for each dtype the SHA-256 of the padded device
factor ``Lx`` (its bytes), its size and the w2 solve's residual. The
package imported is the one beside this script, so a copy of the script
placed in another checkout digests that checkout's factor: two checkouts
give the same digest where their factors agree bit for bit. Exits with
code 2 without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import numpy as np


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lx_digest: no CUDA device", file=sys.stderr)
        return 2
    import suitesparse_tpu_torch as sstt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    A = sstt.fixtures.laplacian_3d(50)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    S = sstt.analyze(A, cfg)
    b = 1.0 + np.arange(A.ncol) / A.ncol
    out = {"package": sstt.__file__}
    for dtype in ("float32", "float64"):
        c = cfg.replace(compute_dtype=dtype)
        F = sstt.factorize(A, S, c, device="cuda")
        assert F.ok, f"{dtype} factorization failed at column {F.minor}"
        lx = F.F.Lx.cpu().numpy()
        out[dtype] = {"lx_sha256": hashlib.sha256(lx.tobytes()).hexdigest(),
                      "lx_size": int(lx.size),
                      "residual": sstt.residual_norm(A, sstt.solve(F, b, c),
                                                     b)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
