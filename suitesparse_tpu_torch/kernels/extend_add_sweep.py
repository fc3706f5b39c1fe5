"""Time K7 at every pair class that the factor places through it, on one
card.

    python3 -m suitesparse_tpu_torch.kernels.extend_add_sweep

Plan: the n = 125k model plan (``laplacian_3d(50)``, METIS ordering,
default tile threshold), whose fp32 factor places through K7 each pair
class that no tile manifest folds (381 classes). For each, in plan order,
on random fronts and a random source update block made on the card from
seed 0, in the factor's form (``src``): K7 held against
``extend_add_plain`` (1e-5 of the largest entry), then timed beside its
bound (``class_work`` at 3.35 TB/s) and beside ``extend_add_library``
(one ``index_put_(accumulate=True)``, the placement the factor made
before K7). The sums over the classes are the per-factor figures.

Times as the other sweeps take them (``bmv_sweep._device_ms``): device
milliseconds, the mean of 20 calls, the L2 cache flushed and a spin kernel
queued before each, Python's garbage collector held off. After the card's
name and power limit it prints the sums, the spread of K7's time over its
bound, the sums by batch size B (one block a slot: a class of B slots
fills B of the card's 132 SMs) and the 20 slowest classes; every class's
line goes to ``prof_out/extend_add_classes.txt`` in the checkout.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from ..prof import OUT_DIR
from .bmv_sweep import L2_FLUSH_BYTES, _device_ms
from .extend_add import class_work, extend_add, extend_add_library, \
    extend_add_plain

TOL = 1e-5
HBM_BYTES_S = 3.35e12         # H100 SXM device memory rate


def unfolded_classes(plan):
    """(group, class index) of every pair class that no tile manifest
    folds, in plan order: the classes the fp32 factor places through K7."""
    out = []
    for gl in plan.groups:
        for g in gl:
            folded = set(g._tile.folded) if g._tile is not None else set()
            out += [(g, ci) for ci in range(len(g.pairs)) if ci not in folded]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("extend_add_sweep: no CUDA device", file=sys.stderr)
        return 2
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import supernodal
    from suitesparse_tpu_torch.numeric.supernodal_device import build_plan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    A = sstt.fixtures.laplacian_3d(50)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    S = supernodal.supernodal_symbolic(A, sstt.analyze(A, cfg), cfg)
    plan = build_plan(S, A.symperm(S.perm).transpose())
    rows, by_b = [], {}
    for g, ci in unfolded_classes(plan):
        pc = g.pairs[ci]
        src, dst, idx = g._pair_arrays[ci]
        B_c = plan.groups[pc.src_level][pc.src_gi].B
        it, dt, st = (torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                      device=dev) for a in (idx, dst, src))
        F = torch.randn(g.B, g.R, g.R, generator=gen, device=dev)
        U = torch.randn(B_c, pc.RU_c, pc.RU_c, generator=gen, device=dev)
        got = extend_add(F.clone(), U, it, dt, st)
        ref = extend_add_plain(F.clone(), U, it, dt, st)
        torch.cuda.synchronize()
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= TOL, (g.B, g.R, pc.npairs, pc.RU_c, err)
        k7 = _device_ms(lambda: extend_add(F, U, it, dt, st), flush)
        Fbuf = torch.cat([F.reshape(-1), F.new_zeros(1)])
        lib = _device_ms(lambda: extend_add_library(Fbuf, U, it, dt, g.R, st),
                         flush)
        nbytes, adds = class_work(g.R, idx, dst, 4, src)
        bound = nbytes / HBM_BYTES_S * 1e3
        rows.append((k7, bound, lib, f"(B,R)=({g.B},{g.R}) (np,RU)="
                     f"({pc.npairs},{pc.RU_c}) B_c={B_c} cells={adds:.0f} "
                     f"K7={k7:.4f} bound={bound:.5f} library={lib:.4f} "
                     f"K7/bound={k7 / bound:.1f} err={err:.1e}"))
        s = by_b.setdefault(g.B, [0, 0.0, 0.0])
        s[0], s[1], s[2] = s[0] + 1, s[1] + k7, s[2] + bound
        del F, U, Fbuf, got, ref
    k7s = np.array([r[0] for r in rows])
    ratio = k7s / np.array([r[1] for r in rows])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "extend_add_classes.txt"), "w") as f:
        f.write("\n".join(r[3] for r in rows) + "\n")
    print(f"{len(rows)} classes: K7 sum={k7s.sum():.4f} ms bound sum="
          f"{sum(r[1] for r in rows):.4f} ms library sum="
          f"{sum(r[2] for r in rows):.4f} ms; K7 per class min="
          f"{k7s.min():.4f} median={np.median(k7s):.4f} max={k7s.max():.4f}"
          f"; K7/bound min={ratio.min():.1f} median={np.median(ratio):.1f} "
          f"max={ratio.max():.1f}", flush=True)
    for B, (n, k7, bound) in sorted(by_b.items()):
        print(f"B={B}: classes={n} K7 sum={k7:.4f} ms bound sum={bound:.4f}",
              flush=True)
    for r in sorted(rows, key=lambda r: -r[0])[:20]:
        print(r[3], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
