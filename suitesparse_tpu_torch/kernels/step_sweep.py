"""Time K3 over its launch plans, beside the classic sweep's library route,
on one card.

    python3 -m suitesparse_tpu_torch.kernels.step_sweep [--quick]

For the 50 groups that the classic sweep sends to K3 in the n = 125k model
plan (``K3_GROUPS``, (B, C, RU)), in both directions at 1 and 64
right-hand sides, it times the kernel with the plan
:func:`solve_step_geometry` picks, with forced splits of RU (forward:
parts; backward: cluster sizes, 16 a non-portable cluster) and, at NR 1,
with forced warps an element and elements a block; and the library route that the sweep takes for the groups K3 does not
(``solve_triangular`` and ``baddbmm``); each kernel result is held
against ``solve_step_*_plain`` (1e-5 of the largest entry). L21 and the
(B, RU, NR) vectors are views into a packed (B, R, C) panel and a
(B, R, NR) buffer, as the sweep passes them. Times as ``bmv_sweep`` takes
them: device milliseconds, the mean of 20 calls, the L2 cache flushed and
a spin kernel queued before each, Python's garbage collector held off.
One line per case, after the card's name and power limit. ``--quick``
takes only the four groups ``chip_smoke.py`` times.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .bmv_sweep import L2_FLUSH_BYTES, _device_ms
from .solve_step import (_launch_bwd, _launch_fwd, solve_step_bwd_plain,
                         solve_step_fwd_plain, solve_step_geometry)

# (B, C, RU) of the 50 K3 groups of the n = 125k plan (METIS ordering,
# default tile threshold), in plan order; the same at nrhs 1 and 64
K3_GROUPS = (
    (8735, 8, 8), (2339, 8, 16), (89, 8, 16), (25, 8, 24), (549, 8, 24),
    (67, 8, 32), (142, 16, 24), (544, 16, 32), (367, 16, 48), (50, 16, 32),
    (539, 16, 48), (537, 16, 64), (286, 16, 96), (13, 16, 112), (16, 16, 64),
    (174, 16, 96), (17, 24, 96), (228, 16, 128), (44, 24, 128),
    (24, 32, 128), (68, 16, 168), (20, 24, 168), (19, 32, 176),
    (27, 16, 128), (30, 24, 128), (11, 32, 128), (45, 16, 184),
    (93, 24, 192), (114, 32, 192), (43, 48, 192), (8, 24, 256),
    (26, 32, 256), (15, 40, 248), (19, 24, 192), (27, 32, 192),
    (23, 48, 192), (14, 24, 256), (40, 32, 256), (51, 48, 256),
    (20, 32, 376), (40, 48, 376), (14, 48, 256), (45, 48, 384),
    (22, 64, 384), (13, 48, 496), (21, 64, 504), (10, 88, 376),
    (9, 64, 512), (14, 88, 504), (12, 96, 720))
QUICK = ((12, 96, 720), (45, 48, 384), (114, 32, 192), (8735, 8, 8))
SPLITS = {False: (1, 2, 4, 16, 32), True: (1, 2, 4, 8, 16)}
# other plans at NR 1: warps an element (the plan's split), elements a
# block (one part). At NR 64 fewer warps than chunks take the slabs one
# after another: 2-10x slower in an earlier sweep.
VARIANTS = {1: ({"wpt": 1}, {"wpt": 2}, {"wpt": 8},
                {"split": 1, "wpt": 1, "tpb": 4},
                {"lanes": 32}, {"lanes": 16}, {"lanes": 16, "tpb": 16}),
            64: ()}
NRS = (1, 64)
TOL = 1e-5


def library_fwd(L11, L21, Y, WB):
    """The classic sweep's forward step for the groups K3 does not take
    (``solve_triangular``, then ``baddbmm`` for L21): K3's yardstick."""
    xc = torch.linalg.solve_triangular(L11, Y, upper=False)
    return xc, torch.baddbmm(WB, L21, xc)


def library_bwd(L11, L21, Y, XB):
    """The same for a backward step: ``baddbmm``, then ``solve_triangular``
    on L11^T."""
    return torch.linalg.solve_triangular(
        L11.mT, torch.baddbmm(Y, L21.mT, XB, alpha=-1), upper=True)


def step_inputs(rng, B, C, RU, nr, dev):
    """L11 (diagonal in [1, 2], off-diagonal below 1/C, NaN above the
    diagonal), the L21 view, y and the (B, RU, NR) view."""
    R = C + RU
    L = np.tril(rng.uniform(-1.0, 1.0, (B, C, C)) / C, -1)
    L += np.eye(C) * rng.uniform(1.0, 2.0, (B, 1, C))
    L[:, np.triu_indices(C, 1)[0], np.triu_indices(C, 1)[1]] = np.nan
    P = torch.empty(B, R, C, device=dev)
    P[:, C:] = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, RU, C))
                               .astype(np.float32) / C, device=dev)
    Y = torch.as_tensor(rng.standard_normal((B, C, nr), dtype=np.float32),
                        device=dev)
    W = torch.as_tensor(rng.standard_normal((B, R, nr), dtype=np.float32),
                        device=dev)
    return (torch.as_tensor(L.astype(np.float32), device=dev), P[:, C:], Y,
            W[:, C:])


def _err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("step_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    groups = QUICK if "--quick" in argv else K3_GROUPS
    for B, C, RU in groups:
        for nr in NRS:
            L11, L21, Y, W = step_inputs(rng, B, C, RU, nr, dev)
            Lc = L11.nan_to_num(nan=0.0)     # the library reads it all
            pxc, pv = solve_step_fwd_plain(Lc, L21, Y, W)
            pxb = solve_step_bwd_plain(Lc, L21, Y, W)
            for tr in (False, True):
                plans = {"plan": solve_step_geometry(B, C, RU, nr, tr)}
                plans.update((f"split{s}", solve_step_geometry(
                    B, C, RU, nr, tr, split=s)) for s in SPLITS[tr])
                for kw in VARIANTS[nr]:
                    try:
                        plans["/".join(f"{k}{v}" for k, v in kw.items())] = \
                            solve_step_geometry(B, C, RU, nr, tr, **kw)
                    except ValueError:      # no room for that many elements
                        pass
                out = []
                for name, g in plans.items():
                    xc = torch.empty_like(Y)
                    if tr:
                        def run(g=g, xc=xc):
                            _launch_bwd(L11, L21, Y, W, xc, g)
                        run()
                        torch.cuda.synchronize()
                        err = _err(xc, pxb)
                    else:
                        v = torch.empty(B, RU, nr, device=dev)

                        def run(g=g, xc=xc, v=v):
                            _launch_fwd(L11, L21, Y, W, xc, v, g)
                        run()
                        torch.cuda.synchronize()
                        err = max(_err(xc, pxc), _err(v, pv))
                    assert err <= TOL, (B, C, RU, nr, tr, name, g, err)
                    ms = _device_ms(run, flush)
                    out.append(f"{name}(split {g.split} wpt {g.wpt} tpb "
                               f"{g.tpb} lanes {g.lanes})={ms:.4f}")
                lib = library_bwd if tr else library_fwd
                lib_ms = _device_ms(lambda: lib(Lc, L21, Y, W), flush)
                print(f"(B,C,RU,NR)=({B},{C},{RU},{nr}) "
                      f"{'bwd' if tr else 'fwd'} " + " ".join(out)
                      + f" library={lib_ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
