"""Time K1 over its launch plans, beside the factor's library route, on one
card.

    python3 -m suitesparse_tpu_torch.kernels.potrf_sweep [--parent DIR]

For the 24 groups that the factor sends to K1 in the n = 125k model plan
(``K1_GROUPS``, (B, C, RU)), it times the kernel with the plan
:func:`potrf_geometry` picks, with forced splits of RU, forced tiles a
warp (C <= 32) and forced warps a tile (C > 32), and the route the factor
takes for the groups K1 does not (``cholesky_ex``, then
``solve_triangular``, as ``_group_compute`` calls them). Every kernel
result is held against ``potrf_trsm_plain`` (1e-5 of the largest entry),
and every forced plan must give the plan's bits. With ``--parent DIR``, a
checkout of an earlier tree, it builds that tree's kernels and times its
K1 on the same inputs. Then, for a later routing decision only, K1's plan
beside the library route on the 65 groups of the plan with C <= 96 that
the gate (B >= 32) sends to the library (``LIBRARY_GROUPS``). Times as
``bmv_sweep`` takes them: device milliseconds, the mean of 20 calls, the
L2 cache flushed and a spin kernel queued before each, Python's garbage
collector held off. One line per case, after the card's name and power
limit, then the sums.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

from .bmv_sweep import L2_FLUSH_BYTES, _device_ms
from .potrf import _launch, potrf_geometry, potrf_trsm_plain

# (B, C, RU) of the 24 K1 groups of the n = 125k plan (METIS ordering,
# default tile threshold), in plan order
K1_GROUPS = (
    (8735, 8, 8), (2339, 8, 16), (89, 8, 16), (549, 8, 24), (67, 8, 32),
    (142, 16, 24), (544, 16, 32), (367, 16, 48), (50, 16, 32),
    (539, 16, 48), (537, 16, 64), (286, 16, 96), (174, 16, 96),
    (228, 16, 128), (44, 24, 128), (68, 16, 168), (45, 16, 184),
    (93, 24, 192), (114, 32, 192), (43, 48, 192), (40, 32, 256),
    (51, 48, 256), (40, 48, 376), (45, 48, 384))
# (B, C, RU) of the 65 groups of the same plan with C <= 96 and B < 32,
# which the gate sends to cholesky_ex + solve_triangular
LIBRARY_GROUPS = (
    (25, 8, 24), (7, 16, 16), (7, 16, 24), (13, 16, 112), (1, 16, 48),
    (16, 16, 64), (17, 24, 96), (7, 32, 96), (24, 32, 128), (2, 40, 112),
    (20, 24, 168), (19, 32, 176), (1, 40, 168), (5, 16, 96), (3, 24, 96),
    (3, 32, 96), (27, 16, 128), (2, 40, 88), (30, 24, 128), (11, 32, 128),
    (3, 40, 128), (1, 16, 208), (8, 24, 256), (26, 32, 256), (15, 40, 248),
    (1, 24, 296), (1, 32, 272), (1, 24, 104), (1, 32, 128), (2, 16, 160),
    (19, 24, 192), (27, 32, 192), (23, 48, 192), (1, 16, 248),
    (14, 24, 256), (3, 64, 256), (7, 24, 328), (20, 32, 376), (2, 56, 280),
    (2, 48, 408), (1, 24, 128), (3, 48, 192), (2, 56, 192), (2, 32, 248),
    (14, 48, 256), (5, 64, 256), (6, 32, 360), (22, 64, 384), (3, 72, 360),
    (13, 48, 496), (21, 64, 504), (7, 80, 488), (3, 64, 608), (1, 32, 248),
    (1, 64, 256), (1, 48, 312), (4, 64, 368), (10, 88, 376), (2, 48, 488),
    (9, 64, 512), (14, 88, 504), (7, 64, 640), (12, 96, 720), (1, 88, 784),
    (4, 96, 512))
SPLITS = (1, 2, 4, 8, 16)
VARIANTS = ({"tpw": 1}, {"tpw": 2}, {"tpw": 4}, {"wpt": 4}, {"wpt": 8})
TOL = 1e-5
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOP_S = 67e12     # H100 SXM fp32 rate outside the tensor cores


def tiles(rng, B, C, RU, dev):
    """F11 = M M^T + C I (SPD, well conditioned) and F21 ~ N(0, 1)."""
    M = rng.standard_normal((B, C, C), dtype=np.float32)
    f11 = torch.as_tensor(M @ np.swapaxes(M, 1, 2)
                          + C * np.eye(C, dtype=np.float32), device=dev)
    f21 = torch.as_tensor(rng.standard_normal((B, RU, C), dtype=np.float32),
                          device=dev) if RU else None
    return f11, f21


def library_route(f11, f21):
    """The factor's route for the groups K1 does not take: ``cholesky_ex``
    (a failed tile all NaN), then ``solve_triangular`` for L21; K1's
    yardstick."""
    L, info = torch.linalg.cholesky_ex(f11)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    if f21 is None:
        return L, None
    return L, torch.linalg.solve_triangular(L.mT, f21, upper=True,
                                            left=False)


def bound_ms(B, C, RU) -> tuple[float, str]:
    """The least ms the card could take: F11 read and L11 written as lower
    triangles, F21 read and L21 written, at 3.35 TB/s; or C^3/3 + RU C^2
    flops a tile at 67 TFLOP/s, whichever is larger (``chip_smoke.py``'s
    bound)."""
    t_bytes = 4.0 * B * (C * (C + 1) + 2 * RU * C) / HBM_BYTES_S * 1e3
    t_ops = B * (C ** 3 / 3 + RU * C * C) / FP32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def parent_kernel(root: str):
    """sst_potrf_trsm of the tree at ``root`` (built by that tree's own
    ``kernels/_build.py`` into its build directory), as a function of
    (f11, f21, L11, L21)."""
    path = os.path.join(root, "suitesparse_tpu_torch", "kernels",
                        "_build.py")
    spec = importlib.util.spec_from_file_location("_parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.load()

    def run(f11, f21, L11, L21):
        B, C, _ = f11.shape
        RU = 0 if f21 is None else f21.shape[1]
        err = lib.sst_potrf_trsm(
            f11.data_ptr(), f21.data_ptr() if RU else None, L11.data_ptr(),
            L21.data_ptr() if RU else None, B, C, RU,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"parent potrf_trsm: cudaError {err}"
    return run


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("potrf_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    parent = None
    if "--parent" in argv:
        parent = parent_kernel(argv[argv.index("--parent") + 1])
    sums = {"plan": 0.0, "best": 0.0, "library": 0.0, "parent": 0.0,
            "bound": 0.0}
    for B, C, RU in K1_GROUPS:
        f11, f21 = tiles(rng, B, C, RU, dev)
        P11, P21 = potrf_trsm_plain(f11, f21)
        plans = {"plan": potrf_geometry(B, C, RU)}
        for s in SPLITS:
            if s <= max(RU, 1):
                plans[f"split{s}"] = potrf_geometry(B, C, RU, split=s)
        for kw in VARIANTS:
            try:
                plans["/".join(f"{k}{v}" for k, v in kw.items())] = \
                    potrf_geometry(B, C, RU, **kw)
            except ValueError:      # not a team for this C
                pass
        out, ref, times = [], None, {}
        for name, g in plans.items():
            L11 = torch.empty_like(f11)
            L21 = None if f21 is None else torch.empty_like(f21)

            def run(g=g, L11=L11, L21=L21):
                _launch(f11, f21, L11, L21, g)
            run()
            torch.cuda.synchronize()
            err = rel_err(L11, P11)
            if RU:
                err = max(err, rel_err(L21, P21))
            assert err <= TOL, (B, C, RU, name, g, err)
            got = (L11.clone(), None if L21 is None else L21.clone())
            run()
            torch.cuda.synchronize()
            same = torch.equal(L11, got[0]) and (
                RU == 0 or torch.equal(L21, got[1]))
            if ref is None:
                ref = got
            same = same and torch.equal(got[0], ref[0]) and (
                RU == 0 or torch.equal(got[1], ref[1]))
            assert same, f"{(B, C, RU)} {name}: not the plan's bits"
            times[name] = _device_ms(run, flush)
            out.append(f"{name}(split {g.split} tpw {g.tpw} wpt {g.wpt} "
                       f"warps {g.warps})={times[name]:.4f}")
        lib_ms = _device_ms(lambda: library_route(f11, f21), flush)
        L, L21l = library_route(f11, f21)
        lib_err = max(rel_err(L, P11),
                      rel_err(L21l, P21) if RU else 0.0)
        b_ms, b_by = bound_ms(B, C, RU)
        line = (f"(B,C,RU)=({B},{C},{RU}) " + " ".join(out)
                + f" library={lib_ms:.4f} (err {lib_err:.1e})")
        if parent is not None:
            L11 = torch.empty_like(f11)
            L21 = None if f21 is None else torch.empty_like(f21)
            parent(f11, f21, L11, L21)
            torch.cuda.synchronize()
            perr = max(rel_err(L11, P11), rel_err(L21, P21) if RU else 0.0)
            assert perr <= TOL, (B, C, RU, "parent", perr)
            par_ms = _device_ms(lambda: parent(f11, f21, L11, L21), flush)
            sums["parent"] += par_ms
            line += f" parent={par_ms:.4f}"
        print(line + f" bound={b_ms:.4f} ({b_by})", flush=True)
        sums["plan"] += times["plan"]
        sums["best"] += min(times.values())
        sums["library"] += lib_ms
        sums["bound"] += b_ms
    print("sum over the groups: " + " ".join(
        f"{k}={v:.4f}" for k, v in sums.items()
        if parent is not None or k != "parent"), flush=True)
    k1 = lib = 0.0
    for B, C, RU in LIBRARY_GROUPS:
        f11, f21 = tiles(rng, B, C, RU, dev)
        P11, P21 = potrf_trsm_plain(f11, f21)
        g = potrf_geometry(B, C, RU)
        L11 = torch.empty_like(f11)
        L21 = None if f21 is None else torch.empty_like(f21)
        _launch(f11, f21, L11, L21, g)
        torch.cuda.synchronize()
        err = max(rel_err(L11, P11), rel_err(L21, P21) if RU else 0.0)
        assert err <= TOL, (B, C, RU, "plan", err)
        ms = _device_ms(lambda: _launch(f11, f21, L11, L21, g), flush)
        lib_ms = _device_ms(lambda: library_route(f11, f21), flush)
        k1, lib = k1 + ms, lib + lib_ms
        print(f"gate B<32 (B,C,RU)=({B},{C},{RU}) plan={ms:.4f} "
              f"library={lib_ms:.4f} kernel/library={ms / lib_ms:.2f}",
              flush=True)
    print(f"sum over the {len(LIBRARY_GROUPS)} groups below the gate: "
          f"plan={k1:.4f} library={lib:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
