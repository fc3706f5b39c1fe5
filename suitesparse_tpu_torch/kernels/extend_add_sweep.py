"""Time K7 at every group and every pair class that the factor places
through it, on one card.

    python3 -m suitesparse_tpu_torch.kernels.extend_add_sweep [--quick]

Plan: the n = 125k model plan (``laplacian_3d(50)``, METIS ordering,
default tile threshold). The factor launches K7 once a group with classes
to place: in fp32 the classes no tile manifest folds (381 classes in 41
groups), in fp64 every class (800 in 114 groups), and so with bfloat16
updates (``update_dtype="bfloat16"``, fp32 or fp64 fronts: every class,
through K7's bfloat16 instances). Each group's work list
(``build_work``, as the factor builds it) on random fronts and random
source update blocks made on the card from seed 0: the group form
(``extend_add_group``) held against ``extend_add_group_plain`` (1e-5 of
the largest entry in fp32, 1e-12 in fp64), then timed beside its band
height, its summed bound (``class_work`` of each class at 3.35 TB/s, the
child cells at the update's itemsize) and
``extend_add_library`` (one ``index_put_(accumulate=True)`` a class,
the placement the factor made before K7, summed over the group's
classes). The sums over the groups are the per-factor figures. On the ten
groups of each dtype with the most child cells, every band height of
``BANDS`` is timed beside the plan's pick. ``--quick`` stops there and
leaves out the library calls.

Then each of the 381 fp32 classes alone, in the factor's form (``src``),
through the one-class form ``extend_add`` (the factor's launch before the
group form), beside its bound and the library call.

Times as the other sweeps take them (``bmv_sweep._device_ms``): device
milliseconds, the mean of 20 calls (the library's: 3), the L2 cache
flushed and a spin kernel queued before each, Python's garbage collector
held off. After the card's name and power limit it prints the per-group
rows and sums for each dtype, the band heights, the per-class sums and
the 20 slowest classes; every class's line goes to
``prof_out/extend_add_classes.txt`` and every group's to
``prof_out/extend_add_groups.txt`` in the checkout.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from ..prof import OUT_DIR
from .bmv_sweep import L2_FLUSH_BYTES, _device_ms
from .extend_add import BANDS, build_work, class_maps, class_work, \
    extend_add, extend_add_group, extend_add_group_plain, \
    extend_add_library, extend_add_plain

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
HBM_BYTES_S = 3.35e12         # H100 SXM device memory rate
LIB_REPS = 3                  # the library scatter takes up to seconds a group
TOP = 10                      # groups a dtype whose band heights are timed


def unfolded_classes(plan):
    """(group, class index) of every pair class that no tile manifest
    folds, in plan order: the classes the fp32 factor places through K7."""
    out = []
    for gl in plan.groups:
        for g in gl:
            folded = set(g._tile.folded) if g._tile is not None else set()
            out += [(g, ci) for ci in range(len(g.pairs)) if ci not in folded]
    return out


def group_works(plan, dtype, udtype=None):
    """(group, its classes, its host work list) of each group the factor
    launches K7 on in ``dtype`` with updates in ``udtype`` (default
    ``dtype``), in plan order."""
    from ..numeric.supernodal_device import _tiled, k7_classes

    out = []
    for gl in plan.groups:
        for g in gl:
            skip = set(g._tile.folded) if g._tile is not None \
                and _tiled(dtype, udtype) else ()
            classes = k7_classes(g, skip)
            if classes:
                out.append((g, classes, build_work(g.B, g.R, classes)))
    return out


def _blocks(plan, work, gen, dev, dtype, udtype=None):
    """Random fronts and source update blocks (in ``udtype``, default
    ``dtype``) for ``work``."""
    F = torch.randn(work.B, work.R, work.R, generator=gen, device=dev,
                    dtype=dtype)
    Us = [torch.randn(plan.groups[k[0]][k[1]].B, int(RU), int(RU),
                      generator=gen, device=dev, dtype=dtype).to(
                          udtype or dtype)
          for k, (RU, *_r) in zip(work.keys, work.meta)]
    return F, Us


def sweep_groups(plan, dtype, gen, dev, flush, library=True, udtype=None):
    """The per-group table of one dtype, with updates in ``udtype``
    (without the library call's times where ``library`` is false); returns
    its rows."""
    itemsize = torch.finfo(dtype).bits // 8
    u_itemsize = torch.finfo(udtype or dtype).bits // 8
    rows = []
    for g, classes, host in group_works(plan, dtype, udtype):
        work = host.to(dev)
        F, Us = _blocks(plan, work, gen, dev, dtype, udtype)
        got = extend_add_group(F.clone(), Us, work)
        ref = extend_add_group_plain(F.clone(), Us, work)
        torch.cuda.synchronize()
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= TOL[dtype], (g.B, g.R, err)
        k7 = _device_ms(lambda: extend_add_group(F, Us, work), flush)
        Fbuf = torch.cat([F.reshape(-1), F.new_zeros(1)])
        tmaps = [class_maps(work, c) for c in range(len(Us))]

        def scatter():
            for U, (idx, dst, src) in zip(Us, tmaps):
                extend_add_library(Fbuf, U, idx, dst, g.R, src)

        lib = _device_ms(scatter, flush, LIB_REPS) if library else np.nan
        bound = sum(class_work(g.R, idx, dst, itemsize, src, u_itemsize)[0]
                    for _key, src, dst, idx in classes) / HBM_BYTES_S * 1e3
        rows.append(dict(
            g=g, classes=classes, host=host, k7=k7, bound=bound, lib=lib,
            line=f"(B,R)=({g.B},{g.R}) classes={len(Us)} "
                 f"band={work.geom.rows} blocks="
                 f"{sum(p[2].numel() for p in work.parts)} "
                 f"cells={work.cells} K7={k7:.4f} bound={bound:.5f} "
                 f"library={lib:.4f} K7/bound={k7 / bound:.1f} "
                 f"err={err:.1e}"))
        del F, Us, Fbuf, got, ref
    return rows


def band_heights(plan, rows, dtype, gen, dev, flush, udtype=None):
    """Every band height of BANDS on the TOP groups with the most cells."""
    for r in sorted(rows, key=lambda r: -r["host"].cells)[:TOP]:
        g, host = r["g"], r["host"]
        F, Us = _blocks(plan, host, gen, dev, dtype, udtype)
        times = []
        for h in BANDS:
            w = build_work(g.B, g.R, r["classes"], rows=h).to(dev)
            ms = _device_ms(lambda: extend_add_group(F, Us, w), flush)
            times.append(f"{h}={ms:.4f}")
        print(f"  band heights (B,R)=({g.B},{g.R}) plan={host.geom.rows}: "
              + " ".join(times), flush=True)
        del F, Us


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
    quick = "--quick" in sys.argv[1:]
    os.makedirs(OUT_DIR, exist_ok=True)
    lines = []
    bf = torch.bfloat16
    for dtype, udtype in ((torch.float32, None), (torch.float64, None),
                          (torch.float32, bf), (torch.float64, bf)):
        rows = sweep_groups(plan, dtype, gen, dev, flush, not quick, udtype)
        name = str(dtype).split(".")[-1] + ("_bf16" if udtype else "")
        lines += [f"{name} {r['line']}" for r in rows]
        k7 = np.array([r["k7"] for r in rows])
        print(f"{name}: {len(rows)} groups, "
              f"{sum(len(r['host'].keys) for r in rows)} classes, "
              f"{sum(len(r['host'].parts) for r in rows)} launches: K7 sum="
              f"{k7.sum():.4f} ms bound sum="
              f"{sum(r['bound'] for r in rows):.4f} ms library sum="
              f"{sum(r['lib'] for r in rows):.4f} ms; K7 per group min="
              f"{k7.min():.4f} median={np.median(k7):.4f} max={k7.max():.4f}",
              flush=True)
        for r in sorted(rows, key=lambda r: -r["k7"])[:15]:
            print(f"  {r['line']}", flush=True)
        band_heights(plan, rows, dtype, gen, dev, flush, udtype)
    with open(os.path.join(OUT_DIR, "extend_add_groups.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if quick:
        return 0

    rows = []
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
        assert err <= TOL[torch.float32], (g.B, g.R, pc.npairs, pc.RU_c, err)
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
        del F, U, Fbuf, got, ref
    k7s = np.array([r[0] for r in rows])
    ratio = k7s / np.array([r[1] for r in rows])
    with open(os.path.join(OUT_DIR, "extend_add_classes.txt"), "w") as f:
        f.write("\n".join(r[3] for r in rows) + "\n")
    print(f"{len(rows)} classes one launch each: K7 sum={k7s.sum():.4f} ms "
          f"bound sum={sum(r[1] for r in rows):.4f} ms library sum="
          f"{sum(r[2] for r in rows):.4f} ms; K7 per class min="
          f"{k7s.min():.4f} median={np.median(k7s):.4f} max={k7s.max():.4f}"
          f"; K7/bound min={ratio.min():.1f} median={np.median(ratio):.1f} "
          f"max={ratio.max():.1f}", flush=True)
    for r in sorted(rows, key=lambda r: -r[0])[:20]:
        print(r[3], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
