"""Time K2 and K2b over their launch plans on one card, and K2 beside the
factor's placement (K7) on groups below the tile threshold.

    python3 -m suitesparse_tpu_torch.kernels.tile_sweep

Plan: every tile manifest of the n = 125k model plan (``laplacian_3d(50)``,
METIS ordering, tile threshold R >= 256: 73 groups), one-piece (K2) and
two-piece (K2b), timed with each split of ``SPLITS`` (the one
:func:`tile_geometry` picks marked) beside the manifest's bound
(``manifest_work`` at 3.35 TB/s). Each kernel result is held against
``extend_add_tiles_plain`` (1e-6 of the largest entry) and every split must
give the same bits. The sums over the 73 groups are the per-factor
figures; with them, the child bytes the manifests add, the 32-byte
sectors those cells lie in, and the Ucat bytes the factor zeroes and
fills around the kernel.

Off the plan: the manifests that ``build_plan(..., tile_rmin=128)`` gives
the three largest groups below the threshold, ``SUB_GROUPS``, which the
factor places class by class with K7 (``extend_add``, one launch a
class). For each, K2 alone, the tile route (Ucat zeroed and filled as the
factor fills it, then K2), K7 over the same classes and the library
scatter ``extend_add_library`` (one ``index_put_(accumulate=True)`` a
class), on the same child blocks; the routes must agree on the lower
tiles (1e-5). Routing does not change here.

Times as the other sweeps take them (``bmv_sweep._device_ms``): device
milliseconds, the mean of 20 calls, the L2 cache flushed and a spin kernel
queued before each, Python's garbage collector held off. Inputs are made
on the card from seed 0. One line per case, after the card's name and
power limit.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .bmv_sweep import L2_FLUSH_BYTES, _device_ms
from .extend_add_tiles import (SPLITS, TILE, _launch, extend_add_tiles_plain,
                               manifest_work, tile_geometry)

SIZE = 50                     # laplacian_3d(50): n = 125,000
SUB_GROUPS = ((114, 224, 32), (93, 216, 24), (228, 144, 16))   # (B, R, C)
SUB_RMIN = 128
TOL = 1e-6
ROUTE_TOL = 1e-5
HBM_BYTES_S = 3.35e12         # H100 SXM device memory rate


def _analysis():
    import suitesparse_tpu_torch as sstt
    from suitesparse_tpu_torch.numeric import supernodal

    A = sstt.fixtures.laplacian_3d(SIZE)
    cfg = sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS)
    S = supernodal.supernodal_symbolic(A, sstt.analyze(A, cfg), cfg)
    return S, A.symperm(S.perm).transpose()


def _tile_groups(plan):
    return [g for gl in plan.groups for g in gl if g._tile is not None]


def _inputs(g, gen, dev):
    """F (B, R, R) and Ucat (K, RUp, RUp) from ``gen``; 5% of Ucat's upper
    cells NaN, which the kernel must count as zero."""
    tm = g._tile
    F = torch.randn(g.B, g.R, g.R, generator=gen, device=dev)
    U = torch.randn(max(tm.nslots, 1), tm.RUp, tm.RUp, generator=gen,
                    device=dev)
    upper = torch.ones(tm.RUp, tm.RUp, dtype=torch.bool, device=dev).triu(1)
    U[(torch.rand(U.shape, generator=gen, device=dev) < 0.05) & upper] = \
        float("nan")
    return F, U


def _device_args(g, dev):
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (g._tile.man, g._tile.rowmap, g._tile.colmap,
                           g._tile_runs))


def _sector_bytes(tm) -> int:
    """Bytes of the 32-byte sectors of Ucat that a manifest's valid child
    cells lie in (each piece's rows; a row of Ucat starts on a sector)."""
    total = 0
    for m, rm, cm in zip(tm.man, tm.rowmap, tm.colmap):
        for p in range(rm.shape[0]):
            blkc, blkc2 = m[[8, 9]] if tm.man.shape[1] == 10 \
                else m[7 + 5 * p:9 + 5 * p]
            c = cm[p][cm[p] >= 0]
            cc = np.where(c < TILE, blkc, blkc2) * TILE + c % TILE
            total += 32 * np.unique(cc // 8).size * int((rm[p] >= 0).sum())
    return total


def _err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def sweep_plan(plans, dev, gen, flush) -> None:
    """Every manifest of the plans ({form: plan}) at every split."""
    for form, plan in plans.items():
        sums = dict.fromkeys(("plan", "best", "bound",
                              *(f"split{s}" for s in SPLITS)), 0.0)
        cells = sectors = ucat = 0.0
        for g in _tile_groups(plan):
            npiece = 1 if g._tile.man.shape[1] == 10 else 2
            nruns = len(g._tile_runs) - 1
            F0, U = _inputs(g, gen, dev)
            args = _device_args(g, dev)
            ref = extend_add_tiles_plain(F0.clone(), U, *args[:3])
            plan_split = tile_geometry(nruns, g.R, g._tile.RUp, npiece).split
            out, first = {}, None
            for split in SPLITS:
                geo = tile_geometry(nruns, g.R, g._tile.RUp, npiece, split)
                F = F0.clone()
                _launch(F, U, *args, geo)
                torch.cuda.synchronize()
                if first is None:
                    err = _err(F, ref)
                    assert err <= TOL, (form, g.B, g.R, split, err)
                    first = F.clone()     # F itself takes the timed calls
                else:
                    assert torch.equal(F, first), (form, g.B, g.R, split)
                out[split] = _device_ms(
                    lambda: _launch(F, U, *args, geo), flush)
            nbytes, adds = manifest_work(g._tile, g._tile_runs, g.R)
            bound = nbytes / HBM_BYTES_S * 1e3
            cells += 4.0 * adds
            sectors += _sector_bytes(g._tile)
            ucat += 4.0 * max(g._tile.nslots, 1) * g._tile.RUp ** 2
            for split, ms in out.items():
                sums[f"split{split}"] += ms
            sums["plan"] += out[plan_split]
            sums["best"] += min(out.values())
            sums["bound"] += bound
            print(f"{form} (B,R)=({g.B},{g.R}) tiles={nruns} "
                  f"steps={g._tile.man.shape[0]} RUp={g._tile.RUp} "
                  + " ".join(f"split{s}={ms:.4f}" for s, ms in out.items())
                  + f" plan=split{plan_split} bound={bound:.4f}", flush=True)
            del F0, U, F, first, ref
        print(f"{form} child cells {cells / 1e6:.1f} MB in "
              f"{sectors / 1e6:.1f} MB of 32-byte sectors; Ucat, zeroed and "
              f"filled around the kernel, {ucat / 1e9:.3f} GB a factor",
              flush=True)
        print(f"{form} sum over {len(_tile_groups(plan))} manifests (ms): "
              + " ".join(f"{k}={v:.4f}" for k, v in sums.items()), flush=True)


def sweep_sub(S, C_low, dev, gen, flush) -> None:
    """K2 against K7 and the library scatter on SUB_GROUPS, manifests at
    SUB_RMIN."""
    from suitesparse_tpu_torch.kernels.extend_add import (extend_add,
                                                          extend_add_library)
    from suitesparse_tpu_torch.numeric.supernodal_device import build_plan

    plan = build_plan(S, C_low, tile_rmin=SUB_RMIN)
    for key in SUB_GROUPS:
        (g,) = [g for g in _tile_groups(plan) if (g.B, g.R, g.C) == key]
        tm, R = g._tile, g.R
        blocks = [torch.randn(g._pair_arrays[ci][0].size, g.pairs[ci].RU_c,
                              g.pairs[ci].RU_c, generator=gen, device=dev)
                  for ci in tm.folded]
        pairs = [(torch.as_tensor(dst, device=dev),
                  torch.as_tensor(idx, device=dev))
                 for _src, dst, idx in (g._pair_arrays[ci]
                                        for ci in tm.folded)]
        F0 = torch.randn(g.B, R, R, generator=gen, device=dev)
        args = _device_args(g, dev)
        nruns = len(g._tile_runs) - 1
        geo = tile_geometry(nruns, R, tm.RUp, 1)

        def stage():
            Ucat = torch.zeros(max(tm.nslots, 1), tm.RUp, tm.RUp, device=dev)
            for (_ci, k0, _key, RU_c, _src), blk in zip(tm.uslices, blocks):
                Ucat[k0:k0 + blk.shape[0], :RU_c, :RU_c] = blk
            return Ucat

        def tile_route(F):
            _launch(F, stage(), *args, geo)

        def k7_route(F):
            for blk, (dst, idx) in zip(blocks, pairs):
                extend_add(F, blk, idx, dst)

        def library_route(Fbuf):
            for blk, (dst, idx) in zip(blocks, pairs):
                extend_add_library(Fbuf, blk, idx, dst, R)

        Ucat = stage()
        Ft = F0.clone()
        tile_route(Ft)
        F7 = F0.clone()
        k7_route(F7)
        Fbuf = torch.cat([F0.reshape(-1), F0.new_zeros(1)])
        library_route(Fbuf)
        torch.cuda.synchronize()
        t = torch.arange(R, device=dev) // TILE
        low = (t[:, None] >= t[None, :]).expand(g.B, R, R)
        err = max(_err(Ft[low], F7[low]),
                  _err(Ft[low], Fbuf[:-1].view(g.B, R, R)[low]))
        assert err <= ROUTE_TOL, (key, err)
        Fk = F0.clone()
        k2 = _device_ms(lambda: _launch(Fk, Ucat, *args, geo), flush)
        route = _device_ms(lambda: tile_route(Fk), flush)
        k7 = _device_ms(lambda: k7_route(Fk), flush)
        lib = _device_ms(lambda: library_route(Fbuf), flush)
        nbytes, _ = manifest_work(tm, g._tile_runs, R)
        print(f"below threshold (B,R,C)={key} classes={len(tm.folded)} "
              f"pairs={sum(b.shape[0] for b in blocks)} tiles={nruns} "
              f"steps={tm.man.shape[0]} RUp={tm.RUp} split={geo.split} "
              f"K2={k2:.4f} stage+K2={route:.4f} K7={k7:.4f} "
              f"library={lib:.4f} "
              f"K2_bound={nbytes / HBM_BYTES_S * 1e3:.4f} "
              f"route_err={err:.2e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from suitesparse_tpu_torch.numeric.supernodal_device import build_plan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    S, C_low = _analysis()
    sweep_plan({"K2": build_plan(S, C_low),
                "K2b": build_plan(S, C_low, tile_pair=True)}, dev, gen, flush)
    sweep_sub(S, C_low, dev, gen, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
