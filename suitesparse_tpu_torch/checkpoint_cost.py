"""Checkpoint cost of the port: a factor saved and loaded back, plain and
deflated.

    python3 -m suitesparse_tpu_torch.checkpoint_cost [--nx 50]

Factors the 3-D Laplacian on the card (the model problem at the default
``--nx``), saves it with ``serialize.save_factor`` (a plain ``.npz``; its
seconds include ``lx_host()``, the factor's px copy on the host), then
writes the same arrays again plain (``np.savez``) and deflated
(``np.savez_compressed``, the reference's format) and loads each file
back onto the card with ``serialize.load_factor``, twice in the order
plain, deflated, deflated, plain. Every loaded factor's panels must equal
``lx_host()`` bit for bit. Prints the card's name and power limit, then
one JSON line: the seconds of each save and load, and each file's bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from . import DEFAULT, Ordering, analyze, factorize, serialize
from .io import fixtures


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=50)
    nx = ap.parse_args().nx
    if not torch.cuda.is_available():
        raise SystemExit("checkpoint_cost: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = DEFAULT.replace(ordering=Ordering.METIS)
    A = fixtures.laplacian_3d(nx)
    F = factorize(A, analyze(A, cfg), cfg, device="cuda")
    if not F.ok:
        raise SystemExit(f"checkpoint_cost: the factor failed at column "
                         f"{F.minor}")
    out = {"matrix": f"laplacian3d_{nx}", "card": card, "n": A.ncol,
           "lnz": F.F.S.lnz}
    with tempfile.TemporaryDirectory() as tmp:
        first = f"{tmp}/F.npz"
        # the first save pays for lx_host() (the px copy, cached after)
        _, out["save_factor_s"] = _timed(
            lambda: serialize.save_factor(first, F))
        lx = torch.from_numpy(F.F.lx_host())
        with np.load(first) as z:
            arrays = {k: z[k] for k in z.files}
        writers = {"plain": np.savez, "deflated": np.savez_compressed}
        for fmt in ("plain", "deflated", "deflated", "plain"):
            path = f"{tmp}/{fmt}.npz"
            _, save_s = _timed(lambda: writers[fmt](path, **arrays))
            G, load_s = _timed(
                lambda: serialize.load_factor(path, device="cuda",
                                              config=cfg))
            if not torch.equal(G.F.Lx.cpu().double(), lx):
                raise SystemExit(f"checkpoint_cost: the {fmt} file's "
                                 f"panels differ from lx_host()")
            rec = out.setdefault(fmt, {"save_s": [], "load_s": [],
                                       "file_bytes": os.path.getsize(path)})
            rec["save_s"].append(save_s)
            rec["load_s"].append(load_s)
            del G
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
