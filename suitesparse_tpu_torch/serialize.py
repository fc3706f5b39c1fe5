"""Factor and symbolic-object persistence of the port.

Port of the JAX package's ``serialize.py`` (the ``umfpack_save_numeric.c`` /
``umfpack_load_numeric.c`` analog: checkpoint and restart of an
analyze-once/factor-many pipeline). One ``.npz`` per object, numpy arrays
and a small JSON header, in the reference's format: the same magic string,
``kind`` values and array keys, so that each package reads the other's
simplicial and supernodal files. The port writes plain ``.npz`` (the
reference deflates it; ``np.load`` reads both): at the model problem a
deflated save takes several times as long for less than half the bytes
(``python3 -m suitesparse_tpu_torch.checkpoint_cost`` measures both).

A supernodal factor is saved in the CHOLMOD px layout, ``S.lnz`` values in
fp64 (``lx_host()``), whatever layout it lives in: a device factor's padded
``Lx`` is never written as it is (the reference writes it raw and reads it
back as px panels, which gives wrong panels). :func:`load_factor` puts a
supernodal factor with ``S.fl >= 5e6`` (the reference's device threshold)
on the device as a :class:`~.numeric.supernodal.TorchPxFactor`, which
``solve`` sends through the px sweep.

    >>> sstt.serialize.save_factor("f.npz", F)
    >>> F2 = sstt.serialize.load_factor("f.npz", device="cuda")
    >>> x = sstt.solve(F2, b)
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .config import DEFAULT, Config
from .device import resolve_device
from .numeric.simplicial import Factor, SymbolicChol
from .numeric.supernodal import (SupernodalFactor, SupernodalFactorAdapter,
                                 TorchPxFactor, TorchSupernodalFactor,
                                 _should_use_device)
from .numeric.supernodal_device import compute_dtype
from .sparse import CSC
from .symbolic.supernodes import SupernodalSymbolic

__all__ = ["save_factor", "load_factor", "save_symbolic", "load_symbolic"]

_MAGIC = "suitesparse_tpu-factor-v1"
_SUPERNODAL = (SupernodalFactor, TorchSupernodalFactor, TorchPxFactor)


def save_factor(path, F) -> None:
    """Write the Cholesky factor ``F`` (a simplicial ``Factor``, or a
    supernodal factor of any layout, bare or in its adapter) to ``path``
    as a plain ``.npz`` (:func:`load_factor` also reads the reference's
    deflated files)."""
    if isinstance(F, Factor):
        head = {"magic": _MAGIC, "kind": "simplicial",
                "has_d": F.d is not None, "minor": int(F.minor)}
        np.savez(path, header=json.dumps(head),
                 Lp=F.L.indptr, Li=F.L.indices, Lx=F.L.data, perm=F.perm,
                 d=F.d if F.d is not None else np.empty(0),
                 shape=np.array(F.L.shape))
        return
    inner = getattr(F, "F", F)
    if isinstance(inner, _SUPERNODAL):
        S = inner.S
        head = {"magic": _MAGIC, "kind": "supernodal",
                "minor": int(inner.minor), "n": int(S.n),
                "nsuper": int(S.nsuper)}
        rows_flat = np.concatenate(S.rows) if S.nsuper \
            else np.empty(0, np.int64)
        rows_len = np.array([len(r) for r in S.rows], dtype=np.int64)
        np.savez(path, header=json.dumps(head), Lx=inner.lx_host(),
                 perm=S.perm, parent=S.parent, colcount=S.colcount,
                 super_first=S.super_first, sparent=S.sparent,
                 rows_flat=rows_flat, rows_len=rows_len,
                 level_of=S.level_of, Lpx=S.Lpx, snode_of_col=S.snode_of_col)
        return
    raise TypeError(f"cannot serialize factor of type {type(F)}")


def _header(z) -> dict:
    head = json.loads(str(z["header"]))
    if head.get("magic") != _MAGIC:
        raise ValueError("not a suitesparse_tpu factor file")
    return head


def _supernodal_symbolic(z, head: dict) -> SupernodalSymbolic:
    """The analysis stored in a supernodal file, with its flop count and
    largest update recomputed (as the reference does)."""
    rows_len = z["rows_len"]
    offs = np.zeros(rows_len.size + 1, dtype=np.int64)
    np.cumsum(rows_len, out=offs[1:])
    rows_flat = z["rows_flat"]
    rows = [rows_flat[offs[i]:offs[i + 1]] for i in range(rows_len.size)]
    level_of = z["level_of"]
    nlev = int(level_of.max()) + 1 if level_of.size else 0
    levels = [np.flatnonzero(level_of == d) for d in range(nlev)]
    Lpx = z["Lpx"]
    S = SupernodalSymbolic(
        n=head["n"], perm=z["perm"], parent=z["parent"],
        colcount=z["colcount"], nsuper=head["nsuper"],
        super_first=z["super_first"], sparent=z["sparent"], rows=rows,
        snode_of_col=z["snode_of_col"], levels=levels, level_of=level_of,
        lnz=int(Lpx[-1]), fl=0.0, maxcsize=0, Lpx=Lpx)
    fl = 0.0
    for s in range(S.nsuper):
        nr, nc = S.nrows(s), S.ncols(s)
        fl += nc ** 3 / 3.0 + (nr - nc) * nc * nc + (nr - nc) ** 2 * nc
        S.maxcsize = max(S.maxcsize, nr - nc)
    S.fl = fl
    return S


def load_factor(path, device="cuda", config: Config = DEFAULT):
    """The factor saved at ``path`` (by either package).

    A simplicial file gives a ``Factor``. A supernodal file gives a
    ``SupernodalFactorAdapter`` over: with ``S.fl >= 5e6``, a
    ``TorchPxFactor`` whose panels lie on ``device`` in the dtype
    ``config.compute_dtype`` names (the loaded values are the saved fp64
    values cast once); below that, the host ``SupernodalFactor``. The
    device is resolved first whatever the file holds (CUDA unless the
    caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        head = _header(z)
        if head["kind"] == "simplicial":
            n = int(z["shape"][0])
            L = CSC(n, int(z["shape"][1]), z["Lp"], z["Li"], z["Lx"], 0)
            d = z["d"] if head["has_d"] else None
            return Factor(L=L, perm=z["perm"], d=d, minor=head["minor"])
        if head["kind"] == "supernodal":
            S = _supernodal_symbolic(z, head)
            Lx = z["Lx"]
            if Lx.shape != (S.lnz,):
                raise ValueError(
                    f"load_factor: the file's Lx holds {Lx.size} values, "
                    f"its px layout {S.lnz} (a device-layout factor saved "
                    f"raw, whose panels cannot be read back)")
            if not _should_use_device(S, config):
                return SupernodalFactorAdapter(
                    SupernodalFactor(S=S, Lx=Lx, minor=head["minor"]))
            Lt = torch.from_numpy(Lx).to(compute_dtype(config)).to(dev)
            return SupernodalFactorAdapter(
                TorchPxFactor(S=S, Lx=Lt, minor=head["minor"]))
    raise ValueError(f"unknown factor kind {head['kind']}")


def save_symbolic(path, S: SymbolicChol) -> None:
    head = {"magic": _MAGIC, "kind": "symbolic_chol", "n": int(S.n),
            "lnz": int(S.lnz), "fl": float(S.fl)}
    np.savez(path, header=json.dumps(head), perm=S.perm, parent=S.parent,
             post=S.post, colcount=S.colcount, Lp=S.Lp)


def load_symbolic(path) -> SymbolicChol:
    with np.load(path, allow_pickle=False) as z:
        head = _header(z)
        if head["kind"] != "symbolic_chol":
            raise ValueError(f"not a symbolic file: kind {head['kind']}")
        return SymbolicChol(n=head["n"], perm=z["perm"], parent=z["parent"],
                            post=z["post"], colcount=z["colcount"],
                            Lp=z["Lp"], lnz=head["lnz"], fl=head["fl"])
