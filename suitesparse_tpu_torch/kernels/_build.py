"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, ``build/libsst_kernels.so``, at
first use, bound with ctypes. A content hash of the sources is kept in
``build/build.stamp`` beside the library; a change to any source rebuilds it
(the same scheme as :mod:`suitesparse_tpu_torch.native`). Processes that
start together (the ranks of a distributed run) build once: the build
holds an ``fcntl`` lock on ``build/build.lock`` (released when its holder
exits, however it exits) and checks the stamp again under it, and the
library and its stamp are written under per-process names and renamed
into place, so no process loads a partial file. There is no fallback:
without ``nvcc`` the build raises.

C interface: every pointer and the CUDA stream are ``void*``, every size an
``int`` and every batch stride a 64-bit ``long long``; each entry point
launches on the given stream, does not synchronize, and returns
``cudaGetLastError()`` as an int (0 = launched).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libsst_kernels.so")
STAMP_PATH = os.path.join(BUILD_DIR, "build.stamp")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
LOCK_PATH = os.path.join(BUILD_DIR, "build.lock")
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"     # where PATH does not name nvcc

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong

# entry point -> argtypes (restype is always int: the cudaError_t of the launch)
_SIGNATURES = {
    # f11, f21, l11, l21, B, C, RU, then potrf_geometry's inst, lanes, wpt,
    # split, prow, crow, warps, smem; stream
    "sst_potrf_trsm": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i,
                       _i, _i, _i, _vp],
    # F, Ucat, man, rowmap, colmap, run_ptr, nruns, R, RUp, then
    # tile_geometry's T, split and vec; stream
    "sst_extend_add_tiles": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                             _i, _vp],
    # the same, two pieces per step
    "sst_extend_add_tiles_pair": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
                                  _i, _i, _i, _vp],
    # F, host array of the classes' U, host array of their (RU, first
    # pair, npairs, first idx entry), ncls, idx, dst, src (or null), blocks
    # (or null), nblocks, B, R, then extend_add_geometry's rows and warps,
    # the instance (0 fp32, 1 fp64, 2 fp32 fronts with bf16 updates, 3 fp64
    # fronts with bf16 updates); stream
    "sst_extend_add": [_vp, _vp, _vp, _i, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                       _i, _i, _vp],
    # M, X, Z, B, I, J, NR, transpose, then bmv_geometry's epb, split,
    # part, chunk, stages, xsmem, smem; stream
    "sst_bmatvec": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                    _i, _i, _vp],
    # M, X, Z, B, K, N, NR, then vec and pmv_geometry's tw, tiles, warps,
    # split, rows, smem; stream
    "sst_pmatvec": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                    _i, _vp],
    # L, Y, X, B, C, NR, transpose, then trisolve_geometry's tpb, wpt, cpw,
    # chunks, csplit, smem; stream
    "sst_trisolve": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                     _vp],
    # L11, L21, l21_bstride, Y, WB, wb_bstride, XC, V, B, C, RU, NR, then
    # solve_step_geometry's tpb, wpt, lanes, cpw, chunks, split, prow, crow,
    # smem; stream
    "sst_solve_step_fwd": [_vp, _vp, _ll, _vp, _vp, _ll, _vp, _vp, _i, _i, _i,
                           _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp],
    # L11, L21, l21_bstride, Y, XB, xb_bstride, XC, B, C, RU, NR, then the
    # same nine ints; stream
    "sst_solve_step_bwd": [_vp, _vp, _ll, _vp, _vp, _ll, _vp, _i, _i, _i, _i,
                           _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp],
}

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(SRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(SRC_DIR, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(CUDA_NVCC):
        nvcc = CUDA_NVCC
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "suitesparse_tpu_torch cannot be built")
    return nvcc


FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]


def nvcc_commands(nvcc: str = "nvcc", out: str = LIB_PATH
                  ) -> tuple[list[list[str]], list[str]]:
    """One compile command per kernel source (run together), then the
    link command that makes the shared library ``out``."""
    compiles, objects = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src)[:-len(".cu")] + ".o")
        compiles.append([nvcc, *FLAGS, "-Xptxas=-v", "-c", src, "-o", obj])
        objects.append(obj)
    return compiles, [nvcc, *FLAGS, "-shared", "-o", out, *objects]


def _run_all(cmds: list[list[str]], log) -> None:
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate(timeout=600)
        log.write(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def _current(want: str) -> bool:
    if os.path.exists(LIB_PATH) and os.path.exists(STAMP_PATH):
        with open(STAMP_PATH) as f:
            return f.read().strip() == want
    return False


def build() -> None:
    """Compile the library unless the stamp matches the current sources;
    one process at a time (see the module's docstring)."""
    want = source_hash()
    if _current(want):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
        if _current(want):          # another process built it meanwhile
            return
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        compiles, link = nvcc_commands(find_nvcc(), tmp)
        with open(LOG_PATH, "w") as log:
            _run_all(compiles, log)
            _run_all([link], log)
        os.replace(tmp, LIB_PATH)
        stamp = f"{STAMP_PATH}.{os.getpid()}.tmp"
        with open(stamp, "w") as f:
            f.write(want)
        os.replace(stamp, STAMP_PATH)


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
