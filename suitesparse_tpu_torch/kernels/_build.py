"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, ``build/libsst_kernels.so``, at
first use, and bound with ctypes. A content hash of the sources is kept in
``build/build.stamp`` beside the library; a change to any source rebuilds it
(the same scheme as :mod:`suitesparse_tpu.native`). There is no fallback:
without ``nvcc`` the build raises.

C interface: every pointer and the CUDA stream are ``void*``, every size an
``int``; each entry point launches on the given stream, does not synchronize,
and returns ``cudaGetLastError()`` as an int (0 = launched).
"""

from __future__ import annotations

import ctypes
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
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"     # where PATH does not name nvcc

_vp = ctypes.c_void_p
_i = ctypes.c_int

# entry point -> argtypes (restype is always int: the cudaError_t of the launch)
_SIGNATURES = {
    # f11, f21, l11, l21, B, C, RU, stream
    "sst_potrf_trsm": [_vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    # F, Ucat, man, rowmap, colmap, run_ptr, nruns, R, RUp, stream
    "sst_extend_add_tiles": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp],
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


def nvcc_command(nvcc: str = "nvcc") -> list[str]:
    """The one compile-and-link command for every kernel source."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
            "-o", LIB_PATH, *sources()]


def build() -> None:
    """Compile the library unless the stamp matches the current sources."""
    want = source_hash()
    if os.path.exists(LIB_PATH) and os.path.exists(STAMP_PATH):
        with open(STAMP_PATH) as f:
            if f.read().strip() == want:
                return
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = nvcc_command(find_nvcc())
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(LOG_PATH, "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    with open(STAMP_PATH, "w") as f:
        f.write(want)


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
