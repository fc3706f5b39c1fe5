"""The port's entry points, device rule, JAX-free import and kernel build.

``cholsol`` on the CPU is held against the reference ``cholsol`` at
1e-4 * max|x| (two fp32 factors, each at fp32 accuracy) and to the
residual gate 1e-5."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu.io import fixtures
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.device import fp32_precision
from suitesparse_tpu_torch.kernels import _build
from suitesparse_tpu_torch.numeric.supernodal import TorchSupernodalFactor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cholsol_cpu_matches_reference():
    n = fixtures.laplacian_3d(12).ncol
    b = 1.0 + np.arange(n) / n
    x_ref = sst.cholsol(fixtures.laplacian_3d(12), b)
    A = sstt.fixtures.laplacian_3d(12)
    x = sstt.cholsol(A, b, device="cpu")
    assert np.abs(x - x_ref).max() <= 1e-4 * np.abs(x_ref).max()
    assert sstt.residual_norm(A, x, b) < 1e-5


def test_factorize_takes_the_device_path_and_exposes_L():
    A = sstt.fixtures.laplacian_3d(12)
    S = sstt.analyze(A)
    F = sstt.factorize(A, S, device="cpu")
    assert isinstance(F.F, TorchSupernodalFactor) and F.ok
    # the host view of the device factor: L L^T reproduces P A P^T
    L = F.L.to_dense()
    P = A.symperm(F.perm).to_dense()
    Pfull = np.triu(P) + np.triu(P, 1).T
    assert np.abs(L @ L.T - Pfull).max() < 1e-4 * np.abs(Pfull).max()


def test_small_problem_stays_on_the_host():
    A = sstt.fixtures.laplacian_3d(5)
    b = np.ones(A.ncol)
    S = sstt.analyze(A)
    F = sstt.factorize(A, S, device="cpu")
    assert not isinstance(getattr(F, "F", None), TorchSupernodalFactor)
    assert sstt.residual_norm(A, sstt.solve(F, b), b) < 1e-10


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = sstt.fixtures.laplacian_3d(12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sstt.cholsol(A, np.ones(A.ncol))            # device="cuda" default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sstt.factorize(A, sstt.analyze(A), device="cuda")


def test_routes_outside_the_slice_raise():
    A = sstt.fixtures.laplacian_3d(4)
    x = sstt.lusol(A, np.ones(A.ncol))           # ported: the host LU
    assert sstt.residual_norm(A, x, np.ones(A.ncol)) < 1e-12
    # complex input, once outside the slice, now solves on every route
    Ac = sstt.fixtures.laplacian_3d(4)
    Ac.data = Ac.data.astype(np.complex128)
    bc = np.ones(Ac.ncol) + 1j * np.arange(Ac.ncol) / Ac.ncol
    D = Ac.to_dense()
    for x in (sstt.lusol(Ac, bc), sstt.cholsol(Ac, bc, device="cpu"),
              sstt.qrsol(Ac, bc, device="cpu")):
        assert x.dtype == np.complex128
        assert np.abs(D @ x - bc).max() < 1e-12 * np.abs(bc).max()


def test_imports_and_solves_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['suitesparse_tpu'] = None\n"
        "import numpy as np, suitesparse_tpu_torch as sstt\n"
        "A = sstt.fixtures.laplacian_3d(12)\n"
        "b = 1.0 + np.arange(A.ncol) / A.ncol\n"
        "x = sstt.cholsol(A, b, device='cpu')\n"
        "r = sstt.residual_norm(A, x, b)\n"
        "assert r < 1e-5, r\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', r)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_nvcc_command_targets_sm90a_into_the_ignored_build_dir():
    compiles, link = _build.nvcc_commands("cuda-12/nvcc")
    build_dir = os.path.join(REPO, "suitesparse_tpu_torch", "kernels",
                             "build")
    for cmd in compiles + [link]:
        assert cmd[0] == "cuda-12/nvcc"
        assert cmd[cmd.index("-gencode") + 1] == \
            "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3"):
            assert flag in cmd
        assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
        assert os.path.dirname(cmd[cmd.index("-o") + 1]) == build_dir
    # one compile per source, run together, then one link of the objects
    srcs = [c for cmd in compiles for c in cmd if c.endswith(".cu")]
    assert sorted(os.path.basename(s) for s in srcs) == [
        "bmatvec.cu", "extend_add.cu", "extend_add_tiles.cu", "pmatvec.cu",
        "potrf_trsm.cu", "solve_step.cu", "trisolve.cu"]
    assert all("-c" in cmd for cmd in compiles)
    assert "-shared" in link
    assert link[link.index("-o") + 1] == os.path.join(build_dir,
                                                      "libsst_kernels.so")
    assert sorted(c for c in link if c.endswith(".o")) == sorted(
        cmd[cmd.index("-o") + 1] for cmd in compiles)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "suitesparse_tpu_torch/kernels/build/" in f.read().split()


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text("__global__ void k() {}\n")
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    h1 = _build.source_hash()
    (tmp_path / "a.cu").write_text("__global__ void k() { }\n")
    assert _build.source_hash() != h1


@pytest.mark.parametrize("precision,inside", [("highest", False),
                                              ("default", True)])
def test_fp32_precision_scope_restores_caller_setting(precision, inside):
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cd.allow_tf32)
    try:
        mm.allow_tf32, cd.allow_tf32 = True, True
        with fp32_precision(precision):
            assert (mm.allow_tf32, cd.allow_tf32) == (inside, inside)
        assert (mm.allow_tf32, cd.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32, cd.allow_tf32 = saved
