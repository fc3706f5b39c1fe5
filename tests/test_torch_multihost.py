"""The port's launch layer (``parallel/multihost.py``), in process, and the
process-safe kernel build.

A world of one rank needs no process group, and its (host, chip) mesh is
the flat one; the topology splits host-major and refuses anything else;
``initialize`` names its backend and refuses NCCL where it cannot work;
the modeled scaling table holds together at the rates it is given; two
processes that build the CUDA library at once build it once."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal
from suitesparse_tpu_torch.parallel import diag, dist2
from suitesparse_tpu_torch.parallel import multihost as mh
from suitesparse_tpu_torch.parallel.schedule import model_scaling
from suitesparse_tpu_torch.symbolic.supernodes import analyze_supernodal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_world_of_one_without_initialize_is_the_flat_schedule():
    mh.initialize()                                 # a no-op at world 1
    assert not torch.distributed.is_initialized()
    A = sstt.fixtures.laplacian_3d(7)
    S = analyze_supernodal(A, sstt.ordering.amd_order(A))
    cfg = sstt.DEFAULT.replace(compute_dtype="float64")
    mesh = mh.host_chip_mesh(device="cpu")
    assert (mesh.nhost, mesh.nchip, mesh.rank, mesh.world) == (1, 1, 0, 1)
    F = mh.factorize(A, S, mesh, cfg)
    flat = mh.global_solver_mesh(device="cpu")
    Ff = dist2.dist_factorize_v2(A, S, flat, cfg)
    assert F.ok and torch.equal(F.Lx, Ff.Lx)
    host = supernodal.factorize_host(A, S).Lx
    assert np.abs(F.lx_host() - host).max() <= 1e-10 * np.abs(host).max()
    b = 1.0 + np.arange(A.ncol) / A.ncol
    x = mh.solve(F, b, cfg)
    assert sstt.residual_norm(A, x, b) < 1e-12
    census = diag.collective_census(F)
    assert {k: v["count"] for k, v in census["factor"].items()} == \
        {"halo": 1, "assembly": 1}
    assert {k: v["count"] for k, v in census["solve"].items()} == \
        {"solve_up": 1, "solve_x": 1}


@pytest.mark.parametrize("nhost,nchip", [(2, 2), (4, 1), (1, 4)])
def test_topology_is_host_major(nhost, nchip):
    seen = set()
    for r in range(nhost * nchip):
        t = mh.topology(nhost, nchip, r, device="cpu")
        assert (t.host, t.chip) == (r // nchip, r % nchip)
        assert t.world == 4 and t.device == torch.device("cpu")
        seen.add((t.host, t.chip))
    assert len(seen) == 4
    names = [f"h{r // nchip}" for r in range(4)]
    assert mh.host_layout(names) == (nhost, nchip)


@pytest.mark.parametrize("names", [["a", "b", "a", "b"], ["a", "a", "a", "b"],
                                   ["a", "b", "b", "a"]])
def test_ranks_that_are_not_host_major_raise(names):
    with pytest.raises(ValueError):
        mh.host_layout(names)


def test_topology_and_mesh_refuse_what_cannot_be():
    with pytest.raises(ValueError):
        mh.topology(2, 2, 4, device="cpu")
    with pytest.raises(ValueError):
        mh.host_chip_mesh(2, 2, device="cpu")       # a world of one rank


def test_initialize_names_its_backend():
    for backend in (None, "mpi"):
        with pytest.raises(ValueError, match="backend"):
            mh.initialize("file:///nonexistent", 2, 0, backend)
    if torch.cuda.is_available():
        pytest.skip("the NCCL refusal below needs a machine without a card")
    with pytest.raises(ValueError, match="NCCL"):
        mh.initialize("file:///nonexistent", 2, 0, "nccl")
    assert not torch.distributed.is_initialized()


def test_cuda_asked_for_and_absent_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        mh.host_chip_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mh.topology(2, 2, 1)


def test_model_scaling_table_holds_together():
    """``tests/test_multihost.py:116-134`` on the port, at rates that the
    caller gives (these are arbitrary: the table is a model)."""
    A = sstt.fixtures.laplacian_3d(16)
    S = analyze_supernodal(A, sstt.ordering.amd_order(A))
    rows = model_scaling(S, [(1, 8), (2, 4), (4, 2)], rate_flops=1e12,
                         ici_bw=1e11, dcn_bw=1e10)
    by = {(r["nhost"], r["nchip"]): r for r in rows}
    for r in rows:
        assert r["leaf_balance"] < 2.0
        assert r["t_total_s"] == pytest.approx(
            r["t_leaf_s"] + r["t_mid_s"] + r["t_top_s"] + r["t_ici_s"]
            + r["t_dcn_s"])
    assert by[(2, 4)]["dcn_mbytes"] < by[(1, 8)]["dcn_mbytes"]


_BUILDER = r'''
import os, sys, time
from suitesparse_tpu_torch.kernels import _build

tmp, fake = sys.argv[1], sys.argv[2]
_build.BUILD_DIR = tmp
_build.LIB_PATH = os.path.join(tmp, "libsst_kernels.so")
_build.STAMP_PATH = os.path.join(tmp, "build.stamp")
_build.LOG_PATH = os.path.join(tmp, "build.log")
_build.LOCK_PATH = os.path.join(tmp, "build.lock")
_build.find_nvcc = lambda: fake
_build.nvcc_commands = lambda nvcc, out: (
    [[sys.executable, nvcc, "compile", os.path.join(tmp, "runs")]],
    [sys.executable, nvcc, "link", os.path.join(tmp, "runs"), out])
while time.time() < float(sys.argv[3]):      # start together
    time.sleep(0.001)
_build.build()
with open(_build.LIB_PATH) as f:
    assert f.read() == "library"
print("BUILT", flush=True)
'''

_FAKE_NVCC = r'''
import sys, time
with open(sys.argv[2], "a") as f:
    f.write(sys.argv[1] + "\n")
time.sleep(0.5)                # long enough for the other process to wait
if sys.argv[1] == "link":
    with open(sys.argv[3], "w") as f:
        f.write("library")
'''


def test_two_processes_build_the_library_once(tmp_path):
    import time

    (tmp_path / "builder.py").write_text(_BUILDER)
    (tmp_path / "nvcc.py").write_text(_FAKE_NVCC)
    env = dict(os.environ, PYTHONPATH=REPO)
    start = str(time.time() + 2.0)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "builder.py"), str(tmp_path),
         str(tmp_path / "nvcc.py"), start], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "BUILT" in out, out
    assert (tmp_path / "runs").read_text().split() == ["compile", "link"]
    from suitesparse_tpu_torch.kernels import _build
    assert (tmp_path / "build.stamp").read_text() == _build.source_hash()
    assert not list(tmp_path.glob("*.tmp"))
