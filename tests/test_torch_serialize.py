"""The port's factor and symbolic files against the JAX package's.

Both packages write the same format (magic string, ``kind`` values, array
keys), so each reads the other's files: simplicial (LL' and LDL'),
host-supernodal and symbolic files are written by one package and read by
the other, and both solve to the same x within 1e-10 (fp64 host factors;
the two host solvers sum in the same order, so the difference is rounding
at most). Problems come from the seeded generators of ``io/fixtures.py``,
analysed by the reference and, for the port, with the reference's
permutation.

F1: the port saves a device factor in the px layout, ``S.lnz`` fp64 values
(``lx_host()``), never its padded device ``Lx``. A device factor of the
port, computed on the CPU, is saved and loaded back (``device="cpu"``) as
a px-layout factor whose values equal ``lx_host()`` bit for bit (in fp32
the saved values are the fp32 ones widened, so the cast back is exact), and
solves through the px sweep to a residual below 1e-5 (fp32) or 1e-12
(fp64); the reference reads the same file and its host solve reaches the
same gate, which its own raw device-layout file would not give."""

import json

import numpy as np
import pytest
import torch

import suitesparse_tpu as sst
from suitesparse_tpu import serialize as ref_serialize
from suitesparse_tpu.numeric import simplicial as ref_simplicial
from suitesparse_tpu.numeric import supernodal as ref_supernodal
from suitesparse_tpu.ordering import amd_order, nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch import serialize
from suitesparse_tpu_torch.numeric import simplicial, supernodal, \
    supernodal_device
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal

X_TOL = 1e-10
FP32_RESID = 1e-5
FP64_RESID = 1e-12


def _rhs(n):
    return 1.0 + np.arange(n) / n


@pytest.mark.parametrize("kind", ["ll", "ldl"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_simplicial_files_cross_between_the_packages(tmp_path, kind, writer):
    Aj, A = sst.io.fixtures.laplacian_2d(10), sstt.fixtures.laplacian_2d(10)
    perm = amd_order(Aj)
    Sj = ref_simplicial.symbolic_cholesky(Aj, perm)
    S = simplicial.symbolic_cholesky(A, perm)
    if kind == "ll":
        Fj, F = ref_simplicial.chol_up(Aj, Sj), simplicial.chol_up(A, S)
    else:
        Fj, F = ref_simplicial.ldl_up(Aj, Sj), simplicial.ldl_up(A, S)
    p = tmp_path / "factor.npz"
    if writer == "port":
        serialize.save_factor(p, F)
        G = ref_serialize.load_factor(p)
        x = ref_simplicial.chol_solve(G, _rhs(A.ncol))
    else:
        ref_serialize.save_factor(p, Fj)
        G = serialize.load_factor(p, device="cpu")
        assert isinstance(G, simplicial.Factor) and G.ok
        assert (G.d is None) == (kind == "ll")
        x = simplicial.chol_solve(G, _rhs(A.ncol))
    xj = ref_simplicial.chol_solve(Fj, _rhs(A.ncol))
    assert np.abs(x - xj).max() <= X_TOL * np.abs(xj).max()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_host_supernodal_files_cross_between_the_packages(tmp_path, writer):
    """fl < 5e6: the port loads the host px factor, as the reference does."""
    Aj, A = sst.io.fixtures.laplacian_2d(14), sstt.fixtures.laplacian_2d(14)
    Sj = analyze_supernodal(Aj, amd_order(Aj))
    S = port_analyze_supernodal(A, Sj.perm)
    assert S.fl < 5e6
    Fj = ref_supernodal.SupernodalFactorAdapter(
        ref_supernodal.factorize_host(Aj, Sj))
    F = supernodal.SupernodalFactorAdapter(supernodal.factorize_host(A, S))
    b = _rhs(A.ncol)
    p = tmp_path / "super.npz"
    if writer == "port":
        serialize.save_factor(p, F)
        G = ref_serialize.load_factor(p)
        x = ref_simplicial.chol_solve(G, b)
    else:
        ref_serialize.save_factor(p, Fj)
        G = serialize.load_factor(p, device="cpu")
        assert isinstance(G.F, supernodal.SupernodalFactor)
        assert G.F.S.nsuper == Sj.nsuper and G.F.S.fl == Sj.fl
        x = sstt.solve(G, b)
    xj = ref_simplicial.chol_solve(Fj, b)
    assert np.abs(x - xj).max() <= X_TOL * np.abs(xj).max()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_symbolic_files_cross_between_the_packages(tmp_path, writer):
    Aj, A = sst.io.fixtures.laplacian_2d(10), sstt.fixtures.laplacian_2d(10)
    Sj = ref_simplicial.symbolic_cholesky(Aj, amd_order(Aj))
    S = simplicial.symbolic_cholesky(A, Sj.perm)
    p = tmp_path / "sym.npz"
    if writer == "port":
        serialize.save_symbolic(p, S)
        T = ref_serialize.load_symbolic(p)
    else:
        ref_serialize.save_symbolic(p, Sj)
        T = serialize.load_symbolic(p)
        assert np.allclose(simplicial.chol_up(A, T).L.data,
                           simplicial.chol_up(A, S).L.data, rtol=0, atol=0)
    for f in ("perm", "parent", "post", "colcount", "Lp"):
        assert np.array_equal(getattr(T, f), getattr(Sj, f))
    assert (T.n, T.lnz, T.fl) == (Sj.n, Sj.lnz, Sj.fl)


@pytest.fixture(scope="module")
def device_factors():
    """The port's device-layout factors (fp32, fp64) of laplacian_3d(11),
    computed on the CPU, with the reference's ND permutation; S.fl >= 5e6,
    so a load puts it back on a device."""
    Aj = sst.io.fixtures.laplacian_3d(11)
    perm = analyze_supernodal(Aj, nested_dissection_order(
        Aj, sst.DEFAULT)).perm
    A = sstt.fixtures.laplacian_3d(11)
    S = port_analyze_supernodal(A, perm)
    assert S.fl >= 5e6
    return A, {dt: supernodal_device.factorize_device(
        A, S, sstt.DEFAULT.replace(compute_dtype=dt), "cpu")
        for dt in ("float32", "float64")}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_factor_is_saved_as_px_panels_and_solves_after_loading(
        tmp_path, device_factors, dtype):
    A, Fs = device_factors
    F = Fs[dtype]
    assert F.Lx.numel() == F.dplan.plan.dev_size != F.S.lnz
    p = tmp_path / "dev.npz"
    serialize.save_factor(p, supernodal.SupernodalFactorAdapter(F))
    with np.load(p) as z:
        head = json.loads(str(z["header"]))
        assert head["kind"] == "supernodal" and head["minor"] == F.S.n
        Lx = z["Lx"]
    assert Lx.dtype == np.float64 and Lx.shape == (F.S.lnz,)
    assert np.array_equal(Lx, F.lx_host())
    cfg = sstt.DEFAULT.replace(compute_dtype=dtype)
    G = serialize.load_factor(p, device="cpu", config=cfg)
    assert isinstance(G.F, supernodal.TorchPxFactor)
    assert G.F.Lx.dtype == supernodal_device.compute_dtype(cfg)
    assert G.F.Lx.device.type == "cpu"
    assert torch.equal(G.F.Lx.double(), torch.from_numpy(F.lx_host()))
    b = _rhs(A.ncol)
    x = sstt.solve(G, b, cfg)
    tol = FP32_RESID if dtype == "float32" else FP64_RESID
    assert sstt.residual_norm(A, x, b) < tol
    # the reference reads the port's file as a host px factor
    xj = ref_simplicial.chol_solve(ref_serialize.load_factor(p), b)
    assert sstt.residual_norm(A, xj, b) < tol


def test_reference_file_past_the_threshold_loads_as_a_px_factor(
        tmp_path, device_factors):
    """A host px file of the reference with S.fl >= 5e6 goes to the
    device as a px factor and solves as the reference's host factor does."""
    A, Fs = device_factors
    Aj = sst.io.fixtures.laplacian_3d(11)
    Sj = analyze_supernodal(Aj, Fs["float32"].S.perm)
    Fj = ref_supernodal.SupernodalFactorAdapter(
        ref_supernodal.factorize_host(Aj, Sj))
    p = tmp_path / "ref.npz"
    ref_serialize.save_factor(p, Fj)
    G = serialize.load_factor(p, device="cpu")
    assert isinstance(G.F, supernodal.TorchPxFactor)
    assert G.F.Lx.dtype == torch.float32
    b = _rhs(A.ncol)
    x, xj = sstt.solve(G, b), ref_simplicial.chol_solve(Fj, b)
    assert np.abs(x - xj).max() <= 1e-5 * np.abs(xj).max()
    assert sstt.residual_norm(A, x, b) < FP32_RESID


def test_load_factor_rejects_other_files_and_objects(tmp_path, device_factors):
    p = tmp_path / "bad.npz"
    np.savez(p, header=json.dumps({"magic": "other"}))
    with pytest.raises(ValueError, match="not a suitesparse_tpu factor"):
        serialize.load_factor(p, device="cpu")
    # the reference's raw device-layout file (its F1): dev_size values
    A, Fs = device_factors
    F = Fs["float32"]
    good = tmp_path / "good.npz"
    serialize.save_factor(good, F)
    with np.load(good) as z:
        arrays = dict(z)
    arrays["Lx"] = F.Lx.double().numpy()
    raw = tmp_path / "raw.npz"
    np.savez(raw, **arrays)
    with pytest.raises(ValueError, match="device-layout factor saved raw"):
        serialize.load_factor(raw, device="cpu")
    with pytest.raises(TypeError, match="cannot serialize"):
        serialize.save_factor(tmp_path / "x.npz", object())
    A, Fs = device_factors
    q = tmp_path / "f.npz"
    serialize.save_factor(q, Fs["float32"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serialize.load_factor(q)
