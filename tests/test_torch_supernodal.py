"""Port's supernodal factor (CPU, plain kernel versions) vs the reference.

The reference ``factorize_device`` runs as its own tests run it off the
TPU: tile placement for groups with R >= 32 and both Pallas kernels in
interpret mode. Each side analyzes the same matrix with its own code; the
port takes the reference's ordering (``perm``) so that the two factor the
same permuted matrix, builds the same plan (``tile_rmin=32``) and writes
the same padded layout, so the factors compare entry by entry.

Tolerances: fp32 at 1e-5 * max|Lx| — the groups that miss the potrf_trsm
gate factor through LAPACK in two libraries, and sums run in another
order; fp64 at 1e-10 * max|Lx|."""

import numpy as np
import pytest

import suitesparse_tpu as sst
from suitesparse_tpu.io import fixtures
from suitesparse_tpu.numeric import supernodal_device as ref_device
from suitesparse_tpu.ordering import nested_dissection_order
from suitesparse_tpu.symbolic.supernodes import analyze_supernodal
import suitesparse_tpu_torch as sstt
from suitesparse_tpu_torch.numeric import supernodal_device
from suitesparse_tpu_torch.symbolic.supernodes import \
    analyze_supernodal as port_analyze_supernodal
from test_torch_host import _reference_native

# each fixture built by both packages' generators (same matrix)
FIXTURES = {
    "laplacian_3d_12": lambda fx: fx.laplacian_3d(12),
    "aniso_10": lambda fx: fx.anisotropic_laplacian_3d(
        10, grade=2.0, drop_tol=1e-3),
    "fem_1500": lambda fx: fx.fem_mesh_spd(1500),
}
TOL = {"float32": 1e-5, "float64": 1e-10}


def _reference_env(monkeypatch):
    monkeypatch.setenv("SSTPU_PALLAS", "1")
    monkeypatch.setenv("SSTPU_PLACE", "tile")
    monkeypatch.setenv("SSTPU_TILE_RMIN", "32")


def _port_analysis(name):
    """The port's own analysis of fixture ``name`` on the port's ordering."""
    At = FIXTURES[name](sstt.fixtures)
    S = port_analyze_supernodal(
        At, sstt.ordering.nested_dissection_order(At, sstt.DEFAULT))
    return At, S


def _both(make, dtype, monkeypatch):
    """Reference and port factors of the matrix ``make(fixtures)``."""
    _reference_env(monkeypatch)
    A = make(fixtures)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(
        A, S, sst.DEFAULT.replace(compute_dtype=dtype))
    At = make(sstt.fixtures)
    St = port_analyze_supernodal(At, S.perm)
    Ft = supernodal_device.factorize_device(
        At, St, sstt.DEFAULT.replace(compute_dtype=dtype), device="cpu",
        tile_rmin=32)
    return St, Fj, Ft


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_factor_matches_reference(name, dtype, monkeypatch):
    S, Fj, Ft = _both(FIXTURES[name], dtype, monkeypatch)
    assert Fj.ok and Ft.ok
    assert Ft.Lx.dtype == getattr(__import__("torch"), dtype)
    groups = [g for gl in Ft.dplan.plan.groups for g in gl]
    assert any(g._tile is not None for g in groups)
    lj = np.asarray(Fj.Lx, dtype=np.float64)
    lt = Ft.Lx.numpy().astype(np.float64)
    assert lj.shape == lt.shape == (Ft.dplan.plan.dev_size,)
    tol = TOL[dtype] * np.abs(lj).max()
    assert np.abs(lt - lj).max() <= tol
    assert np.abs(Ft.lx_host() - Fj.lx_host()).max() <= tol


# the reference's placement routes off the TPU, forced by SSTPU_PLACE; the
# port places every class that no tile manifest folds through K7
PLACE_ROUTES = ["mm", "gather", "scan"]
# the fixture whose plan has classes the scan route takes (R >= 128 and
# RU >= 127); elsewhere SSTPU_PLACE=scan falls back to the cost model
SCAN_FIXTURES = {"laplacian_3d_12"}


def _both_placed(name, dtype, route, monkeypatch):
    """Reference factor under SSTPU_PLACE=route (no tile manifests, XLA's
    Cholesky) and the port's at the default tile threshold. The ordering
    is the reference's C++ nested dissection: a worker that lost the race
    to build the reference's library orders by its Python fallback, whose
    larger fronts reach the tile kernel at that threshold."""
    _reference_native()
    monkeypatch.setenv("SSTPU_PLACE", route)
    if route == "gather":
        # the one-hot matmul loses the reference's cost model, so every
        # class takes the gather route
        monkeypatch.setattr(ref_device, "_PLACE_MM", 1.0)
    A = FIXTURES[name](fixtures)
    S = analyze_supernodal(A, nested_dissection_order(A, sst.DEFAULT))
    Fj = ref_device.factorize_device(
        A, S, sst.DEFAULT.replace(compute_dtype=dtype))
    routes = {pc.strategy for gl in S._device_plan.groups for g in gl
              for pc in g.pairs}
    At = FIXTURES[name](sstt.fixtures)
    St = port_analyze_supernodal(At, S.perm)
    Ft = supernodal_device.factorize_device(
        At, St, sstt.DEFAULT.replace(compute_dtype=dtype), device="cpu")
    return routes, Fj, Ft


@pytest.mark.parametrize("route", PLACE_ROUTES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_factor_matches_reference_placement_routes(name, dtype, route,
                                                   monkeypatch):
    """At the default threshold no group of these fixtures reaches the
    tile kernel, so every pair class goes through K7's plain version."""
    routes, Fj, Ft = _both_placed(name, dtype, route, monkeypatch)
    if route != "scan" or name in SCAN_FIXTURES:
        assert route in routes, routes
    assert Fj.ok and Ft.ok
    groups = [g for gl in Ft.dplan.plan.groups for g in gl]
    assert all(g._tile is None for g in groups) and \
        sum(len(g.pairs) for g in groups) > 0
    lj = np.asarray(Fj.Lx, dtype=np.float64)
    lt = Ft.Lx.numpy().astype(np.float64)
    assert lj.shape == lt.shape == (Ft.dplan.plan.dev_size,)
    assert np.abs(lt - lj).max() <= TOL[dtype] * np.abs(lj).max()


@pytest.mark.parametrize("tile_rmin,dtype", [(256, "float32"),
                                             (32, "float32"),
                                             (32, "float64")])
def test_factor_places_each_unfolded_class_through_k7(tile_rmin, dtype,
                                                      monkeypatch):
    """One extend_add_group call a group that has a class no manifest
    folds (fp64 runs no manifest), covering exactly those classes in plan
    order, each on its int32 maps and the source group's whole update
    block; the library scatter is never called."""
    import torch
    from suitesparse_tpu_torch.kernels import extend_add as k7

    calls, library = [], []

    def spy(F, Us, work):
        calls.append(((work.B, work.R),
                      [(tuple(U.shape), key) for U, key in zip(Us, work.keys)],
                      (work.idx.dtype, work.dst.dtype, work.src.dtype)))
        return k7.extend_add_group(F, Us, work)

    def library_spy(*args, **kw):
        library.append(args)
        return k7.extend_add_library(*args, **kw)

    monkeypatch.setattr(supernodal_device, "extend_add_group", spy)
    monkeypatch.setattr(k7, "extend_add_library", library_spy)
    A, S = _port_analysis("laplacian_3d_12")
    F = supernodal_device.factorize_device(
        A, S, sstt.DEFAULT.replace(compute_dtype=dtype), device="cpu",
        tile_rmin=tile_rmin)
    assert F.ok and not library
    assert not hasattr(supernodal_device, "extend_add_library")
    plan = F.dplan.plan
    want = []
    for gl in plan.groups:
        for g in gl:
            folded = set(g._tile.folded) if g._tile is not None and \
                dtype == "float32" else set()
            classes = []
            for ci, pc in enumerate(g.pairs):
                if ci not in folded:
                    B_c = plan.groups[pc.src_level][pc.src_gi].B
                    classes.append(((B_c, pc.RU_c, pc.RU_c),
                                    (pc.src_level, pc.src_gi)))
            if classes:
                want.append(((g.B, g.R), classes, (torch.int32,) * 3))
    assert calls == want
    if tile_rmin == 32 and dtype == "float32":
        assert sum(len(c[1]) for c in want) < sum(
            len(g.pairs) for gl in plan.groups for g in gl)


def test_laplacian_runs_both_kernels_plain(monkeypatch):
    """At this size the port's plan sends groups through both kernels (the
    plain versions on the CPU), so the parity above covers them."""
    import torch
    A, S = _port_analysis("laplacian_3d_12")
    dp = supernodal_device.device_plan(A, S, torch.device("cpu"), 32)
    groups = [g for gl in dp.plan.groups for g in gl]
    assert sum(g._tile is not None for g in groups) >= 2
    assert sum(supernodal_device._use_potrf_kernel(torch.float32, g.B, g.C)
               for g in groups) >= 2


def test_minor_matches_reference(monkeypatch):
    S, Fj, Ft = _both(lambda fx: fx.laplacian_3d(8, shift=-3.0),  # indefinite
                      "float32", monkeypatch)
    assert not Fj.ok
    assert Ft.minor == Fj.minor < S.n


def test_plan_cache_keys_on_tile_threshold_and_device():
    import torch
    A, S = _port_analysis("laplacian_3d_12")
    cpu = torch.device("cpu")
    p32 = supernodal_device.device_plan(A, S, cpu, 32)
    assert supernodal_device.device_plan(A, S, cpu, 32) is p32
    p256 = supernodal_device.device_plan(A, S, cpu)
    assert p256 is not p32
    assert p256.device == p32.device == cpu
    assert set(S._torch_plan) == {(32, False, "cpu", 0, 0.0),
                                  (256, False, "cpu", 0, 0.0)}
    assert not any(g._tile is not None and g.R < 256
                   for gl in p256.plan.groups for g in gl)
    # the manifest form is part of the key: two-piece steps, same layout
    pair = supernodal_device.device_plan(A, S, cpu, 32, tile_pair=True)
    assert pair is not p32 and (32, True, "cpu", 0, 0.0) in S._torch_plan
    assert pair.plan.dev_size == p32.plan.dev_size
    assert {g._tile.man.shape[1] for gl in pair.plan.groups for g in gl
            if g._tile is not None} == {14}
    # so are the wide-tile threshold and the fold fraction (F7)
    wide = supernodal_device.device_plan(A, S, cpu, 32, tile_big=192,
                                         tile_frac=0.5)
    assert wide is not p32 and (32, False, "cpu", 192, 0.5) in S._torch_plan
    assert wide.plan.dev_size == p32.plan.dev_size
    assert {g._tile.rowmap.shape[-1] for gl in wide.plan.groups for g in gl
            if g._tile is not None} == {128, 256}
