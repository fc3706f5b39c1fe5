"""The frozen matrix generators and the traffic's values from the seed."""

import numpy as np
import pytest

from bench_port import harness, stencil

CELLS = ("lap3d80_fp32.refactor", "hpcg27_80_fp64.refactor")


def dense(st, data):
    D = np.zeros((st.n, st.n))
    cols = np.repeat(np.arange(st.n), np.diff(st.indptr))
    D[st.indices, cols] = data
    return D + np.triu(D, 1).T


def small_cell(name, g=6):
    cell = harness.Cell(name)
    return harness.Cell(name, config=dict(cell.config, nx=g, ny=g, nz=g))


@pytest.mark.parametrize("points, diag", [(7, 6.0), (27, 26.0)])
def test_published_stencil(points, diag):
    st = stencil.build((5, 6, 7), points)
    D = dense(st, st.values(np.ones(st.weight_shape())))
    assert np.all(np.diag(D) == diag)
    off = D - np.diag(np.diag(D))
    assert set(np.unique(off)) <= {0.0, -1.0}
    counts = (D != 0).sum(axis=1)
    assert counts.max() == points            # an interior row
    x, y, z = 2, 3, 3                        # interior point
    row = D[(x * 6 + y) * 7 + z]
    assert np.count_nonzero(row) == points and row.sum() == 0.0
    # CSC order: rows ascending, diagonal last in each upper column
    for j in range(st.n):
        r = st.indices[st.indptr[j]:st.indptr[j + 1]]
        assert np.all(np.diff(r) > 0) and r[-1] == j


def test_lap7_matches_the_port_fixture():
    from suitesparse_tpu_torch.io import fixtures
    st = stencil.build((6, 5, 4), 7)
    B = fixtures.laplacian_3d(6, 5, 4)
    assert np.array_equal(B.indptr, st.indptr)
    assert np.array_equal(B.indices, st.indices)
    assert np.array_equal(B.data, st.values(np.ones(st.weight_shape())))


@pytest.mark.parametrize("name", CELLS)
def test_generators_repeat(name):
    cell = small_cell(name)
    a, b = cell.generator.build(cell.config), cell.generator.build(cell.config)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.off_edge, b.off_edge)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_values_from_seed_are_dominant_and_repeat(name, seed):
    cell = small_cell(name)
    runs = []
    for _ in range(2):
        mix = harness.Run(cell, "cpu").mix
        mix.build_pattern()
        mix.seed_inputs(seed)
        runs.append(mix)
    st = runs[0].st
    for k in range(6):
        v = runs[0].values(k)
        assert np.array_equal(v, runs[1].values(k))
        assert np.array_equal(runs[0].rhs(k), runs[1].rhs(k))
        D = dense(st, v)
        off = np.abs(D).sum(axis=1) - np.abs(np.diag(D))
        assert np.all(np.diag(D) - off >= 1e-3 - 1e-12)   # the shift
        w = -v[st.off_pos]
        assert w.min() >= 0.5 and w.max() <= 2.0
    # every step's values differ
    vals = [runs[0].values(k).tobytes() for k in range(8)]
    assert len(set(vals)) == 8


def test_other_seed_other_values():
    cell = small_cell(CELLS[0])
    r1, r2 = harness.Run(cell, "cpu").mix, harness.Run(cell, "cpu").mix
    for r, s in ((r1, 1), (r2, 2)):
        r.build_pattern()
        r.seed_inputs(s)
    assert not np.array_equal(r1.values(0), r2.values(0))
