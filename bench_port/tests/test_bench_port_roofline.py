"""The frozen flop count of the factor roofline."""

import numpy as np
import pytest

from bench_port import roofline, stencil


def test_dense_count_is_sum_of_squares():
    n = 9
    indptr = np.concatenate([[0], np.cumsum(np.arange(1, n + 1))]).astype(
        np.int64)
    indices = np.concatenate([np.arange(j + 1) for j in range(n)]).astype(
        np.int64)
    perm = np.random.default_rng(1).permutation(n)
    cc = roofline.column_counts(indptr, indices, perm)
    assert list(cc) == [n - j for j in range(n)]
    w = roofline.factor_work(indptr, indices, perm, "float64")
    assert w["fl"] == sum((n - j) ** 2 for j in range(n))
    assert w["bytes"] == (indptr[-1] + n * (n + 1) / 2) * 8


@pytest.mark.parametrize("points, grid", [(7, (7, 6, 5)), (27, (5, 6, 4))])
def test_count_matches_the_port(points, grid):
    import suitesparse_tpu_torch as sstt
    st = stencil.build(grid, points)
    A = sstt.CSC(st.n, st.n, st.indptr, st.indices,
                 st.values(np.ones(st.weight_shape())), 1)
    S = sstt.analyze(A, sstt.DEFAULT.replace(ordering=sstt.Ordering.METIS))
    w = roofline.factor_work(st.indptr, st.indices, S.perm, "float32")
    assert w["fl"] == S.fl and w["lnz"] == S.lnz
    assert w["bound_s"] == max(w["fl"] / 67e12, w["bytes"] / 3.35e12)
