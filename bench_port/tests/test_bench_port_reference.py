"""The plain reference against a dense numpy solve, and its isolation."""

import ast
import os

import numpy as np

from bench_port import stencil
from bench_port.reference import solve as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reference_agrees_with_dense_solve():
    st = stencil.build((6, 5, 7), 27)
    data = st.values(np.random.default_rng(4).uniform(0.5, 2,
                                                      st.weight_shape()))
    data[st.diag_pos] += 1e-3
    D = np.zeros((st.n, st.n))
    cols = np.repeat(np.arange(st.n), np.diff(st.indptr))
    D[st.indices, cols] = data
    D = D + np.triu(D, 1).T
    b = np.random.default_rng(5).standard_normal((st.n, 2))
    x = np.linalg.solve(D, b)
    r = ref.judge(st.indptr, st.indices, data, b, x, "cpu")
    assert r["x_err"] < 1e-11 and r["berr"] < 1e-15 and r["cg_rel"] < 1e-12
    # a wrong answer reads wrong
    x2 = x.copy()
    x2[3, 0] += 1e-3 * np.abs(x).max()
    r2 = ref.judge(st.indptr, st.indices, data, b, x2, "cpu")
    assert r2["x_err"] > 5e-4 and r2["berr"] > 1e-5
    # the backward error as defined
    res = np.abs(b - D @ x2).max()
    want = res / (np.abs(D).sum(axis=1).max() * np.abs(x2).max()
                  + np.abs(b).max())
    assert np.isclose(r2["berr"], want, rtol=1e-9)


def test_reference_imports_numpy_and_torch_only():
    allowed = {"__future__", "warnings", "numpy", "torch"}
    for name in os.listdir(os.path.join(HERE, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(HERE, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{name}: relative import"
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, f"{name} imports {m}"
