"""BENCHMARK.json, and the harness finding every piece by name; no module
of a run is JAX's or the JAX package's."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_port import harness

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BANNED = {"jax", "jaxlib", "flax", "suitesparse_tpu"}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert len(c["why"]) <= 200
        conf = harness.load_json(os.path.join(ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert set(conf["limits"]) and all(v > 0 for v in
                                           conf["limits"].values())
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["config"] in names and w["chips"] in (1, 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_harness_finds_every_piece(cell):
    c = harness.Cell(cell)
    assert hasattr(c.generator, "build") and hasattr(c.mix, "Mix")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    reported = c.mix.end_to_end([0.25, 0.5, 0.75], 1.5)
    for m in c.end_to_end:
        assert m["name"] == "setup_s" or reported[m["name"]] > 0
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m).read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no_such.cell")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    here = os.path.dirname(harness.__file__)
    for dirpath, _dirs, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                for m in _imports(os.path.join(dirpath, f)):
                    assert m.split(".")[0] not in BANNED, (f, m)


def test_loaded_modules_of_a_run():
    """What a run loads (the harness, the port, every reader, the trace
    and roofline modules, the reference), compared by top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench_port import harness, trace, roofline\n"
        "from bench_port.reference import solve\n"
        "c = harness.Cell('lap3d80_fp32.refactor')\n"
        "r = harness.Run(c, 'cpu')\n"
        "[c.reader(m) for m in c.per_layer]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "suitesparse_tpu_torch" in tops
    assert not tops & BANNED


def test_run_without_a_card_prints_no_result(tmp_path):
    """Here there is no CUDA device: a non-zero exit and no result; the
    same in a directory holding only BENCHMARK.json and bench_port."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
            shutil.copytree(os.path.join(ROOT, "bench_port"),
                            tmp_path / "bench_port",
                            ignore=shutil.ignore_patterns(".cache",
                                                          "__pycache__"))
        p = subprocess.run([sys.executable, "bench_port/run.py",
                            "--workload", "lap3d80_fp32.refactor", "--seed",
                            "1", "--seconds", "1", "--trace", "0"],
                           capture_output=True, text=True, cwd=cwd,
                           timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout
