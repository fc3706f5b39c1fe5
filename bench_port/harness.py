"""One run of one cell: set-up, the measured window, the traced steps and
the check against the reference.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration ``configs/<config>.json``; the
configuration's matrix generator ``matrices/<generator>.py``; its traffic
``traffic/<traffic>.json``, a data file of parameters that names the step
it drives, ``steps/<step>.py`` (the one generator that reads every traffic
file naming it: the step, the answers the reference judges, the step's
end-to-end metrics); each per-layer metric's reader
``metrics/<metric>.py``. So a later mix of an existing step is a data file
alone, and a new kind of step new files, with no edit to this module.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

from . import timing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "suitesparse_tpu")
# the tag of the random stream that draws the judged steps (a step module
# draws its inputs from tags below it)
_SAMPLE = 4
PROFILED_STEPS = 3
WINDOW_SPAN = "bench.window"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name only begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metrics, all found by name under this directory."""

    def __init__(self, workload: str, config: dict | None = None):
        """``config`` in place of the configuration's file (the tests'
        smaller grids)."""
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.entry["config"])
        self.config = config if config is not None else load_json(
            os.path.join(ROOT, conf["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", self.entry["traffic"] + ".json"))
        self.mix = load_module(
            os.path.join(HERE, "steps", self.traffic["step"] + ".py"),
            "bench_port_step_" + self.traffic["step"])
        self.generator = load_module(
            os.path.join(HERE, "matrices", self.config["generator"] + ".py"),
            "bench_port_matrix_" + self.config["generator"])

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric: dict):
        """The reader module of a per-layer metric, checked against its
        entry."""
        mod = load_module(os.path.join(HERE, "metrics",
                                       metric["name"] + ".py"),
                          "bench_port_metric_" + metric["name"])
        for key in ("unit", "layer", "source", "moves", "better"):
            if getattr(mod, key.upper()) != metric[key]:
                raise ValueError(f"metrics/{metric['name']}.py: {key} "
                                 f"{getattr(mod, key.upper())!r} against "
                                 f"{metric[key]!r} in BENCHMARK.json")
        return mod


def rng(seed: int, *key: int) -> np.random.Generator:
    """An independent random stream of ``seed`` (any whole number) for
    the tags ``key``."""
    return np.random.default_rng(np.random.SeedSequence(
        entropy=int(seed) % 2 ** 64, spawn_key=key))


class Run:
    """The program driven through one cell's traffic from one seed.

    ``sst`` is the port's package, reached only through its public API;
    ``cfg`` its ``Config`` from the configuration's ``program`` block, or
    with ``control`` the ``control`` block applied over it: the program's
    own lower-precision path. ``mix`` is the traffic's step module's
    ``Mix``, which drives the program step by step."""

    def __init__(self, cell: Cell, device: str = "cuda",
                 control: bool = False):
        import torch

        import suitesparse_tpu_torch as sst

        self.torch, self.sst = torch, sst
        self.cell, self.device = cell, device
        self.cuda = device.startswith("cuda")
        prog = dict(cell.config["program"])
        if control:
            prog.update({k: v for k, v in cell.config["control"].items()
                         if k != "tf32"})
            if cell.config["control"].get("tf32"):
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
        self.dtype = prog["compute_dtype"]
        prog["ordering"] = sst.Ordering(prog["ordering"])
        self.cfg = sst.DEFAULT.replace(**prog)
        self.spans = timing.Spans()
        self.marks: dict[str, float] = {}
        self.steps: list[tuple[int, float, float]] = []
        self.failed = 0
        self.profile = None
        self.mix = cell.mix.Mix(self, cell.traffic)

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def setup(self, seed: int) -> int:
        """The mix's set-up from the seed and the traffic's warm-up steps;
        returns the first step of the window."""
        k = self.mix.setup(seed)
        for _ in range(self.cell.traffic["warmup_steps"]):
            self.mix.step(k)
            k += 1
        self.sync()
        self.mix.answers.clear()
        self.spans = timing.Spans()
        return k

    def window(self, k0: int, seconds: float, sync: bool = False) -> int:
        """Steps from ``k0`` until ``seconds`` have passed; returns the next
        step. A step that raises counts as failed."""
        t_start = time.perf_counter()
        k = k0
        shown = False
        while True:
            t0 = time.perf_counter()
            try:
                self.mix.step(k, sync=sync)
            except Exception:              # a failed step is counted
                self.failed += 1
                if not shown:
                    traceback.print_exc()
                    shown = True
            t1 = time.perf_counter()
            self.steps.append((k, t0, t1))
            k += 1
            if t1 - t_start >= seconds:
                break
        self.t_window = (t_start, t1)
        return k

    def profiled(self, k0: int) -> None:
        """``PROFILED_STEPS`` steps from ``k0`` under ``torch.profiler``."""
        from . import trace

        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        keep = self.spans
        self.spans = timing.Spans()
        self.sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                for k in range(k0, k0 + PROFILED_STEPS):
                    self.mix.step(k, sync=True,
                                  label=torch.profiler.record_function)
                self.sync()
        self.spans = keep
        self.profile = trace.read(prof, WINDOW_SPAN, PROFILED_STEPS)

    def free(self) -> None:
        """Let go of the program's state before the reference runs."""
        self.mix.free()
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    # ----- results -----
    def end_to_end(self) -> dict:
        """The step module's end-to-end metrics over the window."""
        return self.cell.mix.end_to_end(
            [t1 - t0 for _k, t0, t1 in self.steps],
            self.t_window[1] - self.t_window[0])

    def sample(self) -> list[int]:
        """The steps of the window whose answers the reference judges,
        drawn from the seed."""
        ks = [k for k, _t0, _t1 in self.steps if k in self.mix.answers]
        m = min(self.cell.traffic["sample"], len(ks))
        pick = rng(self.mix.seed, _SAMPLE).choice(len(ks), size=m,
                                                  replace=False)
        return sorted(ks[i] for i in pick)

    def judge(self, ks: list[int]) -> dict:
        """The worst of each compared number over the steps ``ks``, by the
        reference (run on this run's device, after :meth:`free`)."""
        worst: dict[str, float] = {}
        for k in ks:
            for name, v in self.mix.judge(k).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst


def checks(cell: Cell, readings: dict) -> dict:
    """Each compared number beside its limit, from the configuration's
    ``limits``."""
    return {name: {"value": readings.get(name, float("inf")),
                   "limit": limit}
            for name, limit in cell.config["limits"].items()}


def verdict(run: Run, ks: list[int], readings: dict) -> tuple[bool, dict]:
    """``correct`` and the checks of a run whose steps ``ks`` the
    reference judged: no step failed, some were judged, and every
    compared number is within its limit."""
    check = checks(run.cell, readings)
    ok = all(c["value"] <= c["limit"] for c in check.values())
    return run.failed == 0 and bool(ks) and ok, check
