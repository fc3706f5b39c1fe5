"""The step of a refactorization mix, and its end-to-end metrics.

A traffic file that names ``"step": "refactor"`` gives the parameters:
``weights`` (the range of the edge weights), ``pool`` (coefficient sets
and right-hand sides drawn from the seed), ``shift`` (the range of a
step's own diagonal shift), ``warmup_steps`` and ``sample``.

A step: new values on the configuration's pattern (coefficient set k mod
``pool``, plus the step's own diagonal shift, so no two steps factor the
same values), ``factorize`` on the analysis of set-up, and ``solve`` of
one right-hand side from the pool, x back on the host. The reference
judges x against the same A_k and b_k.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from bench_port import timing
from bench_port.harness import rng

# tags of the independent random streams drawn from one seed
_WEIGHTS, _RHS, _SHIFT = 1, 2, 3


def end_to_end(latencies: list[float], window_s: float) -> dict:
    """``refactor_ms``: the window over the steps completed in it;
    ``refactor_ms_p90``: the 90th percentile of every step's latency."""
    return {"refactor_ms": window_s / len(latencies) * 1e3,
            "refactor_ms_p90": timing.quantile(latencies, 0.9) * 1e3}


class Mix:
    """The refactor traffic of one run. ``run`` is the
    :class:`bench_port.harness.Run` that holds the program (``sst``,
    ``cfg``, ``device``), its spans and marks; ``params`` the traffic
    file."""

    def __init__(self, run, params: dict):
        self.run, self.p = run, params
        self.sst = run.sst
        self.answers: dict[int, np.ndarray] = {}
        self.F = None
        self.S = None
        self._work = None

    # ----- inputs, all from the seed -----
    def build_pattern(self) -> None:
        self.st = self.run.cell.generator.build(self.run.cell.config)
        n = self.st.n
        self.A = self.sst.CSC(n, n, self.st.indptr, self.st.indices,
                              np.zeros(self.st.nnz), 1)

    def seed_inputs(self, seed: int) -> None:
        lo, hi = self.p["weights"]
        shape = self.st.weight_shape()
        self.seed = seed
        self.pool = [self.st.values(rng(seed, _WEIGHTS, i).uniform(
            lo, hi, shape)) for i in range(self.p["pool"])]
        self.bpool = [rng(seed, _RHS, i).standard_normal(self.st.n)
                      for i in range(self.p["pool"])]

    def values(self, k: int, out: np.ndarray | None = None) -> np.ndarray:
        """A_k's values (into ``out`` where given): pool entry k mod pool,
        shifted by the step's own diagonal shift."""
        lo, hi = self.p["shift"]
        src = self.pool[k % len(self.pool)]
        if out is None:
            out = np.empty_like(src)
        np.copyto(out, src)
        out[self.st.diag_pos] += lo + (hi - lo) * rng(
            self.seed, _SHIFT, k).random()
        return out

    def rhs(self, k: int) -> np.ndarray:
        return self.bpool[k % len(self.bpool)]

    # ----- the program -----
    def analyze(self) -> None:
        t0 = time.perf_counter()
        self.S = self.sst.analyze(self.A, self.run.cfg)
        self.run.marks["analyze_s"] = time.perf_counter() - t0
        self.perm = np.array(self.S.perm)

    def first_factor(self) -> None:
        """The first factor of A's values: the supernodal analysis, the
        plan, the upload of its index arrays and the factor."""
        self.run.sync()
        t0 = time.perf_counter()
        self.F = self.sst.factorize(self.A, self.S, self.run.cfg,
                                    self.run.device)
        self.run.sync()
        self.run.marks["first_factor_s"] = time.perf_counter() - t0

    def setup(self, seed: int) -> int:
        """Pattern, inputs, analysis, first factor and its solve; returns
        the next step."""
        self.build_pattern()
        self.seed_inputs(seed)
        self.A.data = self.values(0)
        self.analyze()
        self.first_factor()
        self.step(0, factor=False)
        return 1

    def step(self, k: int, sync: bool = False, label=None,
             factor: bool = True) -> None:
        """Step k; its x is kept for the check. ``sync`` ends the factor's
        span at a device synchronize; ``label`` wraps each phase in a
        profiler span of that name; ``factor`` false skips the factor
        (set-up's first step, factored already)."""
        spans = self.run.spans
        lab = label or (lambda name: contextlib.nullcontext())
        if factor:
            with lab("bench.values"), spans("values"):
                self.values(k, out=self.A.data)
            with lab("bench.factorize"), spans("factorize"):
                self.F = None
                self.F = self.sst.factorize(self.A, self.S, self.run.cfg,
                                            self.run.device)
                if sync:
                    self.run.sync()
        if not self.F.ok:
            raise FloatingPointError(f"step {k}: the factor failed at "
                                     f"column {self.F.minor}")
        b = self.rhs(k)
        with lab("bench.solve"), spans("solve"):
            x = self.sst.solve(self.F, b, self.run.cfg)
        self.answers[k] = x

    def free(self) -> None:
        self.F = None
        self.S = None
        gc.collect()

    # ----- the check and the roofline -----
    def judge(self, k: int) -> dict:
        """The reference's numbers for step k's x, from A_k and b_k."""
        from bench_port.reference import solve as ref

        return ref.judge(self.st.indptr, self.st.indices, self.values(k),
                         self.rhs(k), self.answers[k], self.run.device)

    def work(self) -> dict:
        """The factor's work for the roofline (``roofline.factor_work``)."""
        if self._work is None:
            from bench_port import roofline
            self._work = roofline.factor_work(
                self.st.indptr, self.st.indices, self.perm,
                self.run.dtype)
        return self._work
