"""Benchmark of the PyTorch and CUDA port (``suitesparse_tpu_torch``).

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Driven by data: ``BENCHMARK.json`` at the checkout's root names the cells;
each cell's configuration is ``configs/<config>.json``, its matrix generator
``matrices/<generator>.py``, its traffic mix ``traffic/<traffic>.json`` (a
data file of parameters naming the step module ``steps/<step>.py`` that
reads it) and each per-layer metric a reader ``metrics/<metric>.py``. The
shared arithmetic (timing, the profiler's busy union, the roofline count and the
card's peaks, the reference's comparison) lives in this package's modules.
"""
