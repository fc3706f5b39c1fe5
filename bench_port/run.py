"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s`` from the start of this script): the port's
import and the CUDA context, the matrix and the inputs from the seed, the
analysis, the first factor and solve, the traffic's warm-up steps. Then
the window: steps for ``--seconds``. With ``--trace 1`` the window's
phases end at a device synchronize, and three more steps run under
``torch.profiler``; the line then holds the per-layer metrics, ``busy_s``
and ``window_s``, and the breakdown. After the window the program's
state is let go and the reference judges a sample of the window's steps,
drawn from the seed; each compared number is printed beside its limit as
the last lines of standard error and under ``checks``, the last key of
the result, the last line of standard output.

Exits non-zero without a result where there is no CUDA device or fewer
than the cell asks for, or where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# fixed build and kernel cache directories inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
# the checkout's root in place of this directory, whose module names
# (trace, timing) would shadow others
sys.path[0] = ROOT


def main() -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from bench_port import harness

    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    chips = int(cell.entry["chips"])
    if torch.cuda.device_count() < chips:
        print(f"run.py: the cell asks for {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    run = harness.Run(cell, "cuda")
    k = run.setup(args.seed)
    setup_s = time.perf_counter() - T0
    k = run.window(k, args.seconds, sync=bool(args.trace))
    bad = harness.banned_modules()
    if bad:
        print(f"run.py: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    peak = torch.cuda.max_memory_allocated()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": peak}

    metrics = {}
    breakdown = None
    if args.trace:
        run.profiled(k)
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        breakdown = {"device_ops": run.profile.device_ops,
                     "idle_gaps": run.profile.idle_gaps}
        for m in cell.per_layer:
            v = cell.reader(m).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        print(f"hand kernels (ms, launches over {run.profile.steps} "
              f"profiled steps): {run.profile.hand_kernels}; device busy "
              f"in each span (s): {run.profile.busy_in}; spans (s): "
              f"{run.profile.span_s}; factor work: {run.mix.work()}",
              file=sys.stderr)
    else:
        values = dict(run.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                print(f"run.py: step {cell.traffic['step']} reports no "
                      f"{m['name']}", file=sys.stderr)
                return 4
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    ks = run.sample()
    run.free()
    readings = run.judge(ks)
    correct, check = harness.verdict(run, ks, readings)
    if harness.banned_modules():
        print(f"run.py: loaded {', '.join(harness.banned_modules())}",
              file=sys.stderr)
        return 3
    print(f"steps {len(run.steps)}, failed {run.failed}, judged {ks}, "
          f"reference cg iters {readings.get('cg_iters')} rel "
          f"{readings.get('cg_rel')}", file=sys.stderr)
    for name, c in check.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": correct, "attempted": len(run.steps),
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = check
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
