"""The readings that a cell's limits are set from: the program's compared
numbers over many seeds, and its control's.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 [--modes program,control] [--steps 6]

For cells whose traffic drives ``steps/refactor.py``. One process, one
analysis (the pattern is the seed's no more than the sizes are): for each seed the cell's inputs from that seed, one warm-up
step, then ``--steps`` steps of the cell's traffic at its own size, and
the reference's judgement of the same number of sampled steps as a run
judges. ``control`` runs the program with the configuration's ``control``
block: its own lower-precision path (TF32 in the fp32 cell's matmuls, a
float32 factor in the fp64 cell). The benchmark's runs never run it.
Prints one JSON line a (mode, seed), then for each compared number the
largest program reading and the smallest control reading.
"""

import argparse
import json
import os
import sys

# the checkout's root in place of this directory (see run.py)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(run, seed: int, steps: int) -> dict:
    mix = run.mix
    mix.seed_inputs(seed)
    mix.answers.clear()
    run.steps.clear()
    k = 1
    mix.step(k)                     # warm-up: the first values of the seed
    mix.answers.clear()
    for k in range(k + 1, k + 1 + steps):
        mix.step(k)
        run.steps.append((k, 0.0, 0.0))
    return run.judge(run.sample())


def main() -> int:
    ap = argparse.ArgumentParser(description="program and control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from bench_port import harness

    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    base = None
    summary = {}
    for mode in args.modes.split(","):
        run = harness.Run(cell, args.device, control=(mode == "control"))
        mix = run.mix
        if base is None:
            mix.build_pattern()
            mix.seed_inputs(seeds[0])
            mix.A.data = mix.values(0)
            mix.analyze()
            base = mix
        else:
            mix.st, mix.A, mix.S, mix.perm = base.st, base.A, base.S, base.perm
        for seed in seeds:
            r = readings(run, seed, args.steps)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, **r}), flush=True)
            for name in cell.config["limits"]:
                key = (mode, name)
                pick = max if mode == "program" else min
                summary[key] = pick(summary.get(key, r[name]), r[name])
        run.mix.F = None
    for (mode, name), v in sorted(summary.items()):
        side = "largest" if mode == "program" else "smallest"
        print(f"{args.workload} {mode} {name} {side} {v!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
