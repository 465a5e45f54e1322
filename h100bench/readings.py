"""Readings for the limits of a cell's compared numbers, many seeds in one
process (the CUDA context and the kernel library are set up once).

    python3 h100bench/readings.py --workload <cell> --seeds 11,12,13 \
        [--control 21,22,23] [--bare 31] [--clock 41] [--seconds 2] [--out readings.jsonl]

For each ``--seeds`` seed it makes a run of the cell with a short window,
as ``run.py`` does, and prints the compared numbers (the lower readings);
for each ``--control`` seed it puts the reference in bfloat16 in the
program's place and prints its numbers (the upper readings); for each
``--bare`` seed it makes a run with the workload's obstacles left out of
the program, for each ``--clock`` seed one whose epochs' bins leave the
state's clock at 0 (faults the numbers must catch). One JSON object a
line, also appended to ``--out``. Needs a CUDA device.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def obstacles_left_out(drv):
    """The program steps without the workload's obstacles."""
    drv.obstacles = None


def clock_left_at_zero(drv):
    """Each epoch's bin leaves the state's clock at 0 instead of the
    epoch's first step times dt: the obstacles move by the wrong time."""
    nb = drv._nb

    class ClockLeftAtZero:
        def __getattr__(self, name):
            return getattr(nb, name)

        def bin_state(self, grid, state, sim_time=None):
            return nb.bin_state(grid, state)

    drv._nb = ClockLeftAtZero()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--bare", default="")
    ap.add_argument("--clock", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness, judge

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench()
    work = bench.workload(args.workload)
    cfg = bench.config(work["config"])
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    runs = [(s, "program", None) for s in args.seeds.split(",") if s]
    runs += [(s, "bare", obstacles_left_out) for s in args.bare.split(",") if s]
    runs += [(s, "clock", clock_left_at_zero) for s in args.clock.split(",") if s]
    for seed, side, fault in ((int(s), side, f) for s, side, f in runs):
        t = time.perf_counter()
        result, check = harness.run(args.workload, seed, args.seconds, False, bench=bench,
                                    fault=fault)
        emit({"workload": args.workload, "seed": seed, "side": side,
              "correct": result["correct"], "failed": result["failed"],
              "rebins_before_check": result["rebins_before_check"],
              "numbers": {k: v for k, (v, _) in check.items()},
              "metrics": {k: m["value"] for k, m in result["metrics"].items()},
              "judge_s": result["judge_s"], "run_s": time.perf_counter() - t})
    builder = bench.module("scenes", cfg["builder"])
    for seed in (int(s) for s in args.control.split(",") if s):
        t = time.perf_counter()
        inp = builder.inputs(cfg, seed, torch.device("cuda"))
        nums = judge.numbers(cfg, work, inp, judge.control(cfg, work, inp))
        emit({"workload": args.workload, "seed": seed, "side": "control",
              "correct": judge.verdict(work["check"]["limits"], nums), "numbers": nums,
              "run_s": time.perf_counter() - t})
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
