"""Readings of a stream cell's emission faults (``traffic/emit.py``), many
seeds in one process, as ``readings.py`` takes the rest.

    python3 h100bench/emit_readings.py --workload faucet2d_4k.emit \
        [--skipped 11] [--late 21] [--still 31] [--seconds 2] [--out readings.jsonl]

For each ``--skipped`` seed it makes a run, as ``run.py`` does with a short
window, whose first boundary with rows due emits none (they join one
boundary late); for each ``--late`` seed one whose every emission comes
an epoch late; for each ``--still`` seed one whose stream spawns at rest.
It prints the compared numbers, one JSON object a line, also appended to
``--out``. The check must fail each. Needs a CUDA device.
"""

import argparse
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def emission_skipped(drv):
    """The first boundary after the segment's start with rows due emits
    none: they join at the next one."""
    spawn = drv.schedule.spawn_step
    first = int(spawn[spawn > 0].min())
    skip = -(-first // drv.epoch_steps) * drv.epoch_steps
    real = drv._em.emit_due
    drv._em = types.SimpleNamespace(
        emit_due=lambda state, em, k, *rule: state if k == skip else real(state, em, k, *rule))


def emitted_late(drv):
    """Every emission an epoch late: the rows due at the boundary before."""
    real, epoch = drv._em.emit_due, drv.epoch_steps
    drv._em = types.SimpleNamespace(
        emit_due=lambda state, em, k, *rule: real(state, em, k - epoch, *rule))


def spawned_still(drv):
    """The stream's spawn velocity zeroed: the rows start at rest."""
    drv.schedule = dataclasses.replace(drv.schedule, spawn_vel=drv.schedule.spawn_vel * 0.0)


FAULTS = {"skipped": emission_skipped, "late": emitted_late, "still": spawned_still}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    for name in FAULTS:
        ap.add_argument(f"--{name}", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    if not torch.cuda.is_available():
        print("emit_readings: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench()
    out = open(args.out, "a") if args.out else None
    for side, fault in FAULTS.items():
        for seed in (int(s) for s in getattr(args, side).split(",") if s):
            t = time.perf_counter()
            result, check = harness.run(args.workload, seed, args.seconds, False, bench=bench,
                                        fault=fault)
            line = json.dumps({"workload": args.workload, "seed": seed, "side": side,
                               "correct": result["correct"], "failed": result["failed"],
                               "numbers": {k: v for k, (v, _) in check.items()},
                               "run_s": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
