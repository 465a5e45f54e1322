"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository's root. Without as many CUDA devices as the cell asks
for it exits 2 and prints no result; it never falls back to the CPU. The
last lines on standard error are the compared numbers beside their limits;
the last line on standard output is the result: ``correct``, ``attempted``
(segments run in the window), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    bench = harness.Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, check = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                bench=bench, t0=T0)
    for name, (value, limit) in check.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    result["check"] = {k: {"value": finite(v), "limit": lim} for k, (v, lim) in check.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
