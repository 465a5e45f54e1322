"""CLI: python -m sph_pie_torch simulate <builder | scene.json>.

Runs a scene on the card (``--device cuda``, the default) and prints its
final metrics as JSON. Without a CUDA device it fails; it never falls back
to the CPU, which is run only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sph_pie_torch",
        description="The PyTorch + CUDA SPH engine. The reference's "
        "'serve' and 'verify' commands are not ported yet: they wait for the "
        "port's service and trajectory-contract script.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("simulate", help="run a scene and print metrics")
    s.add_argument("scene", help="builder name or scene JSON path")
    s.add_argument("--steps", type=int, default=500)
    s.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu only when asked)")
    args = p.parse_args(argv)

    from sph_pie_torch.scenes import builders
    from sph_pie_torch.scenes.config import load_scene_file
    from sph_pie_torch.service.metrics import state_metrics
    from sph_pie_torch.solvers import run as run_lib

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    if args.scene.endswith(".json"):
        scene = load_scene_file(args.scene, device=device)
    else:
        if not hasattr(builders, args.scene):
            p.error(
                f"unknown scene '{args.scene}' "
                "(try dam_break_2d, dam_break_3d, emitter_2d, or a JSON path)"
            )
        scene = getattr(builders, args.scene)(device=device)
    st, overflow = run_lib.run_scene(scene, args.steps)
    m = state_metrics(st, scene.params, step=args.steps)
    m["overflow"] = int(overflow)
    print(json.dumps(m, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
