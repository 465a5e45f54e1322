"""CLI: python -m sph_pie_torch {serve|simulate|verify}.

``serve`` runs the HTTP service and viewer, ``simulate`` runs a scene and
prints its final metrics as JSON, ``verify`` runs the trajectory contract
(``verify.py``) and prints its result, last, as one JSON line. Each runs on
the card (``--device cuda``, the default); without a CUDA device it fails,
and it never falls back to the CPU, which is run only when asked for with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def _device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu only when asked)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sph_pie_torch",
                                description="The PyTorch + CUDA SPH engine.")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the HTTP service + viewer")
    s.add_argument("--config", default="config/app-config.json")
    _device_arg(s)
    s = sub.add_parser("simulate", help="run a scene and print metrics")
    s.add_argument("scene", help="builder name or scene JSON path")
    s.add_argument("--steps", type=int, default=500)
    _device_arg(s)
    s = sub.add_parser("verify", help="run the trajectory contract")
    s.add_argument("--n-target", type=int, default=4096,
                   help="particles of the 2D dam break (default 4096)")
    s.add_argument("--steps", type=int, default=1000)
    _device_arg(s)
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    if args.cmd == "serve":
        from sph_pie_torch.service.api import serve

        serve(args.config, device=device)
        return 0
    if args.cmd == "verify":
        from sph_pie_torch import verify

        result = verify.run(args.n_target, args.steps, device=device)
        print(json.dumps(result))
        return 0 if result["ok"] else 1

    from sph_pie_torch.scenes import builders
    from sph_pie_torch.scenes.config import load_scene_file
    from sph_pie_torch.service.metrics import state_metrics
    from sph_pie_torch.solvers import run as run_lib

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
