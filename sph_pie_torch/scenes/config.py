"""JSON scene files (``config/scene-*.json``) resolved into Scene objects.

A spec either names a builder of ``scenes/builders.py`` with its arguments,
or describes the geometry: domain, lattice spacing, fluid blocks, emitters,
obstacles and ``FluidParams`` overrides. Defaults and derived values are the
reference's: h = 2 dx, dt = 0.25 h / c0, the cell capacity from the skin and
a 2D / 3D headroom, the gravity-first axis order, and a disjoint slot share
for each emitter. Lattices and emitter plans are made with numpy on the
host; tensors are made at the end, on the requested device.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from sph_pie_torch.core import state as state_lib
from sph_pie_torch.core.params import make_params
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.grid import grid_from_bounds
from sph_pie_torch.scenes import builders, emitter as em_lib, obstacles as obs_lib
from sph_pie_torch.scenes.builders import Scene, lattice_block, lattice_mass


def load_scene_file(
    path: str | Path,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Scene:
    spec = json.loads(Path(path).read_text())
    return scene_from_spec(spec, dtype=dtype, device=device)


def scene_from_spec(
    spec: dict,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Scene:
    """Build a Scene from a declarative spec.

    Spec shape (all lengths in metres, SI-ish):
      {
        "name": "my-scene",
        "builder": "dam_break_2d",          # OR explicit geometry below
        "builder_args": {"n_target": 4096},
        "dim": 2, "domain": [[0,0],[1,1]], "dx": 0.01,
        "fluid_blocks": [{"lo": [0,0], "hi": [0.4,0.6]}],
        "emitters": [{"nozzle_lo": .., "nozzle_hi": .., "direction": ..,
                       "speed": 1.5, "t_start": 0.0}],
        "obstacles": {"spheres": [{"center": [..], "radius": r}],
                       "boxes": [{"lo": [..], "hi": [..]}]},
        "params": {"viscosity": 0.05, ...},   # FluidParams overrides
        "capacity": 8192
      }
    """
    if "builder" in spec:
        fn = getattr(builders, spec["builder"])
        return fn(**spec.get("builder_args", {}), dtype=dtype, device=device)

    dim = int(spec["dim"])
    lo, hi = spec["domain"]
    dx = float(spec["dx"])
    p = dict(spec.get("params", {}))
    h = float(p.pop("h", 2.0 * dx))
    rest_density = float(p.pop("rest_density", 1000.0))
    sound_speed = float(p.pop("sound_speed", 40.0))
    dt = float(p.pop("dt", 0.25 * h / sound_speed))
    mass = lattice_mass(dim, h, dx, rest_density)
    params = make_params(
        dim=dim,
        h=h,
        dt=dt,
        rest_density=rest_density,
        sound_speed=sound_speed,
        bound_min=list(lo),
        bound_max=list(hi),
        dtype=dtype,
        device=device,
        **p,
    )

    blocks = [lattice_block(b["lo"], b["hi"], dx) for b in spec.get("fluid_blocks", [])]
    pos = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, dim), np.float64)
    capacity = int(spec.get("capacity", max(len(pos), 1)))
    if len(pos):
        st = state_lib.from_positions(
            pos, capacity=capacity, mass=mass, dtype=dtype, device=device
        )
    else:
        st = state_lib.allocate(capacity, dim, dtype, device)

    skin_frac = float(spec.get("skin_frac", 0.25))
    cell = h * (1 + skin_frac)
    headroom = 3.0 if dim == 2 else 2.0
    bcap = max(8, (int(math.ceil(headroom * (cell / dx) ** dim)) + 7) // 8 * 8)
    gspec = grid_from_bounds(lo, hi, cell_size=h, cap=builders._default_cap(dim, h, dx))
    bgrid = nb.binned_grid_from_bounds(
        lo,
        hi,
        h=h,
        cap=bcap,
        skin_frac=skin_frac,
        max_particles=capacity,
        axis_order=builders._gravity_first_order(dim),
    )

    obstacles = None
    ob = spec.get("obstacles")
    if ob:
        obstacles = obs_lib.make(
            dim,
            spheres=[(s["center"], s["radius"]) for s in ob.get("spheres", [])],
            boxes=[(b["lo"], b["hi"]) for b in ob.get("boxes", [])],
            dtype=dtype,
            device=device,
        )

    emitter = None
    ems = spec.get("emitters", [])
    if ems:
        # Every emitter gets a disjoint slot range: an explicit "slots"
        # budget per emitter, else an equal share of free capacity.
        free = capacity - len(pos)
        default_share = max(free // len(ems), 0)
        plans, cursor = [], len(pos)
        for e in ems:
            share = int(e.get("slots", default_share))
            share = min(share, capacity - cursor)
            plans.append(
                em_lib.plan_stream(
                    start_index=cursor,
                    capacity=capacity,
                    dim=dim,
                    nozzle_lo=e["nozzle_lo"],
                    nozzle_hi=e["nozzle_hi"],
                    direction=e["direction"],
                    speed=float(e["speed"]),
                    dx=dx,
                    mass=mass,
                    dt=dt,
                    t_start=float(e.get("t_start", 0.0)),
                    t_end=float(e.get("t_end", float("inf"))),
                    n_slots=share,
                    dtype=dtype,
                    device=device,
                )
            )
            cursor += share
        emitter = em_lib.merge_schedules(plans)

    return Scene(
        name=str(spec.get("name", "scene")),
        params=params,
        gspec=gspec,
        bgrid=bgrid,
        state=st,
        obstacles=obstacles,
        emitter=emitter,
    )
