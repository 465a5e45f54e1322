"""An emitter stream poured onto a static circle: the faucet fill.

``inputs`` makes the benchmark's own plan of the stream from the
configuration's numbers, on the device: one row of sites across the nozzle
(along an axis wider than the spacing dx, from lo + dx/2 by dx while under
hi; along a narrower one, its middle), a row every round(dx / speed / dt)
steps from step 0, as many whole rows as the configuration's rows hold
(the rest never spawn, spawn step -1). Each row has its spawn step, its
spawn position jittered by a seeded uniform +-``jitter`` dx on each
coordinate (a ``torch.Generator`` on that device), its velocity (``speed``
along ``direction``) and one mass, the one that makes an infinite
lattice's poly6 density exactly rho0. ``program`` builds the program's
scene, ``scenes.builders.emitter_2d``, checks it and the program's
emission clearance against the configuration and the unjittered plan,
and hands over its params, grid
and all-inactive state; ``schedule`` is the seed's stream in the
program's form, the one the driver emits from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h100bench.reference import geometry, sph
from h100bench.scenes import block


@dataclasses.dataclass(frozen=True)
class Inputs:
    pos: torch.Tensor         # [N, dim] spawn positions, jittered; 0 where never
    vel: torch.Tensor         # [N, dim] spawn velocities; 0 where never
    mass: float               # every particle's mass
    spawn_step: torch.Tensor  # [N] int64; -1: never


def plan(cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(spawn step [N] int64, spawn position [N, dim] float64, velocity
    [N, dim] float64) of every row, unjittered."""
    p = sph.physics(cfg)
    dx = sph.spacing(cfg)
    axes = []
    for lo, hi in zip(cfg["nozzle_lo"], cfg["nozzle_hi"]):
        if hi - lo > dx:
            k = len(np.arange(lo + 0.5 * dx, hi, dx))
            axes.append(lo + 0.5 * dx + dx * torch.arange(k, dtype=torch.float64, device=device))
        else:
            axes.append(torch.tensor([0.5 * (lo + hi)], dtype=torch.float64, device=device))
    row = torch.stack([m.reshape(-1) for m in torch.meshgrid(*axes, indexing="ij")], dim=-1)
    per_row, n = row.shape[0], cfg["particles"]
    rows = n // per_row
    interval = max(1, round(dx / cfg["emit_speed"] / p.dt))
    direction = torch.tensor(cfg["emit_direction"], dtype=torch.float64, device=device)
    step = torch.full((n,), -1, dtype=torch.int64, device=device)
    step[:rows * per_row] = torch.arange(rows, device=device).repeat_interleave(per_row) * interval
    pos = torch.zeros((n, p.dim), dtype=torch.float64, device=device)
    pos[:rows * per_row] = row.repeat(rows, 1)
    vel = torch.zeros_like(pos)
    vel[:rows * per_row] = cfg["emit_speed"] * direction / direction.norm()
    return step, pos, vel


def inputs(cfg: dict, seed: int, device) -> Inputs:
    p = sph.physics(cfg)
    dx = sph.spacing(cfg)
    step, pos, vel = plan(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    u = torch.rand(pos.shape, generator=gen, dtype=torch.float64, device=device)
    spawns = (step >= 0)[:, None]
    pos = torch.where(spawns, pos + (2.0 * u - 1.0) * (cfg["jitter"] * dx), 0.0)
    dt = block.DTYPES[cfg["dtype"]]
    return Inputs(pos=pos.to(dt), vel=vel.to(dt), mass=block.lattice_mass(p, dx),
                  spawn_step=step)


def scaled(cfg: dict, n: int) -> dict:
    """The configuration at ``n`` rows, as ``emitter_2d(n)`` builds it (the
    CPU tests' size): the spacing, the nozzle's thickness (dx / 2) and the
    slots follow."""
    out = {**cfg, "n_target": n, "particles": n}
    out["nozzle_hi"] = [cfg["nozzle_hi"][0], cfg["nozzle_lo"][1] + 0.5 * sph.spacing(out)]
    out["slots"] = geometry.grid(out).slots
    return out


def _differs(got: torch.Tensor, want, rel: float) -> bool:
    want = torch.as_tensor(want, dtype=torch.float64, device=got.device)
    return bool(((got.to(torch.float64) - want).abs() > rel * want.abs()).any())


def program(cfg: dict, inp: Inputs):
    """(params, grid, state) of the program's ``emitter_2d`` scene: every row
    inactive. Raises where the scene is not the configuration's or its
    stream not the plan's."""
    from h100bench.traffic import segments
    from sph_pie_torch.scenes import emitter
    from sph_pie_torch.scenes.builders import emitter_2d

    n = inp.pos.shape[0]
    dt, dev = inp.pos.dtype, inp.pos.device
    if n != cfg["n_target"]:
        raise ValueError(f"{cfg['name']}: emitter_2d holds n_target rows, the inputs {n}")
    scene = emitter_2d(n, dtype=dt, device=dev)
    p = sph.physics(cfg)
    rel = 4.0 * torch.finfo(dt).eps
    params = scene.params
    want = {"h": p.h, "dt": p.dt, "rest_density": p.rest_density,
            "sound_speed": p.sound_speed, "viscosity": p.viscosity, "xsph_eps": p.xsph_eps,
            "surface_tension": p.surface_tension, "gravity": p.gravity,
            "bound_min": p.bound_min, "bound_max": p.bound_max,
            "boundary_stiffness": p.boundary_stiffness,
            "boundary_damping": p.boundary_damping, "max_speed": p.max_speed}
    wrong = [k for k, v in want.items() if _differs(getattr(params, k), v, rel)]
    if params.eos_gamma != p.gamma:
        wrong.append("eos_gamma")
    g, want_g = scene.bgrid, geometry.grid(cfg)
    if ((g.dims, g.axis_order, g.cap, g.num_slots)
            != (want_g.dims, want_g.axis_order, cfg["cap"], cfg["slots"])
            or _differs(torch.tensor([g.cell_size, g.skin], dtype=torch.float64),
                        [geometry.cell_size(cfg), p.skin], 1e-12)):
        wrong.append(f"grid: {g.dims} cells of cap {g.cap}, {g.num_slots} slots, "
                     f"cell {g.cell_size}, skin {g.skin}")
    step, pos, vel = plan(cfg, dev)
    em = scene.emitter
    if not torch.equal(em.spawn_step.to(torch.int64), step):
        wrong.append("spawn steps")
    if _differs(em.spawn_pos, pos, rel):
        wrong.append("spawn positions")
    if _differs(em.spawn_vel, vel, rel):
        wrong.append("spawn velocities")
    if _differs(em.spawn_mass, (step >= 0).to(torch.float64) * inp.mass, rel):
        wrong.append("mass")
    if getattr(emitter, "CLEARANCE", None) != cfg["emit_clearance"]:
        wrong.append("emission")
    obs = segments.obstacles(cfg, inp.pos)
    if any(not torch.equal(getattr(scene.obstacles, f.name), getattr(obs, f.name))
           for f in dataclasses.fields(obs)):
        wrong.append("obstacles")
    if wrong:
        raise ValueError(f"{cfg['name']}: the program's emitter_2d({n}) differs from the "
                         f"configuration in {wrong}")
    return params, g, scene.state


def schedule(inp: Inputs):
    """The seed's stream as the program's ``EmitterSchedule``."""
    from sph_pie_torch.scenes.emitter import EmitterSchedule

    mass = (inp.spawn_step >= 0).to(inp.pos.dtype) * inp.mass
    return EmitterSchedule(spawn_step=inp.spawn_step.to(torch.int32), spawn_pos=inp.pos,
                           spawn_vel=inp.vel, spawn_mass=mass)
