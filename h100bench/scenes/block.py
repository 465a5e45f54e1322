"""A block of fluid at rest on a lattice in a box: the dam breaks.

``inputs`` makes the lattice (the first site at lo + dx/2, spacing dx, the
fluid block's volume over ``n_target`` per site) on the device, with a
seeded uniform jitter of each coordinate, +-``jitter`` dx, from a
``torch.Generator`` on that device; the particles rest, and each has the
mass that makes an infinite lattice's poly6 density exactly rho0.
``program`` hands them to the program: its params and slot grid from
``scenes.builders.block_scene`` on the configuration's numbers, its state
made of the inputs.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from h100bench.reference import sph

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Inputs:
    pos: torch.Tensor  # [N, dim], the configuration's dtype
    vel: torch.Tensor  # [N, dim] zeros
    mass: float        # every particle's mass


def lattice_mass(p: sph.Physics, dx: float) -> float:
    """m = rho0 / sum over the lattice of W(|offset|)."""
    reach = math.ceil(p.h / dx)
    w = sum(p.c_poly6 * (p.h * p.h - r2) ** 3
            for off in itertools.product(range(-reach, reach + 1), repeat=p.dim)
            if (r2 := sum((o * dx) ** 2 for o in off)) < p.h * p.h)
    return p.rest_density / w


def _sites(cfg: dict) -> list[int]:
    """Lattice sites per axis: lo + dx/2, lo + 3 dx/2, .. < hi."""
    dx = sph.spacing(cfg)
    return [len(np.arange(a + 0.5 * dx, b, dx)) for a, b in zip(*cfg["fluid"])]


def lattice_sites(cfg: dict) -> int:
    return math.prod(_sites(cfg))


def inputs(cfg: dict, seed: int, device) -> Inputs:
    p = sph.physics(cfg)
    dx = sph.spacing(cfg)
    lo = cfg["fluid"][0]
    sites = _sites(cfg)
    axes = [a + 0.5 * dx + dx * torch.arange(k, dtype=torch.float64, device=device)
            for a, k in zip(lo, sites)]
    grid = torch.stack([m.reshape(-1) for m in torch.meshgrid(*axes, indexing="ij")], dim=-1)
    if grid.shape[0] != cfg["particles"]:
        raise ValueError(f"{cfg['name']}: the lattice holds {grid.shape[0]} particles, the "
                         f"configuration states {cfg['particles']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    u = torch.rand(grid.shape, generator=gen, dtype=torch.float64, device=device)
    pos = (grid + (2.0 * u - 1.0) * (cfg["jitter"] * dx)).to(DTYPES[cfg["dtype"]])
    return Inputs(pos=pos, vel=torch.zeros_like(pos), mass=lattice_mass(p, dx))


def program(cfg: dict, inp: Inputs):
    """(params, grid, state) of the program for these inputs."""
    from sph_pie_torch.core.state import ParticleState
    from sph_pie_torch.scenes.builders import block_scene

    n, dim = inp.pos.shape
    dt, dev = inp.pos.dtype, inp.pos.device
    scene = block_scene(
        name=cfg["name"], dim=dim, domain=cfg["domain"], fluid_lo=cfg["fluid"][0],
        fluid_hi=cfg["fluid"][1], dx=sph.spacing(cfg), h_over_dx=cfg["h_over_dx"],
        sound_speed=cfg["sound_speed"], viscosity=cfg["viscosity"], xsph_eps=cfg["xsph_eps"],
        surface_tension=cfg["surface_tension"], cfl=cfg["cfl"], capacity=n, bcap=cfg["cap"],
        skin_frac=cfg["skin_frac"], build_state=False, dtype=dt, device=dev,
        rest_density=cfg["rest_density"], eos_gamma=cfg["eos_gamma"],
        gravity=[0.0] * (dim - 1) + [cfg["gravity"]],
        boundary_stiffness=cfg["boundary_stiffness"], boundary_damping=cfg["boundary_damping"],
    )
    if scene.bgrid.num_slots != cfg["slots"]:
        raise ValueError(f"{cfg['name']}: the program's grid has {scene.bgrid.num_slots} slots, "
                         f"the configuration states {cfg['slots']}")
    state = ParticleState(
        pos=inp.pos.clone(), vel=inp.vel.clone(), mass=torch.full((n,), inp.mass, dtype=dt, device=dev),
        density=torch.zeros(n, dtype=dt, device=dev), pressure=torch.zeros(n, dtype=dt, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
    )
    return scene.params, scene.bgrid, state
