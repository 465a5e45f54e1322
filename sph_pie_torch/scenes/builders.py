"""Scene builders: canonical particle layouts + tuned parameters.

The lattices are built with numpy on the host, exactly as the reference
builds them; tensors are made at the end, on the requested device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from sph_pie_torch.core import state as state_lib
from sph_pie_torch.core.params import FluidParams, make_params
from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.grid import GridSpec, grid_from_bounds
from sph_pie_torch.scenes import emitter as em_lib
from sph_pie_torch.scenes import obstacles as obs_lib


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    params: FluidParams
    gspec: GridSpec        # naive per-particle cell grid (reference engine)
    bgrid: nb.BinnedGrid   # dense slot grid (main path)
    state: ParticleState
    obstacles: obs_lib.Obstacles | None = None
    emitter: em_lib.EmitterSchedule | None = None
    boundary: tuple[torch.Tensor, torch.Tensor] | None = None  # frozen ghosts

    def binned_state(self) -> nb.BinnedState:
        return nb.bin_state(self.bgrid, self.state, self.boundary)


def lattice_block(lo, hi, dx: float) -> np.ndarray:
    """Particle positions on a regular lattice filling an AABB, spacing dx;
    the first particle sits at lo + dx/2."""
    axes = [np.arange(l + 0.5 * dx, h, dx) for l, h in zip(lo, hi)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1)


def lattice_mass(dim: int, h: float, dx: float, rest_density: float) -> float:
    """Mass that makes the discrete poly6 density of an infinite lattice
    exactly rest_density: m = rho0 / sum_lattice W(|offset|)."""
    reach = int(math.ceil(h / dx))
    coeff = smoothing.poly6_coeff(dim, h)  # pure python float
    w_sum = 0.0
    for off in itertools.product(range(-reach, reach + 1), repeat=dim):
        r2 = sum((o * dx) ** 2 for o in off)
        if r2 < h * h:
            w_sum += coeff * (h * h - r2) ** 3
    return rest_density / w_sum


def wall_lattice(lo, hi, dx: float, layers: int, open_top: bool = True) -> np.ndarray:
    """Frozen boundary (ghost) particle positions: ``layers`` staggered
    lattice shells just outside each face of the AABB (the open top is
    skipped for tank scenes)."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    dim = lo.shape[0]
    shells = []
    for axis in range(dim):
        for side in (0, 1):
            if open_top and axis == dim - 1 and side == 1:
                continue  # open top face
            t_lo = lo - layers * dx
            t_hi = hi + layers * dx
            for l in range(layers):
                off = (l + 0.5) * dx
                plane = lo[axis] - off if side == 0 else hi[axis] + off
                axes = []
                for a in range(dim):
                    if a == axis:
                        axes.append(np.array([plane]))
                    else:
                        axes.append(np.arange(t_lo[a] + 0.5 * dx, t_hi[a], dx))
                mesh = np.meshgrid(*axes, indexing="ij")
                shells.append(np.stack([m.reshape(-1) for m in mesh], axis=-1))
    if not shells:
        return np.zeros((0, dim))
    pts = np.concatenate(shells, axis=0)
    # de-dup corner overlaps (quantize to the lattice)
    key = np.round(pts / (0.5 * dx)).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return pts[np.sort(idx)]


def _gravity_first_order(dim: int) -> tuple[int, ...]:
    """Grid axis order with the gravity (last spatial) axis leading: settled
    fluid occupies a contiguous prefix of cell ids."""
    g = dim - 1
    return (g,) + tuple(a for a in range(dim) if a != g)


def _default_cap(dim: int, h: float, dx: float) -> int:
    """Per-cell gather capacity: rest occupancy (h/dx)^dim with ~2x
    headroom, rounded up to a multiple of 8."""
    rest = (h / dx) ** dim
    cap = int(math.ceil(2.0 * rest))
    return max(8, (cap + 7) // 8 * 8)


def block_scene(
    *,
    name: str,
    dim: int,
    domain,
    fluid_lo,
    fluid_hi,
    dx: float,
    h_over_dx: float = 2.0,
    sound_speed: float = 40.0,
    viscosity: float = 0.05,
    xsph_eps: float = 0.0,
    surface_tension: float = 0.0,
    cfl: float = 0.25,
    capacity: int | None = None,
    cap: int | None = None,
    bcap: int | None = None,
    skin_frac: float = 0.25,
    wall_layers: int = 0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    **param_overrides,
) -> Scene:
    """Generic block-of-fluid scene in an AABB domain.

    ``wall_layers`` > 0 adds that many shells of frozen ghost particles
    outside every face except the top."""
    lo, hi = domain
    h = h_over_dx * dx
    rest_density = float(param_overrides.pop("rest_density", 1000.0))
    mass = lattice_mass(dim, h, dx, rest_density)
    dt = cfl * h / sound_speed
    params = make_params(
        dim=dim,
        h=h,
        dt=dt,
        rest_density=rest_density,
        sound_speed=sound_speed,
        viscosity=viscosity,
        xsph_eps=xsph_eps,
        surface_tension=surface_tension,
        bound_min=list(lo),
        bound_max=list(hi),
        dtype=dtype,
        device=device,
        **param_overrides,
    )
    cap = cap if cap is not None else _default_cap(dim, h, dx)
    gspec = grid_from_bounds(lo, hi, cell_size=h, cap=cap)
    cell = h * (1.0 + skin_frac)
    rest_occ = (cell / dx) ** dim
    # Headroom over rest occupancy: dam-break impact compresses cells well
    # past rest, most in 2D wall corners.
    headroom = 4.5 if dim == 2 else 2.0
    if bcap is None:
        bcap = max(8, (int(math.ceil(headroom * rest_occ)) + 7) // 8 * 8)
    else:
        # Explicit override: 8-granular rounding only; overflow is counted
        # at runtime (BinnedState.overflow).
        bcap = max(8, (int(bcap) + 7) // 8 * 8)
    pos = lattice_block(fluid_lo, fluid_hi, dx)
    st = state_lib.from_positions(
        pos, capacity=capacity, mass=mass, dtype=dtype, device=device
    )
    boundary = None
    n_boundary = 0
    if wall_layers > 0:
        bpos = wall_lattice(lo, hi, dx, wall_layers)
        boundary = (
            torch.as_tensor(bpos, dtype=dtype, device=device),
            torch.full((len(bpos),), mass, dtype=dtype, device=device),
        )
        n_boundary = len(bpos)
    # ghosts sit outside the AABB: the margin must cover them
    margin = max(2, int(math.ceil(wall_layers * dx / (h * (1 + skin_frac)))) + 1)
    bgrid = nb.binned_grid_from_bounds(
        lo,
        hi,
        h=h,
        cap=bcap,
        skin_frac=skin_frac,
        max_particles=st.capacity + n_boundary,
        axis_order=_gravity_first_order(dim),
        margin_cells=margin,
    )
    bgrid = dataclasses.replace(bgrid, n_boundary=n_boundary)
    return Scene(
        name=name, params=params, gspec=gspec, bgrid=bgrid, state=st,
        boundary=boundary,
    )


def dam_break_2d(
    n_target: int = 4096,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    **overrides,
) -> Scene:
    """2D dam break, ~n_target particles: a 0.4 x 0.6 fluid column in a unit
    box; dx solved from the target count."""
    area = 0.4 * 0.6
    dx = math.sqrt(area / n_target)
    return block_scene(
        name="dam_break_2d",
        dim=2,
        domain=([0.0, 0.0], [1.0, 1.0]),
        fluid_lo=[0.0, 0.0],
        fluid_hi=[0.4, 0.6],
        dx=dx,
        dtype=dtype,
        device=device,
        **overrides,
    )


def emitter_2d(
    n_target: int = 4096,
    emit_speed: float = 1.5,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    **overrides,
) -> Scene:
    """2D faucet fill: an emitter stream from a nozzle at the top of a unit
    box onto a circular obstacle, XSPH viscosity, boundary penalty walls.
    All ``n_target`` rows start inactive; the stream activates them."""
    fill_area = 0.3  # m^2 the stream will eventually fill
    dx = math.sqrt(fill_area / n_target)
    h = 2.0 * dx
    overrides.setdefault("xsph_eps", 0.1)
    overrides.setdefault("viscosity", 0.05)
    rest_density = float(overrides.pop("rest_density", 1000.0))
    mass = lattice_mass(2, h, dx, rest_density)
    sound_speed = float(overrides.pop("sound_speed", 40.0))
    dt = 0.25 * h / sound_speed
    params = make_params(
        dim=2,
        h=h,
        dt=dt,
        rest_density=rest_density,
        sound_speed=sound_speed,
        bound_min=[0.0, 0.0],
        bound_max=[1.0, 1.0],
        dtype=dtype,
        device=device,
        **overrides,
    )
    skin_frac = 0.25
    bcap = max(8, (int(math.ceil(3.0 * ((h * (1 + skin_frac)) / dx) ** 2)) + 7) // 8 * 8)
    gspec = grid_from_bounds([0, 0], [1, 1], cell_size=h, cap=_default_cap(2, h, dx))
    st = state_lib.allocate(n_target, 2, dtype, device)
    bgrid = nb.binned_grid_from_bounds(
        [0, 0],
        [1, 1],
        h=h,
        cap=bcap,
        skin_frac=skin_frac,
        max_particles=n_target,
        axis_order=_gravity_first_order(2),
        margin_cells=2,
    )
    emitter = em_lib.plan_stream(
        start_index=0,
        capacity=n_target,
        dim=2,
        nozzle_lo=[0.45, 0.92],
        nozzle_hi=[0.55, 0.92 + 0.5 * dx],
        direction=[0.0, -1.0],
        speed=emit_speed,
        dx=dx,
        mass=mass,
        dt=float(dt),
        dtype=dtype,
        device=device,
    )
    obstacles = obs_lib.make(2, spheres=[([0.5, 0.5], 0.12)], dtype=dtype, device=device)
    return Scene(
        name="emitter_2d",
        params=params,
        gspec=gspec,
        bgrid=bgrid,
        state=st,
        obstacles=obstacles,
        emitter=emitter,
    )


def dam_break_3d(
    n_target: int = 100_000,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    **overrides,
) -> Scene:
    """3D dam break with surface tension and XSPH: a 0.3 x 0.4 x 0.6 column
    at one end of a 1 x 0.4 x 0.75 tank.

    Defaults to skin 0.40 with cap 40 (the reference's flagship geometry);
    an explicit ``skin_frac`` owns its cap."""
    vol = 0.3 * 0.4 * 0.6
    dx = (vol / n_target) ** (1.0 / 3.0)
    overrides.setdefault("surface_tension", 0.25)
    overrides.setdefault("xsph_eps", 0.05)
    if "skin_frac" not in overrides:
        overrides["skin_frac"] = 0.40
        overrides.setdefault("bcap", 40)
    return block_scene(
        name="dam_break_3d",
        dim=3,
        domain=([0.0, 0.0, 0.0], [1.0, 0.4, 0.75]),
        fluid_lo=[0.0, 0.0, 0.0],
        fluid_hi=[0.3, 0.4, 0.6],
        dx=dx,
        dtype=dtype,
        device=device,
        **overrides,
    )
