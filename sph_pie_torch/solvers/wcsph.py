"""Weakly-compressible SPH on the naive gather engine, and the wall and
speed-limit helpers every engine shares.

The gather engine (``neighbors/grid.py``) folds over [N, cap] candidate
windows per adjacent cell: density, then pressure, viscosity, cohesion and
the XSPH sum in one fold, then symplectic Euler. Same physics, constants
and update order as the reference's ``solvers/wcsph.py``; it reaches no
Pallas kernel there, so it is plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.kernels import eos, smoothing
from sph_pie_torch.neighbors import grid as nbr
from sph_pie_torch.neighbors.binned import axis_vector
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.utils.struct import replace


def compute_density(
    params: FluidParams, gspec: nbr.GridSpec, cl: nbr.CellList, state: ParticleState
) -> torch.Tensor:
    """SPH density summation rho_i = sum_j m_j W_poly6(|x_ij|), floored at
    1e-6 rest_density."""
    pos, mass = state.pos, state.mass
    h2 = params.h * params.h

    def pair(rho, j, valid):
        d = pos[:, None, :] - pos[j]                       # [N, cap, dim]
        r2 = (d * d).sum(-1)                               # [N, cap]
        w = smoothing.poly6(params.dim, params.h, r2)      # includes self term
        contrib = torch.where(valid & (r2 < h2), mass[j] * w, 0.0)
        return rho + contrib.sum(-1)

    rho = nbr.neighbor_fold(gspec, cl, pair, torch.zeros_like(mass))
    return torch.maximum(rho, 1e-6 * params.rest_density)


def _pair_accel(params: FluidParams, state: ParticleState):
    """(pair_fn, init) for pressure + viscosity + cohesion acceleration and
    the XSPH velocity-correction sum in one neighbor fold."""
    pos, vel = state.pos, state.vel
    mass, rho, prs = state.mass, state.density, state.pressure
    dim, h = params.dim, params.h
    h2 = h * h
    tiny = 1e-12

    def pair(carry, j, valid):
        acc, xsph = carry
        d = pos[:, None, :] - pos[j]                       # x_ij [N, cap, dim]
        r2 = (d * d).sum(-1)
        live = valid & (r2 < h2) & (r2 > tiny)             # exclude self
        r = torch.sqrt(torch.clamp(r2, min=tiny))
        rhat = d / r[..., None]
        m_j = torch.where(live, mass[j], 0.0)
        rho_j = rho[j]
        inv_rho_j = 1.0 / rho_j

        # Symmetric pressure gradient:
        #   a_i = -sum_j m_j (p_i/rho_i^2 + p_j/rho_j^2) grad_i W_spiky
        gw = smoothing.spiky_grad_mag(dim, h, r)
        p_term = prs[:, None] / (rho[:, None] ** 2) + prs[j] * inv_rho_j**2
        acc = acc - ((m_j * p_term * gw)[..., None] * rhat).sum(1)

        # Mueller viscosity: a_i += (mu/rho_i) sum_j m_j (v_j - v_i)/rho_j lapW
        dv = vel[j] - vel[:, None, :]
        lap = smoothing.visc_lap(dim, h, r)
        visc_w = m_j * inv_rho_j * lap
        acc = acc + (params.viscosity / rho[:, None]) * (visc_w[..., None] * dv).sum(1)

        # Akinci-style cohesion, attractive along -rhat.
        coh = smoothing.cohesion(dim, h, r)
        acc = acc - params.surface_tension * ((m_j * coh)[..., None] * rhat).sum(1)

        # XSPH sum (pre-step velocities, m_j/rho_j weighting).
        w = smoothing.poly6(dim, h, r2)
        xw = torch.where(live, mass[j] * inv_rho_j * w, 0.0)
        xsph = xsph + (xw[..., None] * dv).sum(1)
        return acc, xsph

    zero = torch.zeros_like(pos)
    return pair, (zero, zero)


def boundary_accel(
    params: FluidParams,
    pos: torch.Tensor,
    vel: torch.Tensor,
    wall_axes: tuple[bool, ...] | None = None,
) -> torch.Tensor:
    """Penalty spring-damper against the domain AABB walls.

    The damping ramps in linearly over the first 0.1h of penetration, so
    the force field stays continuous in state. ``wall_axes``: optional
    per-SPATIAL-axis mask; False disables the wall on that axis (periodic
    axes have no walls)."""
    pen_lo = torch.clamp(params.bound_min - pos, min=0.0)
    pen_hi = torch.clamp(pos - params.bound_max, min=0.0)
    if wall_axes is not None and not all(wall_axes):
        m = axis_vector(wall_axes, pos.dtype, pos.device)[None, :]
        pen_lo = pen_lo * m
        pen_hi = pen_hi * m
    pen = (pen_lo + pen_hi).amax(dim=-1, keepdim=True)
    ramp = torch.clamp(pen / (0.1 * params.h), max=1.0)
    acc = params.boundary_stiffness * (pen_lo - pen_hi)
    return acc - params.boundary_damping * ramp * vel


def clamp_speed(params: FluidParams, vel: torch.Tensor) -> torch.Tensor:
    """CFL guard: rescale any velocity above ``max_speed`` onto the cap.

    It is what makes the binned engine's Verlet-skin rebin bound
    (displacement <= max_speed * dt per step) a hard guarantee."""
    speed2 = (vel * vel).sum(dim=-1, keepdim=True)
    cap2 = params.max_speed * params.max_speed
    scale = torch.where(
        speed2 > cap2, params.max_speed * torch.rsqrt(speed2), 1.0
    )
    return vel * scale


@torch.no_grad()
def step(
    params: FluidParams,
    gspec: nbr.GridSpec,
    state: ParticleState,
    obstacles=None,
    t=0.0,
) -> ParticleState:
    """One WCSPH step: build cells -> density -> EOS -> forces -> integrate.

    ``obstacles`` add their penalty at time ``t``."""
    cl = nbr.build(gspec, state.pos, state.active)

    rho = compute_density(params, gspec, cl, state)
    state = replace(state, density=rho, pressure=eos.tait_pressure(params, rho))

    pair, init = _pair_accel(params, state)
    acc, xsph = nbr.neighbor_fold(gspec, cl, pair, init)

    acc = acc + params.gravity
    acc = acc + boundary_accel(params, state.pos, state.vel)
    if obstacles is not None:
        acc = acc + obs_lib.accel(obstacles, state.pos, state.vel, t)

    active = state.active[:, None]
    vel = torch.where(active, state.vel + params.dt * acc, state.vel)
    vel = clamp_speed(params, vel)
    vel_adv = vel + params.xsph_eps * xsph
    pos = torch.where(active, state.pos + params.dt * vel_adv, state.pos)
    return replace(state, pos=pos, vel=vel)


def simulate(params, gspec, state, n_steps: int, obstacles=None) -> ParticleState:
    """Roll ``n_steps`` steps; step i runs at t = i dt."""
    for i in range(int(n_steps)):
        state = step(params, gspec, state, obstacles, t=i * params.dt)
    return state


def simulate_trajectory(params, gspec, state, n_steps: int, record_every: int = 1):
    """Roll the sim, recording positions every ``record_every`` steps.

    Returns (final_state, traj) with traj [n_steps // record_every, N, dim]."""
    frames = []
    for _ in range(n_steps // record_every):
        for _ in range(record_every):
            state = step(params, gspec, state)
        frames.append(state.pos)
    if not frames:
        return state, state.pos.new_zeros((0,) + tuple(state.pos.shape))
    return state, torch.stack(frames)
