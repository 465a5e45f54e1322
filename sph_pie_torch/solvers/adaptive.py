"""Adaptive timestep: a CFL controller around the binned WCSPH step.

Standard WCSPH stability limits (Monaghan):

    dt_acoustic = C_cfl * h / (c0 + v_max)
    dt_force    = C_f   * sqrt(h / a_max)
    dt_viscous  = C_v   * h^2 / nu          (nu = mu / rho0)

The controller takes the minimum each step, clamped to [dt_min, dt_base]
— never above the scene's configured dt (which already satisfies the
acoustic limit at v=0), shrinking through impacts and recovering
afterwards. ``params.dt`` is replaced per step by a 0-d tensor on the
device, so the Verlet-skin ``travel`` bookkeeping (which multiplies by dt)
stays exact.

Opt-in: fixed-dt ``wcsph_binned.simulate`` remains the default; emission
schedules are step-indexed and assume fixed dt, so adaptive runs are for
non-emitter scenes.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.solvers import wcsph_binned
from sph_pie_torch.utils.struct import replace


def cfl_dt(
    params: FluidParams,
    v_max: torch.Tensor,
    a_max: torch.Tensor,
    c_cfl: float = 0.25,
    c_force: float = 0.25,
    c_visc: float = 0.125,
) -> torch.Tensor:
    """The three-limit CFL timestep (before clamping)."""
    h = params.h
    dt_ac = c_cfl * h / (params.sound_speed + v_max)
    dt_f = c_force * torch.sqrt(h / torch.clamp(a_max, min=1e-12))
    nu = params.viscosity / params.rest_density
    dt_v = torch.where(
        params.viscosity > 0, c_visc * h * h / torch.clamp(nu, min=1e-12), torch.inf
    )
    return torch.minimum(torch.minimum(dt_ac, dt_f), dt_v)


def _max_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1).amax())


@torch.no_grad()
def simulate_adaptive(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    t_end,
    obstacles=None,
    max_steps: int = 100_000,
    dt_min_frac: float = 0.05,
):
    """Advance to physical time ``t_end`` with per-step CFL dt.

    Returns (state, t_reached, n_steps, dt_last): ``t_reached`` and
    ``dt_last`` are 0-d tensors, ``n_steps`` an int. dt is bounded to
    [dt_min_frac * dt_base, dt_base] and cut to the time left; the loop
    also stops at ``max_steps``. Whether to take another step is a decision
    on the host, so it reads one device scalar: one device-to-host sync per
    step, beside the step's own.
    """
    dt_base = params.dt
    dt_min = dt_min_frac * dt_base
    t_end = torch.as_tensor(t_end, dtype=b.pos.dtype, device=b.pos.device)
    t = torch.zeros((), dtype=b.pos.dtype, device=b.pos.device)
    # a_max from the last step's velocity change: one step stale; the dt
    # clamp plus the safety factors absorb that.
    last_amax = torch.zeros((), dtype=b.pos.dtype, device=b.pos.device)
    dt, k = dt_base, 0
    while k < max_steps and bool(t < t_end):
        dt = cfl_dt(params, _max_norm(b.vel), last_amax)
        dt = torch.clamp(dt, dt_min, dt_base)
        dt = torch.minimum(dt, torch.maximum(t_end - t, dt_min))
        prev_vel = b.vel
        b = wcsph_binned.step(replace(params, dt=dt), grid, b, obstacles)
        last_amax = _max_norm(b.vel - prev_vel) / torch.clamp(dt, min=1e-12)
        t, k = t + dt, k + 1
    return b, t, k, dt
