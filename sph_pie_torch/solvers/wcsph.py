"""Wall and speed-limit helpers shared with the reference WCSPH engine.

Only ``boundary_accel`` and ``clamp_speed`` are ported so far; the
gather-based engine of the reference's ``solvers/wcsph.py`` is not.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.params import FluidParams


def boundary_accel(
    params: FluidParams, pos: torch.Tensor, vel: torch.Tensor
) -> torch.Tensor:
    """Penalty spring-damper against the domain AABB walls.

    The damping ramps in linearly over the first 0.1h of penetration, so
    the force field stays continuous in state."""
    pen_lo = torch.clamp(params.bound_min - pos, min=0.0)
    pen_hi = torch.clamp(pos - params.bound_max, min=0.0)
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
