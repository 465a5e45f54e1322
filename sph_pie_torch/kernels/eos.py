"""Equations of state for weakly-compressible SPH."""

from __future__ import annotations

import torch

from sph_pie_torch.core.params import FluidParams


def tait_pressure(params: FluidParams, density: torch.Tensor) -> torch.Tensor:
    """Tait EOS: p = B ((rho/rho0)^gamma - 1), clamped at 0 (the
    free-surface / no-tension condition the CPU oracle also applies)."""
    ratio = density / params.rest_density
    p = params.eos_stiffness * (ratio**params.eos_gamma - 1.0)
    return torch.clamp(p, min=0.0)
