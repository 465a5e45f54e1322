"""Physical / numerical parameters for the SPH solvers.

``FluidParams`` is a frozen dataclass: the four structural flags are plain
Python values, every physical constant is a 0-d (``gravity`` and the
bounds: [dim]) tensor on the simulation's device, so the hot path never
reads a constant back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

# The tensor fields, in declaration order (convert.py walks them).
ARRAY_FIELDS = (
    "h",
    "dt",
    "rest_density",
    "sound_speed",
    "viscosity",
    "xsph_eps",
    "surface_tension",
    "gravity",
    "bound_min",
    "bound_max",
    "boundary_stiffness",
    "boundary_damping",
    "max_speed",
)


@dataclasses.dataclass(frozen=True)
class FluidParams:
    """Parameters of a weakly-compressible SPH fluid (SI-ish units)."""

    dim: int                    # 2 or 3
    eos_gamma: int              # Tait exponent (7 classic, 1 = linear)
    use_xsph: bool              # False drops the XSPH term
    use_cohesion: bool          # False drops cohesion

    h: torch.Tensor                # smoothing/support radius
    dt: torch.Tensor               # timestep
    rest_density: torch.Tensor     # rho_0
    sound_speed: torch.Tensor      # c_0 for the Tait EOS stiffness
    viscosity: torch.Tensor        # Mueller-03 dynamic viscosity mu
    xsph_eps: torch.Tensor         # XSPH velocity-smoothing strength
    surface_tension: torch.Tensor  # cohesion coefficient
    gravity: torch.Tensor          # [dim] body acceleration
    bound_min: torch.Tensor        # [dim] domain AABB lower corner
    bound_max: torch.Tensor        # [dim] domain AABB upper corner
    boundary_stiffness: torch.Tensor  # wall penalty spring constant
    boundary_damping: torch.Tensor    # wall normal-velocity damping (1/s)
    max_speed: torch.Tensor           # CFL speed clamp (Verlet-skin bound)

    @property
    def eos_stiffness(self) -> torch.Tensor:
        """Tait B = rho_0 c_0^2 / gamma."""
        return self.rest_density * self.sound_speed**2 / self.eos_gamma


def make_params(
    *,
    dim: int,
    h: float,
    dt: float,
    rest_density: float = 1000.0,
    sound_speed: float = 30.0,
    viscosity: float = 0.1,
    xsph_eps: float = 0.0,
    surface_tension: float = 0.0,
    gravity=None,
    bound_min=None,
    bound_max=None,
    boundary_stiffness: float = 1.0e5,
    boundary_damping: float = 20.0,
    max_speed: float | None = None,
    eos_gamma: int = 7,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> FluidParams:
    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    if max_speed is None:
        max_speed = sound_speed  # WCSPH assumes Mach << 1; c0 is a safe cap
    if gravity is None:
        gravity = [0.0] * (dim - 1) + [-9.81]
    if bound_min is None:
        bound_min = [0.0] * dim
    if bound_max is None:
        bound_max = [1.0] * dim
    return FluidParams(
        dim=dim,
        eos_gamma=int(eos_gamma),
        use_xsph=bool(xsph_eps),
        use_cohesion=bool(surface_tension),
        h=f(h),
        dt=f(dt),
        rest_density=f(rest_density),
        sound_speed=f(sound_speed),
        viscosity=f(viscosity),
        xsph_eps=f(xsph_eps),
        surface_tension=f(surface_tension),
        gravity=f(gravity),
        bound_min=f(bound_min),
        bound_max=f(bound_max),
        boundary_stiffness=f(boundary_stiffness),
        boundary_damping=f(boundary_damping),
        max_speed=f(max_speed),
    )
