"""The deployment's physical constants and the per-particle terms.

``Physics`` holds plain Python numbers worked out from the configuration
file (the program derives its own from the same file). The smoothing
kernels, in terms of the support radius h:

  poly6    W(r)    = C_p (h^2 - r^2)^3      C_p: 2D 4/(pi h^8),  3D 315/(64 pi h^9)
  spiky    |dW(r)| = C_s (h - r)^2          C_s: 2D -30/(pi h^5), 3D -45/(pi h^6)
  visc     lapW(r) = C_v (h - r)            C_v: 2D 40/(pi h^5),  3D 45/(pi h^6)
  cohesion C(r)    = K (h-r)^3 r^3 for h/2 < r < h, K (2 (h-r)^3 r^3 - h^6/64)
                     for 0 < r <= h/2, K = 32/(pi h^9) (3D) or 32/(pi h^8) (2D)
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Physics:
    dim: int
    h: float
    dt: float
    rest_density: float
    sound_speed: float
    viscosity: float
    xsph_eps: float
    surface_tension: float
    gamma: int
    gravity: tuple[float, ...]
    bound_min: tuple[float, ...]
    bound_max: tuple[float, ...]
    boundary_stiffness: float
    boundary_damping: float
    max_speed: float
    skin: float

    @property
    def c_poly6(self) -> float:
        h = self.h
        return 4.0 / (math.pi * h**8) if self.dim == 2 else 315.0 / (64.0 * math.pi * h**9)

    @property
    def c_spiky(self) -> float:
        h = self.h
        return -30.0 / (math.pi * h**5) if self.dim == 2 else -45.0 / (math.pi * h**6)

    @property
    def c_visc(self) -> float:
        h = self.h
        return 40.0 / (math.pi * h**5) if self.dim == 2 else 45.0 / (math.pi * h**6)

    @property
    def c_cohesion(self) -> float:
        return 32.0 / (math.pi * self.h ** (9 if self.dim == 3 else 8))


def physics(cfg: dict) -> Physics:
    """The constants of configuration ``cfg`` (a ``configs/*.json``)."""
    dim = cfg["dim"]
    dx = spacing(cfg)
    h = cfg["h_over_dx"] * dx
    c = cfg["sound_speed"]
    return Physics(
        dim=dim, h=h, dt=cfg["cfl"] * h / c, rest_density=cfg["rest_density"], sound_speed=c,
        viscosity=cfg["viscosity"], xsph_eps=cfg["xsph_eps"],
        surface_tension=cfg["surface_tension"], gamma=cfg["eos_gamma"],
        gravity=tuple([0.0] * (dim - 1) + [cfg["gravity"]]),
        bound_min=tuple(cfg["domain"][0]), bound_max=tuple(cfg["domain"][1]),
        boundary_stiffness=cfg["boundary_stiffness"], boundary_damping=cfg["boundary_damping"],
        max_speed=c, skin=cfg["skin_frac"] * h,
    )


def spacing(cfg: dict) -> float:
    """Lattice spacing: the fluid block's volume over the target count."""
    lo, hi = cfg["fluid"]
    return (math.prod(b - a for a, b in zip(lo, hi)) / cfg["n_target"]) ** (1.0 / cfg["dim"])


def poly6(p: Physics, r2: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(p.h * p.h - r2, min=0.0)
    return p.c_poly6 * q * q * q


def spiky(p: Physics, r: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(p.h - r, min=0.0)
    return p.c_spiky * q * q


def visc_lap(p: Physics, r: torch.Tensor) -> torch.Tensor:
    return p.c_visc * torch.clamp(p.h - r, min=0.0)


def cohesion(p: Physics, r: torch.Tensor) -> torch.Tensor:
    h = p.h
    hr3 = torch.clamp(h - r, min=0.0) ** 3
    r3 = r**3
    c = torch.where(r <= 0.5 * h, 2.0 * hr3 * r3 - h**6 / 64.0, hr3 * r3)
    return torch.where((r > 0.0) & (r < h), p.c_cohesion * c, 0.0)


def tait(p: Physics, rho: torch.Tensor) -> torch.Tensor:
    """p = B ((rho/rho0)^gamma - 1), B = rho0 c^2 / gamma, clamped at 0."""
    b = p.rest_density * p.sound_speed**2 / p.gamma
    return torch.clamp(b * ((rho / p.rest_density) ** p.gamma - 1.0), min=0.0)


def vector(p: Physics, values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def walls(p: Physics, pos: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """Penalty spring against the box, with a damping that ramps in over
    the first 0.1 h of penetration."""
    pen_lo = torch.clamp(vector(p, p.bound_min, pos) - pos, min=0.0)
    pen_hi = torch.clamp(pos - vector(p, p.bound_max, pos), min=0.0)
    pen = (pen_lo + pen_hi).amax(dim=-1, keepdim=True)
    ramp = torch.clamp(pen / (0.1 * p.h), max=1.0)
    return p.boundary_stiffness * (pen_lo - pen_hi) - p.boundary_damping * ramp * vel


def clamp_speed(p: Physics, vel: torch.Tensor) -> torch.Tensor:
    """Rescale a velocity above the speed limit onto it."""
    s2 = (vel * vel).sum(dim=-1, keepdim=True)
    cap = p.max_speed
    return vel * torch.where(s2 > cap * cap, cap * torch.rsqrt(s2), 1.0)
