"""SPH smoothing kernels (Mueller et al. 2003 family), 2D and 3D.

All kernels take the support radius ``h`` (W(r) = 0 for r >= h), as a
Python float or a 0-d tensor, and are branch-free functions of ``r**2`` or
``r``. Normalisation constants (d = spatial dimension):

  poly6    W(r)  = C_p (h^2 - r^2)^3          C_p: 2D 4/(pi h^8),  3D 315/(64 pi h^9)
  spiky   dW(r)  = C_s (h - r)^2 rhat         C_s: 2D -30/(pi h^5), 3D -45/(pi h^6)
  visc  lap W(r) = C_v (h - r)                C_v: 2D 40/(pi h^5),  3D 45/(pi h^6)

The CUDA pair kernels (``csrc/``) evaluate the same formulas with the
coefficients these functions compute.
"""

from __future__ import annotations

import math

import torch


def poly6_coeff(dim: int, h):
    if dim == 2:
        return 4.0 / (math.pi * h**8)
    if dim == 3:
        return 315.0 / (64.0 * math.pi * h**9)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def spiky_grad_coeff(dim: int, h):
    if dim == 2:
        return -30.0 / (math.pi * h**5)
    if dim == 3:
        return -45.0 / (math.pi * h**6)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def visc_lap_coeff(dim: int, h):
    if dim == 2:
        return 40.0 / (math.pi * h**5)
    if dim == 3:
        return 45.0 / (math.pi * h**6)
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def cohesion_coeff(dim: int, h):
    """K of the cohesion spline: 32/(pi h^9) in 3D, 32/(pi h^8) in 2D."""
    return 32.0 / (math.pi * h ** (9 if dim == 3 else 8))


def poly6(dim: int, h, r2: torch.Tensor) -> torch.Tensor:
    """W_poly6(r) from squared distance. Zero outside support."""
    q = torch.clamp(h * h - r2, min=0.0)
    return poly6_coeff(dim, h) * q * q * q


def spiky_grad_mag(dim: int, h, r: torch.Tensor) -> torch.Tensor:
    """Signed magnitude C_s (h-r)^2 of the spiky gradient; times rhat."""
    q = torch.clamp(h - r, min=0.0)
    return spiky_grad_coeff(dim, h) * q * q


def visc_lap(dim: int, h, r: torch.Tensor) -> torch.Tensor:
    """Laplacian of the Mueller viscosity kernel: C_v (h - r), >= 0."""
    return visc_lap_coeff(dim, h) * torch.clamp(h - r, min=0.0)


def cohesion(dim: int, h, r: torch.Tensor) -> torch.Tensor:
    """Akinci-2013-style cohesion spline (normalised to 3D constants).

    C(r) = K * (h-r)^3 r^3                 for h/2 < r <= h
         = K * (2 (h-r)^3 r^3 - h^6/64)    for 0 < r <= h/2
    The ``r > 0`` guard zeroes the self pair's constant near-field term.
    """
    k = cohesion_coeff(dim, h)
    hr3 = torch.clamp(h - r, min=0.0) ** 3
    r3 = r**3
    near = 2.0 * hr3 * r3 - h**6 / 64.0
    far = hr3 * r3
    c = torch.where(r <= 0.5 * h, near, far)
    return torch.where((r > 0.0) & (r < h), k * c, 0.0)
