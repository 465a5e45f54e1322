"""One WCSPH step, plainly.

With d = x_i - x_j, r = |d|, over the pairs in support:

  rho_i  = max(sum_j m_j W(r^2), 1e-6 rho0)           (self pair included)
  p_i    = Tait(rho_i)
  acc_i  = - sum_j [m_j (p_i/rho_i^2 + p_j/rho_j^2) |dW|(r) + st m_j C(r)] d / r
           + mu / rho_i sum_j (m_j / rho_j) lapW(r) (v_j - v_i)
           + g + walls(x_i, v_i) [+ extra(x_i, v_i)]
  xsph_i = sum_j (m_j / rho_j) W(r^2) (v_j - v_i)      (when xsph_eps > 0)
  v_i'   = clamp(v_i + dt acc_i);  x_i' = x_i + dt (v_i' + xsph_eps xsph_i)

The step's state is what the program's step hands on: x', v' (without the
XSPH term), and the rho and p of the step. ``extra`` is an acceleration
of (pos, vel) added last, as the program adds its obstacles' penalty.
"""

from __future__ import annotations

import torch

from h100bench.reference import neighbors, sph


def step(p: sph.Physics, pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
         extra=None):
    """(pos, vel, rho, pressure) after one step from (pos, vel)."""
    n = pos.shape[0]
    i, j = neighbors.pairs(pos, p.h)
    d = pos[i] - pos[j]
    r2 = (d * d).sum(1)
    w = sph.poly6(p, r2)
    rho = torch.clamp(neighbors.fold(n, i, mass[j] * w), min=1e-6 * p.rest_density)
    prs = sph.tait(p, rho)

    inv_rho = 1.0 / rho
    pr2 = prs * inv_rho * inv_rho
    m_rho = mass * inv_rho
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-12))
    r = r2 * inv_r
    radial = mass[j] * (pr2[i] + pr2[j]) * sph.spiky(p, r)
    if p.surface_tension:
        radial = radial + p.surface_tension * mass[j] * sph.cohesion(p, r)
    dv = vel[j] - vel[i]
    acc = -neighbors.fold(n, i, (radial * inv_r)[:, None] * d)
    acc = acc + p.viscosity * inv_rho[:, None] * neighbors.fold(
        n, i, (m_rho[j] * sph.visc_lap(p, r))[:, None] * dv)
    acc = acc + sph.vector(p, p.gravity, pos) + sph.walls(p, pos, vel)
    if extra is not None:
        acc = acc + extra(pos, vel)

    vel = sph.clamp_speed(p, vel + p.dt * acc)
    adv = vel
    if p.xsph_eps:
        adv = vel + p.xsph_eps * neighbors.fold(n, i, (m_rho[j] * w)[:, None] * dv)
    return pos + p.dt * adv, vel, rho, prs
