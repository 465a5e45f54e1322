"""One PBF step (Macklin & Mueller 2013), plainly.

  predict   v* = clamp(v + dt (g + walls [+ extra])),  x* = x + dt v*
            (``extra``: an acceleration of (pos, vel), the obstacles')
  iters x   over the pairs in support of x*, with |dW| = spiky, gw = |dW|/r:
              rho_i    = sum_j m_j W
              lambda_i = -(rho_i/rho0 - 1) / ((sum_j |m_j gw d|^2
                          + |sum_j m_j gw d|^2) / rho0^2 + relax_eps)
              dx_i     = sor / rho0 sum_j m_j (lambda_i + lambda_j + s_corr) gw d,
                         s_corr = -k h^2 (W / W(dq h))^n
              x*_i    <- clip_box(x*_i + dx_i min(1, cap / |dx_i|)),
                         cap = min(proj_cap_h h, skin / 2)
  velocity  v = clamp((x* - x) / dt)
  epilogue  over the pairs in support of x*, w_j = m_j / rho_prev_j (rho0
            where there is no previous density):
              rho_i = max(sum_j m_j W, 1e-6 rho0)
              v_i  <- clamp(v_i + xsph_eps sum_j w_j W (v_j - v_i))

The state handed on is (x*, v, rho); rho is the next step's rho_prev.
"""

from __future__ import annotations

import dataclasses

import torch

from h100bench.reference import neighbors, sph


@dataclasses.dataclass(frozen=True)
class Knobs:
    iters: int
    sor: float
    proj_cap_h: float
    relax_eps: float
    s_corr_k: float
    s_corr_n: int
    s_corr_dq: float


def knobs(solver: dict) -> Knobs:
    """The PBF knobs of a workload's ``solver`` entry."""
    return Knobs(**{f.name: solver[f.name] for f in dataclasses.fields(Knobs)})


def step(p: sph.Physics, k: Knobs, pos, vel, mass, rho_prev, extra=None):
    """(pos, vel, rho) after one step."""
    n = pos.shape[0]
    rho0 = p.rest_density
    body = sph.vector(p, p.gravity, pos) + sph.walls(p, pos, vel)
    if extra is not None:
        body = body + extra(pos, vel)
    v = sph.clamp_speed(p, vel + p.dt * body)
    x = pos + p.dt * v
    cap = min(k.proj_cap_h * p.h, 0.5 * p.skin)
    inv_wdq = 1.0 / (p.c_poly6 * (p.h * p.h - (k.s_corr_dq * p.h) ** 2) ** 3)
    lo, hi = sph.vector(p, p.bound_min, pos), sph.vector(p, p.bound_max, pos)
    for _ in range(k.iters):
        i, j = neighbors.pairs(x, p.h)
        d = x[i] - x[j]
        r2 = (d * d).sum(1)
        inv_r = torch.rsqrt(torch.clamp(r2, min=1e-12))
        w = sph.poly6(p, r2)
        gw = sph.spiky(p, r2 * inv_r) * inv_r
        g = (mass[j] * gw)[:, None] * d
        rho = neighbors.fold(n, i, mass[j] * w)
        denom = (neighbors.fold(n, i, (g * g).sum(1))
                 + (neighbors.fold(n, i, g) ** 2).sum(1)) / (rho0 * rho0)
        lam = -(rho / rho0 - 1.0) / (denom + k.relax_eps)
        s_corr = -(k.s_corr_k * p.h * p.h) * (w * inv_wdq) ** k.s_corr_n
        coef = mass[j] * (lam[i] + lam[j] + s_corr) * gw
        dx = k.sor / rho0 * neighbors.fold(n, i, coef[:, None] * d)
        norm = torch.sqrt(torch.clamp((dx * dx).sum(1, keepdim=True), min=1e-30))
        x = torch.minimum(torch.maximum(x + dx * torch.clamp(cap / norm, max=1.0), lo), hi)

    v = sph.clamp_speed(p, (x - pos) / p.dt)
    i, j = neighbors.pairs(x, p.h)
    d = x[i] - x[j]
    w = sph.poly6(p, (d * d).sum(1))
    rho = torch.clamp(neighbors.fold(n, i, mass[j] * w), min=1e-6 * rho0)
    if p.xsph_eps:
        wj = mass / torch.where(rho_prev > 0, rho_prev, rho0)
        dv = neighbors.fold(n, i, (wj[j] * w)[:, None] * (v[j] - v[i]))
        v = sph.clamp_speed(p, v + p.xsph_eps * dv)
    return x, v, rho
