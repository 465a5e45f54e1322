"""Solid obstacles in the flow, plainly: a penalty acceleration.

Spheres (circles in 2D) and axis-aligned boxes, each moving rigidly as

  center(t) = c0 + lin t + amp sin(2 pi f t + phase),
  v_ob(t)   = lin + amp 2 pi f cos(2 pi f t + phase)

(a box's lo and hi share the offset). For each shape a particle is inside
of, with its penetration depth pen and outward normal n:

  a = stiffness pen n - damping min(pen / ramp_dist, 1) (v - v_ob)

summed over the shapes. A sphere: pen = max(r - |x - c|, 0), n = (x -
c) / |x - c| (|x - c| floored at 1e-6). A box: inside where lo < x < hi on
every axis, pen the distance to the nearest face, n that face's outward
normal (the first such axis on a tie, the low face where both are as
near). The shapes and constants are the workload's ``obstacles`` entry:

  {"spheres": [{"center", "radius", "lin", "amp", "freq", "phase"}],
   "boxes": [{"lo", "hi", "lin", "amp", "freq", "phase"}],
   "stiffness", "damping", "ramp_dist"}

with ``lin``, ``amp``, ``freq`` and ``phase`` 0 where left out.
"""

from __future__ import annotations

import math

import torch


def _motion(shape: dict, dim: int, t: float) -> tuple[list[float], list[float]]:
    """(offset, velocity) of a shape at time ``t``, as Python numbers."""
    lin = shape.get("lin", [0.0] * dim)
    amp = shape.get("amp", [0.0] * dim)
    w = 2.0 * math.pi * shape.get("freq", 0.0)
    ang = w * t + shape.get("phase", 0.0)
    off = [lin[a] * t + amp[a] * math.sin(ang) for a in range(dim)]
    vel = [lin[a] + amp[a] * w * math.cos(ang) for a in range(dim)]
    return off, vel


def accel(obs: dict, pos: torch.Tensor, vel: torch.Tensor, t: float) -> torch.Tensor:
    """The obstacles' acceleration [N, dim] on particles at ``pos`` moving at
    ``vel``, at time ``t``, in the positions' dtype."""
    dim = pos.shape[1]
    k, c, ramp_dist = obs["stiffness"], obs["damping"], obs["ramp_dist"]

    def vec(v):
        return torch.tensor(v, dtype=pos.dtype, device=pos.device)

    def term(pen, normal, v_ob):
        ramp = torch.clamp(pen / ramp_dist, max=1.0)[:, None]
        return k * pen[:, None] * normal - c * ramp * (vel - vec(v_ob))

    acc = torch.zeros_like(pos)
    for s in obs.get("spheres", []):
        off, v_ob = _motion(s, dim, t)
        d = pos - vec([c0 + o for c0, o in zip(s["center"], off)])
        dist = torch.sqrt(torch.clamp((d * d).sum(1), min=1e-12))
        pen = torch.clamp(s["radius"] - dist, min=0.0)
        acc = acc + term(pen, d / dist[:, None], v_ob)
    for bx in obs.get("boxes", []):
        off, v_ob = _motion(bx, dim, t)
        lo = vec([a + o for a, o in zip(bx["lo"], off)])
        hi = vec([a + o for a, o in zip(bx["hi"], off)])
        d_lo, d_hi = pos - lo, hi - pos
        inside = ((d_lo > 0) & (d_hi > 0)).all(1)
        near = torch.minimum(d_lo, d_hi)
        axis = torch.argmin(near, dim=1)
        rows = torch.arange(pos.shape[0], device=pos.device)
        low = d_lo[rows, axis] <= d_hi[rows, axis]
        normal = torch.zeros_like(pos)
        normal[rows, axis] = torch.where(low, -1.0, 1.0).to(pos.dtype)
        pen = torch.where(inside, near[rows, axis], 0.0)
        acc = acc + term(pen, normal, v_ob)
    return acc
