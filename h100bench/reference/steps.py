"""The judge's default reference: the workload's solver stepped from the
inputs, every row active throughout.

WCSPH (``wcsph.step``) or PBF (``pbf.step`` with the workload's knobs),
``check.steps`` steps. Where the workload has ``obstacles``, step k adds
their acceleration (``obstacles.accel``) at t = k dt; where it has none,
no term is added.
"""

from __future__ import annotations

import torch

from h100bench.reference import obstacles, pbf, sph, wcsph


def run(cfg: dict, work: dict, inp, dtype: torch.dtype) -> dict:
    """pos, vel, rho and mass of each input row after ``check.steps``
    steps, and the time, K dt, in ``dtype``."""
    p = sph.physics(cfg)
    pos, vel = inp.pos.to(dtype), inp.vel.to(dtype)
    mass = torch.full((pos.shape[0],), inp.mass, dtype=dtype, device=pos.device)
    rho = torch.zeros_like(mass)
    solver = work["solver"]
    knobs = pbf.knobs(solver) if solver["name"] == "pbf" else None
    obs = work.get("obstacles")
    for k in range(work["check"]["steps"]):
        extra = None
        if obs is not None:
            def extra(x, v, t=k * p.dt):
                return obstacles.accel(obs, x, v, t)
        if knobs is None:
            pos, vel, rho, _ = wcsph.step(p, pos, vel, mass, extra)
        else:
            pos, vel, rho = pbf.step(p, knobs, pos, vel, mass, rho, extra)
    time = torch.tensor(work["check"]["steps"] * p.dt, dtype=dtype, device=pos.device)
    return {"pos": pos, "vel": vel, "rho": rho, "mass": mass, "time": time}
