"""The faucet's reference: rows join the flow when the stream's schedule
says, and only the rows that have joined are stepped.

At each epoch start k (k = 0, E, 2 E, ..; E is the workload's
``epoch_steps``) every row not yet active whose spawn step s (the
inputs' ``spawn_step``; -1: never) is at most k becomes active, with its
spawn velocity v, at its spawn position plus v (k - s) dt: where it would
be had it left the nozzle at s and kept its speed; unless a row already
active lies nearer to that place than the configuration's
``emit_clearance`` h, and then it stays inactive until a later epoch
start. Each step k = 0 .. K - 1 is then WCSPH (``wcsph.step``) over the
active rows alone, with the acceleration of the configuration's
obstacles (``obstacles.accel``) at t = k dt; the rows not yet active take
part in nothing.

Departures from the stream as ``emitter_2d`` plans it, as
``solvers/run.run_epochs`` emits: a row joins at the first epoch start at
or after its spawn step, not at the spawn step itself, up to E - 1 steps
late, and downstream by the distance it would have travelled at its
spawn velocity, without gravity or its neighbours' push (with 53 steps
between rows and E = 50, one row joins at most boundaries and none at
some); a row held back by the clearance joins later still. A row that a
full cell would drop has no counterpart here (the program's overflow,
which fails a run).
"""

from __future__ import annotations

import torch

from h100bench.reference import obstacles, sph, wcsph


def run(cfg: dict, work: dict, inp, dtype: torch.dtype) -> dict:
    """pos, vel, rho and mass of each row after ``check.steps`` steps, which
    rows are active, and the time, K dt, in ``dtype``."""
    p = sph.physics(cfg)
    obs = cfg["obstacles"]
    epoch, n_steps = work["epoch_steps"], work["check"]["steps"]
    spawn = inp.spawn_step
    spawn_pos, spawn_vel = inp.pos.to(dtype), inp.vel.to(dtype)
    pos, vel = torch.zeros_like(spawn_pos), torch.zeros_like(spawn_vel)
    mass = torch.full((pos.shape[0],), inp.mass, dtype=dtype, device=pos.device)
    rho = torch.zeros_like(mass)
    active = torch.zeros_like(spawn, dtype=torch.bool)
    for k in range(n_steps):
        if k % epoch == 0:
            due = ((spawn >= 0) & (spawn <= k) & ~active).nonzero()[:, 0]
            place = spawn_pos[due] + spawn_vel[due] * ((k - spawn[due]).to(dtype) * p.dt)[:, None]
            gap = (place[:, None, :] - pos[None, :, :]).norm(dim=-1)
            free = ~((gap < cfg["emit_clearance"] * p.h) & active).any(1)
            join = due[free]
            pos[join], vel[join], active[join] = place[free], spawn_vel[join], True
            # The active rows change only here: step them apart until the
            # epoch ends.
            rows = active.nonzero()[:, 0]
            x, v, m, r = pos[rows], vel[rows], mass[rows], rho[rows]
        if rows.numel():

            def extra(x, v, t=k * p.dt):
                return obstacles.accel(obs, x, v, t)

            x, v, r, _ = wcsph.step(p, x, v, m, extra)
        if (k + 1) % epoch == 0 or k + 1 == n_steps:
            pos[rows], vel[rows], rho[rows] = x, v, r
    time = torch.tensor(n_steps * p.dt, dtype=dtype, device=pos.device)
    return {"pos": pos, "vel": vel, "rho": rho, "mass": mass, "active": active, "time": time}
