"""The comparison that decides ``correct``.

The timed path's state after the workload's ``check.steps`` steps of the
window's first segment (every segment starts from the same inputs) is
held, particle by particle in input order, against the plain reference
(``reference/``) run in float64 from the same inputs for as many steps.
The numbers compared, each against its limit in the workload file:

  lost       particles that have no slot (a drop by a full cell); limit 0
  pos_gap    max |x - x_ref| / h
  vel_gap    max |v - v_ref| / max |v_ref|
  rho_gap    max |rho - rho_ref| / rho0 (the density of the last step)
  frame_gap  the share of the last step's frame's pixels, in %, that are off
             the reference's by more than one count (one count is the
             uint8 quantisation), where the workload draws a frame; the
             reference draws it from the cells the program's slots put each
             particle in (the placement itself is held by the numbers above:
             a particle in a wrong cell has wrong neighbours)

``control`` is the reference put in the program's place in bfloat16, the
precision below the configuration's float32: its numbers must fail.
"""

from __future__ import annotations

import torch

from h100bench.reference import frame, geometry, pbf, sph, wcsph


def reference(cfg: dict, work: dict, inp, dtype: torch.dtype) -> dict:
    """The reference's pos, vel and rho after ``check.steps`` steps, and
    its masses, computed in ``dtype``."""
    p = sph.physics(cfg)
    pos, vel = inp.pos.to(dtype), inp.vel.to(dtype)
    mass = torch.full((pos.shape[0],), inp.mass, dtype=dtype, device=pos.device)
    rho = torch.zeros_like(mass)
    solver = work["solver"]
    knobs = pbf.knobs(solver) if solver["name"] == "pbf" else None
    for _ in range(work["check"]["steps"]):
        if knobs is None:
            pos, vel, rho, _ = wcsph.step(p, pos, vel, mass)
        else:
            pos, vel, rho = pbf.step(p, knobs, pos, vel, mass, rho)
    return {"pos": pos, "vel": vel, "rho": rho, "mass": mass}


def draw(cfg: dict, work: dict, cell: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """The workload's frame of particles of ``mass`` in cells ``cell``."""
    f = work["frame"]
    return frame.render(geometry.grid(cfg), cell, mass, f["resolution"], f["axis"], f["gain"])


def numbers(cfg: dict, work: dict, inp, got: dict) -> dict[str, float]:
    """The compared numbers of the state ``got`` (per particle: pos, vel,
    rho, cell, alive; ``frame`` where the workload draws one)."""
    p = sph.physics(cfg)
    ref = reference(cfg, work, inp, torch.float64)
    alive = got["alive"]
    n = alive.shape[0]
    if not bool(alive.any()):
        return {"lost": float(n)}

    def gap(name):
        d = got[name].to(torch.float64) - ref[name]
        return float(d.reshape(n, -1).norm(dim=1)[alive].max())

    out = {
        "lost": float(n - int(alive.sum())),
        "pos_gap": gap("pos") / p.h,
        "vel_gap": gap("vel") / max(float(ref["vel"].norm(dim=1).max()), 1e-30),
        "rho_gap": gap("rho") / p.rest_density,
    }
    if work.get("frame"):
        want = draw(cfg, work, got["cell"], ref["mass"])
        off = (got["frame"].to(torch.int64) - want.to(torch.int64)).abs() > 1
        out["frame_gap"] = 100.0 * float(off.to(torch.float64).mean())
    return out


def control(cfg: dict, work: dict, inp) -> dict:
    """The control's state: the reference in bfloat16 in the program's
    place, its particles in the cells of their own positions, its frame
    drawn in bfloat16 from them."""
    out = reference(cfg, work, inp, torch.bfloat16)
    out["alive"] = torch.ones(out["pos"].shape[0], dtype=torch.bool, device=out["pos"].device)
    out["cell"] = geometry.cell_of(cfg, geometry.grid(cfg), out["pos"])
    if work.get("frame"):
        out["frame"] = draw(cfg, work, out["cell"], out["mass"])
    return out


def verdict(limits: dict, nums: dict) -> bool:
    """Correct when every number is at or under its limit (a missing or
    non-finite number fails)."""
    return all(k in nums and nums[k] == nums[k] and nums[k] <= v for k, v in limits.items())
