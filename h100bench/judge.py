"""The comparison that decides ``correct``.

The timed path's state after the workload's ``check.steps`` steps of the
window's first segment (every segment starts from the same inputs) is
held, row by row in input order, against the plain reference
(``reference/``) run in float64 from the same inputs for as many steps.
The reference is the module under ``reference/`` that the workload's
``check.reference`` names, ``steps`` (the solver's steps, the workload's
obstacles in them) where it names none. The numbers compared, each
against its limit in the workload file:

  lost       rows that exist in one state and not in the other: a row
             active in the reference with no slot in the program (a drop
             by a full cell), or the other way round; limit 0
  pos_gap    max |x - x_ref| / h
  vel_gap    max |v - v_ref| / max |v_ref|
  rho_gap    max |rho - rho_ref| / rho0 (the density of the last step)
  time_gap   |t - t_ref| / dt, the state's clock against the reference's
             (the time its obstacles move by), where the reference gives one
  frame_gap  the share of the last step's frame's pixels, in %, that are off
             the reference's by more than one count (one count is the
             uint8 quantisation), where the workload draws a frame; the
             reference draws it from the cells the program's slots put each
             particle in (the placement itself is held by the numbers above:
             a particle in a wrong cell has wrong neighbours)

The gaps are taken over the rows that exist in both.

``control`` is the reference put in the program's place in bfloat16, the
precision below the configuration's float32: its numbers must fail.
"""

from __future__ import annotations

import importlib

import torch

from h100bench.reference import frame, geometry, sph


def module(work: dict):
    """The reference module the workload's ``check.reference`` names,
    ``reference/steps.py`` where it names none. The harness loads it in
    its set-up, before the window."""
    name = work["check"].get("reference", "steps")
    return importlib.import_module(f"h100bench.reference.{name}")


def reference(cfg: dict, work: dict, inp, dtype: torch.dtype) -> dict:
    """The reference's state after ``check.steps`` steps, computed in
    ``dtype``: pos, vel, rho and mass of each input row, ``active`` where
    not every row exists and ``time`` where the scene keeps a clock
    (``run`` of ``module(work)``)."""
    return module(work).run(cfg, work, inp, dtype)


def draw(cfg: dict, work: dict, cell: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """The workload's frame of particles of ``mass`` in cells ``cell``."""
    f = work["frame"]
    return frame.render(geometry.grid(cfg), cell, mass, f["resolution"], f["axis"], f["gain"])


def numbers(cfg: dict, work: dict, inp, got: dict) -> dict[str, float]:
    """The compared numbers of the state ``got`` (per particle: pos, vel,
    rho, cell, alive; ``frame`` where the workload draws one)."""
    return compare(cfg, work, reference(cfg, work, inp, torch.float64), got)


def compare(cfg: dict, work: dict, ref: dict, got: dict) -> dict[str, float]:
    """The compared numbers of ``got`` against the reference's state
    ``ref``."""
    p = sph.physics(cfg)
    alive = got["alive"]
    n = alive.shape[0]
    active = ref.get("active")
    if active is None:
        active = torch.ones_like(alive)
    both = alive & active
    lost = float(int((alive != active).sum()))
    if not bool(both.any()):
        return {"lost": float(n)}

    def gap(name):
        d = got[name].to(torch.float64) - ref[name]
        return float(d.reshape(n, -1).norm(dim=1)[both].max())

    out = {
        "lost": lost,
        "pos_gap": gap("pos") / p.h,
        "vel_gap": gap("vel") / max(float(ref["vel"][active].norm(dim=1).max()), 1e-30),
        "rho_gap": gap("rho") / p.rest_density,
    }
    if "time" in ref:
        out["time_gap"] = abs(float(got["time"]) - float(ref["time"])) / p.dt
    if work.get("frame"):
        want = draw(cfg, work, got["cell"], ref["mass"])
        off = (got["frame"].to(torch.int64) - want.to(torch.int64)).abs() > 1
        out["frame_gap"] = 100.0 * float(off.to(torch.float64).mean())
    return out


def control(cfg: dict, work: dict, inp) -> dict:
    """The control's state: the reference in bfloat16 in the program's
    place, the rows it holds active alive, its particles in the cells of
    their own positions, its frame drawn in bfloat16 from them."""
    out = reference(cfg, work, inp, torch.bfloat16)
    out["alive"] = out.get("active", torch.ones(out["pos"].shape[0], dtype=torch.bool,
                                                device=out["pos"].device))
    out["cell"] = geometry.cell_of(cfg, geometry.grid(cfg), out["pos"])
    if work.get("frame"):
        out["frame"] = draw(cfg, work, out["cell"], out["mass"])
    return out


def verdict(limits: dict, nums: dict) -> bool:
    """Correct when every number is at or under its limit (a missing or
    non-finite number fails)."""
    return all(k in nums and nums[k] == nums[k] and nums[k] <= v for k, v in limits.items())
