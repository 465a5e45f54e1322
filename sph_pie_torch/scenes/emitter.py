"""Emitters: pre-scheduled particle spawning with static shapes.

The scene is allocated at its final particle count and every future
particle has a precomputed (spawn_step, pos, vel, mass). Until its step
arrives a particle is simply inactive (never binned). Activation happens at
epoch boundaries of the run loop (``solvers/run.py``) on the flat state.
``plan_stream`` plans on the host in numpy float64, as the reference does,
and makes the tensors at the end on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.utils.struct import replace


@dataclasses.dataclass(frozen=True)
class EmitterSchedule:
    """Per-particle spawn plan. spawn_step < 0 means "never" (slot unused
    by the emitter; e.g. particles active from t=0)."""

    spawn_step: torch.Tensor  # [K] int32
    spawn_pos: torch.Tensor   # [K, dim]
    spawn_vel: torch.Tensor   # [K, dim]
    spawn_mass: torch.Tensor  # [K]


def no_emitter(
    capacity: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> EmitterSchedule:
    return EmitterSchedule(
        spawn_step=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        spawn_pos=torch.zeros((capacity, dim), dtype=dtype, device=device),
        spawn_vel=torch.zeros((capacity, dim), dtype=dtype, device=device),
        spawn_mass=torch.zeros((capacity,), dtype=dtype, device=device),
    )


def emit_due(state: ParticleState, em: EmitterSchedule, step_count: int) -> ParticleState:
    """Activate every not-yet-active particle whose spawn step has arrived."""
    due = (em.spawn_step >= 0) & (em.spawn_step <= step_count) & ~state.active
    d2 = due[:, None]
    return replace(
        state,
        pos=torch.where(d2, em.spawn_pos, state.pos),
        vel=torch.where(d2, em.spawn_vel, state.vel),
        mass=torch.where(due, em.spawn_mass, state.mass),
        active=state.active | due,
    )


def merge_schedules(schedules: list[EmitterSchedule]) -> EmitterSchedule:
    """Combine emitters occupying DISJOINT slot ranges into one schedule
    (unused slots have spawn_step == -1, so an elementwise latest-wins
    select is exact for disjoint plans)."""
    out = schedules[0]
    for s in schedules[1:]:
        use = s.spawn_step >= 0
        out = EmitterSchedule(
            spawn_step=torch.where(use, s.spawn_step, out.spawn_step),
            spawn_pos=torch.where(use[:, None], s.spawn_pos, out.spawn_pos),
            spawn_vel=torch.where(use[:, None], s.spawn_vel, out.spawn_vel),
            spawn_mass=torch.where(use, s.spawn_mass, out.spawn_mass),
        )
    return out


def plan_stream(
    *,
    start_index: int,
    capacity: int,
    dim: int,
    nozzle_lo,
    nozzle_hi,
    direction,
    speed: float,
    dx: float,
    mass: float,
    dt: float,
    t_start: float = 0.0,
    t_end: float = np.inf,
    n_slots: int | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> EmitterSchedule:
    """Continuous stream: rows of particles across the nozzle cross-section,
    one row every dx/speed seconds, moving along ``direction`` at ``speed``.

    Fills schedule slots [start_index, capacity); the stream stops when slots
    run out or t_end is reached. ``dt`` is a Python float: the row interval
    is rounded from it on the host.
    """
    nozzle_lo = np.asarray(nozzle_lo, float)
    nozzle_hi = np.asarray(nozzle_hi, float)
    direction = np.asarray(direction, float)
    direction = direction / np.linalg.norm(direction)
    dt = float(dt)

    # Cross-section lattice across the nozzle (the nozzle AABB is thin along
    # the flow direction; its full extent is latticed).
    axes = [
        np.arange(lo + 0.5 * dx, hi, dx) if hi - lo > dx else np.array([(lo + hi) / 2])
        for lo, hi in zip(nozzle_lo, nozzle_hi)
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    row = np.stack([m.reshape(-1) for m in mesh], axis=-1)  # [R, dim]
    per_row = row.shape[0]
    row_interval = max(1, int(round(dx / speed / dt)))

    budget = capacity - start_index
    n_slots = budget if n_slots is None else min(int(n_slots), budget)
    n_rows = n_slots // per_row
    steps = []
    pos = []
    first_step = int(round(t_start / dt))
    last_step = int(t_end / dt) if np.isfinite(t_end) else None
    for r in range(n_rows):
        s = first_step + r * row_interval
        if last_step is not None and s > last_step:
            break
        steps.append(np.full(per_row, s, np.int32))
        pos.append(row)
    if not steps:
        return no_emitter(capacity, dim, dtype, device)
    steps = np.concatenate(steps)
    pos = np.concatenate(pos)
    n = len(steps)

    spawn_step = np.full(capacity, -1, np.int32)
    spawn_pos = np.zeros((capacity, dim))
    spawn_vel = np.zeros((capacity, dim))
    spawn_mass = np.zeros(capacity)
    end = start_index + n
    spawn_step[start_index:end] = steps
    spawn_pos[start_index:end] = pos
    spawn_vel[start_index:end] = direction * speed
    spawn_mass[start_index:end] = mass
    return EmitterSchedule(
        spawn_step=torch.as_tensor(spawn_step, device=device),
        spawn_pos=torch.as_tensor(spawn_pos, dtype=dtype, device=device),
        spawn_vel=torch.as_tensor(spawn_vel, dtype=dtype, device=device),
        spawn_mass=torch.as_tensor(spawn_mass, dtype=dtype, device=device),
    )
