"""Emitters: pre-scheduled particle spawning with static shapes.

The scene is allocated at its final particle count and every future
particle has a precomputed (spawn_step, pos, vel, mass). Until its step
arrives a particle is simply inactive (never binned). Activation happens at
epoch boundaries of the run loop (``solvers/run.py``) on the flat state;
each is the span ``sph.emit`` of the profile while one records
(``utils.profiling.annotate``), and ``emit_due.calls`` counts them. The
run loop passes the step ``dt`` and a clearance: a particle that joins
after its spawn step starts where its spawn velocity would have carried it
by then, so that a stream's rows keep the spacing they were planned at
whatever the epoch; and a particle joins only where no active particle is
nearer than the clearance, else it waits for a later boundary.
``plan_stream`` plans on the host in numpy float64, as the reference does,
and makes the tensors at the end on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.utils.profiling import annotate
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


# The run loop's clearance, a share of the smoothing length h: the scene
# builders' streams put their rows h / 2 apart.
CLEARANCE = 0.4


def emit_due(
    state: ParticleState, em: EmitterSchedule, step_count: int, dt, clearance
) -> ParticleState:
    """Activate every not-yet-active particle whose spawn step has arrived,
    at ``spawn_pos + spawn_vel (step_count - spawn_step) dt`` (``dt`` and
    ``clearance`` floats or 0-d tensors), unless an active particle lies
    nearer than ``clearance`` to that place: then it stays inactive and is
    due again at the next call. A stream's row due every 53 steps but
    placed at its spawn position at 50-step epoch boundaries would join 6%
    closer to the row before than planned, and the stream would burst; a
    particle placed on another is shot off at tens of m/s, and spray at a
    nozzle would do that to row after row. dt = clearance = 0 is the plain
    rule: every due particle at its spawn position. Reads the number of
    due particles on the host."""
    emit_due.calls += 1
    with annotate("sph.emit"):
        due = (em.spawn_step >= 0) & (em.spawn_step <= step_count) & ~state.active
        late = (step_count - em.spawn_step).to(em.spawn_pos.dtype) * dt
        pos = em.spawn_pos + em.spawn_vel * late[:, None]
        due = clear(due, pos, state, clearance)
        d2 = due[:, None]
        return replace(
            state,
            pos=torch.where(d2, pos, state.pos),
            vel=torch.where(d2, em.spawn_vel, state.vel),
            mass=torch.where(due, em.spawn_mass, state.mass),
            active=state.active | due,
        )


def clear(due: torch.Tensor, pos: torch.Tensor, state: ParticleState, clearance) -> torch.Tensor:
    """``due`` less the particles whose place in ``pos`` has an active
    particle of ``state`` nearer than ``clearance``; the due places against
    every particle, at most 2**22 pairs at a time."""
    rows = due.nonzero()[:, 0]
    n = state.pos.shape[0]
    if rows.numel() == 0 or n == 0:
        return due
    c2 = torch.as_tensor(clearance, dtype=pos.dtype, device=pos.device) ** 2
    blocked = []
    for part in rows.split(max(1, 2**22 // n)):
        d = pos[part][:, None, :] - state.pos[None, :, :]
        blocked.append(((d * d).sum(-1) < c2).logical_and(state.active).any(1))
    return due.index_put((rows,), ~torch.cat(blocked))


emit_due.calls = 0


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
