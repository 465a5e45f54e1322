"""Scene run loop: epochs of steps with emission at epoch boundaries.

Each epoch emits the particles that are due, bins the flat state, rolls
``epoch_steps`` steps of WCSPH (or PBF) and unbins. The loop is an eager
Python loop over epochs; the state stays on its device throughout.
Emission semantics: a particle whose spawn step falls inside an epoch
activates at that epoch's start.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.state import ParticleState
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.scenes import emitter as em_lib
from sph_pie_torch.solvers import pbf as pbf_lib
from sph_pie_torch.solvers import wcsph_binned


@torch.no_grad()
def run_epochs(
    params,
    grid: nb.BinnedGrid,
    state: ParticleState,
    emitter: em_lib.EmitterSchedule | None,
    obstacles,
    epoch_steps: int,
    n_epochs: int,
    start_step: int = 0,
    boundary=None,
    pbf_params=None,
) -> tuple[ParticleState, torch.Tensor]:
    """Run n_epochs * epoch_steps steps with emission between epochs.

    Returns (state, overflow): overflow is the largest per-epoch count of
    particles dropped by full cells (a 0-d int32 tensor). A dropped
    particle is inactive after the epoch's unbin, so the emitter re-emits
    it at its spawn position at the next epoch.

    ``pbf_params`` selects the PBF solver for the epochs instead of WCSPH.
    The unbin/bin round trip carries density (``nb.bin_state``), so PBF's
    previous-step Monaghan weight survives; ``sim_time`` is re-seeded from
    the running step count so moving obstacles keep their phase."""
    capacity = state.capacity
    overflow = torch.zeros((), dtype=torch.int32, device=state.pos.device)
    for e in range(int(n_epochs)):
        step0 = int(start_step) + e * int(epoch_steps)
        if emitter is not None:
            state = em_lib.emit_due(state, emitter, step0)
        # step0 in the state's dtype times dt, as the reference's clock
        b = nb.bin_state(grid, state, boundary, sim_time=float(step0) * params.dt)
        if pbf_params is not None:
            b = pbf_lib.simulate(params, grid, pbf_params, b, epoch_steps, obstacles)
        else:
            b = wcsph_binned.simulate(params, grid, b, epoch_steps, obstacles)
        state = nb.unbin(grid, b, capacity)
        overflow = torch.maximum(overflow, b.overflow)
    return state, overflow


def run_scene(scene, n_steps: int, epoch_steps: int = 50, pbf_params=None):
    """Run a Scene (emitter, obstacles and boundary included) for at least
    ``n_steps``: whole epochs, ceil(n_steps / epoch_steps) of them."""
    n_epochs = -(-n_steps // epoch_steps)
    return run_epochs(
        scene.params,
        scene.bgrid,
        scene.state,
        scene.emitter,
        scene.obstacles,
        epoch_steps,
        n_epochs,
        boundary=scene.boundary,
        pbf_params=pbf_params,
    )
