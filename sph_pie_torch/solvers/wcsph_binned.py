"""WCSPH on the binned dense layout — the main path of the port.

Same physics, constants and update order as the reference's
``solvers/wcsph_binned.py``:

  1. ``maybe_rebin`` (lazy Verlet-skin trigger), then on a periodic grid
     ``wrap_ghosts`` (the ghost cells take the opposite edge's images);
  2. density (``neighbors/density.py``), then the Tait EOS;
  3. forces (``neighbors/forces.py``) plus gravity, the wall penalty and
     the obstacle penalty (``scenes/obstacles.accel``);
  4. symplectic Euler on the slots that move, the CFL clamp, XSPH;
  5. the per-step displacement bound ``travel`` and the clock.

On CUDA tensors the pair sums and the rebin placement run the hand-written
kernels; on CPU tensors their plain PyTorch versions.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import eos
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.density import density
from sph_pie_torch.neighbors.forces import forces
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_torch.utils.struct import replace


def maybe_rebin(
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    light: bool = False,
    carry_density: bool = False,
) -> nb.BinnedState:
    """Two-stage lazy rebin trigger.

    ``travel`` (sum of per-step max displacement bounds) is cheap but
    conservative. When it passes skin/2, measure the true max displacement
    against the bin-time anchor ``bin_pos``: rebin only if a particle
    really drifted past skin/2, otherwise tighten ``travel`` to the
    measured drift. The cell-list guarantee needs drift <= skin/2 when the
    pair sums run, right after this check. PBF moves particles between its
    folds, so it calls this before every fold; ``light`` and
    ``carry_density`` go to ``nb.rebin``.

    Each branch is a decision on the host, so it reads one device scalar:
    one device-to-host sync per step, two on a step where ``travel`` has
    passed the threshold.
    """
    thr = 0.5 * grid.skin
    if not bool(b.travel > thr):
        return b
    d = torch.sqrt(((b.pos - b.bin_pos) ** 2).sum(dim=-1).amax())
    if bool(d > thr):
        return nb.rebin(grid, b, light=light, carry_density=carry_density)
    return replace(b, travel=d)


def wall_axes(grid: nb.BinnedGrid) -> tuple[bool, ...] | None:
    """Per SPATIAL axis: True where the domain has walls (not periodic);
    None on a grid without periodic axes."""
    if not any(grid.periodic):
        return None
    order = grid.axis_order or tuple(range(grid.dim))
    return tuple(not grid.periodic[order.index(sa)] for sa in range(grid.dim))


@torch.no_grad()
def step(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    obstacles=None,
) -> nb.BinnedState:
    """One WCSPH step in binned space, with conditional amortised rebin.

    ``obstacles`` (``scenes.obstacles.Obstacles``) add their penalty at the
    clock before it advances, over every slot; the move mask drops empty
    slots. Periodic axes have no wall: their ghost planes are refreshed
    after the rebin check, and the ghost slots move with the rest."""
    b = maybe_rebin(grid, b)
    if any(grid.periodic):
        b = nb.wrap_ghosts(grid, b)

    rho = density(params, grid, b)
    b = replace(b, density=rho, pressure=eos.tait_pressure(params, rho))

    acc, xsph = forces(params, grid, b)
    acc = acc + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel, wall_axes(grid))
    if obstacles is not None:
        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)

    move = (b.valid & ~nb.frozen_mask(grid, b))[:, None]
    vel = torch.where(move, b.vel + params.dt * acc, 0.0)
    vel = clamp_speed(params, vel)
    vel_adv = torch.where(move, vel + params.xsph_eps * xsph, 0.0)
    pos = torch.where(move, b.pos + params.dt * vel_adv, b.pos)

    # Hard per-step displacement bound for the Verlet-skin guarantee.
    step_disp = params.dt * torch.sqrt(
        torch.clamp((vel_adv * vel_adv).sum(dim=-1).amax(), min=0.0)
    )
    return replace(
        b,
        pos=pos,
        vel=vel,
        travel=b.travel + step_disp,
        sim_time=b.sim_time + params.dt,
    )


def simulate(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    n_steps: int,
    obstacles=None,
) -> nb.BinnedState:
    """Roll ``n_steps`` steps."""
    for _ in range(int(n_steps)):
        b = step(params, grid, b, obstacles)
    return b
