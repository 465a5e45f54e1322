"""WCSPH on the binned dense layout — the main path of the port.

Same physics, constants and update order as the reference's
``solvers/wcsph_binned.py``:

  1. ``maybe_rebin`` (lazy Verlet-skin trigger);
  2. density (``neighbors/density.py``), then the Tait EOS;
  3. forces (``neighbors/forces.py``) plus gravity plus the wall penalty;
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
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_torch.utils.struct import replace


def maybe_rebin(grid: nb.BinnedGrid, b: nb.BinnedState) -> nb.BinnedState:
    """Two-stage lazy rebin trigger.

    ``travel`` (sum of per-step max displacement bounds) is cheap but
    conservative. When it passes skin/2, measure the true max displacement
    against the bin-time anchor ``bin_pos``: rebin only if a particle
    really drifted past skin/2, otherwise tighten ``travel`` to the
    measured drift. The cell-list guarantee needs drift <= skin/2 when the
    pair sums run, right after this check.

    Each branch is a decision on the host, so it reads one device scalar:
    one device-to-host sync per step, two on a step where ``travel`` has
    passed the threshold.
    """
    thr = 0.5 * grid.skin
    if not bool(b.travel > thr):
        return b
    d = torch.sqrt(((b.pos - b.bin_pos) ** 2).sum(dim=-1).amax())
    if bool(d > thr):
        return nb.rebin(grid, b)
    return replace(b, travel=d)


@torch.no_grad()
def step(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    obstacles=None,
) -> nb.BinnedState:
    """One WCSPH step in binned space, with conditional amortised rebin."""
    if obstacles is not None:
        raise NotImplementedError("obstacles are not ported yet")
    if any(grid.periodic):
        raise NotImplementedError("periodic axes are not ported yet")
    b = maybe_rebin(grid, b)

    rho = density(params, grid, b)
    b = replace(b, density=rho, pressure=eos.tait_pressure(params, rho))

    acc, xsph = forces(params, grid, b)
    acc = acc + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel)

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
