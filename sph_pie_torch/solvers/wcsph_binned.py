"""WCSPH on the binned dense layout — the main path of the port.

Same physics, constants and update order as the reference's
``solvers/wcsph_binned.py``:

  1. ``maybe_rebin`` (lazy Verlet-skin trigger), then on a periodic grid
     ``wrap_ghosts`` (the ghost cells take the opposite edge's images);
  2. density (``neighbors/density.py``), then the Tait EOS;
  3. forces (``neighbors/forces.py``);
  4. gravity, the wall penalty and the obstacle penalty
     (``scenes/obstacles.accel``) added, then symplectic Euler on the slots
     that move, the CFL clamp, XSPH and the per-step displacement bound
     ``travel`` (``solvers/integrate.update``: on the card one kernel, the
     obstacle term included), and the clock.

Each phase is a span of the profile while one records
(``utils.profiling.annotate``): ``sph.rebin_check`` (1), ``sph.density``
(2), ``sph.forces`` (3), ``sph.integrate`` (4).

On CUDA tensors the pair sums, the update and the rebin placement run the
hand-written kernels; on CPU tensors their plain PyTorch versions.
"""

from __future__ import annotations

import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import eos
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.density import density
from sph_pie_torch.neighbors.forces import forces
from sph_pie_torch.solvers import integrate
from sph_pie_torch.utils.profiling import annotate
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
    passed the threshold. ``maybe_rebin.checks`` counts the first reads,
    ``maybe_rebin.drift_reads`` the second; the rebins fired are counted
    by the state's ``n_rebins``.
    """
    thr = 0.5 * grid.skin
    maybe_rebin.checks += 1
    if not bool(b.travel > thr):
        return b
    d = torch.sqrt(((b.pos - b.bin_pos) ** 2).sum(dim=-1).amax())
    maybe_rebin.drift_reads += 1
    if bool(d > thr):
        return nb.rebin(grid, b, light=light, carry_density=carry_density)
    return replace(b, travel=d)


maybe_rebin.checks = 0
maybe_rebin.drift_reads = 0


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
    clock before it advances, inside the update (on the card on the slots
    that move only). Periodic axes have no wall: their ghost planes are
    refreshed after the rebin check, and the ghost slots move with the
    rest."""
    with annotate("sph.rebin_check"):
        b = maybe_rebin(grid, b)
        if any(grid.periodic):
            b = nb.wrap_ghosts(grid, b)

    with annotate("sph.density"):
        rho = density(params, grid, b)
        b = replace(b, density=rho, pressure=eos.tait_pressure(params, rho))

    with annotate("sph.forces"):
        acc, xsph = forces(params, grid, b)

    with annotate("sph.integrate"):
        pos, vel, travel = integrate.update(params, grid, b, wall_axes(grid), acc, xsph, obstacles)
        return replace(b, pos=pos, vel=vel, travel=travel, sim_time=b.sim_time + params.dt)


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
