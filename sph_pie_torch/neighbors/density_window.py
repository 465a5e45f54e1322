"""One-sided poly6 density, the two drop-in density kernels of the reference.

    rho_i = sum_j m_j W_poly6(|x_i - x_j|)   (self pair included)

over the 3^(dim-1) slab windows of slot i's cell, then floored at
1e-6 rest_density. Counterparts of the JAX package's

  * ``neighbors/pallas_pair.py:292`` ``density_pallas`` → ``density_cap32``:
    cap 32 only (``_plan``), h = ``cell_size - skin`` (``_grid_h``), and
    ``where(valid, rho, 0)`` before the floor;
  * ``neighbors/pallas_density.py:91`` ``density_pallas`` →
    ``density_window``: any cap, h = ``params.h``, and NO valid mask: an
    empty slot keeps the density its windows give its stored position (0
    where the placement left it), then is floored.

Mind the support radius: ``density_cap32`` takes h from the grid geometry
while ``density`` (the main path) and ``density_window`` take ``params.h``;
the two agree only up to rounding. Both compute in float32, as the TPU
kernels do, and raise on any other dtype.

For CUDA tensors each wrapper launches the main path's density kernel over
runs of cells (``csrc/density.cu``, ``neighbors/runs.py``), ``density_cap32``
with its valid mask on, ``density_window`` with the mask off: every occupied
slot, and the empty slots of a cell through one shared home record per
stored position. That arm of ``density_window`` takes what the runs can
stage (``runs.stageable``: a cap that is a multiple of 4 up to 384, pos and
mass starting on 16-byte boundaries); the kernel's launcher gives any other
layout to the one-thread-per-slot arm. For CPU tensors a wrapper runs its
``*_plain`` twin (the blocked slab fold); any other device raises.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors import runs


def _check(name: str, grid: nb.BinnedGrid, b: nb.BinnedState, cap32: bool) -> None:
    if b.pos.dtype != torch.float32 or b.mass.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32 pos and mass, got {b.pos.dtype}, {b.mass.dtype}")
    if cap32 and grid.cap != 32:
        raise ValueError(f"{name}: requires cap == 32, got {grid.cap}")
    if b.pos.shape != (grid.num_slots, grid.dim):
        raise ValueError(f"{name}: pos must be [{grid.num_slots}, {grid.dim}]")


def _cap32_consts(params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState) -> torch.Tensor:
    """[h^2, poly6 coeff, floor] with h from the grid, as ``_grid_h``: the
    constants are computed in double and rounded once to float32."""
    h = float(grid.cell_size - grid.skin)
    c = b.pos.new_tensor([h * h, smoothing.poly6_coeff(grid.dim, h)])
    return torch.cat([c, (1e-6 * params.rest_density).reshape(1).to(c)])


def _window_consts(params: FluidParams, b: nb.BinnedState) -> torch.Tensor:
    """[h^2, poly6 coeff, floor] with h = params.h, in float32 arithmetic."""
    h = params.h.to(b.pos.dtype)
    return torch.stack(
        [h * h, smoothing.poly6_coeff(params.dim, h), (1e-6 * params.rest_density).to(h)]
    )


def _fold(grid: nb.BinnedGrid, b: nb.BinnedState, prm: torch.Tensor, every_slot: bool):
    """[S] sum_j m_j (c6 q) q q, q = max(h^2 - r^2, 0), by the slab fold."""
    h2, c6 = prm[0], prm[1]

    def pair(carry, home, w):
        _, r2 = nb._r2(grid.dim, home, w)                 # [blk, r, 3cap]
        q = torch.clamp(h2 - r2, min=0.0)
        return (carry[0] + (w["mass"][:, None, :] * (c6 * q * q * q)).sum(2),)

    fields = {**nb._planar("p", b.pos), "mass": b.mass}
    (rho,) = nb.slab_fold(grid, fields, pair, (torch.zeros_like(b.mass),), every_slot)
    return rho


def density_cap32_plain(
    params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState
) -> torch.Tensor:
    """[S] density, h from the grid, 0 where not valid, then floored."""
    _check("density_cap32", grid, b, cap32=True)
    prm = _cap32_consts(params, grid, b)
    rho = torch.where(b.valid, _fold(grid, b, prm, every_slot=False), 0.0)
    return torch.maximum(rho, prm[2])


def density_window_plain(
    params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState
) -> torch.Tensor:
    """[S] density, h = params.h, every slot (no valid mask), floored."""
    _check("density_window", grid, b, cap32=False)
    prm = _window_consts(params, b)
    return torch.maximum(_fold(grid, b, prm, every_slot=True), prm[2])


def _check_cuda(name: str, b: nb.BinnedState, prm: torch.Tensor) -> None:
    _native.check_cuda(
        name, b.pos.dtype, b.pos.device, pos=(b.pos, None), mass=(b.mass, None),
        valid=(b.valid, torch.bool), prm=(prm, None),
    )


def density_cap32(
    params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState
) -> torch.Tensor:
    """``density_cap32_plain`` on the CPU; ``density.cu``, masked, on the card."""
    if not _native.on_card("density_cap32", b.pos):
        return density_cap32_plain(params, grid, b)
    _check("density_cap32", grid, b, cap32=True)
    prm = _cap32_consts(params, grid, b)
    _check_cuda("density_cap32", b, prm)
    runs.check_staging("density_cap32", grid.cap, pos=b.pos, mass=b.mass)
    rho = torch.empty_like(b.mass)
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "density", b.pos.dtype, b.pos, b.mass, b.valid, prm, rho, grid.num_slots,
        grid.cap, grid.dim, s0, s1, 0, grid.num_cells,
    )
    density_cap32.launches += 1
    return rho


def density_window(
    params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState
) -> torch.Tensor:
    """``density_window_plain`` on the CPU; ``density.cu``, unmasked, on the
    card: over runs of cells where ``runs.stageable``, else a thread per slot."""
    if not _native.on_card("density_window", b.pos):
        return density_window_plain(params, grid, b)
    _check("density_window", grid, b, cap32=False)
    prm = _window_consts(params, b)
    _check_cuda("density_window", b, prm)
    rho = torch.empty_like(b.mass)
    # scratch of the runs arm: which cells hold mass
    flags = torch.empty(grid.num_cells, dtype=torch.int32, device=b.pos.device)
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "density_window", b.pos.dtype, b.pos, b.mass, prm, flags, rho, grid.num_slots,
        grid.cap, grid.dim, s0, s1,
    )
    density_window.launches += 1
    return rho


density_cap32.launches = 0
density_window.launches = 0
