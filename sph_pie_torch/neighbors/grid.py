"""Uniform-grid cell list of the naive (gather) engine.

  1. Hash every particle to a grid cell (cell edge == support radius h).
  2. Stable ``argsort`` of the particles by cell id: the candidate order,
     and so the summation order, is the reference's.
  3. Per-cell contiguous ranges by ``searchsorted`` (left and right).
  4. Neighbor candidates of particle i: for each of the 3^d adjacent cells,
     in the reference's offset order, the first ``cap`` particles of that
     cell's sorted range, so the temporaries stay [N, cap, ...].

Inactive particles sort to a sentinel cell id past every real cell and
never appear in a candidate range. ``solvers/wcsph.py`` runs its density
and forces over ``neighbor_fold``; it reaches no Pallas kernel in the
reference, so this is plain PyTorch on every device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, TypeVar

import torch

Carry = TypeVar("Carry")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of the uniform neighbor grid."""

    dims: tuple[int, ...]      # number of cells per axis
    origin: tuple[float, ...]  # world coordinate of cell (0,...,0) corner
    cell_size: float           # cell edge length (>= support radius h)
    cap: int                   # max particles gathered per cell

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def num_cells(self) -> int:
        return math.prod(self.dims)

    @property
    def strides(self) -> tuple[int, ...]:
        s = [1] * self.dim
        for a in range(self.dim - 2, -1, -1):
            s[a] = s[a + 1] * self.dims[a + 1]
        return tuple(s)


def grid_from_bounds(bound_min, bound_max, cell_size: float, cap: int) -> GridSpec:
    """GridSpec covering an AABB. Bounds must be concrete Python floats."""
    bmin = tuple(float(v) for v in bound_min)
    bmax = tuple(float(v) for v in bound_max)
    dims = tuple(
        max(1, int(math.ceil((hi - lo) / cell_size)))
        for lo, hi in zip(bmin, bmax)
    )
    return GridSpec(dims=dims, origin=bmin, cell_size=float(cell_size), cap=int(cap))


@dataclasses.dataclass(frozen=True)
class CellList:
    """Result of one counting-sort build over the particle set."""

    order: torch.Tensor   # [N] int32 particle indices sorted by cell id
    starts: torch.Tensor  # [C] int32 first index in ``order`` for each cell
    ends: torch.Tensor    # [C] int32 one-past-last index in ``order``
    coords: torch.Tensor  # [N, dim] int32 cell coordinates per particle


def cell_coords(grid: GridSpec, pos: torch.Tensor) -> torch.Tensor:
    """Integer cell coordinates, clipped into the grid."""
    dev = pos.device
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=dev)
    cell = torch.tensor(grid.cell_size, dtype=pos.dtype, device=dev)
    coords = torch.floor((pos - origin) / cell).to(torch.int32)
    hi = torch.tensor(grid.dims, dtype=torch.int32, device=dev) - 1
    return torch.minimum(torch.clamp(coords, min=0), hi)


def build(grid: GridSpec, pos: torch.Tensor, active: torch.Tensor) -> CellList:
    """Counting-sort cell list: one stable sort, static shapes."""
    dev = pos.device
    coords = cell_coords(grid, pos)
    strides = torch.tensor(grid.strides, dtype=torch.int32, device=dev)
    cid = (coords * strides).sum(-1, dtype=torch.int32)
    # Inactive rows go to a sentinel cell past the last real cell, so the
    # per-cell [start, end) ranges never cover them.
    cid = torch.where(active, cid, grid.num_cells)
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    all_cells = torch.arange(grid.num_cells, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_cid, all_cells, right=False)
    ends = torch.searchsorted(sorted_cid, all_cells, right=True)
    return CellList(
        order=order.to(torch.int32),
        starts=starts.to(torch.int32),
        ends=ends.to(torch.int32),
        coords=coords,
    )


def _neighbor_offsets(dim: int) -> list[tuple[int, ...]]:
    """The {-1,0,1}^dim cell offsets, first axis outermost (``meshgrid`` ij)."""
    return list(itertools.product((-1, 0, 1), repeat=dim))


def neighbor_fold(
    grid: GridSpec,
    cl: CellList,
    pair_fn: Callable[[Carry, torch.Tensor, torch.Tensor], Carry],
    init: Carry,
) -> Carry:
    """Fold ``pair_fn`` over all neighbor candidates of every particle.

    ``pair_fn(carry, j, valid)`` receives, for each of the 3^d adjacent-cell
    offsets in turn:
      j     [N, cap] int64 — candidate neighbor indices (original numbering)
      valid [N, cap] bool  — candidate exists (in-range slot of a real cell)
    and returns the updated carry. The candidates include the particle
    itself (callers mask r > 0 for pair forces and keep the self term for
    density)."""
    n, dev = cl.order.shape[0], cl.order.device
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)
    strides = torch.tensor(grid.strides, dtype=torch.int32, device=dev)
    slot = torch.arange(grid.cap, dtype=torch.int32, device=dev)
    offsets = torch.tensor(_neighbor_offsets(grid.dim), dtype=torch.int32, device=dev)
    order = cl.order.to(torch.int64)
    carry = init
    for off in offsets:
        nb = cl.coords + off
        in_grid = ((nb >= 0) & (nb < dims)).all(-1)
        nb_cid = (torch.minimum(torch.clamp(nb, min=0), dims - 1) * strides).sum(-1)
        s = cl.starts[nb_cid]
        e = cl.ends[nb_cid]
        idx = s[:, None] + slot[None, :]
        valid = (idx < e[:, None]) & in_grid[:, None]
        j = order[torch.clamp(idx, 0, n - 1).to(torch.int64)]
        carry = pair_fn(carry, j, valid)
    return carry


def max_cell_occupancy(grid: GridSpec, cl: CellList) -> torch.Tensor:
    """Diagnostic: the fullest cell's population (to validate ``cap``)."""
    return (cl.ends - cl.starts).max()
