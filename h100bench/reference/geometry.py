"""The cell grid a configuration states, worked out from its file.

Cells are h (1 + skin_frac) wide and cover the box plus ``margin_cells``
on each side, with one more ghost cell each side (the padded grid); the
grid's axes run gravity's axis first, then the others in order. Each cell
holds ``cap`` slots, so the slots are cells x cap. The frame's binning and
the rooflines' byte counts are reckoned on these numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from h100bench.reference import sph


@dataclasses.dataclass(frozen=True)
class Grid:
    dims: tuple[int, ...]        # interior cells per grid axis
    axis_order: tuple[int, ...]  # grid axis -> spatial axis
    cap: int

    @property
    def padded(self) -> tuple[int, ...]:
        return tuple(d + 2 for d in self.dims)

    @property
    def cells(self) -> int:
        return math.prod(self.padded)

    @property
    def slots(self) -> int:
        return self.cells * self.cap


def cell_size(cfg: dict) -> float:
    h = sph.physics(cfg).h
    return h + cfg["skin_frac"] * h


def grid(cfg: dict) -> Grid:
    cell = cell_size(cfg)
    dim = cfg["dim"]
    order = (dim - 1,) + tuple(range(dim - 1))
    m = cfg["margin_cells"]
    lo, hi = cfg["domain"]
    dims = tuple(max(1, math.ceil((hi[a] - lo[a]) / cell) + 2 * m) for a in order)
    return Grid(dims=dims, axis_order=order, cap=cfg["cap"])


def origin(cfg: dict, g: Grid) -> tuple[float, ...]:
    """World coordinates of interior cell (0, ..), in grid axis order."""
    cell = cell_size(cfg)
    return tuple(cfg["domain"][0][a] - cfg["margin_cells"] * cell for a in g.axis_order)


def cell_of(cfg: dict, g: Grid, pos: torch.Tensor) -> torch.Tensor:
    """Padded-grid cell id of each position, positions outside the
    interior clipped into its edge cells."""
    cell = cell_size(cfg)
    x = pos.to(torch.float64)[:, list(g.axis_order)]
    o = torch.tensor(origin(cfg, g), dtype=torch.float64, device=pos.device)
    c = torch.floor((x - o) / cell).to(torch.int64) + 1
    hi = torch.tensor(g.dims, dtype=torch.int64, device=pos.device)
    c = torch.minimum(torch.clamp(c, min=1), hi)
    strides = [1] * len(g.dims)
    for a in range(len(g.dims) - 2, -1, -1):
        strides[a] = strides[a + 1] * g.padded[a + 1]
    return (c * torch.tensor(strides, dtype=torch.int64, device=pos.device)).sum(1)
