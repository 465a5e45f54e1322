"""Uniform-grid description of the naive cell-list engine.

Only the geometry is ported so far (``Scene.gspec`` keeps its field); the
gather engine that uses it is not.
"""

from __future__ import annotations

import dataclasses
import math


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
