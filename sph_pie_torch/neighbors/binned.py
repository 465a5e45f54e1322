"""Binned dense cell layout: the neighbor structure of the WCSPH main path.

  * Every grid cell owns ``cap`` particle slots in one flat slot-major array
    (slot = cell_id * cap + rank). A one-cell ghost border keeps every
    neighbor window of an occupied cell in bounds.
  * Cells are raveled row-major with the LAST grid axis contiguous, so the
    3^d stencil collapses to 3^(d-1) "slabs": for each offset of the
    leading axes, the neighbor cells c+shift-1 .. c+shift+1 are one
    contiguous run of 3*cap slots.
  * A Verlet-style skin (cell_size = h + skin) lets the re-binning (a
    stable sort by cell id) run only when a particle may have drifted more
    than skin/2 since the last binning.

The result-bearing rules are those of the JAX reference: slot layout, the
drop rule for an overfull cell (a stable sort keeps its first ``cap``
rows), empty slots at pos 0 with mass 0 and owner -1, ``valid = mass > 0``.
Row placement goes through the ``expand`` kernel (``neighbors/expand.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from sph_pie_torch.core.state import ParticleState, allocate
from sph_pie_torch.neighbors.expand import expand
from sph_pie_torch.utils.struct import replace

PairFn = Callable[
    [tuple[torch.Tensor, ...], dict[str, torch.Tensor], dict[str, torch.Tensor]],
    tuple[torch.Tensor, ...],
]


@dataclasses.dataclass(frozen=True)
class BinnedGrid:
    """Static slot-grid description (plain Python values only)."""

    dims: tuple[int, ...]      # interior cells per GRID axis
    origin: tuple[float, ...]  # world coord of interior cell (0,..,0), grid order
    cell_size: float           # >= support radius h + skin
    cap: int                   # particle slots per cell
    skin: float                # Verlet skin absorbed into cell_size
    block_cells: int = 0       # home cells per plain-fold chunk (0 = all)
    max_particles: int = 0     # compact particle capacity (for O(N) rebin)
    axis_order: tuple[int, ...] = ()  # grid axis g -> spatial axis
    n_boundary: int = 0        # trailing compact rows that are frozen
                               # boundary (ghost) particles
    periodic: tuple[bool, ...] = ()  # per GRID axis: wrapped ids, ghost
                                     # images (wrap_ghosts), period dims*cell

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def padded_dims(self) -> tuple[int, ...]:
        return tuple(d + 2 for d in self.dims)  # one ghost cell per side

    @property
    def num_cells(self) -> int:
        return math.prod(self.padded_dims)

    @property
    def num_slots(self) -> int:
        return self.num_cells * self.cap

    @property
    def strides(self) -> tuple[int, ...]:
        pd = self.padded_dims
        s = [1] * self.dim
        for a in range(self.dim - 2, -1, -1):
            s[a] = s[a + 1] * pd[a + 1]
        return tuple(s)

    def slab_shifts(self) -> list[int]:
        """Flat cell shifts for each {-1,0,1}^(dim-1) leading-axes offset."""
        shifts = [0]
        for a in range(self.dim - 1):
            stride = self.strides[a]
            shifts = [s + o * stride for s in shifts for o in (-1, 0, 1)]
        return shifts


def binned_grid_from_bounds(
    bound_min,
    bound_max,
    h: float,
    cap: int,
    skin_frac: float = 0.5,
    block_cells: int | None = None,
    max_particles: int = 0,
    axis_order: tuple[int, ...] | None = None,
    margin_cells: int = 0,
    periodic: tuple[bool, ...] | None = None,
) -> BinnedGrid:
    """Grid whose cells are h*(1+skin_frac) wide; rebin is needed only when
    a particle may have moved more than skin/2 since the last binning.

    ``block_cells`` bounds the plain fold's pair temporaries to
    [block_cells, cap, 3cap]; auto-sized as in the reference.
    ``margin_cells`` extends the interior past the domain AABB on every
    side, so wall penetrators keep their true cell instead of being
    clipped into the edge ring.
    """
    skin = float(skin_frac) * float(h)
    cell = float(h) + skin
    bmin = tuple(float(v) for v in bound_min)
    bmax = tuple(float(v) for v in bound_max)
    dim = len(bmin)
    if axis_order is None:
        axis_order = tuple(range(dim))
    m = int(margin_cells)
    per_g = tuple(bool(periodic[a]) for a in axis_order) if periodic else ()
    if any(per_g) and m:
        raise ValueError("margin_cells and periodic are mutually exclusive")
    dims = tuple(
        max(1, int(math.ceil((bmax[a] - bmin[a]) / cell)) + 2 * m)
        for a in axis_order
    )
    grid = BinnedGrid(
        dims=dims,
        origin=tuple(bmin[a] - m * cell for a in axis_order),
        cell_size=cell,
        cap=int(cap),
        skin=skin,
        max_particles=int(max_particles),
        axis_order=tuple(axis_order),
        periodic=per_g,
    )
    if block_cells is None:
        budget = 8 * 1024 * 1024  # pair-tensor element cap per block
        sweet = 1024 if len(dims) == 2 else 256
        block_cells = max(8, min(sweet, budget // (grid.cap * 3 * grid.cap)))
        if block_cells >= grid.num_cells:
            block_cells = 0  # single block
    return dataclasses.replace(grid, block_cells=int(block_cells))


@dataclasses.dataclass(frozen=True)
class BinnedState:
    """Dense slot-major particle state. Leading dim = grid.num_slots."""

    pos: torch.Tensor       # [S, dim]
    vel: torch.Tensor       # [S, dim]
    mass: torch.Tensor      # [S]
    density: torch.Tensor   # [S]
    pressure: torch.Tensor  # [S]
    valid: torch.Tensor     # [S] bool
    owner: torch.Tensor     # [S] int32 — original particle index, -1 if empty
    slot_of: torch.Tensor   # [K] int32 — particle k's slot; num_slots if absent
    bin_pos: torch.Tensor   # [S, dim] positions at bin time (drift anchor)
    travel: torch.Tensor    # [] upper bound on displacement since bin
    overflow: torch.Tensor  # [] int32 — particles dropped by full cells
    n_rebins: torch.Tensor  # [] int32 — re-sorts since bin_state
    sim_time: torch.Tensor  # [] simulated seconds since bin_state


def _cell_ids(grid: BinnedGrid, pos: torch.Tensor, valid: torch.Tensor):
    """Padded-grid flat cell id per row; invalid rows -> num_cells.

    Non-periodic axes clip penetrators into the edge ring of the interior;
    periodic axes wrap them modulo the interior width (Python-style, as
    ``jnp.mod``), so a particle leaving one side bins on the other."""
    dev = pos.device
    order = grid.axis_order or tuple(range(grid.dim))
    pos_g = pos[:, list(order)]  # spatial columns permuted into grid order
    origin = torch.tensor(grid.origin, dtype=pos.dtype, device=dev)
    # A tensor divisor keeps this a true division on every device (a
    # Python-float divisor may become a reciprocal multiply).
    cell = torch.tensor(grid.cell_size, dtype=pos.dtype, device=dev)
    coords = torch.floor((pos_g - origin) / cell).to(torch.int32)
    hi = torch.tensor(grid.padded_dims, dtype=torch.int32, device=dev) - 2
    clipped = torch.minimum(torch.clamp(coords + 1, min=1), hi)
    if any(grid.periodic):
        dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)
        per = torch.tensor(grid.periodic, dtype=torch.bool, device=dev)
        coords = torch.where(per, torch.remainder(coords, dims) + 1, clipped)
    else:
        coords = clipped
    strides = torch.tensor(grid.strides, dtype=torch.int32, device=dev)
    cid = (coords * strides).sum(-1, dtype=torch.int32)
    return torch.where(valid, cid, grid.num_cells)


def _fold_periodic(grid: BinnedGrid, pos: torch.Tensor) -> torch.Tensor:
    """Positions folded into the primary box on periodic axes.

    Applied at bin time only: between rebins a particle may drift up to
    skin/2 past the seam, which the wrapped cell ids and the ghost images
    still cover, and continuous positions keep the drift check exact."""
    if not any(grid.periodic):
        return pos
    order = grid.axis_order or tuple(range(grid.dim))
    cols = []
    for s_axis in range(grid.dim):
        g_axis = order.index(s_axis)
        x = pos[:, s_axis]
        if grid.periodic[g_axis]:
            o = grid.origin[g_axis]
            L = grid.dims[g_axis] * grid.cell_size
            x = o + torch.remainder(x - o, L)
        cols.append(x)
    return torch.stack(cols, dim=-1)


@dataclasses.dataclass(frozen=True)
class SortedRows:
    """K compact rows sorted by cell id: the placement step's inputs."""

    rows: torch.Tensor   # [K, NCOL] pos | vel (optional) | density (optional) | mass
    owner: torch.Tensor  # [K] int32 owner of each sorted row
    slot: torch.Tensor   # [K] int64 slot of each sorted row; S if dropped
    first: torch.Tensor  # [C] int32 index of each cell's first sorted row
    count: torch.Tensor  # [C] int32 rows per cell (before the cap)
    overflow: torch.Tensor  # [] int32 rows dropped by full cells


def sort_rows(
    grid: BinnedGrid,
    pos: torch.Tensor,
    vel: torch.Tensor | None,
    mass: torch.Tensor,
    owner: torch.Tensor,
    valid: torch.Tensor,
    density: torch.Tensor | None = None,
) -> SortedRows:
    """Stable sort of K compact rows by cell id, with each row's slot and
    each cell's (first, count).

    The sort is stable, so within a cell rows keep their input order and an
    overfull cell drops its highest-ranked rows, exactly as the reference's
    stable multi-operand sort does. A ``vel`` or ``density`` of None is
    not carried: the rows then hold only the columns given. Positions are
    folded into the primary box on periodic axes first (``_fold_periodic``):
    the rows carry the folded positions."""
    n, dev = pos.shape[0], pos.device
    C, cap, S = grid.num_cells, grid.cap, grid.num_slots
    pos = _fold_periodic(grid, pos)
    cid = _cell_ids(grid, pos, valid)
    scid, perm = torch.sort(cid, stable=True)
    cols = [pos] + ([vel] if vel is not None else [])
    cols += [density[:, None]] if density is not None else []
    rows = torch.cat(cols + [mass[:, None]], dim=1)[perm]

    # rank within cell = i - (index of this cell's first row), where the
    # first-row index is the running max over change-point markers.
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = scid[1:] != scid[:-1]
    first_row = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    rank = iota - first_row
    fits = (rank < cap) & (scid < C)

    # Per-cell (first, count) over the sorted ids: a bincount whose last
    # bin collects the invalid rows, then an exclusive cumsum.
    count = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    count.scatter_add_(0, scid.to(torch.int64), torch.ones_like(iota))
    count = count[:C]
    return SortedRows(
        rows=rows.contiguous(),
        owner=owner[perm].to(torch.int32).contiguous(),
        slot=torch.where(fits, scid.to(torch.int64) * cap + rank, S),
        first=(torch.cumsum(count, 0) - count).to(torch.int32),
        count=count.to(torch.int32),
        overflow=(cid < C).sum(dtype=torch.int32) - fits.sum(dtype=torch.int32),
    )


def _bin_rows(
    grid: BinnedGrid,
    pos: torch.Tensor,
    vel: torch.Tensor | None,
    mass: torch.Tensor,
    owner: torch.Tensor,
    valid: torch.Tensor,
    n_rebins: torch.Tensor | None = None,
    sim_time: torch.Tensor | None = None,
    density: torch.Tensor | None = None,
) -> BinnedState:
    """Sort K compact rows by cell id and place them into the dense slots
    (``expand``). ``owner`` must be the particle index of each row (a
    permutation of 0..K-1). ``vel=None`` places no velocity (the dense vel
    is zeros), ``density=None`` no density (zeros)."""
    n, dim, dev, dt = pos.shape[0], grid.dim, pos.device, pos.dtype
    S = grid.num_slots
    nv = dim if vel is not None else 0
    srt = sort_rows(grid, pos, vel, mass, owner, valid, density)
    dense, owner_d = expand(srt.first, srt.count, srt.rows, srt.owner, grid.cap)
    pos_d = dense[:, :dim].contiguous()
    vel_d = (
        dense[:, dim : dim + nv].contiguous()
        if nv
        else torch.zeros((S, dim), dtype=dt, device=dev)
    )
    dens_d = (
        dense[:, dim + nv].contiguous()
        if density is not None
        else torch.zeros(S, dtype=dt, device=dev)
    )
    mass_d = dense[:, -1].contiguous()

    slot_of = torch.empty(n, dtype=torch.int32, device=dev)
    slot_of[srt.owner.to(torch.int64)] = srt.slot.to(torch.int32)
    return BinnedState(
        pos=pos_d,
        vel=vel_d,
        mass=mass_d,
        density=dens_d,
        pressure=torch.zeros(S, dtype=dt, device=dev),
        # Real particles have strictly positive mass; empty slots hold 0.
        valid=mass_d > 0,
        owner=owner_d,
        slot_of=slot_of,
        bin_pos=pos_d,
        travel=torch.zeros((), dtype=dt, device=dev),
        overflow=srt.overflow,
        n_rebins=(
            torch.zeros((), dtype=torch.int32, device=dev)
            if n_rebins is None
            else n_rebins
        ),
        sim_time=(
            torch.zeros((), dtype=dt, device=dev) if sim_time is None else sim_time
        ),
    )


def bin_state(
    grid: BinnedGrid,
    state: ParticleState,
    boundary: tuple[torch.Tensor, torch.Tensor] | None = None,
    sim_time: torch.Tensor | None = None,
) -> BinnedState:
    """ParticleState (flat, original order) -> dense binned layout.

    ``boundary`` is an optional (pos [M, dim], mass [M]) pair of frozen
    ghost particles appended after the fluid rows (M == grid.n_boundary).
    ``state.density`` is carried into the slots (zero for boundary rows).
    """
    n_fluid = (grid.max_particles or state.capacity) - grid.n_boundary
    if grid.max_particles and state.capacity != n_fluid:
        raise ValueError(
            f"state capacity {state.capacity} != fluid rows {n_fluid} "
            f"(grid.max_particles {grid.max_particles}, "
            f"n_boundary {grid.n_boundary})"
        )
    pos, vel, mass, valid = state.pos, state.vel, state.mass, state.active
    dens = state.density
    if grid.n_boundary:
        if boundary is None:
            raise ValueError(f"grid expects {grid.n_boundary} boundary rows")
        bpos, bmass = boundary
        if bpos.shape[0] != grid.n_boundary:
            raise ValueError(
                f"boundary rows {bpos.shape[0]} != grid.n_boundary {grid.n_boundary}"
            )
        pos = torch.cat([pos, bpos.to(pos.dtype)])
        vel = torch.cat([vel, torch.zeros_like(bpos, dtype=pos.dtype)])
        mass = torch.cat([mass, bmass.to(mass.dtype)])
        valid = torch.cat([valid, torch.ones_like(bmass, dtype=torch.bool)])
        dens = torch.cat([dens, torch.zeros_like(bmass, dtype=dens.dtype)])
    owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return _bin_rows(
        grid, pos, vel, mass, owner, valid,
        sim_time=(
            None
            if sim_time is None
            else torch.as_tensor(sim_time, dtype=pos.dtype, device=pos.device)
        ),
        density=dens,
    )


def axis_vector(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small per-axis tensor of Python values, made on ``device`` by fills:
    a tensor copied from the host (``torch.tensor`` of a list, or an item
    assignment) would make the host wait for the card."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


def _wrap_axis(
    grid: BinnedGrid, x: torch.Tensor, axis: int, offset: torch.Tensor | None
) -> torch.Tensor:
    """x: flat [S, ...] -> a new tensor whose two ghost planes along grid
    ``axis`` hold the opposite interior edge planes; ``offset`` (a spatial
    [dim] vector) is subtracted from the low image and added to the high
    one, or None."""
    pd = grid.padded_dims
    lead = math.prod(pd[:axis])
    tail = math.prod(pd[axis + 1 :]) * grid.cap
    shape = (lead, pd[axis], tail) + tuple(x.shape[1:])
    out = x.clone(memory_format=torch.contiguous_format)
    src, dst = x.reshape(shape), out.view(shape)
    lo_img, hi_img = src[:, -2:-1], src[:, 1:2]  # high edge -> low ghost, and back
    if offset is not None:
        lo_img, hi_img = lo_img - offset, hi_img + offset
    dst[:, :1] = lo_img
    dst[:, -1:] = hi_img
    return out


def wrap_ghost_fields(
    grid: BinnedGrid,
    fields: dict[str, torch.Tensor],
    offset_fields: tuple[str, ...] = ("pos", "bin_pos"),
) -> dict[str, torch.Tensor]:
    """Field-level ghost wrap: name -> flat [S, ...] tensors, returned as new
    tensors (the inputs are not written). Fields named in ``offset_fields``
    get the +-L spatial image offset; the rest are copied verbatim. Axis by
    axis, so that corners compose."""
    if not any(grid.periodic):
        return dict(fields)
    order = grid.axis_order or tuple(range(grid.dim))
    out = dict(fields)
    for g_axis, per in enumerate(grid.periodic):
        if not per:
            continue
        s_axis = order[g_axis]
        length = grid.dims[g_axis] * grid.cell_size
        for k, x in out.items():
            off = None
            if k in offset_fields:
                vec = [length if a == s_axis else 0.0 for a in range(grid.dim)]
                off = axis_vector(vec, x.dtype, x.device)
            out[k] = _wrap_axis(grid, x, g_axis, off)
    return out


def wrap_ghosts(grid: BinnedGrid, b: BinnedState) -> BinnedState:
    """Refresh the ghost-border cells of periodic axes with images of the
    opposite interior edge (positions offset by the domain length).

    Called after every rebin check and before the pair sums. ``bin_pos``
    carries the offset too, else the drift check would see a phantom
    domain-length drift on every populated ghost slot. ``vel``, ``mass``,
    ``valid``, ``owner`` and ``density`` are copied verbatim: ghost slots
    are valid, so they move and count in the step's bounds like their
    sources."""
    if not any(grid.periodic):
        return b
    return replace(
        b,
        **wrap_ghost_fields(
            grid,
            {
                "pos": b.pos,
                "bin_pos": b.bin_pos,
                "vel": b.vel,
                "mass": b.mass,
                "valid": b.valid,
                "owner": b.owner,
                "density": b.density,
            },
        ),
    )


def halo_cells(grid: BinnedGrid) -> int:
    """Cells of halo each side a local fold needs (= max slab reach + 1)."""
    return max(abs(s) for s in grid.slab_shifts()) + 1


def frozen_mask(grid: BinnedGrid, b: BinnedState) -> torch.Tensor:
    """[S] bool: slot holds a frozen boundary particle."""
    if not grid.n_boundary:
        return torch.zeros_like(b.valid)
    n_fluid = grid.max_particles - grid.n_boundary
    return b.owner >= n_fluid


def _compact(
    grid: BinnedGrid,
    b: BinnedState,
    light: bool = False,
    carry_density: bool = False,
):
    """Gather the K compact particle rows out of the dense layout. O(K).

    Returns (pos, vel, mass, alive, density): vel is None when ``light``,
    density None unless ``carry_density`` (the payload rules of ``rebin``)."""
    S = grid.num_slots
    safe = torch.clamp(b.slot_of, 0, S - 1).to(torch.int64)
    vel = None if light else b.vel[safe]
    dens = b.density[safe] if carry_density else None
    return b.pos[safe], vel, b.mass[safe], b.slot_of < S, dens


def rebin(
    grid: BinnedGrid,
    b: BinnedState,
    light: bool = False,
    carry_density: bool = False,
) -> BinnedState:
    """Re-sort after drift: compact-gather K rows, then re-bin. O(K log K).

    ``light=True`` leaves the velocity out (the rebinned state carries zero
    vel): PBF's mid-step rebins under its "gather" epilogue, whose
    constraint iterations read only pos and mass. ``carry_density=True``
    places the density column too, where it is zero otherwise: PBF's "ride"
    epilogue keeps the previous step's density there. WCSPH takes neither
    (it recomputes density next)."""
    pos, vel, mass, alive, dens = _compact(grid, b, light, carry_density)
    owner = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    return _bin_rows(
        grid, pos, vel, mass, owner, alive, b.n_rebins + 1, b.sim_time,
        density=dens,
    )


def unbin(grid: BinnedGrid, b: BinnedState, capacity: int) -> ParticleState:
    """Dense layout -> flat original-order ParticleState (fluid rows only)."""
    if b.slot_of.shape[0] != capacity + grid.n_boundary:
        raise ValueError(
            f"capacity {capacity} + boundary {grid.n_boundary} != "
            f"particle rows {b.slot_of.shape[0]}"
        )
    S = grid.num_slots
    slot_of = b.slot_of[:capacity]
    safe = torch.clamp(slot_of, 0, S - 1).to(torch.int64)
    alive = slot_of < S
    st = allocate(capacity, grid.dim, b.pos.dtype, b.pos.device)
    m = alive[:, None]
    return replace(
        st,
        pos=torch.where(m, b.pos[safe], 0.0),
        vel=torch.where(m, b.vel[safe], 0.0),
        mass=torch.where(alive, b.mass[safe], 0.0),
        density=torch.where(alive, b.density[safe], 0.0),
        pressure=torch.where(alive, b.pressure[safe], 0.0),
        active=alive,
    )


def _planar(name: str, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Split an [S, dim] tensor into per-component [S] fields."""
    return {f"{name}{k}": x[:, k] for k in range(x.shape[1])}


def _r2(dim: int, home: dict, w: dict):
    """Per-component deltas (home - window) and squared pair distance."""
    d = [home[f"p{k}"][:, :, None] - w[f"p{k}"][:, None, :] for k in range(dim)]
    r2 = d[0] * d[0]
    for k in range(1, dim):
        r2 = r2 + d[k] * d[k]
    return d, r2


def _window_view(w: torch.Tensor, blk: int, cap: int) -> torch.Tensor:
    """[blk*cap + 2*cap, ...] contiguous rows -> [blk, 3*cap, ...] windows
    (cell c's window covers cells c-1, c, c+1)."""
    tail = w.shape[1:]
    n = blk * cap
    parts = [w[0:n], w[cap : cap + n], w[2 * cap : 2 * cap + n]]
    return torch.cat([p.reshape((blk, cap) + tail) for p in parts], dim=1)


def slab_windows(grid: BinnedGrid, x: torch.Tensor) -> list[torch.Tensor]:
    """For each of the 3^(dim-1) slabs, the [num_cells, 3*cap, ...] window
    of every cell; slots outside [0, S) read as zeros. Unblocked: for
    small grids and tests (``slab_fold`` is the chunked form)."""
    cap = grid.cap
    shifts = grid.slab_shifts()
    pad = (max(abs(s) for s in shifts) + 1) * cap
    z = torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)
    xp = torch.cat([z, x, z])
    return [
        _window_view(xp[pad + (sh - 1) * cap :], grid.num_cells, cap)
        for sh in shifts
    ]


def home_range(grid: BinnedGrid, rows: int, home: tuple[int, int] | None) -> tuple[int, int]:
    """(first, count) home cells of a buffer of ``rows`` slots: ``home``, or
    the whole grid when it is None (then the buffer must be the grid's S
    slots). Raises on a range that does not lie in the buffer."""
    if home is None:
        if rows != grid.num_slots:
            raise ValueError(f"a whole-grid buffer holds {grid.num_slots} slots, got {rows}")
        return 0, grid.num_cells
    first, count = int(home[0]), int(home[1])
    if rows % grid.cap or first < 0 or count < 0 or (first + count) * grid.cap > rows:
        raise ValueError(f"home cells [{first}, {first + count}) do not lie in a buffer of "
                         f"{rows} slots at cap {grid.cap}")
    return first, count


def split_home(
    grid: BinnedGrid, fields: dict[str, torch.Tensor], home: tuple[int, int]
) -> tuple[dict[str, torch.Tensor], tuple[dict, dict]]:
    """Buffer fields [rows, ...] -> (the home cells' rows, (lo, hi) halos of
    ``halo_cells`` cells each side) for ``slab_fold(halo=, local_cells=)``.
    Rows outside the buffer read as zeros, as past the grid's ends."""
    cap, hc = grid.cap, halo_cells(grid)
    first, count = home
    local, lo, hi = {}, {}, {}
    for k, x in fields.items():
        rows = x.shape[0]

        def rows_of(a, b):  # buffer rows [a, b), zeros outside [0, rows)
            z = x.new_zeros((b - a,) + x.shape[1:])
            s, e = max(a, 0), min(b, rows)
            if e > s:
                z[s - a : e - a] = x[s:e]
            return z

        local[k] = x[first * cap : (first + count) * cap]
        lo[k] = rows_of((first - hc) * cap, first * cap)
        hi[k] = rows_of((first + count) * cap, (first + count + hc) * cap)
    return local, (lo, hi)


def slab_fold(
    grid: BinnedGrid,
    fields: dict[str, torch.Tensor],
    pair_fn: PairFn,
    init: Sequence[torch.Tensor],
    every_slot: bool = False,
    halo: tuple[dict, dict] | None = None,
    local_cells: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Fold ``pair_fn`` over all neighbor slabs, in chunks of home cells.

    ``fields`` maps name -> flat [S, ...] tensor and must hold ``mass``.
    ``init`` is a sequence of flat per-slot accumulators [S, ...]. For every
    chunk of up to ``grid.block_cells`` home cells and every slab,
    ``pair_fn(carry, home, win)`` receives

      carry  tuple of [n, r, ...] accumulators for the chunk's home slots
      home   dict of [n, r, ...] home-slot field blocks
      win    dict of [n, 3*cap, ...] neighbor-window field blocks (cells
             c-1, c, c+1 of the slab, in that order; cells outside the grid
             read as zeros)

    and returns the updated carry. Chunking bounds the pair temporaries to
    [block_cells, cap, 3cap] whatever the grid size.

    Only cells that hold a particle are home cells, and home rows are cut
    to the chunk's deepest cell (``r``): rank r is occupied only if its
    cell holds more than r particles, so the cut rows are empty slots. Both
    leave every occupied slot's sums unchanged; the slots of empty cells
    get 0. Finding the cells and the depths costs two device-to-host copies
    per call. ``every_slot`` makes every cell a home cell with all its
    rows; only ``density_window_plain`` sets it, because its reference
    (``pallas_density.density_pallas``) keeps a density on empty slots.

    Shards (the reference's signature and meaning): with ``halo=(lo, hi)``
    and ``local_cells``, ``fields`` and ``init`` hold the ``local_cells``
    home cells of a contiguous range of the grid, and each halo dict holds
    the ``halo_cells(grid) * cap`` rows of the cells just before (lo) and
    just after (hi) them, in place of the zeros past the grid's ends. The hi
    halo follows the last home cell, wherever the range ends.
    """
    cap = grid.cap
    C = grid.num_cells if local_cells is None else int(local_cells)
    shifts = grid.slab_shifts()
    blk = min(grid.block_cells or C, C) or 1
    padc = max(abs(s) for s in shifts) + 1  # zero or halo cells on each side
    mass = fields["mass"]
    dev = mass.device
    if mass.shape[0] != C * cap:
        raise ValueError(f"slab_fold: fields hold {mass.shape[0]} rows, not {C} cells x {cap}")

    def cells_view(k, x):
        if halo is None:
            lo = hi = x.new_zeros((padc * cap,) + x.shape[1:])
        else:
            lo, hi = halo[0][k], halo[1][k]
        return torch.cat([lo, x, hi]).view((C + 2 * padc, cap) + x.shape[1:])

    padded = {k: cells_view(k, v) for k, v in fields.items()}
    if every_slot:
        cells = torch.arange(C, device=dev)
        depth = [cap] * -(-C // blk)
    else:
        occ = (mass.reshape(C, cap) > 0).sum(1)
        cells = occ.nonzero()[:, 0]
        n = cells.shape[0]
        per = torch.nn.functional.pad(occ[cells], (0, -n % blk))
        depth = per.view(-1, blk).amax(1).tolist() if n else []
    offs = torch.arange(-1, 2, device=dev)

    out = tuple(torch.zeros_like(a) for a in init)
    for i, rows in enumerate(depth):
        idx = cells[i * blk : (i + 1) * blk] + padc  # padded cell ids
        n = idx.shape[0]
        home = {k: v[idx, :rows] for k, v in padded.items()}
        carry = tuple(a.new_zeros((n, rows) + a.shape[1:]) for a in init)
        for sh in shifts:
            nbr = idx[:, None] + (sh + offs)[None, :]  # [n, 3] window cells
            win = {
                k: v[nbr].reshape((n, 3 * cap) + v.shape[2:]) for k, v in padded.items()
            }
            carry = pair_fn(carry, home, win)
        for o, c in zip(out, carry):
            o.view((C, cap) + o.shape[1:])[idx - padc, :rows] = c
    return out
