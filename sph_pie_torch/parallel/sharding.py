"""Spatial domain decomposition of the binned WCSPH step, and sharded PBF.

The port of the JAX package's ``parallel/sharding.py``. There the binned
slot arrays are placed under GSPMD shardings (``slot_sharding`` splits the
slot axis, ``replicated`` keeps scalars whole) and the single-device step
is compiled under them, so XLA inserts the halo collectives. PyTorch has
no partitioner: those two ``NamedSharding`` constructors have no torch
meaning and are not ported. ``shard_binned`` places the state itself, into
the shards of a ``comm.Mesh`` (nearly equal contiguous ranges of cells; no
divisibility, as under GSPMD), and the step spells out what the
partitioner would do:

  1. the two-stage lazy rebin of ``solvers/wcsph_binned.maybe_rebin``: the
     drift is a ``pmax`` over the shards, decided on the host. A rebin and,
     on a periodic grid, ``wrap_ghosts`` run on the gathered global layout,
     then the result is split back (every rank of a process group runs the
     same global rebin: ``expand.cu`` on the card);
  2. an exchange of pos, vel and mass; density on each shard's home range
     (``density.cu`` on the card), then the Tait EOS;
  3. an exchange of what the forces read of a neighbour, ``forces.per_slot``'s
     1/rho, p/rho^2 and m/rho; forces on each shard's home range
     (``forces.cu``);
  4. the single-device step's update, ``integrate.update`` on each shard's
     home rows (``integrate.cu`` on the card), and ``travel`` by ``pmax``.

The same windows in the same order give each home slot the single-device
kernel's sums, so the step's results are the single-device step's. The
shards are updated in place. ``sharded_pbf_simulate`` runs the PBF step on
the global layout with its folds sharded (``mesh_fold``: each shard
launches the ``csrc/pbf.cu`` kernels on its home range).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import eos
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.density import density
from sph_pie_torch.neighbors.forces import forces, per_slot
from sph_pie_torch.parallel import comm
from sph_pie_torch.parallel.comm import make_mesh  # noqa: F401 (the reference's name)
from sph_pie_torch.solvers import integrate
from sph_pie_torch.solvers.wcsph_binned import wall_axes
from sph_pie_torch.utils.struct import replace

# ``forces.per_slot``'s outputs, in its order.
PER_SLOT = ("inv_rho", "pr2", "m_rho")
# Fields in margined buffers (read across shard edges), and home-only ones.
EXCHANGED = ("pos", "vel", "mass", *PER_SLOT)
HOME_ONLY = ("density", "pressure", "valid", "owner", "bin_pos")
# Every slot field of BinnedState that a shard holds.
SLOT_FIELDS = ("pos", "vel", "mass", "density", "pressure", "valid", "owner", "bin_pos")


@dataclasses.dataclass
class ShardedState:
    """A BinnedState split over a mesh: the held shards' slot fields, and
    the per-particle and scalar fields whole (replicated on every rank)."""

    layout: comm.Layout
    shards: list[comm.Shard]
    slot_of: torch.Tensor
    travel: torch.Tensor
    overflow: torch.Tensor
    n_rebins: torch.Tensor
    sim_time: torch.Tensor


@dataclasses.dataclass
class View:
    """What the wrappers read of a shard. Density and forces read pos, vel
    and mass over its buffer's rows and valid over its home slots;
    ``integrate.update`` reads pos, vel, valid and owner over its home
    slots, travel and sim_time."""

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    valid: torch.Tensor
    owner: torch.Tensor
    travel: torch.Tensor
    sim_time: torch.Tensor


def view(s: comm.Shard, st: ShardedState) -> View:
    """A shard's buffers as density and forces read them with
    ``home=s.home``, with its home slots' owner, a zero travel and the
    clock."""
    return View(s.buf["pos"], s.buf["vel"], s.buf["mass"], s.field("valid"),
                s.field("owner"), st.travel.new_zeros(()), st.sim_time)


def equal_splits(num_cells: int, n: int) -> np.ndarray:
    """Nearly equal contiguous ranges: shard d owns [d C // n, (d+1) C // n)."""
    return np.asarray([d * num_cells // n for d in range(n + 1)], np.int64)


def shard_binned(
    mesh: comm.Mesh,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    starts=None,
    alloc: int | None = None,
) -> ShardedState:
    """Place a whole BinnedState (as every rank holds it) onto the mesh:
    cells ``[starts[d], starts[d+1])`` to shard d, each buffer with room
    for ``alloc`` home cells (default the widest shard). The default split
    is ``equal_splits``, and raises on a shard thinner than its halo, as
    the reference's decompositions do; given ``starts`` (the balanced
    split) may hold thin shards, whose neighbours' margins then reach the
    shards beyond."""
    if starts is None:
        starts = equal_splits(grid.num_cells, mesh.n)
        if grid.num_cells // mesh.n < nb.halo_cells(grid):
            raise ValueError(
                f"shard thinner than its halo: {grid.num_cells // mesh.n} cells, halo "
                f"{nb.halo_cells(grid)}; use fewer devices"
            )
    if len(starts) != mesh.n + 1 or int(starts[-1]) != grid.num_cells:
        raise ValueError(f"starts must split {grid.num_cells} cells {mesh.n} ways")
    layout = comm.make_layout(starts, grid.cap, nb.halo_cells(grid), alloc)
    fdt, dim = b.pos.dtype, grid.dim
    vec = ((dim,), fdt)
    specs = {"pos": vec, "vel": vec, "bin_pos": vec, "valid": ((), torch.bool),
             "owner": ((), torch.int32)}
    shards = comm.make_shards(
        mesh, layout,
        {k: specs.get(k, ((), fdt)) for k in EXCHANGED},
        {k: specs.get(k, ((), fdt)) for k in HOME_ONLY},
    )
    st = ShardedState(
        layout=layout, shards=shards, slot_of=b.slot_of.to(mesh.device),
        travel=b.travel.to(mesh.device), overflow=b.overflow.to(mesh.device),
        n_rebins=b.n_rebins.to(mesh.device), sim_time=b.sim_time.to(mesh.device),
    )
    _put(mesh, st, b)
    return st


def _put(mesh: comm.Mesh, st: ShardedState, b: nb.BinnedState, names=SLOT_FIELDS) -> None:
    """Copy the slot fields ``names`` of a whole state into the shards."""
    for k in names:
        for s, part in zip(st.shards, comm.split(mesh, st.layout, getattr(b, k))):
            s.field(k).copy_(part)


def gather_binned(mesh: comm.Mesh, grid: nb.BinnedGrid, st: ShardedState) -> nb.BinnedState:
    """The whole BinnedState (on every rank)."""
    fields = {
        k: comm.gather(mesh, st.layout, [s.field(k) for s in st.shards]) for k in SLOT_FIELDS
    }
    return nb.BinnedState(
        **fields, slot_of=st.slot_of, travel=st.travel, overflow=st.overflow,
        n_rebins=st.n_rebins, sim_time=st.sim_time,
    )


def _global(mesh, grid, st: ShardedState, fn) -> ShardedState:
    """Run ``fn`` on the whole state and split its result back."""
    b = fn(gather_binned(mesh, grid, st))
    _put(mesh, st, b)
    return replace(
        st, slot_of=b.slot_of, travel=b.travel, overflow=b.overflow,
        n_rebins=b.n_rebins, sim_time=b.sim_time,
    )


def _drift(mesh, st: ShardedState) -> torch.Tensor:
    """max |pos - bin_pos| over every slot of the mesh."""
    d2 = [((s.field("pos") - s.field("bin_pos")) ** 2).sum(dim=-1).amax()
          if s.cells else st.travel.new_zeros(()) for s in st.shards]
    return torch.sqrt(comm.pmax(mesh, d2))


def two_stage_rebin(mesh, grid, st: ShardedState) -> ShardedState:
    """``wcsph_binned.maybe_rebin`` over the mesh: when ``travel`` passes
    skin/2, rebin only if the measured drift does too, else tighten
    ``travel`` to it."""
    thr = 0.5 * grid.skin
    if not bool(st.travel > thr):
        return st
    d = _drift(mesh, st)
    if bool(d > thr):
        return _global(mesh, grid, st, lambda b: nb.rebin(grid, b))
    return replace(st, travel=d)


def one_stage_rebin(mesh, grid, st: ShardedState) -> ShardedState:
    """The reference's halo-step trigger: rebin once ``travel`` passes skin/2."""
    if bool(st.travel > 0.5 * grid.skin):
        return _global(mesh, grid, st, lambda b: nb.rebin(grid, b))
    return st


Trigger = Callable[[comm.Mesh, nb.BinnedGrid, ShardedState], ShardedState]


@torch.no_grad()
def local_step(
    mesh: comm.Mesh,
    params: FluidParams,
    grid: nb.BinnedGrid,
    st: ShardedState,
    trigger: Trigger | None,
    obstacles=None,
) -> ShardedState:
    """One WCSPH step over the mesh: ``trigger`` (None: never rebin), the
    global ghost wrap on a periodic grid, then the shards' pair sums on
    their home ranges between exchanges, and the update of each shard's
    home rows, whose travels' ``pmax`` grows ``travel``."""
    if trigger is not None:
        st = trigger(mesh, grid, st)
    if any(grid.periodic):
        st = _global(mesh, grid, st, lambda b: nb.wrap_ghosts(grid, b))
    live = [s for s in st.shards if s.cells]
    views = {s.index: view(s, st) for s in live}

    comm.exchange(mesh, st.shards, ("pos", "vel", "mass"))
    for s in live:
        rho = density(params, grid, views[s.index], home=s.home)
        s.loc["density"], s.loc["pressure"] = rho, eos.tait_pressure(params, rho)
        for k, x in zip(PER_SLOT, per_slot(rho, s.loc["pressure"], s.field("mass"))):
            s.field(k).copy_(x)

    comm.exchange(mesh, st.shards, PER_SLOT)
    walls = wall_axes(grid)
    travels = []
    for s in live:
        v = views[s.index]
        hoisted = tuple(s.buf[k] for k in PER_SLOT)
        acc, xsph = forces(params, grid, v, home=s.home, hoisted=hoisted)
        home_rows = replace(v, pos=s.field("pos"), vel=s.field("vel"))
        pos, vel, travel = integrate.update(params, grid, home_rows, walls, acc, xsph, obstacles)
        s.field("pos").copy_(pos)
        s.field("vel").copy_(vel)
        travels.append(travel)
    if not travels:  # a process whose shard holds no cells
        travels = [st.travel.new_zeros(())]
    return replace(st, travel=st.travel + comm.pmax(mesh, travels),
                   sim_time=st.sim_time + params.dt)


def sharded_step(mesh: comm.Mesh, params: FluidParams, grid: nb.BinnedGrid, obstacles=None):
    """The WCSPH step over the mesh, the two-stage rebin trigger included:
    ``step(ShardedState) -> ShardedState``."""

    def step(st: ShardedState) -> ShardedState:
        return local_step(mesh, params, grid, st, two_stage_rebin, obstacles)

    return step


def sharded_simulate(mesh: comm.Mesh, params: FluidParams, grid: nb.BinnedGrid, obstacles=None):
    """``roll(ShardedState, n_steps) -> ShardedState``."""
    step = sharded_step(mesh, params, grid, obstacles)

    def roll(st: ShardedState, n_steps: int) -> ShardedState:
        for _ in range(int(n_steps)):
            st = step(st)
        return st

    return roll


def mesh_fold(mesh: comm.Mesh, grid: nb.BinnedGrid):
    """The route of PBF's folds over the mesh: ``fold(fn, *args, **fields)``
    splits each whole per-slot field into the shards of ``equal_splits``,
    exchanges their margins, calls the ``neighbors.pbf_folds`` function
    ``fn(*args, **buffers, home=s.home)`` on each shard (its kernel on the
    card, on the shard's home range) and gathers each output (whole, on
    every rank). Integer fields (lambda's hit words) travel as the float
    ones do."""
    layout = comm.make_layout(
        equal_splits(grid.num_cells, mesh.n), grid.cap, nb.halo_cells(grid)
    )

    def fold(fn, *args, **fields):
        specs = {k: (tuple(v.shape[1:]), v.dtype) for k, v in fields.items()}
        shards = comm.make_shards(mesh, layout, specs, {})
        for k, x in fields.items():
            for s, part in zip(shards, comm.split(mesh, layout, x)):
                s.field(k).copy_(part)
        # one exchange per dtype: a process group packs each message by
        # concatenation, which would cast lambda's int32 hit words
        for dt in dict.fromkeys(x.dtype for x in fields.values()):
            comm.exchange(mesh, shards, tuple(k for k, x in fields.items() if x.dtype == dt))
        parts = []
        for s in shards:
            out = fn(*args, **s.buf, home=s.home)
            parts.append(out if isinstance(out, tuple) else (out,))
        whole = tuple(
            comm.gather(mesh, layout, [p[j] for p in parts]) for j in range(len(parts[0]))
        )
        return whole if len(whole) > 1 else whole[0]

    return fold


def sharded_pbf_simulate(mesh: comm.Mesh, params, grid: nb.BinnedGrid, pbf_params,
                         obstacles=None):
    """``roll(BinnedState, n_steps) -> BinnedState``: the PBF step with its
    folds over the mesh (``mesh_fold``). Everything else runs on the whole
    state, replicated on every rank: the prediction, the owner-indexed
    stashes, the rebins and the epilogue, where the reference's partitioner
    puts its cross-shard gathers."""
    from sph_pie_torch.solvers import pbf as pbf_lib

    fold = mesh_fold(mesh, grid)

    def roll(b: nb.BinnedState, n_steps: int) -> nb.BinnedState:
        return pbf_lib.simulate(params, grid, pbf_params, b, n_steps, obstacles, fold=fold)

    return roll
