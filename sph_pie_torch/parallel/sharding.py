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
  3. an exchange of what the forces read of a neighbour: p/rho^2, m/rho and
     1/rho; forces on each shard's home range (``forces.cu``);
  4. the single-device step's update, frozen boundary particles held, and
     ``travel`` by ``pmax``.

The same windows in the same order give each home slot the single-device
kernel's sums, so the step's results are the single-device step's. The
shards are updated in place. ``sharded_pbf_simulate`` runs the PBF step on
the global layout with its folds sharded (``mesh_fold``).
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
from sph_pie_torch.neighbors.forces import forces
from sph_pie_torch.parallel import comm
from sph_pie_torch.parallel.comm import make_mesh  # noqa: F401 (the reference's name)
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_torch.solvers.wcsph_binned import wall_axes
from sph_pie_torch.utils.struct import replace

# Fields in margined buffers (read across shard edges), and home-only ones.
EXCHANGED = ("pos", "vel", "mass", "pr2", "m_rho", "inv_rho")
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
    """What the density and forces wrappers read of a buffer: pos, vel and
    mass over its rows, valid over its home slots."""

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    valid: torch.Tensor


def view(s: comm.Shard) -> View:
    """A shard's buffers as the wrappers read them with ``home=s.home``."""
    return View(s.buf["pos"], s.buf["vel"], s.buf["mass"], s.field("valid"))


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


def _frozen(grid: nb.BinnedGrid, owner: torch.Tensor) -> torch.Tensor:
    if not grid.n_boundary:
        return torch.zeros_like(owner, dtype=torch.bool)
    return owner >= grid.max_particles - grid.n_boundary


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
    their home ranges between exchanges, and the update."""
    if trigger is not None:
        st = trigger(mesh, grid, st)
    if any(grid.periodic):
        st = _global(mesh, grid, st, lambda b: nb.wrap_ghosts(grid, b))
    live = [s for s in st.shards if s.cells]
    views = {s.index: view(s) for s in live}

    comm.exchange(mesh, st.shards, ("pos", "vel", "mass"))
    for s in live:
        rho = density(params, grid, views[s.index], home=s.home)
        s.loc["density"], s.loc["pressure"] = rho, eos.tait_pressure(params, rho)
        inv_rho = 1.0 / rho
        s.field("inv_rho").copy_(inv_rho)
        s.field("pr2").copy_(s.loc["pressure"] * inv_rho * inv_rho)
        s.field("m_rho").copy_(s.field("mass") * inv_rho)

    comm.exchange(mesh, st.shards, ("pr2", "m_rho", "inv_rho"))
    walls = wall_axes(grid)
    d2 = []
    for s in live:
        per_slot = (s.buf["inv_rho"], s.buf["pr2"], s.buf["m_rho"])
        acc, xsph = forces(params, grid, views[s.index], home=s.home, per_slot=per_slot)
        pos, vel = s.field("pos"), s.field("vel")
        acc = acc + params.gravity
        acc = acc + boundary_accel(params, pos, vel, walls)
        if obstacles is not None:
            acc = acc + obs_lib.accel(obstacles, pos, vel, st.sim_time)
        move = (s.field("valid") & ~_frozen(grid, s.field("owner")))[:, None]
        new_vel = clamp_speed(params, torch.where(move, vel + params.dt * acc, 0.0))
        vel_adv = torch.where(move, new_vel + params.xsph_eps * xsph, 0.0)
        pos.copy_(torch.where(move, pos + params.dt * vel_adv, pos))
        vel.copy_(new_vel)
        d2.append((vel_adv * vel_adv).sum(dim=-1).amax())
    if not d2:  # a process whose shard holds no cells
        d2 = [st.travel.new_zeros(())]
    step_disp = params.dt * torch.sqrt(torch.clamp(comm.pmax(mesh, d2), min=0.0))
    return replace(st, travel=st.travel + step_disp, sim_time=st.sim_time + params.dt)


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
    """A ``binned.slab_fold`` over the mesh: each call splits its whole
    input fields into the shards of ``equal_splits``, exchanges their edge
    rows, folds each shard's home cells with its margins as halos and
    gathers the outputs (whole, on every rank)."""
    layout = comm.make_layout(
        equal_splits(grid.num_cells, mesh.n), grid.cap, nb.halo_cells(grid)
    )

    def fold(g, fields, pair_fn, init):
        specs = {k: (tuple(v.shape[1:]), v.dtype) for k, v in fields.items()}
        shards = comm.make_shards(mesh, layout, specs, {})
        for k, x in fields.items():
            for s, part in zip(shards, comm.split(mesh, layout, x)):
                s.field(k).copy_(part)
        comm.exchange(mesh, shards, tuple(fields))
        parts = []
        for s, *inits in zip(shards, *(comm.split(mesh, layout, a) for a in init)):
            local = {k: s.field(k) for k in fields}
            halo = ({k: s.lo(k) for k in fields}, {k: s.hi(k) for k in fields})
            parts.append(nb.slab_fold(g, local, pair_fn, inits, halo=halo, local_cells=s.cells))
        return tuple(
            comm.gather(mesh, layout, [p[j] for p in parts]) for j in range(len(init))
        )

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
