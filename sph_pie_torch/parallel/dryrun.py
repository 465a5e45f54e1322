"""The multi-device dry run: every decomposition of ``parallel/`` on a mesh,
each held to the single-device step.

The port of the JAX package's ``__graft_entry__._dryrun_impl``, whose legs
run on a virtual 8-device CPU mesh; here on an in-process mesh of
``n_devices`` shards on one device (``comm.make_mesh``). One line per leg:

  1. ``sharding.sharded_step`` on ``dam_break_2d(2048)``, one step;
  2. ``halo.make_halo_step`` on the same scene, its leading axis padded so
     the cells divide by the mesh, one step;
  3. the balanced resort (``balance``) on the skewed dam-break column,
     3 steps, max |dpos| < 5e-6 against the single-device step;
  4. the 16M budget (``membudget.dam_break_budget``) and the 16M dam
     break's grid geometry at a sparse fill (a 4 dx lattice, cap 8),
     placed on the mesh; no step (``state_16m`` gives the state to step);
  5. sharded PBF (``flagship_params``), 2 steps, max |dpos| < 1e-6 in
     owner order;
  7. balanced splits + a periodic axis in 3D (``dam_break_3d_periodic``),
     3 steps, max |dpos| < 5e-6 in owner order.

(The reference numbers its legs so; it has no leg 6.) ``n_shape`` and
``n_periodic`` default to the reference's 16M and 50k; smaller values cut
legs 4 and 7 for a CPU run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_pie_torch.core import state as state_lib
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.parallel import balance, comm, halo, sharding
from sph_pie_torch.scenes import builders
from sph_pie_torch.solvers import pbf as pbf_lib
from sph_pie_torch.solvers import wcsph_binned
from sph_pie_torch.utils import membudget

BALANCED_TOL = 5e-6  # max |dpos| after 3 steps, balanced vs single device
PBF_TOL = 1e-6       # max |dpos| after 2 PBF steps, owner order


def padded_grid(grid: nb.BinnedGrid, n: int) -> nb.BinnedGrid:
    """``grid`` with its leading axis grown until the cells divide by ``n``
    (the extra cells stay empty)."""
    d0 = grid.dims[0]
    rest = int(np.prod([d + 2 for d in grid.dims[1:]]))
    while (d0 + 2) * rest % n:
        d0 += 1
    return dataclasses.replace(grid, dims=(d0,) + tuple(grid.dims[1:]))


def state_16m(mesh: comm.Mesh, n_target: int = 16_000_000):
    """(params, grid, ShardedState): the ``n_target`` dam break's grid
    geometry at a sparse fill (a lattice of 4 dx, so cap 8 holds every
    cell), on ``mesh``. Each particle has its lattice's mass
    (``lattice_mass``): the reference's leg, which never steps, gives
    mass 1.0, whose Tait pressure overflows float32 at this h."""
    dev = mesh.device
    shape = builders.dam_break_3d(n_target=n_target, build_state=False, device=dev)
    dx = (0.3 * 0.4 * 0.6 / n_target) ** (1.0 / 3.0)
    pos = builders.lattice_block([0, 0, 0], [0.3, 0.4, 0.6], 4 * dx)
    p = shape.params
    mass = builders.lattice_mass(3, float(p.h), 4 * dx, float(p.rest_density))
    st = state_lib.from_positions(pos, capacity=pos.shape[0], mass=mass, device=dev)
    grid = dataclasses.replace(
        shape.bgrid, cap=8, max_particles=st.capacity, n_boundary=0
    )
    return shape.params, grid, sharding.shard_binned(mesh, grid, nb.bin_state(grid, st))


def _owner_err(grid, a: nb.BinnedState, b: nb.BinnedState, capacity: int) -> tuple[float, int]:
    """max |dpos| over the active particles in owner order, and their count."""
    sa, sb = nb.unbin(grid, a, capacity), nb.unbin(grid, b, capacity)
    act = sb.active
    if not bool(torch.equal(sa.active, act)):
        raise AssertionError("the active particles differ")
    return (sa.pos[act] - sb.pos[act]).abs().max().item(), int(act.sum())


def _balanced(mesh, params, grid, b, steps: int):
    """(balanced final state, balance factor, equal-cells factor)."""
    n = mesh.n
    counts = balance.cell_counts(grid, b).cpu().numpy()
    c_cap = max(3 * grid.num_cells // n, nb.halo_cells(grid) + 1)
    starts = balance.balanced_splits(counts, n, c_cap)
    equal = np.linspace(0, grid.num_cells, n + 1).astype(np.int64)
    init_fn, step_fn, finish_fn = balance.make_balanced_step(mesh, params, grid, c_cap)
    bs = init_fn(b, starts)
    for _ in range(steps):
        bs = step_fn(bs)
    return (finish_fn(bs, b), balance.balance_factor(counts, starts),
            balance.balance_factor(counts, equal))


@torch.no_grad()
def dryrun_multichip(
    n_devices: int,
    device: torch.device | str = "cuda",
    n_shape: int = 16_000_000,
    n_periodic: int = 50_000,
) -> dict:
    """Run the legs on an in-process mesh of ``n_devices`` shards on
    ``device``; raises on a failed check. Returns each leg's numbers."""
    mesh = comm.make_mesh(n_devices, device=device)
    dev = mesh.device
    out = {}

    scene = builders.dam_break_2d(n_target=2048, device=dev)
    g = scene.bgrid
    st = sharding.shard_binned(mesh, g, scene.binned_state())
    st = sharding.sharded_step(mesh, scene.params, g)(st)
    got = sharding.gather_binned(mesh, g, st)
    if got.pos.shape != (g.num_slots, g.dim) or not bool(torch.isfinite(got.pos).all()):
        raise AssertionError("sharded step: wrong shape or non-finite positions")
    print(f"dryrun_multichip (sharded): ok on {n_devices} shards, {g.num_cells} cells, "
          f"starts {st.layout.starts}")

    g2 = padded_grid(g, n_devices)
    step2, _ = halo.make_halo_step(mesh, scene.params, g2)
    st2 = step2(sharding.shard_binned(mesh, g2, nb.bin_state(g2, scene.state)))
    got2 = sharding.gather_binned(mesh, g2, st2)
    if not bool(torch.isfinite(got2.pos).all()):
        raise AssertionError("halo step: non-finite positions")
    print(f"dryrun_multichip (halo): ok on {n_devices} shards, grid {g2.dims}")

    b3 = scene.binned_state()
    b_bal, bf, bf_equal = _balanced(mesh, scene.params, g, b3, 3)
    b_ref = wcsph_binned.simulate(scene.params, g, b3, 3)
    v = b3.valid
    err = (b_bal.pos[v] - b_ref.pos[v]).abs().max().item()
    if not err < BALANCED_TOL:
        raise AssertionError(f"balanced step diverged from single-device: {err}")
    out["balanced"] = dict(balance=bf, balance_equal=bf_equal, err=err)
    print(f"dryrun_multichip (balanced resort): ok on {n_devices} shards, balance "
          f"{bf:.2f}x (equal-cells {bf_equal:.2f}x), max|dpos| {err:.1e} "
          f"(bound {BALANCED_TOL:g})")

    full = membudget.dam_break_budget(16_000_000, n_devices=n_devices)
    print(f"dryrun_multichip (16M budget): {full.row()}")
    if not full.fits:
        raise AssertionError("16M does not fit the per-card budget")
    _, g16, st16 = state_16m(mesh, n_shape)
    n16 = int(st16.slot_of.shape[0])
    out["shape"] = dict(dims=g16.dims, slots=g16.num_slots, particles=n16)
    print(f"dryrun_multichip ({n_shape / 1e6:g}M-shape state): placed, grid {g16.dims}, "
          f"{g16.num_slots:,} slots, {n16:,} particles on {n_devices} shards "
          f"(halo {st16.layout.margin} cells)")
    del st16

    pp = pbf_lib.flagship_params(device=dev)
    b5 = sharding.sharded_pbf_simulate(mesh, scene.params, g, pp)(scene.binned_state(), 2)
    b5_ref = pbf_lib.simulate(scene.params, g, pp, scene.binned_state(), 2)
    err5, _ = _owner_err(g, b5, b5_ref, scene.state.capacity)
    if not err5 < PBF_TOL:
        raise AssertionError(f"sharded PBF diverged from single-device: {err5}")
    out["pbf"] = dict(err=err5)
    print(f"dryrun_multichip (sharded PBF): ok on {n_devices} shards, max|dpos| {err5:.1e} "
          f"(bound {PBF_TOL:g})")

    sc7 = builders.dam_break_3d_periodic(n_periodic, device=dev)
    g7 = sc7.bgrid
    b7 = nb.bin_state(g7, sc7.state)
    b7_bal, bf7, _ = _balanced(mesh, sc7.params, g7, b7, 3)
    b7_ref = wcsph_binned.simulate(sc7.params, g7, b7, 3)
    err7, n7 = _owner_err(g7, b7_bal, b7_ref, sc7.state.capacity)
    if not err7 < BALANCED_TOL:
        raise AssertionError(f"balanced periodic 3D diverged: {err7}")
    out["periodic"] = dict(balance=bf7, err=err7, particles=n7)
    print(f"dryrun_multichip (balanced periodic 3D): ok on {n_devices} shards, {n7:,} "
          f"particles, grid {g7.dims}, balance {bf7:.2f}x, max|dpos| {err7:.1e} "
          f"(bound {BALANCED_TOL:g})")
    return out
