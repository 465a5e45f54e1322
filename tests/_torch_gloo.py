"""Worker of the port's process-group tests: one rank of a gloo group on the
CPU, spawned by ``torch.multiprocessing`` (importable without JAX).

Each rank builds the same scene from its builder, places it on a mesh of
one shard per rank, runs ``steps`` steps of the halo or the balanced step
and saves its shard's home fields to ``<out>/rank<r>.pt`` (or, for kind
"bits", the int32 field ``fold_bits`` gathers through ``mesh_fold``)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.parallel import balance, comm, halo, sharding
from sph_pie_torch.scenes import builders


def padded_scene(n_target: int, n_dev: int, **kw):
    """``dam_break_2d`` with its leading axis padded so the cells divide by
    ``n_dev`` (the extra cells stay empty)."""
    import dataclasses

    scene = builders.dam_break_2d(n_target, device="cpu", **kw)
    g = scene.bgrid
    d0 = g.dims[0]
    while (d0 + 2) * (g.dims[1] + 2) % n_dev:
        d0 += 1
    return dataclasses.replace(scene, bgrid=dataclasses.replace(g, dims=(d0, g.dims[1])))


def shard_fields(st) -> dict:
    return {f"{s.index}/{k}": s.field(k).clone() for s in st.shards for k in sharding.SLOT_FIELDS}


def fold_bits(mesh, scene):
    """The position bits of every slot, as an int32 per-slot field carried
    through ``mesh_fold``'s split, exchange and gather."""
    g, b = scene.bgrid, scene.binned_state()
    fold = sharding.mesh_fold(mesh, g)

    def home_bits(pos, mass, bits, home):
        assert bits.dtype == torch.int32 and torch.equal(bits, pos.view(torch.int32))
        first, count = home
        return bits[first * g.cap:(first + count) * g.cap]

    return fold(home_bits, pos=b.pos, mass=b.mass, bits=b.pos.view(torch.int32))


def run(kind: str, mesh, scene, steps: int):
    """The final home fields of ``steps`` steps of ``kind`` ("halo" or
    "balanced") on ``mesh``, with travel and sim_time; for "bits", the whole
    int32 field ``fold_bits`` gathers."""
    if kind == "bits":
        return {"bits": fold_bits(mesh, scene)}
    g, b = scene.bgrid, scene.binned_state()
    torch.set_num_threads(1)
    if kind == "halo":
        step, _ = halo.make_halo_step(mesh, scene.params, g)
        st = sharding.shard_binned(mesh, g, b)
    else:
        c_cap = max(3 * g.num_cells // mesh.n, nb.halo_cells(g) + 1)
        starts = balance.balanced_splits(balance.cell_counts(g, b).numpy(), mesh.n, c_cap)
        init_fn, step, _ = balance.make_balanced_step(mesh, scene.params, g, c_cap)
        st = init_fn(b, starts)
    for _ in range(steps):
        st = step(st)
    return {**shard_fields(st), "travel": st.travel, "sim_time": st.sim_time}


def worker(rank: int, world: int, store_path: str, out: str, kind: str, steps: int,
           n_target: int) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = comm.make_mesh(world, device="cpu", group=dist.group.WORLD)
        scene = padded_scene(n_target, world, viscosity=0.05)
        torch.save(run(kind, mesh, scene, steps), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
