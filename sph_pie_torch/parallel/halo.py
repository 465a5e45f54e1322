"""The explicit halo-exchange WCSPH step on an equal split of the cells.

The port of the JAX package's ``parallel/halo.py`` (``shard_map`` +
``ppermute``): the grid's cells split into ``n`` equal contiguous ranges
(``num_cells`` must divide by ``n``, and a shard must be thicker than its
halo of ``halo_cells`` cells); each step exchanges the edge rows of the
fields the pair sums read, runs density and forces on each shard's home
range and updates locally; ``travel`` is a ``pmax``.

As in the reference, the rebin is the one-stage trigger (``travel`` past
skin/2), a global rebin on the gathered layout, and a periodic grid's
ghost planes are refreshed by the global ``wrap_ghosts``: those choices
only change on which steps slots are re-sorted. Unlike the reference, the
update holds frozen boundary particles as the single-device step does
(the reference's halo step moves them). The local step is
``sharding.local_step``, shared with the other two decompositions.
"""

from __future__ import annotations

from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.parallel import comm, sharding


def make_halo_step(mesh: comm.Mesh, params, grid: nb.BinnedGrid, obstacles=None):
    """(step, run): ``step(ShardedState) -> ShardedState`` and
    ``run(ShardedState, n_steps)``, on states placed by
    ``sharding.shard_binned`` (equal splits). ``obstacles`` move with the
    state's ``sim_time``."""
    C, n = grid.num_cells, mesh.n
    if C % n:
        raise ValueError(f"num_cells {C} not divisible by {n} devices")
    if nb.halo_cells(grid) > C // n:
        raise ValueError("shard thinner than its halo; use fewer devices")

    def step(st: sharding.ShardedState) -> sharding.ShardedState:
        return sharding.local_step(mesh, params, grid, st, sharding.one_stage_rebin, obstacles)

    def run(st: sharding.ShardedState, n_steps: int) -> sharding.ShardedState:
        for _ in range(int(n_steps)):
            st = step(st)
        return st

    return step, run
