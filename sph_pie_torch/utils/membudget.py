"""Device-memory budget of a binned scene: does N particles fit on D cards?

Reckoned from the static grid geometry and the shapes the port allocates
(no tensor is made):

  * the dense slot state (the dominant term: S = num_cells * cap slots):
    pos, vel, bin_pos [S, dim], mass, density, pressure [S], valid (bool),
    owner (int32), held twice while a step or a rebin builds the next one;
  * the compact rows: ``slot_of`` and the K rows ``rebin`` gathers;
  * the rebin workspace: ``sort_rows``' keys, permutation and rank vectors,
    its [K, NCOL] rows before and after the permutation, and the
    ``expand`` output [S, NCOL] plus its owners;
  * the pair temporaries: 0 on the WCSPH path, whose staged kernels keep
    none.

All terms are reckoned, none measured; ``chip_smoke.py`` Phase F prints
this reckoning beside the peak ``torch.cuda.max_memory_allocated`` of a
run on the card. HBM is 80 GiB per card (NVIDIA H100 80GB).
"""

from __future__ import annotations

import dataclasses

from sph_pie_torch.neighbors.binned import BinnedGrid

HBM_BYTES = 80 << 30


@dataclasses.dataclass(frozen=True)
class MemBudget:
    n_particles: int
    n_devices: int
    num_cells: int
    num_slots: int
    slots_per_device: int
    dense_state_bytes: int      # per device
    compact_bytes: int          # per device
    sort_workspace_bytes: int   # per device
    fold_temp_bytes: int        # per device
    total_bytes: int            # per device, with 2x state double-buffer
    hbm_bytes: int              # per device capacity
    fits: bool

    def row(self) -> dict:
        gb = 1 << 30
        return {
            "n": self.n_particles,
            "devices": self.n_devices,
            "slots_per_device": self.slots_per_device,
            "dense_gb": round(self.dense_state_bytes / gb, 3),
            "compact_gb": round(self.compact_bytes / gb, 3),
            "sort_gb": round(self.sort_workspace_bytes / gb, 3),
            "fold_gb": round(self.fold_temp_bytes / gb, 3),
            "total_gb": round(self.total_bytes / gb, 3),
            "hbm_gb": round(self.hbm_bytes / gb, 1),
            "fits": self.fits,
        }


def budget(
    grid: BinnedGrid,
    n_particles: int,
    n_devices: int = 1,
    hbm_bytes: int = HBM_BYTES,
    dtype_bytes: int = 4,
) -> MemBudget:
    """Per-device budget of a binned scene split over the cell axis."""
    dim, es = grid.dim, dtype_bytes
    S = grid.num_slots
    K = grid.max_particles or n_particles
    s_dev = -(-S // n_devices)
    k_dev = -(-K // n_devices)
    c_dev = -(-grid.num_cells // n_devices)
    ncol = 2 * dim + 2  # pos | vel | density | mass: the widest rebin rows

    dense = s_dev * ((3 * dim + 3) * es + 1 + 4)
    # slot_of (int32) + the compact gather: pos, vel [K, dim], mass, alive
    compact = k_dev * (4 + (2 * dim + 1) * es + 1)
    # sort_rows: cid, sorted cid (int32), perm, iota, first row, rank, slot
    # (int64), is_start (bool), the sorted owners (int32), the rows before
    # and after the permutation; per cell count (int64), first (int32).
    sort_ws = k_dev * (2 * 4 + 5 * 8 + 1 + 4 + 2 * ncol * es) + c_dev * (8 + 4)
    # expand's output rows and owners, split into the new state after it
    sort_ws += s_dev * (ncol * es + 4)
    fold = 0

    total = 2 * dense + compact + sort_ws + fold
    return MemBudget(
        n_particles=n_particles,
        n_devices=n_devices,
        num_cells=grid.num_cells,
        num_slots=S,
        slots_per_device=s_dev,
        dense_state_bytes=dense,
        compact_bytes=compact,
        sort_workspace_bytes=sort_ws,
        fold_temp_bytes=fold,
        total_bytes=total,
        hbm_bytes=hbm_bytes,
        fits=total < hbm_bytes * 0.9,  # 10% headroom for the allocator
    )


def dam_break_budget(n_target: int, n_devices: int = 1) -> MemBudget:
    """Budget of the standard 3D dam break at ``n_target`` particles.

    Builds only the static grid (no lattice, tensors on the meta device),
    so it is instant at 16M and more."""
    from sph_pie_torch.scenes import dam_break_3d

    scene = dam_break_3d(n_target=n_target, build_state=False, device="meta")
    return budget(scene.bgrid, n_target, n_devices)
