"""Load-balanced spatial decomposition (BASELINE config #5: "ppermute halo
exchange + load-balanced resort").

The port of the JAX package's ``parallel/balance.py``. The equal-cells
split starves shards on non-uniform scenes: with the gravity axis leading,
settled fluid is a contiguous prefix of cell ids. Here the split points
come from the per-cell particle counts (``balanced_splits``: the smallest
largest load over contiguous segments of at most ``c_cap`` cells, the
painter's partition) and every shard has room for ``c_cap`` home cells.
``balanced_splits`` and ``balance_factor`` are numpy, the reference's own
arithmetic.

The balanced step is ``sharding.local_step`` on that layout, with the
reference's choices: it never rebins (the splits stay fixed; a resort is
``rebalance_splits`` at a rebin, between runs), and on a periodic grid it
gathers, wraps and splits every step. Unlike the reference, each shard's
hi margin sits right after its last home cell (the reference appends it
after all ``c_cap`` cells of room, so the last ``halo_cells`` home cells
of every shard lose their right neighbours), and frozen boundary particles
stay still: the step's results are the single-device step's.
"""

from __future__ import annotations

import numpy as np
import torch

from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.parallel import comm, sharding
from sph_pie_torch.utils.struct import replace

# The reference's name for the state of the balanced step.
BalancedState = sharding.ShardedState


def cell_counts(grid: nb.BinnedGrid, b: nb.BinnedState) -> torch.Tensor:
    """Particles per cell, [num_cells] int32."""
    return b.valid.reshape(grid.num_cells, grid.cap).sum(1, dtype=torch.int32)


def balanced_splits(counts: np.ndarray, n_dev: int, c_cap: int) -> np.ndarray:
    """Minimax particle-balanced contiguous splits under a cell budget.

    Binary-searches the smallest max-per-device particle load L such that
    the cells can be covered by <= n_dev contiguous segments, each holding
    <= L particles and <= c_cap cells. Returns ``starts`` [n_dev+1]; device
    d owns cells [starts[d], starts[d+1]). With extreme skew only the first
    k = n_dev - ceil(empty/c_cap) devices can hold fluid, bounding the
    balance factor at n_dev/k; a larger c_cap buys balance with memory."""
    counts = np.asarray(counts, np.int64)
    C = counts.shape[0]
    if n_dev * c_cap < C:
        raise ValueError(f"c_cap {c_cap} too small: {n_dev} devices cannot cover {C} cells")
    prefix = np.concatenate([[0], np.cumsum(counts)])

    def segments_for(L):
        """Greedy maximal segments; the cut list, or None if > n_dev."""
        cuts = [0]
        while cuts[-1] < C:
            if len(cuts) > n_dev:
                return None
            s = cuts[-1]
            # furthest end with load <= L, width <= c_cap, tail coverable
            e_load = int(np.searchsorted(prefix, prefix[s] + L, side="right")) - 1
            e = min(max(e_load, s + 1), s + c_cap, C)
            remaining_devs = n_dev - len(cuts)
            e = max(e, C - remaining_devs * c_cap)
            if e > s + c_cap or (e_load < e and prefix[e] - prefix[s] > L):
                return None
            cuts.append(e)
        return cuts

    lo, hi = int(counts.max(initial=0)), int(prefix[-1])
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        seg = segments_for(mid)
        if seg is not None:
            best = seg
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        best = segments_for(int(prefix[-1]))
    while len(best) < n_dev + 1:  # empty trailing devices
        best.append(C)
    return np.asarray(best, np.int64)


def balance_factor(counts: np.ndarray, starts: np.ndarray) -> float:
    """max device particles / mean device particles (1.0 = perfect)."""
    loads = [counts[starts[d] : starts[d + 1]].sum() for d in range(len(starts) - 1)]
    mean = max(np.mean(loads), 1e-9)
    return float(np.max(loads) / mean)


def rebalance_splits(
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    n_dev: int,
    c_cap: int,
    current: np.ndarray | None = None,
    threshold: float = 1.25,
):
    """The resort decision: (starts, balance factor, changed); fresh splits
    only when the current ones are imbalanced past ``threshold``."""
    counts = cell_counts(grid, b).cpu().numpy()
    if current is not None and balance_factor(counts, current) <= threshold:
        return current, balance_factor(counts, current), False
    fresh = balanced_splits(counts, n_dev, c_cap)
    return fresh, balance_factor(counts, fresh), True


def distribute(grid: nb.BinnedGrid, x: torch.Tensor, starts, c_cap: int) -> torch.Tensor:
    """Global flat [S, ...] -> stacked padded [n_dev, c_cap*cap, ...]: each
    device's rows, zeros past its count."""
    cap, n_dev = grid.cap, len(starts) - 1
    out = x.new_zeros((n_dev, c_cap * cap) + x.shape[1:])
    for d in range(n_dev):
        a, b = int(starts[d]) * cap, int(starts[d + 1]) * cap
        out[d, : b - a] = x[a:b]
    return out


def collect(grid: nb.BinnedGrid, stacked: torch.Tensor, starts) -> torch.Tensor:
    """Inverse of ``distribute``: stacked padded slabs -> global [S, ...]."""
    cap = grid.cap
    parts = [stacked[d, : (int(starts[d + 1]) - int(starts[d])) * cap]
             for d in range(stacked.shape[0])]
    return torch.cat(parts)


def make_balanced_step(mesh: comm.Mesh, params, grid: nb.BinnedGrid, c_cap: int,
                       obstacles=None):
    """WCSPH step over particle-balanced shards. Returns (init_fn, step_fn,
    finish_fn):

      init_fn(b, starts)  -> BalancedState (shards with room for c_cap cells)
      step_fn(bs)         -> BalancedState (one step, in place)
      finish_fn(bs, b)    -> ``b`` with pos, vel, density, pressure, travel
                             and sim_time from ``bs``
    """

    def init_fn(b: nb.BinnedState, starts) -> BalancedState:
        return sharding.shard_binned(mesh, grid, b, starts, alloc=c_cap)

    def step_fn(bs: BalancedState) -> BalancedState:
        return sharding.local_step(mesh, params, grid, bs, None, obstacles)

    def finish_fn(bs: BalancedState, b: nb.BinnedState) -> nb.BinnedState:
        out = {k: comm.gather(mesh, bs.layout, [s.field(k) for s in bs.shards])
               for k in ("pos", "vel", "density", "pressure")}
        return replace(b, travel=bs.travel, sim_time=bs.sim_time, **out)

    return init_fn, step_fn, finish_fn


def hbm_budget_bytes(n_particles: int, dim: int = 3, cap: int = 40,
                     occupancy: float = 15.4, occupied_frac: float = 0.21,
                     c_cap_slack: float = 2.0, n_dev: int = 8) -> dict:
    """Feasibility of BASELINE config #5 (16M particles, 8 cards) in the
    port's own bytes against one H100's 80 GB.

    Slots scale as particles / (occupancy * occupied_frac) * cap (the
    reference's geometry). A shard holds per slot pos, vel, bin_pos
    (3 dim floats), mass, density, pressure and the exchanged p/rho^2,
    m/rho, 1/rho (6 floats), valid (1 B) and owner (4 B); its buffers carry
    ``c_cap_slack`` x the equal share of slots."""
    cells = n_particles / (occupancy * occupied_frac)
    slots = cells * cap
    bytes_per_slot = (3 * dim + 6) * 4 + 1 + 4
    global_bytes = slots * bytes_per_slot
    per_dev = global_bytes / n_dev * c_cap_slack
    hbm = 80.0e9
    return {
        "slots": int(slots),
        "bytes_per_slot": bytes_per_slot,
        "global_gb": global_bytes / 1e9,
        "per_device_gb": per_dev / 1e9,
        "h100_hbm_gb": hbm / 1e9,
        "fits": per_dev < hbm * 0.6,  # 40% left for the step's temporaries
    }
