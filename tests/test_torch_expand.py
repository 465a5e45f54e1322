"""Port vs reference: the rebin placement (``expand``).

  * ``expand_plain`` against ``pallas_rebin.expand`` (interpret mode), bit
    for bit, on ragged inputs whose overfull cells stay within that kernel's
    stated domain (at most ``SLACK`` caps of dropped rows per block of
    cells);
  * ``expand_plain`` against a numpy loop over the slots beyond that domain:
    many overfull cells, rows that would pass K, K = 0;
  * the rule that picks the CUDA kernel's arm (``runs.expand_run_cells``:
    0 for the per-slot arm), so this suite pins which arm the card takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_inputs  # noqa: F401  (pins torch to one thread)
from sph_pie_torch.neighbors import runs
from sph_pie_torch.neighbors.expand import expand_plain
from sph_pie_tpu.neighbors import pallas_rebin

DTYPES = {"f32": np.float32, "f64": np.float64}


def ragged(rng, num_cells, cap, ncol, dtype, overfull, excess):
    """(first, count, rows, owner): counts up to cap, empty stretches, and
    ``overfull`` cells of each 128 with up to ``excess`` rows too many."""
    count = rng.integers(0, cap + 1, num_cells)
    count[(np.arange(num_cells) // 37) % 3 == 1] = 0
    for blk in range(0, num_cells, 128):
        size = min(128, num_cells - blk)
        cells = blk + rng.choice(size, min(overfull, size), replace=False)
        count[cells] = cap + rng.integers(1, excess + 1, len(cells))
    first = np.cumsum(count) - count
    K = int(count.sum())
    rows = rng.normal(size=(K, ncol)).astype(dtype)
    owner = rng.permutation(K).astype(np.int32)
    return first.astype(np.int32), count.astype(np.int32), rows, owner


def by_loop(first, count, rows, owner, cap):
    """The placement, slot by slot."""
    C, (K, ncol) = len(first), rows.shape
    dense = np.zeros((C * cap, ncol), rows.dtype)
    own = np.full(C * cap, -1, np.int32)
    for c in range(C):
        for r in range(min(int(count[c]), cap)):
            src = int(first[c]) + r
            if src < K:
                dense[c * cap + r] = rows[src]
                own[c * cap + r] = owner[src]
    return dense, own


def plain(first, count, rows, owner, cap):
    dense, own = expand_plain(
        torch.tensor(first), torch.tensor(count), torch.tensor(rows), torch.tensor(owner), cap
    )
    return dense.numpy(), own.numpy()


@pytest.mark.parametrize("cap", [8, 40])
@pytest.mark.parametrize("ncol", [5, 7, 8])
def test_expand_plain_matches_pallas_rebin(ncol, cap):
    rng = np.random.default_rng(100 * ncol + cap)
    # 3 overfull cells per block, each at most one cap over: within SLACK = 4
    args = ragged(rng, 300, cap, ncol, np.float32, overfull=3, excess=cap)
    first, count, rows, owner = args
    assert (np.maximum(count - cap, 0).sum()) > 0 and pallas_rebin.SLACK * cap >= 3 * cap
    want = np.asarray(
        pallas_rebin.expand(
            jnp.asarray(first), jnp.asarray(count), jnp.asarray(rows), cap, interpret=True
        )
    )
    dense, own = plain(*args, cap)
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(own, by_loop(*args, cap)[1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["many overfull", "past K", "K == 0"])
def test_expand_plain_matches_the_slot_loop_beyond_the_pallas_domain(case, dtype):
    rng = np.random.default_rng(5)
    cap, ncol = 8, 7
    first, count, rows, owner = ragged(
        rng, 260, cap, ncol, DTYPES[dtype], overfull=20, excess=3 * cap
    )
    dropped = np.add.reduceat(np.maximum(count - cap, 0), np.arange(0, 260, 128))
    assert dropped.max() > pallas_rebin.SLACK * cap  # more than the slack absorbs
    if case == "past K":
        rows, owner = rows[:-30], owner[:-30]  # the last cells' rows do not exist
        assert (first + np.minimum(count, cap) > len(rows)).sum() > 1
    elif case == "K == 0":
        rows, owner = rows[:0], owner[:0]
    dense, own = plain(first, count, rows, owner, cap)
    want_dense, want_own = by_loop(first, count, rows, owner, cap)
    assert dense.dtype == DTYPES[dtype] and own.dtype == np.int32
    np.testing.assert_array_equal(dense, want_dense)
    np.testing.assert_array_equal(own, want_own)
    if case == "K == 0":
        assert not dense.any() and (own == -1).all()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("cap,vector", [(5, False), (8, True), (32, True), (40, True)])
def test_expand_arm_follows_the_cap_in_both_dtypes(cap, vector, itemsize):
    """The 16-byte arm takes every cap the scenes are made with; the inputs'
    alignment plays no part (both arms read rows element by element)."""
    for ncol in (5, 6, 7, 8):
        assert (runs.expand_run_cells(cap, ncol, itemsize) > 0) is vector


@pytest.mark.parametrize("cap,ncol,itemsize,cells", [
    (8, 7, 4, 80), (32, 7, 4, 20), (40, 7, 4, 16), (40, 8, 8, 16),  # EXPAND_SLOTS // cap
    (384, 8, 8, 1), (1000, 7, 4, 1),   # a cap above EXPAND_SLOTS: runs of one cell
    (640, 16, 8, 0), (1000, 7, 8, 0),  # one cell's span passes EXPAND_BYTES
    (5, 7, 4, 0), (6, 7, 8, 0), (0, 7, 4, 0),  # owners of a cell end off a 16-byte boundary
])
def test_expand_run_cells(cap, ncol, itemsize, cells):
    assert runs.expand_run_cells(cap, ncol, itemsize) == cells
    if cells:  # the run's span fits the shared memory set aside, with its bookkeeping
        assert cells * (cap * (ncol * itemsize + 4) + 8) + 64 <= runs.EXPAND_BYTES


@pytest.mark.parametrize("which", ["dense", "owner"])
def test_expand_run_cells_needs_outputs_on_16_byte_boundaries(which):
    dense, owner = torch.zeros(64), torch.zeros(64, dtype=torch.int32)
    assert runs.expand_run_cells(8, 7, 4, dense, owner) == 80
    outs = {"dense": dense, "owner": owner}
    outs[which] = outs[which][1:]
    assert runs.expand_run_cells(8, 7, 4, outs["dense"], outs["owner"]) == 0
