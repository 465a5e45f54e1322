"""Port vs reference: the load-balanced decomposition (``parallel/balance.py``).

The splits and balance factors equal the reference's exactly; distribute /
collect round-trip bit for bit; the balanced step (8 in-process shards)
holds the reference's single-device density and positions on the
reference's own scene (``tests/test_balance.py``), where the reference's
balanced step loses the right neighbours of every shard's last cells;
frozen walls stay still; balanced + periodic 3D at 20k; a gloo process
group of 4 ranks gives the in-process mesh's bits. Bars: density rtol 1e-5,
positions 5e-6 (the reference's).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_gloo
from _torch_parity import jax_fields
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.parallel import balance, comm, dryrun
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.parallel import balance as jbal
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw

N_DEV = 8
STEPS = 5
POS_ATOL = 5e-6      # tests/test_balance.py
DENSITY_RTOL = 1e-5  # tests/test_halo.py's density bar


@pytest.fixture(scope="module")
def mesh():
    return comm.make_mesh(N_DEV, device="cpu")


def _c_cap(grid):
    return max(3 * grid.num_cells // N_DEV, jnb.halo_cells(grid) + 1)


@pytest.mark.parametrize("seed", range(4))
def test_splits_and_factors_equal_the_reference(seed):
    """``balanced_splits`` and ``balance_factor`` on skewed random counts,
    several mesh sizes and cell budgets: the reference's exact starts and
    factors."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(200, 3000))
    counts = np.where(np.arange(C) < rng.integers(20, C), rng.integers(0, 40, C), 0)
    counts = counts.astype(np.int32)
    for n in (2, 4, 8):
        for c_cap in (-(-C // n), 2 * C // n, 3 * C // n):
            want = jbal.balanced_splits(counts, n, c_cap)
            got = balance.balanced_splits(counts, n, c_cap)
            assert np.array_equal(got, want)
            assert balance.balance_factor(counts, got) == jbal.balance_factor(counts, want)


def test_scene_splits_equal_the_reference():
    """On the reference's scene: cell counts, splits and factors equal, the
    starts those of the reference's test, distribute / collect round-trips
    bit for bit and equals the reference's distribute."""
    ref = jb.dam_break_2d(n_target=1200)
    g = ref.bgrid
    b = ref.binned_state()
    want_counts = np.asarray(jbal.cell_counts(g, b))
    tb = convert.binned_state(jax_fields(b), device="cpu")
    tg = convert.binned_grid(dataclasses.asdict(g))
    counts = balance.cell_counts(tg, tb).numpy()
    assert np.array_equal(counts, want_counts)
    c_cap = _c_cap(g)
    starts = balance.balanced_splits(counts, N_DEV, c_cap)
    assert starts.tolist() == [0, 184, 256, 357, 431, 529, 602, 1061, 1225]
    assert np.array_equal(starts, jbal.balanced_splits(want_counts, N_DEV, c_cap))
    stacked = balance.distribute(tg, tb.pos, starts, c_cap)
    assert np.array_equal(stacked.numpy(), np.asarray(jbal.distribute(g, b.pos, starts, c_cap)))
    assert torch.equal(balance.collect(tg, stacked, starts), tb.pos)
    fresh, bf, changed = balance.rebalance_splits(tg, tb, N_DEV, c_cap)
    assert changed and np.array_equal(fresh, starts) and bf < 1.7
    kept, _, changed = balance.rebalance_splits(tg, tb, N_DEV, c_cap, current=starts)
    assert not changed and kept is starts


def test_16m_budget_fits_one_h100_each():
    got = balance.hbm_budget_bytes(16_000_000)
    assert got["fits"] and got["h100_hbm_gb"] == 80.0
    assert got["bytes_per_slot"] == (3 * 3 + 6) * 4 + 5


@pytest.fixture(scope="module")
def runs(mesh):
    """The reference's scene: its single-device and balanced steps, and the
    port's balanced step, 1 and 5 steps."""
    ref = jb.dam_break_2d(n_target=1200)
    g = dataclasses.replace(ref.bgrid, symmetric_fold=False)
    b0 = ref.binned_state()
    counts = np.asarray(jax.device_get(jbal.cell_counts(g, b0)))
    starts = jbal.balanced_splits(counts, N_DEV, _c_cap(g))
    jmesh = jax.sharding.Mesh(jax.devices()[:N_DEV], ("x",))
    init, step, finish = jbal.make_balanced_step(jmesh, ref.params, g, _c_cap(g))
    scene = convert.scene(ref, device="cpu")
    tinit, tstep, tfinish = balance.make_balanced_step(mesh, scene.params, scene.bgrid, _c_cap(g))
    out = {}
    for n in (1, STEPS):
        out[("jax single", n)] = jax_fields(jw.simulate(ref.params, g, b0, n))
        bs = init(b0, starts)
        for _ in range(n):
            bs = step(bs)
        out[("jax balanced", n)] = jax_fields(finish(bs, b0))
        tb0 = scene.binned_state()
        ts = tinit(tb0, starts)
        for _ in range(n):
            ts = tstep(ts)
        out[("port balanced", n)] = convert.to_numpy(tfinish(ts, tb0))
    out["starts"], out["cap"], out["halo"] = starts, g.cap, jnb.halo_cells(g)
    return out


@pytest.mark.parametrize("n", [1, STEPS])
def test_balanced_density_matches_single_device(runs, n):
    """The port's balanced step gives the single-device density and
    positions on the reference's scene."""
    want, got = runs[("jax single", n)], runs[("port balanced", n)]
    v = want["valid"]
    np.testing.assert_allclose(got["density"][v], want["density"][v], rtol=DENSITY_RTOL)
    np.testing.assert_allclose(got["pos"][v], want["pos"][v], rtol=0, atol=POS_ATOL)


def test_reference_balanced_step_misses_shard_edges(runs):
    """The reference's balanced step appends each shard's hi halo after all
    ``c_cap`` cells of its room, not after its last cell
    (``neighbors/binned.py:761, 775-783``), so the particles of the last
    ``halo_cells`` cells of a shard lose their right neighbours: > 30% off
    in density after one step, all of them there. Its positions, from rest,
    stay within the test's bar."""
    want, bad = runs[("jax single", 1)], runs[("jax balanced", 1)]
    v = want["valid"]
    rel = np.abs(bad["density"] - want["density"]) / np.maximum(want["density"], 1e-30)
    assert rel[v].max() > 0.3
    cap, hc, starts = runs["cap"], runs["halo"], runs["starts"]
    cell = np.arange(v.shape[0]) // cap
    edge = np.zeros_like(v)
    for d in range(N_DEV - 1):
        edge |= (cell >= starts[d + 1] - hc) & (cell < starts[d + 1])
    off = v & (rel > 1e-3)
    assert off.any() and not (off & ~edge).any()
    np.testing.assert_allclose(runs[("jax balanced", STEPS)]["pos"][v],
                               runs[("jax single", STEPS)]["pos"][v], atol=POS_ATOL)


def test_balanced_frozen_walls_stay_still(mesh):
    """Frozen boundary particles: the balanced step holds them as the
    single-device step does (the reference's balanced step masks with
    ``valid`` alone)."""
    from sph_pie_torch.scenes import builders
    from sph_pie_torch.solvers import wcsph_binned as tw

    scene = builders.dam_break_2d(400, wall_layers=2, device="cpu")
    g, b0 = scene.bgrid, scene.binned_state()
    counts = balance.cell_counts(g, b0).numpy()
    starts = balance.balanced_splits(counts, N_DEV, _c_cap(g))
    init, step, finish = balance.make_balanced_step(mesh, scene.params, g, _c_cap(g))
    bs = init(b0, starts)
    for _ in range(STEPS):
        bs = step(bs)
    got = finish(bs, b0)
    want = tw.simulate(scene.params, g, b0, STEPS)
    frozen = tnb.frozen_mask(g, b0)
    assert bool(frozen.any()) and torch.equal(got.pos[frozen], b0.pos[frozen])
    assert torch.equal(got.pos, want.pos) and torch.equal(got.density, want.density)


def test_balanced_periodic_3d_matches_reference(mesh):
    """Balanced splits and a periodic y axis in 3D at 20k (the reference's
    test): 3 steps against the reference's single-device periodic step, in
    owner order, and its seam carries pairs."""
    ref = jb.dam_break_3d_periodic(20_000)
    g = ref.bgrid
    b0 = jnb.bin_state(g, ref.state)
    want = jnb.unbin(g, jw.simulate(ref.params, g, b0, 3), ref.state.capacity)
    want = jax_fields(want)
    scene = convert.scene(ref, device="cpu")
    tg, tb0 = scene.bgrid, tnb.bin_state(scene.bgrid, scene.state)
    starts = balance.balanced_splits(balance.cell_counts(tg, tb0).numpy(), N_DEV, _c_cap(g))
    assert balance.balance_factor(balance.cell_counts(tg, tb0).numpy(), starts) < 1.7
    init, step, finish = balance.make_balanced_step(mesh, scene.params, tg, _c_cap(g))
    bs = init(tb0, starts)
    for _ in range(3):
        bs = step(bs)
    got = convert.to_numpy(tnb.unbin(tg, finish(bs, tb0), scene.state.capacity))
    act = want["active"]
    assert np.array_equal(got["active"], act)
    assert act.sum() == int(scene.state.n_active())
    np.testing.assert_allclose(got["pos"][act], want["pos"][act], atol=POS_ATOL)
    p, ly, h = want["pos"][act], g.dims[1] * g.cell_size, g.cell_size - g.skin
    assert (p[:, 1] < h).any() and (p[:, 1] > ly - h).any()


def test_thin_shards_take_margins_from_beyond_their_neighbour(mesh):
    """A split whose middle shards are thinner than the halo: their
    neighbours' margins reach the shards beyond, and the step is still the
    single-device step, bit for bit."""
    from sph_pie_torch.scenes import builders
    from sph_pie_torch.solvers import wcsph_binned as tw

    scene = builders.dam_break_2d(1024, viscosity=0.05, device="cpu")
    g, b0 = scene.bgrid, scene.binned_state()
    hc, C = tnb.halo_cells(g), g.num_cells
    widths = [hc // 3, hc // 2, hc // 4, 1, hc // 2, hc // 3, hc]
    starts = np.concatenate([[0], np.cumsum(widths + [C - sum(widths)])])
    assert starts[-1] == C and min(widths) < hc
    init, step, finish = balance.make_balanced_step(mesh, scene.params, g, C)
    bs = init(b0, starts)
    for _ in range(3):
        bs = step(bs)
    got, want = finish(bs, b0), tw.simulate(scene.params, g, b0, 3)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.density, want.density)


def test_gloo_group_matches_in_process_mesh(tmp_path):
    """4 gloo ranks, one balanced shard each, 5 steps: the same bits as the
    in-process mesh of 4 shards."""
    world = 4
    mp.start_processes(
        _torch_gloo.worker,
        args=(world, str(tmp_path / "store"), str(tmp_path), "balanced", 5, 1024),
        nprocs=world, start_method="spawn", join=True,
    )
    got = {}
    for r in range(world):
        got.update(torch.load(tmp_path / f"rank{r}.pt"))
    scene = _torch_gloo.padded_scene(1024, world, viscosity=0.05)
    want = _torch_gloo.run("balanced", comm.make_mesh(world, device="cpu"), scene, 5)
    assert got.keys() == want.keys()
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


def test_padded_grid_divides():
    g = jb.dam_break_2d(n_target=300).bgrid
    assert dryrun.padded_grid(g, 8).num_cells % 8 == 0
