"""Port vs reference: binned grid geometry, binning, rebin, unbin, the
plain ``expand`` and slab windows. Everything here is integer or copy
arithmetic, so every comparison is exact."""

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import jax_fields, port_inputs
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.neighbors.expand import expand, expand_plain
from sph_pie_torch.scenes import builders as tb
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.utils.struct import replace as jreplace

SCENES = {
    "2d_400": ("dam_break_2d", 400, {}),
    "3d_1500": ("dam_break_3d", 1500, {}),
    "2d_400_bcap8": ("dam_break_2d", 400, {"bcap": 8}),
    "2d_400_walls": ("dam_break_2d", 400, {"wall_layers": 2}),
}


@pytest.fixture(scope="module")
def scenes():
    """name -> (reference scene, port scene, reference binned state)."""
    out = {}
    for name, (make, n, kw) in SCENES.items():
        js = getattr(jb, make)(n, **kw)
        out[name] = (js, getattr(tb, make)(n, device="cpu", **kw), js.binned_state())
    return out


def _assert_state_equal(want_b, got_b):
    want, got = jax_fields(want_b), convert.to_numpy(got_b)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", [400, 1500, 1_000_000], ids=["2d_400", "3d_1500", "3d_1M"])
def test_grid_geometry_matches(n):
    make = "dam_break_2d" if n == 400 else "dam_break_3d"
    js, ts = getattr(jb, make)(n), getattr(tb, make)(n, device="cpu")
    jg, tg = js.bgrid, ts.bgrid
    assert tg == convert.binned_grid(dataclasses.asdict(jg))
    for f in dataclasses.fields(tg):
        assert getattr(tg, f.name) == getattr(jg, f.name), f.name
    assert tg.strides == jg.strides
    assert tg.slab_shifts() == jg.slab_shifts()
    assert (tg.num_cells, tg.num_slots) == (jg.num_cells, jg.num_slots)
    assert ts.gspec == type(ts.gspec)(**dataclasses.asdict(js.gspec))
    np.testing.assert_array_equal(ts.state.pos.numpy(), np.asarray(js.state.pos))
    if n == 1_000_000:  # the flagship geometry
        assert int(ts.state.n_active()) == 995_328
        assert tg.dims == (69, 90, 39) and tg.num_cells == 267_812
        assert (tg.cap, tg.num_slots, tg.block_cells) == (40, 10_712_480, 256)


@pytest.mark.parametrize("name", ["2d_400", "3d_1500", "2d_400_walls"])
def test_bin_state_exact(scenes, name):
    js, ts, jbs = scenes[name]
    _assert_state_equal(jbs, ts.binned_state())


def test_bin_state_overflow_exact(scenes):
    """An overfull cell keeps its first cap rows by owner order (stable
    sort): the same owners are dropped, and the same count."""
    js, ts, jbs = scenes["2d_400_bcap8"]
    tbs = ts.binned_state()
    _assert_state_equal(jbs, tbs)
    assert int(tbs.overflow) == 12
    dropped = np.flatnonzero(tbs.slot_of.numpy() == ts.bgrid.num_slots)
    assert len(dropped) == 12


@pytest.mark.parametrize("name", ["2d_400", "3d_1500"])
def test_rebin_after_nudge_exact(scenes, name):
    js, _, jbs = scenes[name]
    rng = np.random.default_rng(3)
    valid = np.asarray(jbs.valid)[:, None]
    noise = rng.uniform(-1.0, 1.0, jbs.pos.shape) * 0.4 * js.bgrid.skin * valid
    pos = (np.asarray(jbs.pos) + noise).astype(np.asarray(jbs.pos).dtype)
    jn = jreplace(jbs, pos=jnp.asarray(pos))
    _, grid, tn = port_inputs(js, jn)
    want, got = jnb.rebin(js.bgrid, jn), tnb.rebin(grid, tn)
    _assert_state_equal(want, got)
    assert int(got.n_rebins) == 1


def test_frozen_boundary_rows(scenes):
    """Wall ghosts ride the binning as trailing rows and are frozen."""
    js, ts, jbs = scenes["2d_400_walls"]
    g = ts.bgrid
    assert g.n_boundary == js.bgrid.n_boundary > 0
    tbs = ts.binned_state()
    frozen = tnb.frozen_mask(g, tbs)
    assert int(frozen.sum()) == g.n_boundary
    np.testing.assert_array_equal(
        frozen.numpy(), np.asarray(jnb.frozen_mask(js.bgrid, jbs))
    )


def test_unbin_round_trips(scenes):
    js, ts, jbs = scenes["3d_1500"]
    st = tnb.unbin(ts.bgrid, ts.binned_state(), ts.state.capacity)
    for k in ("pos", "vel", "mass", "active"):
        np.testing.assert_array_equal(
            getattr(st, k).numpy(), getattr(ts.state, k).numpy(), err_msg=k
        )
    want = jnb.unbin(js.bgrid, jbs, js.state.capacity)
    for k, v in jax_fields(want).items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), v, err_msg=k)


def test_expand_plain_matches_pallas_interpret(monkeypatch):
    """Inputs of tests/test_pallas_rebin.py, reference kernel in interpret
    mode; owners ride alongside as arange(K)."""
    from sph_pie_tpu.neighbors import pallas_rebin

    monkeypatch.setattr(pl, "pallas_call", partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(7)
    num_cells, cap, ncol = 900, 16, 8
    counts = rng.integers(0, cap + 1, num_cells).astype(np.int32)
    overflow_cells = rng.choice(num_cells, 6, replace=False)
    counts[overflow_cells] = cap + rng.integers(1, 8, 6)
    first = np.concatenate([[0], np.cumsum(counts)])[:-1].astype(np.int32)
    K = int(counts.sum())
    rows = rng.normal(size=(K, ncol)).astype(np.float32)

    want = np.asarray(
        pallas_rebin.expand(
            jnp.asarray(first), jnp.asarray(counts), jnp.asarray(rows), cap
        )
    )
    owner = torch.arange(K, dtype=torch.int32)
    args = (torch.tensor(first), torch.tensor(counts), torch.tensor(rows), owner, cap)
    dense, own = expand_plain(*args)
    np.testing.assert_array_equal(dense.numpy(), want)
    ref_own = np.full((num_cells, cap), -1, np.int32)
    for c in range(num_cells):
        n = min(int(counts[c]), cap)
        ref_own[c, :n] = np.arange(first[c], first[c] + n)
    np.testing.assert_array_equal(own.numpy(), ref_own.reshape(-1))
    # the CPU wrapper is the plain version, and launches nothing
    launches = expand.launches
    d2, o2 = expand(*args)
    assert torch.equal(d2, dense) and torch.equal(o2, own)
    assert expand.launches == launches


def test_expand_rejects_devices_without_kernel():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        expand(z, z, torch.zeros((4, 3), device="meta"), z, 8)


def test_slab_windows_match(scenes):
    js, ts, jbs = scenes["2d_400"]
    tbs = ts.binned_state()
    for x_j, x_t in [(jbs.pos, tbs.pos), (jbs.mass, tbs.mass)]:
        want = jnb.slab_windows(js.bgrid, x_j)
        got = tnb.slab_windows(ts.bgrid, x_t)
        assert len(got) == len(want) == 3
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_particle_state_converts_and_casts(scenes):
    """convert.particle_state carries the reference state exactly, and
    astype matches the reference's cast (active stays bool)."""
    from sph_pie_torch.core.state import astype as t_astype
    from sph_pie_tpu.core.state import astype as j_astype

    js, ts, _ = scenes["3d_1500"]
    st = convert.particle_state(jax_fields(js.state), device="cpu")
    for k, v in jax_fields(js.state).items():
        np.testing.assert_array_equal(getattr(st, k).numpy(), v, err_msg=k)
        np.testing.assert_array_equal(getattr(ts.state, k).numpy(), v, err_msg=k)
    want = jax_fields(j_astype(js.state, jnp.float16))
    got = convert.to_numpy(t_astype(st, torch.float16))
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_convert_round_trips(scenes):
    js, _, jbs = scenes["3d_1500"]
    fields = jax_fields(jbs)
    back = convert.to_numpy(convert.binned_state(fields, device="cpu"))
    for k, v in fields.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    pf = convert.to_numpy(convert.fluid_params(jax_fields(js.params), device="cpu"))
    for k, v in jax_fields(js.params).items():
        np.testing.assert_array_equal(pf[k], v, err_msg=k)
