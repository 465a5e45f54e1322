"""Port vs reference: periodic domains through both binned solvers.

Wrapped cell ids and the bin-time fold, the ghost wrap, the wall mask and
the periodic pair sums bit for bit or to rounding; WCSPH and PBF (both
epilogues) periodic steps in float64 within 1e-9 of the reference across
rebins and seam crossings; the seam-crossing velocity and ride == gather as
the reference's own periodic tests hold them (``tests/test_periodic.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.neighbors.density import density_plain
from sph_pie_torch.neighbors.forces import forces_plain
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import pbf as tp
from sph_pie_torch.solvers import wcsph as twc
from sph_pie_torch.solvers import wcsph_binned as tw
from sph_pie_torch.utils.struct import replace
from sph_pie_tpu.core import state as jstate
from sph_pie_tpu.core.params import make_params as jmake_params
from sph_pie_tpu.kernels import eos as jeos
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import pbf as jp
from sph_pie_tpu.solvers import wcsph as jwc
from sph_pie_tpu.solvers import wcsph_binned as jw
from sph_pie_tpu.utils.struct import replace as jreplace

H = 0.1
CELL = H * 1.25  # skin_frac 0.25
L = 8 * CELL     # 8 cells per periodic axis: the box tiles cells exactly
STEP_TOL = 1e-9  # float64 periodic steps, port vs reference (task bound)

# The reference's binning and wrap, jitted as its steps run them (eager, each
# shape compiles op by op for seconds).
_jbin = jax.jit(jnb.bin_state, static_argnums=0)
_jwrap = jax.jit(jnb.wrap_ghosts, static_argnums=0)


def _jdt(f64: bool):
    return jnp.float64 if f64 else jnp.float32


def _box(pos, vel, f64: bool, **params_kw):
    """Reference (params, grid, state) of a fully periodic 2D box."""
    n, dt = pos.shape[0], _jdt(f64)
    kw = dict(dt=1e-4, viscosity=0.05)
    kw.update(params_kw)
    params = jmake_params(dim=2, h=H, bound_min=[0, 0], bound_max=[L, L], dtype=dt, **kw)
    grid = jnb.binned_grid_from_bounds(
        [0, 0], [L, L], h=H, cap=32, skin_frac=0.25, max_particles=n,
        periodic=(True, True),
    )
    st = jstate.from_positions(jnp.asarray(pos, dt), capacity=n, mass=1.0, dtype=dt)
    return params, grid, jreplace(st, vel=jnp.asarray(vel, dt))


def _random_box(seed: int, f64: bool, drift=(0.0, 0.0), **params_kw):
    """Uniform random particles (``tests/test_periodic.py``'s setup)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, L, size=(250, 2))
    return _box(pos, np.zeros_like(pos) + drift, f64, **params_kw)


def _lattice_box(seed: int, f64: bool, drift=(0.5, 0.15)):
    """A jittered lattice that fills the box at rest density, drifting
    without gravity: smooth flow, so the two packages stay at rounding
    distance across rebins and seam crossings."""
    rng = np.random.default_rng(seed)
    dx = H / 2
    g = (np.arange(20) + 0.5) * dx
    pos = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pos = pos + rng.uniform(-0.1, 0.1, pos.shape) * dx
    vel = np.zeros_like(pos) + drift + rng.normal(0, 0.02, pos.shape)
    params, grid, st = _box(
        pos, vel, f64, dt=2.5e-3, sound_speed=10.0, gravity=[0.0, 0.0], xsph_eps=0.05,
    )
    mass = jb.lattice_mass(2, H, dx, 1000.0)
    return params, grid, jreplace(st, mass=jnp.full_like(st.mass, mass))


def _port(params, grid, st):
    return (
        convert.fluid_params(jax_fields(params), device="cpu"),
        convert.binned_grid(dataclasses.asdict(grid)),
        convert.particle_state(jax_fields(st), device="cpu"),
    )


def _assert_fields_equal(got, want, names=None):
    """Port dataclass against a reference one, exactly (values; dtypes of
    the float fields)."""
    g, w = convert.to_numpy(got), jax_fields(want)
    for k in names or w:
        assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
        if np.asarray(w[k]).dtype.kind == "f":
            assert g[k].dtype == np.asarray(w[k]).dtype, k


@functools.cache
def _channel(f64: bool):
    """The reference's periodic channel at 2000 particles."""
    return jb.dam_break_3d_periodic(2000, dtype=_jdt(f64))


def _spread(rng, grid, n, dtype):
    """Positions beyond the box on every axis: periodic axes wrap, the
    others clip."""
    lo = np.asarray(grid.origin)
    ext = np.asarray(grid.dims) * grid.cell_size
    order = grid.axis_order or tuple(range(grid.dim))
    pos_g = rng.uniform(lo - 0.9 * ext, lo + 1.9 * ext, size=(n, grid.dim))
    pos = np.empty_like(pos_g)
    pos[:, list(order)] = pos_g
    return pos.astype(dtype)


# ---------------------------------------------------------------- binning


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("where", ["box_2d", "channel_3d"])
def test_cell_ids_and_bin_time_fold_bit_for_bit(where, f64):
    rng = np.random.default_rng(3)
    with jax.enable_x64(f64):
        if where == "box_2d":
            _, jg, _ = _random_box(0, f64)
        else:
            jg = _channel(f64).bgrid
        tg = convert.binned_grid(dataclasses.asdict(jg))
        dt = np.float64 if f64 else np.float32
        n = jg.max_particles  # the scene's shapes: the reference compiles once
        pos = _spread(rng, jg, n, dt)
        valid = rng.uniform(size=n) < 0.9
        want = np.asarray(jnb._cell_ids(jg, jnp.asarray(pos), jnp.asarray(valid)))
        got = tnb._cell_ids(tg, torch.from_numpy(pos), torch.from_numpy(valid))
        assert np.array_equal(got.numpy(), want)
        assert got.dtype == torch.int32

        # The fold, against the reference's expression in _bin_rows.
        folded = tnb._fold_periodic(tg, torch.from_numpy(pos)).numpy()
        order = jg.axis_order or tuple(range(jg.dim))
        for s_axis in range(jg.dim):
            g = order.index(s_axis)
            if jg.periodic[g]:
                o, length = jg.origin[g], jg.dims[g] * jg.cell_size
                ref = np.asarray(o + jnp.mod(jnp.asarray(pos[:, s_axis]) - o, length))
                assert np.array_equal(folded[:, s_axis], ref)
                assert ((pos[:, s_axis] < o) | (pos[:, s_axis] >= o + length)).sum() > n // 4
            else:
                assert np.array_equal(folded[:, s_axis], pos[:, s_axis])

        # bin_state places the folded rows: all 13 fields bit for bit.
        st = jstate.from_positions(jnp.asarray(pos), capacity=n, mass=1.0, dtype=_jdt(f64))
        st = jreplace(st, active=jnp.asarray(valid))
        want_b = _jbin(jg, st)
        got_b = tnb.bin_state(tg, convert.particle_state(jax_fields(st), device="cpu"))
        _assert_fields_equal(got_b, want_b, [f.name for f in dataclasses.fields(got_b)
                                             if f.name != "overflow"])
        assert int(got_b.overflow) == int(want_b.overflow)


def _binned_pair(where: str, f64: bool, seed: int = 4):
    """(reference grid, reference binned state, port grid, port binned
    state) with random velocities and densities on the valid slots."""
    rng = np.random.default_rng(seed)
    if where == "box_2d":
        _, jg, st = _random_box(seed, f64)
    else:
        jg, st = _channel(f64).bgrid, _channel(f64).state
    jbs = _jbin(jg, st)
    v = np.asarray(jbs.valid)
    dt = np.asarray(jbs.pos).dtype
    jbs = jreplace(
        jbs,
        vel=jnp.asarray((rng.normal(size=jbs.pos.shape) * v[:, None]).astype(dt)),
        density=jnp.asarray((rng.uniform(900, 1100, v.shape) * v).astype(dt)),
    )
    tg = convert.binned_grid(dataclasses.asdict(jg))
    return jg, jbs, tg, convert.binned_state(jax_fields(jbs), device="cpu")


@pytest.mark.parametrize("where,f64", [("box_2d", True), ("channel_3d", False)])
def test_wrap_ghosts_bit_for_bit(where, f64):
    """Every field of ``wrap_ghosts`` equal to the reference's; the input
    state's tensors unchanged; the ghost planes populated."""
    with jax.enable_x64(f64):
        jg, jbs, tg, tbs = _binned_pair(where, f64)
        before = {k: v.clone() for k, v in vars(tbs).items()}
        want = _jwrap(jg, jbs)
        got = tnb.wrap_ghosts(tg, tbs)
        _assert_fields_equal(got, want, [f.name for f in dataclasses.fields(got)
                                         if f.name != "overflow"])
    for k, v in vars(tbs).items():
        assert torch.equal(v, before[k]), k
    ghost = got.valid & ~tbs.valid
    assert int(ghost.sum()) > 0
    # a ghost image sits one period from its source, on one periodic axis
    src = got.owner[ghost].to(torch.int64)
    home = tbs.slot_of[src].to(torch.int64)
    d = (got.pos[ghost] - tbs.pos[home]).abs()
    period = torch.tensor([tg.dims[tg.axis_order.index(a)] * tg.cell_size
                           for a in range(tg.dim)], dtype=d.dtype)
    near = torch.isclose(d, period, rtol=1e-6) | (d == 0)
    assert bool(near.all())


def test_halo_cells_and_geometry_match():
    for jg in (_random_box(0, False)[1], _channel(False).bgrid):
        tg = convert.binned_grid(dataclasses.asdict(jg))
        assert tnb.halo_cells(tg) == jnb.halo_cells(jg)
        assert tg.periodic == jg.periodic
        assert (tg.dims, tg.padded_dims) == (jg.dims, jg.padded_dims)


@pytest.mark.parametrize(
    "walls", [None, (True, True, True), (False, True, False), (True, False, True),
              (False, False, False)],
)
def test_boundary_accel_wall_axes(walls):
    """The wall mask multiplies the penetrations before the max, as there."""
    rng = np.random.default_rng(7)
    js = _channel(False)
    params = convert.fluid_params(jax_fields(js.params), device="cpu")
    pos = rng.uniform(-0.05, 1.05, size=(500, 3)).astype(np.float32)
    vel = rng.normal(size=(500, 3)).astype(np.float32)
    want = jwc.boundary_accel(js.params, jnp.asarray(pos), jnp.asarray(vel), walls)
    got = twc.boundary_accel(params, torch.from_numpy(pos), torch.from_numpy(vel), walls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wall_axes_in_spatial_order():
    """wall_axes follows the grid's axis order back to spatial axes."""
    g = tnb.BinnedGrid(dims=(4, 5, 6), origin=(0.0,) * 3, cell_size=1.0, cap=4,
                       skin=0.1, axis_order=(2, 0, 1), periodic=(False, True, False))
    assert tw.wall_axes(g) == (False, True, True)  # grid axis 1 is spatial x
    assert tw.wall_axes(dataclasses.replace(g, periodic=())) is None


# ---------------------------------------------------------------- pair sums


def test_periodic_density_matches_min_image():
    """As ``tests/test_periodic.py``: the density after ``wrap_ghosts``
    against a brute-force minimum-image sum (float32, rtol 2e-5)."""
    params, jg, st = _random_box(0, False)
    tparams, tg, tst = _port(params, jg, st)
    b = tnb.wrap_ghosts(tg, tnb.bin_state(tg, tst))
    rho = density_plain(tparams, tg, b).numpy()
    pos = tst.pos.numpy().astype(np.float64)
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d**2).sum(-1)
    w = np.where(r2 < H * H, (4.0 / (np.pi * H**8)) * (H * H - r2) ** 3, 0.0)
    got = rho[b.slot_of.numpy().astype(np.int64)]
    np.testing.assert_allclose(got, w.sum(1), rtol=2e-5)


@pytest.mark.parametrize("where", ["box_2d", "channel_3d"])
def test_periodic_pair_sums_match_reference_on_every_slot(where):
    """Density and forces of the plain versions on a state with populated
    ghost planes, on every valid slot, ghosts included (float64, 1e-12
    relative / scale-normalised)."""
    with jax.enable_x64(True):
        jg, jbs, tg, tbs = _binned_pair(where, True)
        params = (_random_box(0, True)[0] if where == "box_2d" else _channel(True).params)
        jbs = _jwrap(jg, jbs)
        rho_w = np.asarray(jw._density(params, jg, jbs))
        jbs = jreplace(jbs, density=jnp.asarray(rho_w),
                       pressure=jeos.tait_pressure(params, jnp.asarray(rho_w)))
        acc_w, xsph_w = (np.asarray(a) for a in jw._forces(params, jg, jbs))
    tparams = convert.fluid_params(jax_fields(params), device="cpu")
    interior = tbs.valid.numpy()
    tbs = tnb.wrap_ghosts(tg, tbs)
    v = tbs.valid.numpy()
    assert (v & ~interior).sum() > 0  # ghost slots are held too
    rho = density_plain(tparams, tg, tbs).numpy()
    np.testing.assert_allclose(rho[v], rho_w[v], rtol=1e-12)
    tbs = replace(tbs, density=torch.tensor(rho_w),
                  pressure=torch.tensor(np.asarray(jbs.pressure)))
    acc, xsph = (a.numpy() for a in forces_plain(tparams, tg, tbs))
    for got, want in ((acc, acc_w), (xsph, xsph_w)):
        assert np.abs(got[v] - want[v]).max() <= 1e-12 * np.abs(want[v]).max()


# ---------------------------------------------------------------- steps


def _crossings(x0: np.ndarray, x1: np.ndarray) -> int:
    """Particles whose unbinned position left the box or was folded."""
    return int(((x1 < 0) | (x1 >= L) | (np.abs(x1 - x0) > L / 2)).any(1).sum())


def _roll(jstep, tstep, params, jg, st, steps):
    """``steps`` steps of both packages from one state; returns the two
    final unbinned states as numpy and the two binned states."""
    tparams, tg, tst = _port(params, jg, st)
    jbs, tbs = _jbin(jg, st), tnb.bin_state(tg, tst)
    for _ in range(steps):
        jbs = jstep(params, jg, jbs)
        tbs = tstep(tparams, tg, tbs)
    n = st.capacity
    return (jax_fields(jnb.unbin(jg, jbs, n)), convert.to_numpy(tnb.unbin(tg, tbs, n)),
            jbs, tbs)


def _assert_step_parity(want, got, jbs, tbs, x0):
    assert int(tbs.n_rebins) == int(jbs.n_rebins) >= 1
    assert int(tbs.overflow) == 0
    assert np.array_equal(got["active"], want["active"])
    assert _crossings(x0, want["pos"]) >= 1
    assert np.abs(got["pos"] - want["pos"]).max() <= STEP_TOL
    assert np.abs(got["vel"] - want["vel"]).max() <= STEP_TOL


def test_wcsph_periodic_steps_match_reference():
    """60 float64 steps of the drifting lattice box: rebins, seam crossings."""
    with jax.enable_x64(True):
        params, jg, st = _lattice_box(1, True)
        want, got, jbs, tbs = _roll(jw.step, tw.step, params, jg, st, 60)
    _assert_step_parity(want, got, jbs, tbs, np.asarray(st.pos))


def test_wcsph_periodic_channel_matches_reference():
    """The 3D channel (walls on x and z, periodic y) in float64, 8 steps."""
    with jax.enable_x64(True):
        js = _channel(True)
        jbs, (tparams, tg, tbs) = _jbin(js.bgrid, js.state), _port(js.params, js.bgrid, js.state)
        tbs = tnb.bin_state(tg, tbs)
        for _ in range(8):
            jbs = jw.step(js.params, js.bgrid, jbs)
            tbs = tw.step(tparams, tg, tbs)
        n = js.state.capacity
        want = jax_fields(jnb.unbin(js.bgrid, jbs, n))
    got = convert.to_numpy(tnb.unbin(tg, tbs, n))
    assert int(tbs.n_rebins) == int(jbs.n_rebins)
    assert np.abs(got["pos"] - want["pos"]).max() <= STEP_TOL
    assert np.abs(got["vel"] - want["vel"]).max() <= STEP_TOL
    np.testing.assert_allclose(got["density"], want["density"], rtol=STEP_TOL)


@pytest.mark.parametrize("epilogue", ["gather", "ride"])
def test_pbf_periodic_steps_match_reference(epilogue):
    """30 float64 PBF steps of the drifting lattice box under each
    epilogue: mid-step rebins, seam crossings, the min-image velocity."""
    with jax.enable_x64(True):
        params, jg, st = _lattice_box(2, True)
        jpp = jp.make_pbf_params(iters=2, epilogue=epilogue, dtype=jnp.float64)
        tpp = convert.pbf_params(jax_fields(jpp), device="cpu")
        want, got, jbs, tbs = _roll(
            lambda p, g, b: jp.step(p, g, jpp, b),
            lambda p, g, b: tp.step(p, g, tpp, b),
            params, jg, st, 30,
        )
    _assert_step_parity(want, got, jbs, tbs, np.asarray(st.pos))


def test_pbf_seam_crossing_velocity_min_image():
    """The reference's seam-crossing test on the port: every step's move
    passes skin/2, so rebins fire at every check, and the drift crosses the
    seam; without the min-image fold the wrapped particles saturate the
    speed clamp backwards."""
    drift = 0.4
    params, jg, st = _random_box(11, False, drift=(drift, 0.0), dt=0.05, gravity=[0.0, 0.0])
    tparams, tg, tst = _port(params, jg, st)
    pp = tp.make_pbf_params(iters=3, device="cpu")
    b = tp.simulate(tparams, tg, pp, tnb.bin_state(tg, tst), 60)
    assert int(b.n_rebins) > 10
    out = tnb.unbin(tg, b, st.capacity)
    assert int(out.active.sum()) == st.capacity
    v = out.vel[out.active]
    assert bool(torch.isfinite(v).all())
    assert float(v.norm(dim=-1).max()) < 2.0
    assert float(v[:, 0].mean()) > 0.5 * drift


def test_pbf_periodic_ride_equals_gather():
    """The ride payloads survive the wrap: ghost slots carry unoffset
    origins and the min-image fold corrects them, as the gather stashes do
    (float32, 80 steps, atol 1e-6 as the reference's test)."""
    params, jg, st = _random_box(13, False, drift=(0.4, 0.0))
    tparams, tg, tst = _port(params, jg, st)
    outs = {}
    for mode in ("gather", "ride"):
        pp = tp.make_pbf_params(iters=2, epilogue=mode, device="cpu")
        b = tp.simulate(tparams, tg, pp, tnb.bin_state(tg, tst), 80)
        assert int(b.overflow) == 0 and int(b.n_rebins) > 5
        out = tnb.unbin(tg, b, st.capacity)
        assert int(out.active.sum()) == st.capacity
        outs[mode] = (out.pos, out.vel)
    for a, b_ in zip(outs["gather"], outs["ride"]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- scene


@pytest.mark.parametrize("n", [2000, 1_000_000])
def test_dam_break_3d_periodic_matches_reference(n):
    """The builder: grid (periodic y, snapped length), params, state; a
    reference grid converts to the same periodic, dims and padded dims."""
    ts = tb.dam_break_3d_periodic(n, device="cpu")
    js = jb.dam_break_3d_periodic(n) if n == 2000 else None
    if js is not None:
        conv = convert.binned_grid(dataclasses.asdict(js.bgrid))
        assert conv == ts.bgrid
        assert conv.periodic == js.bgrid.periodic == (False, True, False)
        assert (conv.dims, conv.padded_dims) == (js.bgrid.dims, js.bgrid.padded_dims)
        assert ts.gspec == type(ts.gspec)(**dataclasses.asdict(js.gspec))
        for k, v in jax_fields(js.params).items():
            assert np.array_equal(np.asarray(convert.to_numpy(ts.params)[k]), np.asarray(v)), k
        np.testing.assert_array_equal(ts.state.pos.numpy(), np.asarray(js.state.pos))
        np.testing.assert_array_equal(ts.state.mass.numpy(), np.asarray(js.state.mass))
    else:  # the 1M channel of chip_smoke.py Phase F1
        g = ts.bgrid
        assert g.dims == (86, 34, 65) and g.cap == 40
        assert g.padded_dims == (88, 36, 67) and g.num_slots == 8_490_240
        assert int(ts.state.n_active()) == g.max_particles == 984_960
