"""Port vs reference: the naive gather engine (``neighbors/grid.py`` cell
list, ``solvers/wcsph.py`` step).

The cell list and its candidate windows are integer arithmetic, held
exactly. The float64 density, step, roll and trajectory are held within
1e-9 of ``sph_pie_tpu.solvers.wcsph`` (summation order only), and the
port's roll against the O(N^2) oracle as ``tests/test_wcsph.py`` holds the
reference: 1e-6 in float64, 1e-3 in float32, 400 particles, 100 steps.
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
from sph_pie_torch.neighbors import grid as tg
from sph_pie_torch.solvers import wcsph as tw
from sph_pie_tpu.neighbors import grid as jg
from sph_pie_tpu.oracle import oracle_from_scene
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.scenes import obstacles as jobs
from sph_pie_tpu.solvers import wcsph as jw
from sph_pie_tpu.utils.struct import replace as jreplace

TOL = 1e-9  # float64, port vs reference (summation order only)
SPHERE = ([0.5, 0.3], 0.1)


@functools.cache
def _scene(dim: int, f64: bool):
    """The reference's small dam break: 400 particles in 2D as
    ``tests/test_wcsph.py``, 1500 in 3D."""
    dt = jnp.float64 if f64 else jnp.float32
    if dim == 2:
        return jb.dam_break_2d(n_target=400, dtype=dt, viscosity=0.05)
    return jb.dam_break_3d(n_target=1500, dtype=dt)


def _ragged(scene):
    """The scene's state with every fifth row inactive and the lattice
    jittered by up to 0.3 h, so cells hold ragged counts."""
    rng = np.random.default_rng(1)
    pos = np.asarray(scene.state.pos)
    h = float(scene.params.h)
    pos = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(pos.dtype) * h
    active = np.asarray(scene.state.active) & (np.arange(len(pos)) % 5 != 0)
    return jreplace(scene.state, pos=jnp.asarray(pos), active=jnp.asarray(active))


def _port(scene, state):
    return (
        convert.fluid_params(jax_fields(scene.params), device="cpu"),
        tg.GridSpec(**dataclasses.asdict(scene.gspec)),
        convert.particle_state(jax_fields(state), device="cpu"),
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_build_matches_reference(dim):
    """order (the stable sort), starts, ends and coords, exactly."""
    scene = _scene(dim, False)
    st = _ragged(scene)
    _, gspec, tst = _port(scene, st)
    want = jg.build(scene.gspec, st.pos, st.active)
    got = tg.build(gspec, tst.pos, tst.active)
    for k in ("order", "starts", "ends", "coords"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        assert g.dtype == w.dtype == np.int32, k
        assert np.array_equal(g, w), k
    assert int(tg.max_cell_occupancy(gspec, got)) == int(jg.max_cell_occupancy(scene.gspec, want))
    assert np.array_equal(tg.cell_coords(gspec, tst.pos).numpy(),
                          np.asarray(jg.cell_coords(scene.gspec, st.pos)))


@pytest.mark.parametrize("dim", [2, 3])
def test_neighbor_fold_candidates_match_reference(dim):
    """The [N, cap] candidates and their masks of every offset, in the
    reference's offset order."""
    scene = _scene(dim, False)
    st = _ragged(scene)
    _, gspec, tst = _port(scene, st)

    def record(carry, j, valid):
        return carry + [(j.numpy(), valid.numpy())]

    # The reference folds under lax.scan: its candidates of each offset are
    # stacked into the carry.
    n, cap = st.capacity, scene.gspec.cap
    n_off = 3**dim

    def stack(carry, j, valid):
        k, js, vs = carry
        return k + 1, js.at[k].set(j), vs.at[k].set(valid)

    init = (0, jnp.zeros((n_off, n, cap), jnp.int32), jnp.zeros((n_off, n, cap), bool))
    _, js, vs = jg.neighbor_fold(scene.gspec, jg.build(scene.gspec, st.pos, st.active),
                                 stack, init)
    got = tg.neighbor_fold(gspec, tg.build(gspec, tst.pos, tst.active), record, [])
    assert len(got) == n_off
    for k, (j, v) in enumerate(got):
        assert np.array_equal(v, np.asarray(vs[k])), k
        assert np.array_equal(j, np.asarray(js[k])), k
    assert sum(int(v.sum()) for _, v in got) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_compute_density_matches_reference(dim):
    with jax.enable_x64(True):
        scene = _scene(dim, True)
        st = _ragged(scene)
        want = np.asarray(jw.compute_density(
            scene.params, scene.gspec, jg.build(scene.gspec, st.pos, st.active), st))
    params, gspec, tst = _port(scene, st)
    got = tw.compute_density(params, gspec, tg.build(gspec, tst.pos, tst.active), tst).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL)


def _obstacles(f64: bool):
    dt = jnp.float64 if f64 else jnp.float32
    jo = jobs.make(2, spheres=[SPHERE], dtype=dt)
    return jo, convert.obstacles(jax_fields(jo), device="cpu")


@pytest.mark.parametrize("with_obstacle", [False, True], ids=["plain", "sphere"])
def test_step_matches_reference(with_obstacle):
    """One float64 step from a ragged state, with a sphere at t = 0.3 s."""
    with jax.enable_x64(True):
        scene = _scene(2, True)
        st = _ragged(scene)
        jo, to = _obstacles(True) if with_obstacle else (None, None)
        st = jreplace(st, vel=jnp.asarray(
            np.random.default_rng(2).normal(size=st.vel.shape) * np.asarray(st.active)[:, None]))
        want = jax_fields(jw.step(scene.params, scene.gspec, st, jo, t=0.3))
    params, gspec, tst = _port(scene, st)
    got = convert.to_numpy(tw.step(params, gspec, tst, to, t=0.3))
    for k in ("pos", "vel", "density", "pressure"):
        assert np.abs(got[k] - want[k]).max() <= TOL * max(1.0, np.abs(want[k]).max()), k
    assert np.array_equal(got["active"], want["active"])


def test_simulate_matches_reference_and_oracle():
    """100 float64 steps of the 400-particle dam break (with a sphere for
    the reference comparison, ``t = i dt``); without it, the oracle
    contract of ``tests/test_wcsph.py`` (1e-6)."""
    with jax.enable_x64(True):
        scene = _scene(2, True)
        jo, to = _obstacles(True)
        want = jax_fields(jw.simulate(scene.params, scene.gspec, scene.state, 100, jo))
        oracle = oracle_from_scene(scene, dtype=np.float64).run(100)
    params, gspec, tst = _port(scene, scene.state)
    got = convert.to_numpy(tw.simulate(params, gspec, tst, 100, to))
    assert np.abs(got["pos"] - want["pos"]).max() <= TOL
    assert np.abs(got["vel"] - want["vel"]).max() <= TOL
    plain = tw.simulate(params, gspec, tst, 100)
    act = plain.active.numpy()
    assert np.abs(plain.pos.numpy()[act] - oracle).max() < 1e-6


def test_simulate_f32_tracks_oracle():
    scene = _scene(2, False)
    params, gspec, tst = _port(scene, scene.state)
    st = tw.simulate(params, gspec, tst, 100)
    oracle = oracle_from_scene(scene, dtype=np.float64).run(100)
    act = st.active.numpy()
    assert np.abs(st.pos.numpy()[act] - oracle).max() < 1e-3
    pad = 5 * float(params.h)
    pos = st.pos.numpy()[act]
    assert np.isfinite(pos).all()
    assert (pos > params.bound_min.numpy() - pad).all()
    assert (pos < params.bound_max.numpy() + pad).all()


def test_simulate_trajectory_matches_reference():
    with jax.enable_x64(True):
        scene = _scene(2, True)
        _, want = jw.simulate_trajectory(
            scene.params, scene.gspec, scene.state, n_steps=20, record_every=5)
        want = np.asarray(want)
    params, gspec, tst = _port(scene, scene.state)
    st, traj = tw.simulate_trajectory(params, gspec, tst, n_steps=20, record_every=5)
    assert traj.shape == (4, scene.state.capacity, 2) == want.shape
    assert torch.equal(traj[-1], st.pos)
    assert np.abs(traj.numpy() - want).max() <= TOL


def test_density_near_rest_at_start():
    """lattice_mass calibration: the bulk starts within 2% of rest."""
    scene = _scene(2, False)
    params, gspec, tst = _port(scene, scene.state)
    rho = tw.compute_density(params, gspec, tg.build(gspec, tst.pos, tst.active), tst)
    rho = rho.numpy()[tst.active.numpy()]
    assert abs(np.median(rho) / float(params.rest_density) - 1.0) < 0.02
