"""Port vs reference: the adaptive timestep (``solvers/adaptive.py``) on the
CPU, float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields, port_inputs
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import adaptive as tad
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import adaptive as jad


@pytest.mark.parametrize("viscosity", [0.05, 0.0])
def test_cfl_dt_matches_reference(viscosity):
    """The three limits and their minimum, on speeds and accelerations from
    rest (a_max 0) to impact, equal to the reference's up to rounding."""
    rng = np.random.default_rng(5)
    with jax.enable_x64():
        scene = jb.dam_break_2d(200, dtype=jnp.float64, viscosity=viscosity)
        params = convert.fluid_params(jax_fields(scene.params), device="cpu")
        for v, a in [(0.0, 0.0), *rng.uniform(0.0, [5.0, 1e4], (20, 2))]:
            want = float(jad.cfl_dt(scene.params, jnp.float64(v), jnp.float64(a)))
            got = float(tad.cfl_dt(params, torch.tensor(v, dtype=torch.float64),
                                   torch.tensor(a, dtype=torch.float64)))
            assert got == pytest.approx(want, rel=1e-14, abs=0.0)


def test_simulate_adaptive_matches_reference():
    """``dam_break_2d(200)`` to t_end = 40 dt_base: the same number of steps,
    the same time reached and last dt, final positions within 1e-9; dt
    shrank below the base (the acoustic limit with the fluid moving) and
    the last step was cut to the time left."""
    with jax.enable_x64():
        scene = jb.dam_break_2d(200, dtype=jnp.float64)
        b0 = scene.binned_state()
        t_end = 40 * float(scene.params.dt)
        jb_, jt, jk, jdt = jad.simulate_adaptive(scene.params, scene.bgrid, b0, t_end)
        want = jnb.unbin(scene.bgrid, jb_, scene.state.capacity)
        params, grid, tb0 = port_inputs(scene, b0)
    b, t, k, dt = tad.simulate_adaptive(params, grid, tb0, t_end)
    got = tnb.unbin(grid, b, scene.state.capacity)
    assert k == int(jk) and k > 40
    assert float(t) == pytest.approx(float(jt), rel=1e-13) and float(t) >= t_end - 1e-12
    assert float(dt) == pytest.approx(float(jdt), rel=1e-9)
    base = float(params.dt)
    assert 0.05 * base <= float(dt) < base
    act = np.asarray(want.active)
    assert np.array_equal(got.active.numpy(), act)
    assert np.abs(got.pos.numpy()[act] - np.asarray(want.pos)[act]).max() <= 1e-9
    assert int(b.overflow) == 0


def test_simulate_adaptive_stops_at_max_steps():
    s = tb.dam_break_2d(200, device="cpu")
    b, t, k, dt = tad.simulate_adaptive(s.params, s.bgrid, s.binned_state(), 1.0, max_steps=3)
    assert k == 3 and float(t) < 1.0
    assert dataclasses.is_dataclass(b) and int(b.overflow) == 0
