"""Port vs reference: the plain forces (blocked slab fold) against the
reference fold ``wcsph_binned._forces``, on states the reference advanced
10 steps with density and pressure set, compared on valid slots. Both
scenes have cohesion and XSPH on, so every pair term is exercised.

Tolerance, scale-normalised (max |diff| / max |ref|): 1e-10 in 2D float64
(summation order only), 2e-5 in 3D float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_inputs, scaled_err
from sph_pie_torch.neighbors.forces import forces, forces_plain
from sph_pie_tpu.kernels import eos as jeos
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw
from sph_pie_tpu.utils.struct import replace as jreplace

CASES = {
    "2d_f64": ("dam_break_2d", 400, True, 1e-10, {"surface_tension": 0.25, "xsph_eps": 0.1}),
    "3d_f32": ("dam_break_3d", 1500, False, 2e-5, {}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def advanced(request):
    """(case, reference (acc, xsph), port inputs)."""
    make, n, f64, _, kw = CASES[request.param]
    with jax.enable_x64(f64):
        scene = getattr(jb, make)(n, dtype=jnp.float64 if f64 else jnp.float32, **kw)
        b = jw.simulate(scene.params, scene.bgrid, scene.binned_state(), 10)
        rho = jw._density(scene.params, scene.bgrid, b)
        b = jreplace(b, density=rho, pressure=jeos.tait_pressure(scene.params, rho))
        acc, xsph = jw._forces(scene.params, scene.bgrid, b)
    return request.param, (np.asarray(acc), np.asarray(xsph)), port_inputs(scene, b)


def test_forces_plain_matches_fold(advanced):
    case, (acc, xsph), (params, grid, b) = advanced
    assert params.use_cohesion and params.use_xsph
    got_acc, got_xsph = forces_plain(params, grid, b)
    valid = b.valid.numpy()
    tol = CASES[case][3]
    assert np.abs(xsph[valid]).max() > 0
    assert scaled_err(got_acc.numpy()[valid], acc[valid]) < tol
    assert scaled_err(got_xsph.numpy()[valid], xsph[valid]) < tol
    # empty slots carry no force
    assert not got_acc.numpy()[~valid].any() and not got_xsph.numpy()[~valid].any()


def test_forces_wrapper_on_cpu_is_the_plain_version(advanced):
    _, _, (params, grid, b) = advanced
    launches = forces.launches
    a1, x1 = forces(params, grid, b)
    a2, x2 = forces_plain(params, grid, b)
    assert torch.equal(a1, a2) and torch.equal(x1, x2)
    assert forces.launches == launches


def test_forces_rejects_devices_without_kernel(advanced):
    _, _, (params, grid, b) = advanced
    meta = type(b)(**{k: v.to("meta") for k, v in vars(b).items()})
    with pytest.raises(ValueError, match="no kernel"):
        forces(params, grid, meta)
