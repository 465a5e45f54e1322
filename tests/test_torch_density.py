"""Port vs reference: the plain density (blocked slab fold) against the
reference fold ``wcsph_binned._density``, on states the reference advanced
10 steps, compared on valid slots (the reference fold leaves empty slots
unmasked; the port masks them, as ``density_sym`` does).

Tolerance: rtol 1e-12 in 2D float64 (summation order only), 3e-6 in 3D
float32 (the bound ``tests/test_pallas_sym.py`` holds ``density_sym`` to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_inputs
from sph_pie_torch.neighbors.density import density, density_plain
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw

CASES = {"2d_f64": ("dam_break_2d", 400, True, 1e-12), "3d_f32": ("dam_break_3d", 1500, False, 3e-6)}


@pytest.fixture(scope="module", params=sorted(CASES))
def advanced(request):
    """(case, reference density on valid slots, port inputs)."""
    make, n, f64, _ = CASES[request.param]
    with jax.enable_x64(f64):
        scene = getattr(jb, make)(n, dtype=jnp.float64 if f64 else jnp.float32)
        b = jw.simulate(scene.params, scene.bgrid, scene.binned_state(), 10)
        rho = np.asarray(jw._density(scene.params, scene.bgrid, b))
    return request.param, rho, port_inputs(scene, b)


def test_density_plain_matches_fold(advanced):
    case, want, (params, grid, b) = advanced
    got = density_plain(params, grid, b).numpy()
    valid = b.valid.numpy()
    assert valid.any()
    np.testing.assert_allclose(got[valid], want[valid], rtol=CASES[case][3])
    # empty slots: masked to 0, then floored
    floor = 1e-6 * float(params.rest_density)
    np.testing.assert_allclose(got[~valid], floor, rtol=1e-6)


def test_density_wrapper_on_cpu_is_the_plain_version(advanced):
    _, _, (params, grid, b) = advanced
    launches = density.launches
    assert torch.equal(density(params, grid, b), density_plain(params, grid, b))
    assert density.launches == launches


def test_density_rejects_devices_without_kernel(advanced):
    _, _, (params, grid, b) = advanced
    meta = type(b)(**{k: v.to("meta") for k, v in vars(b).items()})
    with pytest.raises(ValueError, match="no kernel"):
        density(params, grid, meta)
