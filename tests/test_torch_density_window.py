"""Port vs reference: the two drop-in density kernels.

  * ``density_cap32_plain`` against ``pallas_pair.density_pallas`` (interpret
    mode) on the scenes of ``tests/test_pallas_pair.py`` advanced 10 steps:
    rtol 3e-6 on valid slots (float32, summation order only), the floor on
    the others;
  * ``density_window_plain`` against ``pallas_density.density_pallas``
    (interpret mode) on the scenes of ``tests/test_pallas_density.py`` at bin
    time, on ALL slots: that kernel has no valid mask, so empty slots at
    pos 0 keep the density their window gives the origin. rtol 3e-6. Also
    with some empty slots moved to positions of their own inside the fluid:
    an empty slot keeps the density of wherever it is stored, which is the
    rule the CUDA kernel's shared home records must respect.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_inputs
from sph_pie_torch.neighbors.density_window import (
    density_cap32,
    density_cap32_plain,
    density_window,
    density_window_plain,
)
from sph_pie_tpu.neighbors import pallas_density, pallas_pair
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw
from sph_pie_tpu.utils import struct

RTOL = 3e-6
CAP32 = {"2d": ("dam_break_2d", 700, {}), "3d": ("dam_break_3d", 1500, {"skin_frac": 0.25})}
WINDOW = {"2d": ("dam_break_2d", 400), "3d": ("dam_break_3d", 1500)}


@pytest.fixture(scope="module", params=sorted(CAP32))
def cap32(request):
    """(reference density, port inputs) on a cap-32 scene after 10 steps."""
    make, n, kw = CAP32[request.param]
    scene = getattr(jb, make)(n, **kw)
    assert scene.bgrid.cap == 32
    b = jw.simulate(scene.params, scene.bgrid, scene.binned_state(), 10)
    rho = np.asarray(pallas_pair.density_pallas(scene.params, scene.bgrid, b, interpret=True))
    return rho, port_inputs(scene, b)


@pytest.fixture(scope="module", params=sorted(WINDOW))
def window(request):
    """(reference density, port inputs) on a scene at bin time."""
    make, n = WINDOW[request.param]
    scene = getattr(jb, make)(n)
    b = scene.binned_state()
    rho = np.asarray(pallas_density.density_pallas(scene.params, scene.bgrid, b, interpret=True))
    return rho, port_inputs(scene, b)


def test_density_cap32_plain_matches_pallas_pair(cap32):
    want, (params, grid, b) = cap32
    got = density_cap32_plain(params, grid, b).numpy()
    valid = b.valid.numpy()
    assert valid.any() and (~valid).any()
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL)
    floor = np.float32(1e-6) * params.rest_density.numpy()
    np.testing.assert_allclose(got[~valid], floor, rtol=1e-6)


def test_density_window_plain_matches_pallas_density_on_every_slot(window):
    want, (params, grid, b) = window
    got = density_window_plain(params, grid, b).numpy()
    floor = 1e-6 * float(params.rest_density)
    # the unmasked rule is exercised: some empty slots sit above the floor
    assert (want[~b.valid.numpy()] > 1.5 * floor).any()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("dim", sorted(WINDOW))
def test_density_window_plain_matches_pallas_density_with_moved_empty_slots(dim):
    make, n = WINDOW[dim]
    scene = getattr(jb, make)(n)
    b = scene.binned_state()
    cap, d = scene.bgrid.cap, scene.bgrid.dim
    pos, mass = np.array(b.pos), np.asarray(b.mass)
    occ = (mass.reshape(-1, cap) != 0).sum(1)
    cells = np.flatnonzero((occ > 0) & (occ < cap - 2))[::3]
    real, empty = cells * cap, cells * cap + occ[cells]
    assert len(cells) > 10 and not mass[empty].any() and mass[real].all()
    rng = np.random.default_rng(2)
    h = float(scene.params.h)
    # distinct positions within h of a particle of the cell; one shared by two
    # empty slots of a cell; one that is a particle's own position
    pos[empty] = pos[real] + rng.uniform(-0.4, 0.4, (len(cells), d)).astype(np.float32) * h
    pos[empty + 1] = pos[empty]
    pos[empty + 2] = pos[real]
    b = struct.replace(b, pos=jnp.asarray(pos))
    want = np.asarray(pallas_density.density_pallas(scene.params, scene.bgrid, b, interpret=True))
    params, grid, tb = port_inputs(scene, b)
    got = density_window_plain(params, grid, tb).numpy()
    floor = 1e-6 * float(params.rest_density)
    moved = np.concatenate([empty, empty + 1, empty + 2])
    assert (want[moved] > 100 * floor).all()
    np.testing.assert_array_equal(got[empty], got[empty + 1])
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _wrapper_is_plain(wrapper, plain, params, grid, b):
    launches = wrapper.launches
    assert torch.equal(wrapper(params, grid, b), plain(params, grid, b))
    assert wrapper.launches == launches


def test_density_cap32_on_cpu_is_the_plain_version(cap32):
    _wrapper_is_plain(density_cap32, density_cap32_plain, *cap32[1])


def test_density_window_on_cpu_is_the_plain_version(window):
    _wrapper_is_plain(density_window, density_window_plain, *window[1])


@pytest.mark.parametrize("wrapper", [density_cap32, density_window])
def test_density_wrappers_reject_devices_without_kernel(wrapper, cap32):
    _, (params, grid, b) = cap32
    meta = type(b)(**{k: v.to("meta") for k, v in vars(b).items()})
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(params, grid, meta)


def test_density_cap32_rejects_other_caps():
    scene = jb.dam_break_3d(1500)  # the flagship geometry: cap 40
    params, grid, b = port_inputs(scene, scene.binned_state())
    assert grid.cap == 40
    for fn in (density_cap32, density_cap32_plain):
        with pytest.raises(ValueError, match="cap == 32"):
            fn(params, grid, b)


def test_density_window_kernels_take_float32_only():
    scene = jb.dam_break_2d(400)
    params, grid, b = port_inputs(scene, scene.binned_state())
    b64 = type(b)(**{
        k: v.double() if v.is_floating_point() else v for k, v in vars(b).items()
    })
    for fn in (density_cap32, density_window):
        with pytest.raises(TypeError, match="float32"):
            fn(params, grid, b64)
