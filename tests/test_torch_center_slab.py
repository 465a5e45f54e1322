"""Port vs reference: the center-slab density arms of
``scripts/micro_compact.py`` (``_make_arm`` with ``_dense_kernel`` and
``_compact_kernel``, interpret mode via ``SPH_PIE_INTERPRET=1``) on a 3D
dam break of 1500 particles (cap 40) advanced 3 steps.

The inputs must equal the reference's center-slab windows exactly; each
arm's plain version must match the JAX arm to rtol 1e-5 (float32,
summation order only) at K = 32 and at K = 4, where K truncates.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_script, port_inputs
from sph_pie_torch.micro.center_slab import (
    center_slab_compact,
    center_slab_compact_plain,
    center_slab_dense,
    center_slab_dense_plain,
    center_slab_inputs,
)
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw

RTOL = 1e-5
BLKC = 16  # cells per program, the harness's default


@pytest.fixture(scope="module")
def slab():
    """(reference module, JAX arm inputs, reference windows, port grid and inputs)."""
    scene = jb.dam_break_3d(1500)
    g = scene.bgrid
    b = jw.simulate(scene.params, g, scene.binned_state(), 3)
    C, cap = g.num_cells, g.cap
    si = g.slab_shifts().index(0)
    wpos, wmass = jnb.slab_windows(g, b.pos)[si], jnb.slab_windows(g, b.mass)[si]
    hpos = b.pos.reshape(C, cap, 3)
    cp = -(-C // BLKC) * BLKC

    def pad(x, lanes):  # the harness's padding to [Cp, cap | 128]
        return jnp.zeros((cp, lanes), jnp.float32).at[:C, : x.shape[1]].set(x)

    jax_in = (
        [pad(hpos[..., a], cap) for a in range(3)]
        + [pad(b.mass.reshape(C, cap), cap)]
        + [pad(wpos[..., a], 128) for a in range(3)]
        + [pad(wmass, 128)]
    )
    ref_windows = [np.asarray(hpos[..., a]) for a in range(3)] + [
        np.asarray(b.mass.reshape(C, cap))
    ] + [np.asarray(wpos[..., a]) for a in range(3)] + [np.asarray(wmass)]
    _, grid, bt = port_inputs(scene, b)
    return load_script("micro_compact"), jax_in, ref_windows, grid, center_slab_inputs(grid, bt)


def _jax_arm(mc, grid, jax_in, K):
    h = float(grid.cell_size - grid.skin)
    h2, coeff = h * h, 315.0 / (64.0 * np.pi * h**9)
    body = (
        functools.partial(mc._dense_kernel, h2, coeff)
        if K is None
        else functools.partial(mc._compact_kernel, h2, coeff, K)
    )
    nblk = jax_in[0].shape[0] // BLKC
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPH_PIE_INTERPRET", "1")
        out = mc._make_arm(body, nblk, BLKC, grid.cap)(*jax_in)
    return np.asarray(out)[: grid.num_cells]


def test_center_slab_inputs_equal_the_reference_windows(slab):
    _, _, ref, _, inputs = slab
    assert len(inputs) == len(ref) == 8
    for got, want in zip(inputs, ref):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [None, 32, 4], ids=["dense", "compact32", "compact4"])
def test_center_slab_plain_matches_the_jax_arm(slab, K):
    mc, jax_in, _, grid, inputs = slab
    want = _jax_arm(mc, grid, jax_in, K)
    if K is None:
        got = center_slab_dense_plain(grid, inputs)
    else:
        got = center_slab_compact_plain(grid, inputs, K)
    assert want.any()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_center_slab_compact_truncates_at_small_k(slab):
    """K = 4 drops in-support candidates past the 4th: compact != dense,
    and never above it (every term is >= 0)."""
    _, _, _, grid, inputs = slab
    dense = center_slab_dense_plain(grid, inputs)
    c4 = center_slab_compact_plain(grid, inputs, 4)
    c_all = center_slab_compact_plain(grid, inputs, 3 * grid.cap)
    assert (c4 < dense * (1 - 1e-3)).any()
    assert (c4 <= dense * (1 + 1e-6)).all()
    # with K past the window every candidate is kept: compact == dense
    torch.testing.assert_close(c_all, dense, rtol=1e-6, atol=0.0)


def test_center_slab_wrappers_on_cpu_are_the_plain_versions(slab):
    _, _, _, grid, inputs = slab
    n_dense, n_compact = center_slab_dense.launches, center_slab_compact.launches
    assert torch.equal(center_slab_dense(grid, inputs), center_slab_dense_plain(grid, inputs))
    assert torch.equal(
        center_slab_compact(grid, inputs, 4), center_slab_compact_plain(grid, inputs, 4)
    )
    assert (center_slab_dense.launches, center_slab_compact.launches) == (n_dense, n_compact)


def test_center_slab_rejects_meta_devices_and_2d_grids(slab):
    _, _, _, grid, inputs = slab
    meta = tuple(t.to("meta") for t in inputs)
    with pytest.raises(ValueError, match="no kernel"):
        center_slab_dense(grid, meta)
    with pytest.raises(ValueError, match="no kernel"):
        center_slab_compact(grid, meta)
    scene = jb.dam_break_2d(400)
    _, g2, b2 = port_inputs(scene, scene.binned_state())
    with pytest.raises(ValueError, match="3D only"):
        center_slab_inputs(g2, b2)
