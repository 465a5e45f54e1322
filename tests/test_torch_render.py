"""Port vs reference: the splat renderer and the PNG encoder, on the CPU."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields, scaled_err
from sph_pie_torch import convert
from sph_pie_torch.render import png as tpng
from sph_pie_torch.render import splat as tsplat
from sph_pie_tpu.render import png as jpng
from sph_pie_tpu.render import splat as jsplat
from sph_pie_tpu.scenes import builders as jb

IMG_TOL = 1e-6  # float32 images, scale-normalised: summation order only


@functools.cache
def _scene(dim: int):
    """The 2D dam break at 4096 and a 3D one at 1500, 20 steps of the
    reference's WCSPH in, so the fluid has moved off the lattice."""
    from sph_pie_tpu.solvers import wcsph_binned

    s = jb.dam_break_2d(4096) if dim == 2 else jb.dam_break_3d(1500)
    b = wcsph_binned.simulate(s.params, s.bgrid, s.binned_state(), 20)
    return s, b


def _flat(dim: int):
    """(reference scene, binned state, unbinned state) and the port's."""
    from sph_pie_tpu.neighbors import binned as jnb

    s, b = _scene(dim)
    st = jnb.unbin(s.bgrid, b, s.state.capacity)
    tst = convert.particle_state(jax_fields(st), device="cpu")
    return s, b, st, tst


def _u8_close(got: torch.Tensor, want) -> None:
    """uint8 frames: equal up to one count, on all but 0.1% of pixels."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


CASES = [(2, 2), (3, 0), (3, 1), (3, 2)]  # (dim, projection axis)


@pytest.mark.parametrize("dim,axis", CASES)
@pytest.mark.parametrize("res", [(256, 256), (48, 40)], ids=["256", "48x40"])
def test_splat_and_render_u8_match_reference(dim, axis, res):
    s, _, st, tst = _flat(dim)
    keep = [a for a in range(dim) if a != axis][:2] if dim == 3 else [0, 1]
    lo, hi = np.asarray(s.params.bound_min), np.asarray(s.params.bound_max)
    # a window a little past the box on one side, so some taps fall outside
    extent = ((float(lo[keep[0]]), float(hi[keep[0]]) * 0.8),
              (float(lo[keep[1]]) - 0.05, float(hi[keep[1]])))
    args = (extent, res, axis)
    want = jsplat.splat(st.pos, st.mass, st.active, *args)
    got = tsplat.splat(tst.pos, tst.mass, tst.active, *args)
    assert got.dtype == torch.float32 and got.shape == res
    assert scaled_err(got.numpy(), want) < IMG_TOL
    gain = 1.0 / float(np.asarray(st.mass).max())
    _u8_close(tsplat.render_u8(tst.pos, tst.mass, tst.active, *args, gain=gain),
              jsplat.render_u8(st.pos, st.mass, st.active, *args, gain=gain))


@pytest.mark.parametrize("dim,axis", CASES)
@pytest.mark.parametrize("res", [(256, 256), (6, 5)], ids=["enlarge", "shrink"])
def test_splat_binned_matches_reference(dim, axis, res):
    """The frame from the binned layout, in a frame larger than the cell
    grid (bilinear) and in one smaller (antialiased)."""
    s, b = _scene(dim)
    grid = convert.binned_grid(dataclasses.asdict(s.bgrid))
    tb = convert.binned_state(jax_fields(b), device="cpu")
    proj = [d for g, d in enumerate(grid.dims) if dim == 2 or grid.axis_order[g] != axis]
    assert max(res) < min(proj) if res == (6, 5) else min(res) > max(proj)
    want = jsplat.splat_binned(s.bgrid, b, res, axis)
    got = tsplat.splat_binned(grid, tb, res, axis)
    assert got.shape == res
    assert scaled_err(got.numpy(), want) < IMG_TOL
    gain = 50.0 / float(np.asarray(want).max())
    _u8_close(tsplat.render_binned_u8(grid, tb, res, axis, gain),
              jsplat.render_binned_u8(s.bgrid, b, res, axis, gain))


@pytest.mark.parametrize("dim", [2, 3])
def test_frame_from_state_matches_reference(dim):
    s, _, st, tst = _flat(dim)
    params = convert.fluid_params(jax_fields(s.params), device="cpu")
    want = jsplat.frame_from_state(st, s.params, (64, 64))
    got = tsplat.frame_from_state(tst, params, (64, 64))
    assert got.dtype == torch.uint8 and int(got.sum()) > 0
    _u8_close(got, want)


def test_splat_binned_is_mass_per_cell_when_sizes_agree():
    """At the cell grid's own size the resize is the identity: the 2D frame
    is the per-cell mass, world-up rows first."""
    s, b = _scene(2)
    grid = convert.binned_grid(dataclasses.asdict(s.bgrid))
    tb = convert.binned_state(jax_fields(b), device="cpu")
    gy, gx = grid.dims  # gravity-first axis order: grid axis 0 is world y
    img = tsplat.splat_binned(grid, tb, (gy, gx), axis=2)
    vol = tb.mass.reshape(grid.num_cells, grid.cap).sum(1).reshape(grid.padded_dims)
    torch.testing.assert_close(img, vol[1:-1, 1:-1].flip(0), rtol=1e-6, atol=0)
    assert img.sum().item() == pytest.approx(tb.mass.sum().item(), rel=1e-6)


@pytest.mark.parametrize("source", ["random", "frame"])
def test_png_bytes_equal_reference(source):
    if source == "random":
        img = np.random.default_rng(0).integers(0, 256, (37, 53), dtype=np.uint8)
    else:
        tst = _flat(2)[3]
        img = tsplat.render_u8(tst.pos, tst.mass, tst.active, ((0, 1), (0, 1)), (96, 80),
                               gain=1.0 / tst.mass.max().item()).numpy()
    got = tpng.encode_gray_png(img)
    assert got == jpng.encode_gray_png(jnp.asarray(img))
    assert tpng.encode_gray_png(torch.from_numpy(img)) == got
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        tpng.encode_gray_png(img[None])
