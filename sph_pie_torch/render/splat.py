"""Particle splatting to a framebuffer, on the particles' device.

The port of the reference's ``render/splat.py``: a float intensity image
or a tone-mapped uint8 frame; only the small image need cross to the host
(``render/png.py`` encodes it). 3D scenes are projected orthographically
along a chosen spatial axis. Row 0 of every image is the top of the window
(world "up" is the last spatial axis left).

``splat`` scatter-adds each particle's weight to its four bilinear taps:
on the card the adds are atomic, so their order, and the last bits of a
pixel, may differ between runs. ``splat_binned`` reads the binned layout
instead: a mass per cell, a sum along the projection axis, a bilinear
resize (half-pixel centres, antialiased when it shrinks, as
``jax.image.resize`` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def splat(
    pos: torch.Tensor,     # [N, dim]
    weight: torch.Tensor,  # [N] per-particle weight (mass, 1.0, speed, ...)
    active: torch.Tensor,  # [N] bool
    extent,                # ((xmin, xmax), (ymin, ymax)) world window
    resolution: tuple[int, int] = (256, 256),
    axis: int = 2,         # projection axis of 3D inputs
) -> torch.Tensor:
    """Bilinear scatter-add of particle weights onto a float32 [H, W] image;
    taps outside the image are dropped."""
    h_px, w_px = resolution
    dim, dt, dev = pos.shape[1], pos.dtype, pos.device
    xy = pos if dim == 2 else pos[:, [a for a in range(dim) if a != axis][:2]]
    (x0, x1), (y0, y1) = extent
    # Tensor divisors keep these true divisions on every device.
    fx = (xy[:, 0] - x0) / torch.tensor(x1 - x0, dtype=dt, device=dev) * (w_px - 1)
    fy = (y1 - xy[:, 1]) / torch.tensor(y1 - y0, dtype=dt, device=dev) * (h_px - 1)
    ix, iy = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - ix, fy - iy
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)

    w = torch.where(active, weight, 0.0)
    oob = h_px * w_px  # sentinel bin, cut below
    idx, val = [], []
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            gx, gy = ix + dx, iy + dy
            ok = (gx >= 0) & (gx < w_px) & (gy >= 0) & (gy < h_px)
            idx.append(torch.where(ok, gy * w_px + gx, oob))
            val.append((w * wx * wy).to(torch.float32))
    flat = torch.zeros(oob + 1, dtype=torch.float32, device=dev)
    flat.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    return flat[:oob].reshape(h_px, w_px)


def _tone_u8(img: torch.Tensor, gain) -> torch.Tensor:
    """255 (1 - exp(-gain img)), clipped, truncated to uint8."""
    tone = 1.0 - torch.exp(-gain * img)
    return torch.clamp(tone * 255.0, 0, 255).to(torch.uint8)


def render_u8(
    pos, weight, active, extent, resolution=(256, 256), axis: int = 2, gain=1.0
) -> torch.Tensor:
    """Tone-mapped uint8 frame of ``splat``."""
    return _tone_u8(splat(pos, weight, active, extent, resolution, axis), gain)


def splat_binned(grid, b, resolution=(256, 256), axis: int = 2) -> torch.Tensor:
    """Image straight from the dense binned layout, scatter-free: a mass per
    interior cell, summed along the grid axis of spatial ``axis`` (3D),
    then resized to ``resolution``. Positions are quantised to the cells:
    the frame for every step of a long roll; ``splat`` for stills."""
    C, cap = grid.num_cells, grid.cap
    vol = b.mass.reshape(C, cap).sum(1).reshape(grid.padded_dims)
    vol = vol[tuple(slice(1, -1) for _ in grid.dims)]  # drop ghost cells
    order = grid.axis_order or tuple(range(grid.dim))
    if grid.dim == 3:
        vol = vol.sum(order.index(axis))
        keep = [a for a in order if a != axis]  # spatial axes left, grid order
    else:
        keep = list(order)
    # rows = world up (the last spatial axis left), row 0 = top
    if keep.index(max(keep)) == 1:
        vol = vol.T
    vol = vol.flip(0)
    return F.interpolate(
        vol[None, None], size=tuple(resolution), mode="bilinear",
        align_corners=False, antialias=True,
    )[0, 0]


def render_binned_u8(grid, b, resolution=(256, 256), axis: int = 2, gain=1.0):
    """Tone-mapped uint8 frame of ``splat_binned``."""
    return _tone_u8(splat_binned(grid, b, resolution, axis), gain)


def frame_from_state(state, params, resolution=(256, 256), axis: int = 2, gain=None):
    """Render a ParticleState with the scene's AABB as the window; ``gain``
    defaults to 1 / the largest mass."""
    extent = (
        (float(params.bound_min[0]), float(params.bound_max[0])),
        (float(params.bound_min[1]), float(params.bound_max[1])),
    )
    if gain is None:
        gain = 1.0 / max(float(state.mass.max()), 1e-12)
    return render_u8(state.pos, state.mass, state.active, extent, resolution, axis, gain)
