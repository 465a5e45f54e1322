"""The preview frame, plainly: each particle's mass into the cell it is
binned in, the cells' masses summed along the projection axis, the image
resized bilinearly (half-pixel centres, antialiased when it shrinks) and
tone-mapped to 255 (1 - exp(-gain img)), clipped and truncated to uint8.
Row 0 is the top (world up is the last spatial axis left).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference.geometry import Grid


def render(g: Grid, cell: torch.Tensor, mass: torch.Tensor, resolution, axis: int,
           gain: float) -> torch.Tensor:
    """uint8 [H, W] frame of particles of masses ``mass`` in padded-grid
    cells ``cell``, computed in ``mass``'s dtype."""
    vol = mass.new_zeros(g.cells).index_add_(0, cell, mass).reshape(g.padded)
    vol = vol[tuple(slice(1, -1) for _ in g.dims)]
    order = g.axis_order
    if len(g.dims) == 3:
        vol = vol.sum(order.index(axis))
        keep = [a for a in order if a != axis]
    else:
        keep = list(order)
    if keep.index(max(keep)) == 1:
        vol = vol.T
    vol = vol.flip(0)
    # The antialiased resize has no bfloat16 kernel: the control resizes in
    # float32 and rounds the image back.
    wide = vol.float() if vol.dtype == torch.bfloat16 else vol
    img = F.interpolate(wide[None, None], size=tuple(resolution), mode="bilinear",
                        align_corners=False, antialias=True)[0, 0].to(vol.dtype)
    tone = 1.0 - torch.exp(-gain * img)
    return torch.clamp(tone * 255.0, 0, 255).to(torch.uint8)
