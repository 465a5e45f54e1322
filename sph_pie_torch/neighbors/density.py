"""SPH density over the binned slots.

Counterpart of the JAX package's ``neighbors/pallas_sym.py``
``density_sym`` (the reference's density route at the flagship size) and
of the fold it is tested against, ``solvers/wcsph_binned.py``
``_density``:

    rho_i = sum_j m_j W_poly6(|x_i - x_j|)   (self pair included)

over the 3^(dim-1) slab windows of slot i's cell; then 0 where the slot is
not valid, then floored at 1e-6 rest_density. ``h`` is ``params.h``.

``density`` launches the CUDA kernel (``csrc/density.cu``, its staged
arm over runs of cells: ``neighbors/runs.py``) for CUDA tensors and runs
``density_plain`` (the blocked slab fold) for CPU tensors; any other
device raises.

Both take ``home=(first, count)``: the home cells of a buffer of cells that
holds more than them, a shard's ``[halo | home cells | halo]``
(``parallel/comm.py``). ``pos`` and ``mass`` then span the buffer, whose
rows the windows read, and ``valid`` and the result span the home slots
only. The kernel's grid covers the home runs alone; the plain version
folds the home cells with the buffer's neighbouring rows as halos
(``slab_fold(halo=, local_cells=)``). Without ``home`` the buffer is the
whole grid.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors import runs


def density_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    home: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Density of the home slots by the one-sided slab fold."""
    dim, h = params.dim, params.h

    def pair(carry, home, w):
        _, r2 = nb._r2(dim, home, w)                      # [blk, r, 3cap]
        wk = smoothing.poly6(dim, h, r2)
        return (carry[0] + (w["mass"][:, None, :] * wk).sum(2),)

    fields = {**nb._planar("p", b.pos), "mass": b.mass}
    first, count = nb.home_range(grid, b.pos.shape[0], home)
    if home is None:
        (rho,) = nb.slab_fold(grid, fields, pair, (torch.zeros_like(b.mass),))
    else:
        local, halo = nb.split_home(grid, fields, (first, count))
        (rho,) = nb.slab_fold(
            grid, local, pair, (torch.zeros_like(local["mass"]),), halo=halo,
            local_cells=count,
        )
    rho = torch.where(b.valid, rho, 0.0)
    return torch.maximum(rho, 1e-6 * params.rest_density)


def density(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    home: tuple[int, int] | None = None,
) -> torch.Tensor:
    """``density_plain`` on the CPU; the ``density`` CUDA kernel on the card,
    which raises on a cap it cannot stage (``runs.check_staging``)."""
    if b.pos.device.type == "cpu":
        return density_plain(params, grid, b, home)
    if b.pos.device.type != "cuda":
        raise ValueError(f"density: no kernel for device {b.pos.device}")
    dt, dev = b.pos.dtype, b.pos.device
    S = b.pos.shape[0]
    first, count = nb.home_range(grid, S, home)
    if b.pos.shape != (S, grid.dim) or b.mass.shape != (S,) or b.valid.shape != (count * grid.cap,):
        raise ValueError(f"density: pos must be [{S}, {grid.dim}], mass [{S}] and valid "
                         f"[{count * grid.cap}] (the home slots)")
    h = params.h
    c = torch.stack(
        [h, smoothing.poly6_coeff(params.dim, h), 1e-6 * params.rest_density]
    ).to(dt)
    prm = torch.cat([c[:1] * c[:1], c[1:]])  # the kernel takes h^2
    _native.check_cuda(
        "density", dt, dev, pos=(b.pos, None), mass=(b.mass, None),
        valid=(b.valid, torch.bool), prm=(prm, None),
    )
    runs.check_staging("density", grid.cap, pos=b.pos, mass=b.mass)
    rho = torch.empty(count * grid.cap, dtype=dt, device=dev)
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "density", dt, b.pos, b.mass, b.valid, prm, rho, S, grid.cap,
        grid.dim, s0, s1, first, count,
    )
    density.launches += 1
    return rho


density.launches = 0
