"""Pressure, viscosity, cohesion and XSPH sums over the binned slots.

Counterpart of the JAX package's ``neighbors/pallas_pair.py``
``forces_pallas`` and of the fold the reference runs for this phase,
``solvers/wcsph_binned.py`` ``_forces``. With d = x_i - x_j, r = |d| and
per-slot pr2 = p/rho^2, m_rho = m/rho:

    acc_i  = - sum_j m_j [(pr2_i + pr2_j) gW(r) + st C(r)] d / r
             + mu / rho_i  sum_j m_rho_j lapW(r) (v_j - v_i)
    xsph_i =   sum_j m_rho_j W(r) (v_j - v_i)

(cohesion C only with ``use_cohesion``, XSPH only with ``use_xsph``). Both
are 0 on slots that are not valid. ``h`` is ``params.h``.

``forces`` launches the CUDA kernel (``csrc/forces.cu``, staged over runs
of cells: ``neighbors/runs.py``) for CUDA tensors and runs
``forces_plain`` (the blocked slab fold) for CPU tensors; any other device
raises.

Both take ``home=(first, count)`` as ``neighbors/density.py`` does: the
inputs span a buffer, ``valid`` and the results its home slots. A shard
passes ``per_slot=(inv_rho, pr2, m_rho)`` over its buffer, exchanged with
its neighbours; without it they are computed from ``b.density`` and
``b.pressure``.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors import runs


def _per_slot(b: nb.BinnedState):
    """inv_rho, p/rho^2 and m/rho: hoisted out of the pair loop."""
    inv_rho = 1.0 / b.density
    return inv_rho, b.pressure * inv_rho * inv_rho, b.mass * inv_rho


def forces_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    home: tuple[int, int] | None = None,
    per_slot: tuple[torch.Tensor, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([n, dim] acc, [n, dim] xsph) of the n home slots by the one-sided
    slab fold."""
    dim, h = params.dim, params.h
    inv_rho, pr2, m_rho = _per_slot(b) if per_slot is None else per_slot

    def pair(carry, hm, w):
        """Mask-free pair math: empty slots carry mass == 0 and m_rho == 0,
        the self pair has d == 0 and dv == 0, and every kernel is 0 beyond
        the support radius, so each term vanishes where it should."""
        acc, xsph = carry[:dim], carry[dim:]
        d, r2 = nb._r2(dim, hm, w)                          # [blk, r, 3cap]
        inv_r = torch.rsqrt(torch.clamp(r2, min=1e-12))
        r = r2 * inv_r
        m_j = w["mass"][:, None, :]
        gw = smoothing.spiky_grad_mag(dim, h, r)
        p_term = hm["pr2"][:, :, None] + w["pr2"][:, None, :]
        radial = m_j * p_term * gw
        if params.use_cohesion:
            coh = smoothing.cohesion(dim, h, r)
            radial = radial + params.surface_tension * m_j * coh
        radial = radial * inv_r
        visc_w = w["m_rho"][:, None, :] * smoothing.visc_lap(dim, h, r)
        if params.use_xsph:
            xw = w["m_rho"][:, None, :] * smoothing.poly6(dim, h, r2)
        mu_over_rho_i = params.viscosity * hm["inv_rho"]
        new_acc, new_xsph = [], []
        for k in range(dim):
            dv_k = w[f"v{k}"][:, None, :] - hm[f"v{k}"][:, :, None]
            new_acc.append(
                acc[k]
                - (radial * d[k]).sum(2)
                + mu_over_rho_i * (visc_w * dv_k).sum(2)
            )
            if params.use_xsph:
                new_xsph.append(xsph[k] + (xw * dv_k).sum(2))
            else:
                new_xsph.append(xsph[k])
        return tuple(new_acc) + tuple(new_xsph)

    fields = {
        **nb._planar("p", b.pos),
        **nb._planar("v", b.vel),
        "mass": b.mass,
        "pr2": pr2,
        "m_rho": m_rho,
        "inv_rho": inv_rho,
    }
    first, count = nb.home_range(grid, b.pos.shape[0], home)
    if home is None:
        zero = torch.zeros_like(b.mass)
        out = nb.slab_fold(grid, fields, pair, (zero,) * (2 * dim))
    else:
        local, halo = nb.split_home(grid, fields, (first, count))
        zero = torch.zeros_like(local["mass"])
        out = nb.slab_fold(
            grid, local, pair, (zero,) * (2 * dim), halo=halo, local_cells=count
        )
    live = b.valid[:, None]
    acc = torch.where(live, torch.stack(out[:dim], dim=-1), 0.0)
    xsph = torch.where(live, torch.stack(out[dim:], dim=-1), 0.0)
    return acc, xsph


def forces(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    home: tuple[int, int] | None = None,
    per_slot: tuple[torch.Tensor, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``forces_plain`` on the CPU; the ``forces`` CUDA kernel on the card,
    which raises on a cap it cannot stage (``runs.check_staging``)."""
    if b.pos.device.type == "cpu":
        return forces_plain(params, grid, b, home, per_slot)
    if b.pos.device.type != "cuda":
        raise ValueError(f"forces: no kernel for device {b.pos.device}")
    dt, dev, dim = b.pos.dtype, b.pos.device, params.dim
    S = b.pos.shape[0]
    first, count = nb.home_range(grid, S, home)
    if b.pos.shape != (S, dim) or b.vel.shape != (S, dim) or b.mass.shape != (S,):
        raise ValueError(f"forces: pos and vel must be [{S}, {dim}], mass [{S}]")
    inv_rho, pr2, m_rho = _per_slot(b) if per_slot is None else per_slot
    h = params.h
    prm = torch.stack(
        [
            h,
            smoothing.spiky_grad_coeff(dim, h),
            smoothing.visc_lap_coeff(dim, h),
            smoothing.poly6_coeff(dim, h),
            smoothing.cohesion_coeff(dim, h),
            h**6 / 64.0,
            params.viscosity,
            params.surface_tension,
        ]
    ).to(dt)
    _native.check_cuda(
        "forces", dt, dev, pos=(b.pos, None), vel=(b.vel, None),
        mass=(b.mass, None), pr2=(pr2, None), m_rho=(m_rho, None),
        inv_rho=(inv_rho, None), prm=(prm, None),
    )
    runs.check_staging("forces", grid.cap, pos=b.pos, mass=b.mass)
    acc = torch.empty((count * grid.cap, dim), dtype=dt, device=dev)
    xsph = torch.empty((count * grid.cap, dim), dtype=dt, device=dev)
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "forces", dt, b.pos, b.vel, b.mass, pr2, m_rho, inv_rho, prm, acc,
        xsph, S, grid.cap, dim, s0, s1, first, count, int(params.use_cohesion),
        int(params.use_xsph),
    )
    forces.launches += 1
    return acc, xsph


forces.launches = 0
