"""Pressure, viscosity and XSPH sums in moment form, on the tensor cores.

Counterpart of the JAX package's ``scripts/micro_mxu_vmem.py:248``
``forces_mxu`` (body ``_build_forces_mxu``): the forces of
``pallas_pair.forces_pallas`` without cohesion, cap 32 only, h =
``cell_size - skin``. Per home cell and slab the per-pair weight planes

    press_ij = m_j (pr2_i + pr2_j) C_s q^2 / r  (0 where r^2 == 0)
    visc_ij  = m_rho_j C_v q,   xw_ij = m_rho_j W_poly6(r^2)

are contracted against the window features F_j = [x_j - c, v_j - cv, 1]
(c, cv: the window's mass-weighted mean pos and vel) into moments, and

    P_i += (x_i - c) mom_press[1] - mom_press[x]
    V_i += mom_visc[v] - (v_i - cv) mom_visc[1]       (X_i likewise)

    acc_i = -P_i + mu / rho_i V_i,   xsph_i = X_i

(``micro_mxu_vmem.py:260-265``; XSPH is computed whatever ``use_xsph``
says, as there). The centering is per home cell and slab over the 3*cap
window; the TPU kernel centers over its 4-cell lane row, which changes the
bf16 rounding only.

Arms: ``bf16=False`` contracts in float32 (3xTF32 on the card, the
counterpart of ``Precision.HIGHEST``); ``bf16=True`` rounds the planes and
the centered features to bf16 and accumulates in float32.

Unlike the JAX function, which leaves garbage on invalid slots (their
p/rho^2 is huge at the floor density; its harness compares valid slots
only), both outputs are 0 on slots that are not valid, as ``forces`` does.
Raises when ``params.use_cohesion`` is set: the kernel has no cohesion
term. Float32 only.

``forces_mma`` launches the CUDA kernel (``csrc/forces_mma.cu``) for CUDA
tensors and runs ``forces_mma_plain`` (the blocked slab fold; the
contraction in float64 on exactly the operands the kernel rounds) for CPU
tensors; any other device raises.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.forces import _per_slot

_TINY = 1e-12


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """[blk, 3*cap] -> [blk, 1] in the kernel's order: 32 lanes sum slots
    l, l+32, l+64 in turn, then an xor butterfly over the lanes. Bit-equal
    window centers keep the bf16 rounding of the features bit-equal."""
    part = (x[:, :32] + x[:, 32:64]) + x[:, 64:]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ o]
    return part[:, :1]


def _check(params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState) -> None:
    if params.use_cohesion:
        raise ValueError("forces_mma: has no cohesion term (params.use_cohesion is set)")
    if grid.cap != 32:
        raise ValueError(f"forces_mma: requires cap == 32, got {grid.cap}")
    S, dim = grid.num_slots, grid.dim
    if b.pos.shape != (S, dim) or b.vel.shape != (S, dim):
        raise ValueError(f"forces_mma: pos and vel must be [{S}, {dim}]")
    fields = (b.pos, b.vel, b.mass, b.density, b.pressure)
    if any(t.dtype != torch.float32 for t in fields):
        raise TypeError("forces_mma: takes float32 pos, vel, mass, density and pressure")


def _consts(params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState) -> torch.Tensor:
    """[h, h^2, C_s, C_v, C_6, mu], h from the grid as ``_grid_h``; the
    kernel constants in double, rounded once to float32."""
    dim, h = grid.dim, float(grid.cell_size - grid.skin)
    c = b.pos.new_tensor([
        h, h * h, smoothing.spiky_grad_coeff(dim, h),
        smoothing.visc_lap_coeff(dim, h), smoothing.poly6_coeff(dim, h),
    ])
    return torch.cat([c, params.viscosity.reshape(1).to(c)])


def forces_mma_plain(
    params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState, bf16: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """([S, dim] acc, [S, dim] xsph) by the moment form over the slab fold."""
    _check(params, grid, b)
    dim = grid.dim
    h, h2, cs, cv, c6, mu = _consts(params, grid, b)
    inv_rho, pr2, m_rho = _per_slot(b)
    ones = 2 * dim

    def pair(carry, hm, w):
        P, V, X = carry[:dim], carry[dim : 2 * dim], carry[2 * dim :]
        m = w["mass"]                                         # [blk, 3cap]
        wsum = torch.clamp(_window_sum(m), min=_TINY)
        cpos = [_window_sum(m * w[f"p{k}"]) / wsum for k in range(dim)]
        cvel = [_window_sum(m * w[f"v{k}"]) / wsum for k in range(dim)]
        feats = torch.stack(
            [w[f"p{k}"] - cpos[k] for k in range(dim)]
            + [w[f"v{k}"] - cvel[k] for k in range(dim)]
            + [torch.ones_like(m)],
            dim=-1,
        )                                                     # [blk, 3cap, 2dim+1]
        _, r2 = nb._r2(dim, hm, w)                            # [blk, r, 3cap]
        inv_r = torch.rsqrt(torch.clamp(r2, min=_TINY))
        r = r2 * inv_r
        qs = torch.clamp(h - r, min=0.0)
        gwr = torch.where(r2 > 0.0, cs * qs * qs * inv_r, 0.0)
        qp = torch.clamp(h2 - r2, min=0.0)
        m_rho_j = w["m_rho"][:, None, :]
        planes = torch.stack([
            (m[:, None, :] * (hm["pr2"][:, :, None] + w["pr2"][:, None, :])) * gwr,
            m_rho_j * (cv * qs),
            m_rho_j * (c6 * qp * qp * qp),
        ], dim=1)                                             # [blk, 3, r, 3cap]
        if bf16:
            planes, feats = planes.to(torch.bfloat16), feats.to(torch.bfloat16)
        mom = torch.matmul(planes.double(), feats.double()[:, None]).float()
        mp, mv, mx = mom.unbind(1)                            # [blk, r, 2dim+1]
        P = [P[k] + (hm[f"p{k}"] - cpos[k]) * mp[..., ones] - mp[..., k] for k in range(dim)]
        V = [V[k] + mv[..., dim + k] - (hm[f"v{k}"] - cvel[k]) * mv[..., ones] for k in range(dim)]
        X = [X[k] + mx[..., dim + k] - (hm[f"v{k}"] - cvel[k]) * mx[..., ones] for k in range(dim)]
        return (*P, *V, *X)

    fields = {
        **nb._planar("p", b.pos),
        **nb._planar("v", b.vel),
        "mass": b.mass,
        "pr2": pr2,
        "m_rho": m_rho,
    }
    zero = torch.zeros_like(b.mass)
    out = nb.slab_fold(grid, fields, pair, (zero,) * (3 * dim))
    P, V, X = (torch.stack(out[t * dim : (t + 1) * dim], dim=-1) for t in range(3))
    live = b.valid[:, None]
    acc = torch.where(live, -P + (mu * inv_rho)[:, None] * V, 0.0)
    return acc, torch.where(live, X, 0.0)


def forces_mma(
    params: FluidParams, grid: nb.BinnedGrid, b: nb.BinnedState, bf16: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """``forces_mma_plain`` on the CPU; the tensor-core kernel on the card.

    Launches are counted per arm: ``forces_mma.launches["f32" | "bf16"]``."""
    if b.pos.device.type == "cpu":
        return forces_mma_plain(params, grid, b, bf16)
    if b.pos.device.type != "cuda":
        raise ValueError(f"forces_mma: no kernel for device {b.pos.device}")
    _check(params, grid, b)
    dt, dev, dim = b.pos.dtype, b.pos.device, grid.dim
    S = grid.num_slots
    inv_rho, pr2, m_rho = _per_slot(b)
    prm = _consts(params, grid, b)
    _native.check_cuda(
        "forces_mma", dt, dev, pos=(b.pos, None), vel=(b.vel, None),
        mass=(b.mass, None), pr2=(pr2, None), m_rho=(m_rho, None),
        inv_rho=(inv_rho, None), prm=(prm, None),
    )
    acc = torch.empty((S, dim), dtype=dt, device=dev)
    xsph = torch.empty((S, dim), dtype=dt, device=dev)
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "forces_mma", dt, b.pos, b.vel, b.mass, pr2, m_rho, inv_rho, prm, acc,
        xsph, S, dim, s0, s1, int(bf16),
    )
    forces_mma.launches["bf16" if bf16 else "f32"] += 1
    return acc, xsph


forces_mma.launches = {"f32": 0, "bf16": 0}
