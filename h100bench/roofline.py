"""The least time of a kernel's work, frozen from ``chip_smoke.py``.

A roofline share is this least time over the kernel's measured time. The
least time is the larger of the bytes any implementation must touch (each
input read once, each output written once) over the memory rate and the
operations (pairs in support times the flops a pair) over the float32 rate
outside the tensor cores. The slots are the configuration's (cells x cap,
``reference/geometry``); the pairs are counted on states of the profiled
slice (``pairs_in_support``).
"""

from __future__ import annotations

import torch

from h100bench.reference import neighbors

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Float operations per pair in support, counted in the kernels' pair math:
# density: r^2 (3 sub, 3 mul, 2 add), q, m (c6 q q q), the sum: 14.
DENSITY_PAIR_FLOPS = 14
# forces: r^2 (8), rsqrt, r, q, q^2 C_s, the pressure term (3), 1/r, the
# viscous weight (2), per axis dv and two multiply-adds (15): 34; cohesion
# adds 11, XSPH 11 (its weight 5, per axis a multiply-add).
FORCES_PAIR_FLOPS, COHESION_FLOPS, XSPH_FLOPS = 34, 11, 11
# The PBF folds (csrc/pbf.cu), per pair in support in 3D: r^2 (8); lambda:
# rsqrt, r, q (3), poly6 and its sum (6), the gradient over r (3), its
# coefficient (1), per axis g, g^2 and two sums (12): 33; dx: rsqrt, r, q
# (3), poly6 (4), the ratio and its 4th power by squaring (3), s_corr and
# the lambda sum (3), the gradient (3), its coefficient (2), per axis a
# multiply-add (6): 32; density+XSPH: poly6 (4), rho's and S0's terms (4),
# per axis a multiply-add (6): 22; vorticity: rsqrt, r, q (3), the gradient
# (3), its coefficient (1), per axis dv and g (6), the cross product's three
# components (12): 33; vorticity's eta: rsqrt, r, q (3), the gradient (3),
# its coefficient (1), per axis a multiply-add (6): 21.
PBF_PAIR_FLOPS = {"lambda": 33, "dx": 32, "density_xsph": 22, "vorticity": 33,
                  "vorticity_eta": 21}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms for the work, what bounds it: "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pairs_in_support(pos: torch.Tensor, h: float) -> int:
    """Ordered pairs of particles, each with itself included, with r^2 <
    h^2: the pair work of a fold over these positions (the program's
    windows hold every such pair)."""
    i, _ = neighbors.pairs(pos.to(torch.float64), h)
    return int(i.shape[0])


def density_bound(S: int, occupied: int, dim: int, es: int, pairs: float) -> tuple[float, str]:
    """Mass in and rho out for every slot, pos only of the occupied slots
    (valid follows from mass)."""
    return bound(S * 2 * es + occupied * dim * es, pairs * DENSITY_PAIR_FLOPS)


def forces_bound(S: int, occupied: int, dim: int, es: int, pairs: float, cohesion: bool,
                 xsph: bool) -> tuple[float, str]:
    """Mass in, acc and xsph out for every slot; pos, vel, density and
    pressure only of the occupied slots."""
    flops = FORCES_PAIR_FLOPS + COHESION_FLOPS * cohesion + XSPH_FLOPS * xsph
    return bound(S * (es + 2 * dim * es) + occupied * (2 * dim + 2) * es, pairs * flops)


def pbf_bounds(S: int, occupied: int, dim: int, es: int, pairs: float) -> dict:
    """{op: (least ms, bound_by)} of the five PBF folds: the mass of every
    slot in (an empty slot is known by it) and every slot's outputs out,
    and pos and the op's other inputs only of the occupied slots; its
    operations are the pairs in support times ``PBF_PAIR_FLOPS``."""
    nv = 3 if dim == 3 else 1
    # (inputs of an occupied slot beside mass, outputs of a slot), in values
    width = {"lambda": (dim, 2), "dx": (dim + 1, dim), "density_xsph": (2 * dim + 1, 1 + dim),
             "vorticity": (2 * dim + 1, nv), "vorticity_eta": (dim + 1, dim)}
    return {op: bound((S * (1 + w_out) + occupied * w_in) * es, pairs * PBF_PAIR_FLOPS[op])
            for op, (w_in, w_out) in width.items()}
