"""Position-Based Fluids (Macklin & Mueller 2013) on the binned layout.

The port of the reference's ``solvers/pbf.py``: the same physics,
constants, arithmetic order and update order. A step:

  predict x* from gravity, the wall and obstacle penalties (speed-clamped)
  repeat ``iters`` times (Jacobi projections):
      rho_i and the gradient sums        ->  lambda_i = -C_i / (denom + eps)
      dx_i = (1/rho0) sum_j m_j (lambda_i + lambda_j + s_corr) gradW_ij
      under-relaxed by ``sor``, capped at min(proj_cap_h h, skin/2)
  v = (x* - x)/dt, speed-clamped; a final fold for density and XSPH
  (optionally vorticity confinement first).

``maybe_rebin`` runs before every fold (``iters + 2`` host decisions a
step), since particles move between folds. The folds are PyTorch over
``binned.slab_fold`` on every device; the final density of the
configurations without the fused fold goes through
``neighbors.density.density`` (the ``density`` CUDA kernel on the card).

Empty slots: the fold gives the slots of empty cells 0 where the reference
computes a sum from position 0. Their values reach nothing: every window
term carries ``m_j = 0`` and every update is masked by the slots that move.
"""

from __future__ import annotations

import dataclasses

import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors.density import density
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_torch.solvers.wcsph_binned import maybe_rebin
from sph_pie_torch.utils.struct import replace

# The tensor fields of PbfParams, in declaration order (convert.py walks them).
ARRAY_FIELDS = ("relax_eps", "s_corr_k", "s_corr_dq", "vort_eps", "sor", "proj_cap_h")


@dataclasses.dataclass(frozen=True)
class PbfParams:
    """PBF solver knobs; FluidParams supplies h, dt, rho0, bounds, gravity.

    ``iters``, ``epilogue``, ``use_vorticity`` and ``s_corr_n`` are plain
    Python values (they shape the step); the rest are 0-d tensors on the
    simulation's device."""

    iters: int               # Jacobi constraint iterations
    epilogue: str            # how step-start positions and the previous
                             # step's density reach the final fold:
                             # "gather" = owner-indexed stashes taken before
                             #   the entry rebin, light mid-step rebins;
                             # "ride" = step-start positions ride the vel
                             #   payload, density rides every rebin.
                             # The same physics either way.
    use_vorticity: bool      # False leaves out the two vorticity folds
    relax_eps: torch.Tensor  # CFM epsilon in the lambda denominator
    s_corr_k: torch.Tensor   # artificial-pressure strength (times h^2)
    s_corr_n: int            # artificial-pressure exponent
    s_corr_dq: torch.Tensor  # reference distance as a fraction of h
    vort_eps: torch.Tensor   # vorticity-confinement strength
    sor: torch.Tensor        # under-relaxation of the Jacobi projection
    proj_cap_h: torch.Tensor # per-projection cap as a fraction of h (the
                             # applied cap is min(proj_cap_h h, skin/2)); it
                             # sets the rebin rate, not the correctness


def make_pbf_params(
    iters: int = 4,
    relax_eps: float = 100.0,
    s_corr_k: float = 0.1,
    s_corr_n: int = 4,
    s_corr_dq: float = 0.3,
    vort_eps: float = 0.0,
    sor: float = 0.8,
    proj_cap_h: float = 0.075,
    epilogue: str = "gather",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> PbfParams:
    """``s_corr_k`` is h-relative: the artificial-pressure coefficient is
    s_corr_k h^2. ``vort_eps`` > 0 turns on vorticity confinement
    (f = eps (N x omega), N the normalised gradient of |omega|)."""
    if epilogue not in ("gather", "ride"):
        raise ValueError(f"epilogue must be 'gather' or 'ride', got {epilogue!r}")

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return PbfParams(
        iters=int(iters),
        epilogue=str(epilogue),
        use_vorticity=bool(vort_eps > 0.0),
        relax_eps=f(relax_eps),
        s_corr_k=f(s_corr_k),
        s_corr_n=int(s_corr_n),
        s_corr_dq=f(s_corr_dq),
        vort_eps=f(vort_eps),
        sor=f(sor),
        proj_cap_h=f(proj_cap_h),
    )


def flagship_params(**overrides) -> PbfParams:
    """The flagship PBF configuration (BASELINE config #4), as the
    reference defines it: two Jacobi iterations at sor 0.9, a projection
    cap of h/16, the "ride" epilogue. ``overrides`` go to
    ``make_pbf_params`` (``device``, ``dtype`` and any knob)."""
    cfg = dict(iters=2, sor=0.9, proj_cap_h=0.0625, epilogue="ride")
    cfg.update(overrides)
    return make_pbf_params(**cfg)


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n for a static int n >= 1 by repeated squaring, in the order of
    the reference's ``lax.integer_pow``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _inv_r(r2: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp(r2, min=1e-12))


def _lambda_fold(params: FluidParams, pbf: PbfParams, grid, fields):
    """(lambda, rho) per slot from one slab fold over predicted positions.

    No per-pair divide or mask: the kernel cut-offs zero far pairs, d == 0
    zeroes the self pair's gradient, empty slots carry mass 0; the 1/rho0
    factors are applied once, after the fold."""
    dim, h = params.dim, params.h
    rho0 = params.rest_density

    def pair(carry, hm, w):
        rho, grad_sq, *grad_sum = carry
        d, r2 = nb._r2(dim, hm, w)
        inv_r = _inv_r(r2)
        r = r2 * inv_r
        m_j = w["mass"][:, None, :]
        wk = smoothing.poly6(dim, h, r2)
        rho = rho + (m_j * wk).sum(2)  # self pair included
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = m_j * gw                # m_j grad_i W_ij (times rho0 later)
        gs = []
        for k in range(dim):
            g_k = coef * d[k]
            grad_sq = grad_sq + (g_k * g_k).sum(2)
            gs.append(g_k.sum(2))
        return (rho, grad_sq) + tuple(a + g for a, g in zip(grad_sum, gs))

    zero = torch.zeros_like(fields["mass"])
    rho, grad_sq, *grad_sum = nb.slab_fold(grid, fields, pair, (zero,) * (2 + dim))
    # |sum grad|^2 + sum |grad|^2 (the CFM denominator), with 1/rho0^2 here
    inv_rho0 = 1.0 / rho0
    denom = grad_sq
    for k in range(dim):
        denom = denom + grad_sum[k] * grad_sum[k]
    denom = denom * (inv_rho0 * inv_rho0)
    # Unclamped constraint: stretched regions attract.
    c = rho * inv_rho0 - 1.0
    lam = -c / (denom + pbf.relax_eps)
    return lam, rho


def _dx_fold(params: FluidParams, pbf: PbfParams, grid, fields):
    """[S, dim] position corrections from the lambdas (``fields["lam"]``),
    with the artificial pressure -k h^2 (W / W(dq h))^n."""
    dim, h = params.dim, params.h
    rho0 = params.rest_density
    w_dq = smoothing.poly6(dim, h, (pbf.s_corr_dq * h) ** 2)
    inv_wdq = 1.0 / w_dq
    neg_k_h2 = -(pbf.s_corr_k * h * h)

    def pair(carry, hm, w):
        d, r2 = nb._r2(dim, hm, w)
        inv_r = _inv_r(r2)
        r = r2 * inv_r
        m_j = w["mass"][:, None, :]
        wk = smoothing.poly6(dim, h, r2)
        s_corr = neg_k_h2 * _integer_pow(wk * inv_wdq, pbf.s_corr_n)
        lam_sum = hm["lam"][:, :, None] + w["lam"][:, None, :] + s_corr
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = (m_j * lam_sum) * gw
        return tuple(c_k + (coef * d[k]).sum(2) for k, c_k in enumerate(carry))

    zero = torch.zeros_like(fields["mass"])
    dxs = nb.slab_fold(grid, fields, pair, (zero,) * dim)
    return torch.stack(dxs, dim=-1) * (1.0 / rho0)


def _density_xsph_fold(params: FluidParams, grid, pos, vel, mass, m_rho):
    """One fold for the density and the XSPH sum: (rho_raw, dv).

    ``m_rho`` is the Monaghan weight m_j / rho_j with rho_j the previous
    step's final density. Moment form: sum_j w_j W (v_j - v_i) =
    S1 - v_i S0, with S0 = sum_j w_j W and S1 = sum_j w_j W v_j."""
    dim, h = params.dim, params.h

    def pair(carry, hm, w):
        rho, s0, *s1 = carry
        _, r2 = nb._r2(dim, hm, w)
        wk = smoothing.poly6(dim, h, r2)
        mw = w["mass"][:, None, :] * wk
        ww = w["m_rho"][:, None, :] * wk
        rho = rho + mw.sum(2)
        s0 = s0 + ww.sum(2)
        return (rho, s0) + tuple(
            s + (ww * w[f"v{k}"][:, None, :]).sum(2) for k, s in enumerate(s1)
        )

    fields = {**nb._planar("p", pos), **nb._planar("v", vel), "mass": mass, "m_rho": m_rho}
    zero = torch.zeros_like(mass)
    rho, s0, *s1 = nb.slab_fold(grid, fields, pair, (zero,) * (2 + dim))
    return rho, torch.stack(s1, dim=-1) - vel * s0[:, None]


def _vorticity_fold(params: FluidParams, grid, pos, vel, mass, rho):
    """omega_i = sum_j (m/rho)_j (v_j - v_i) x grad_i W_ij (spiky gradient):
    [S, 3] in 3D, the scalar z-curl [S, 1] in 2D."""
    dim, h = params.dim, params.h
    m_rho = mass / torch.maximum(rho, 1e-6 * params.rest_density)

    def pair(carry, hm, w):
        d, r2 = nb._r2(dim, hm, w)
        inv_r = _inv_r(r2)
        r = r2 * inv_r
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = w["m_rho"][:, None, :] * gw
        dv = [w[f"v{k}"][:, None, :] - hm[f"v{k}"][:, :, None] for k in range(dim)]
        g = [coef * d[k] for k in range(dim)]
        if dim == 3:
            terms = (
                dv[1] * g[2] - dv[2] * g[1],
                dv[2] * g[0] - dv[0] * g[2],
                dv[0] * g[1] - dv[1] * g[0],
            )
        else:
            terms = (dv[0] * g[1] - dv[1] * g[0],)
        return tuple(c + t.sum(2) for c, t in zip(carry, terms))

    fields = {**nb._planar("p", pos), **nb._planar("v", vel), "mass": mass, "m_rho": m_rho}
    zero = torch.zeros_like(mass)
    out = nb.slab_fold(grid, fields, pair, (zero,) * (3 if dim == 3 else 1))
    return torch.stack(out, dim=-1)


def _vorticity_force(params: FluidParams, grid, pos, mass, rho, omega):
    """f = N x omega, N = eta / |eta|, eta_i = sum_j (m/rho)_j |omega_j|
    grad_i W_ij (towards higher vorticity)."""
    dim, h = params.dim, params.h
    m_rho = mass / torch.maximum(rho, 1e-6 * params.rest_density)
    wmag = torch.sqrt(torch.clamp((omega * omega).sum(-1), min=0.0))

    def pair(carry, hm, w):
        d, r2 = nb._r2(dim, hm, w)
        inv_r = _inv_r(r2)
        r = r2 * inv_r
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = w["m_rho"][:, None, :] * w["wmag"][:, None, :] * gw
        return tuple(c + (coef * d[k]).sum(2) for k, c in enumerate(carry))

    fields = {**nb._planar("p", pos), "mass": mass, "m_rho": m_rho, "wmag": wmag}
    zero = torch.zeros_like(mass)
    eta = torch.stack(nb.slab_fold(grid, fields, pair, (zero,) * dim), dim=-1)
    n_hat = eta * _inv_r((eta * eta).sum(-1, keepdim=True))
    if dim == 3:
        return torch.linalg.cross(n_hat, omega, dim=-1)
    # omega is the scalar z-curl: N x (w zhat) = (N_y w, -N_x w)
    w_z = omega[:, 0]
    return torch.stack([n_hat[:, 1] * w_z, -n_hat[:, 0] * w_z], dim=-1)


def _max_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp((v * v).sum(-1).amax(), min=0.0))


@torch.no_grad()
def step(
    params: FluidParams,
    grid: nb.BinnedGrid,
    pbf: PbfParams,
    b: nb.BinnedState,
    obstacles=None,
) -> nb.BinnedState:
    """One PBF step in binned space (see the module docstring)."""
    if any(grid.periodic):
        raise NotImplementedError("periodic axes are not ported yet")
    ride = pbf.epilogue == "ride"
    if not ride:
        # Owner-indexed stashes, taken before the entry rebin: a fired
        # rebin permutes slots (owners stay) and zeroes the density.
        safe = torch.clamp(b.slot_of, 0, grid.num_slots - 1).to(torch.int64)
        pos0c = b.pos[safe]       # [K, dim] step-start positions
        rho_prev_c = b.density[safe]  # previous step's final density

    b = maybe_rebin(grid, b, carry_density=ride)

    def clip_box(x):
        return torch.clamp(x, params.bound_min, params.bound_max)

    def fmask(bb):
        return (bb.valid & ~nb.frozen_mask(grid, bb))[:, None]

    valid = fmask(b)

    # Predict
    acc = torch.zeros_like(b.pos) + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel)
    if obstacles is not None:
        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)
    vel = torch.where(valid, b.vel + params.dt * acc, 0.0)
    vel = clamp_speed(params, vel)
    x_star = torch.where(valid, b.pos + params.dt * vel, b.pos)

    # "gather": vel is left as it is (light mid-step rebins drop it);
    # "ride": the vel slots carry the step-start positions through full,
    # density-carrying rebins.
    b = replace(
        b,
        pos=x_star,
        vel=b.pos if ride else b.vel,
        travel=b.travel + _max_norm(x_star - b.pos),
    )

    proj_cap = torch.clamp(pbf.proj_cap_h * params.h, max=0.5 * grid.skin)
    for _ in range(pbf.iters):
        b = maybe_rebin(grid, b, light=not ride, carry_density=ride)
        v = fmask(b)
        fields = {**nb._planar("p", b.pos), "mass": b.mass}
        lam, _ = _lambda_fold(params, pbf, grid, fields)
        dx = pbf.sor * _dx_fold(params, pbf, grid, {**fields, "lam": lam})
        n = torch.sqrt(torch.clamp((dx * dx).sum(-1, keepdim=True), min=1e-30))
        dx = torch.where(v, dx * torch.clamp(proj_cap / n, max=1.0), 0.0)
        x = clip_box(b.pos + dx)
        b = replace(b, pos=torch.where(v, x, b.pos), travel=b.travel + _max_norm(dx))

    b = maybe_rebin(grid, b, light=not ride, carry_density=ride)
    valid = fmask(b)
    x_star = b.pos
    if ride:
        pos0, rho_prev = b.vel, b.density
    else:
        own = torch.clamp(b.owner, 0, pos0c.shape[0] - 1).to(torch.int64)
        pos0, rho_prev = pos0c[own], rho_prev_c[own]

    # Monaghan XSPH weight from the previous step's density (rest density
    # for rows that have none yet).
    m_rho = b.mass / torch.where(rho_prev > 0, rho_prev, params.rest_density)

    new_vel = torch.where(valid, (x_star - pos0) / params.dt, 0.0)
    new_vel = clamp_speed(params, new_vel)

    floor = 1e-6 * params.rest_density
    if params.use_xsph and not pbf.use_vorticity:
        rho, dv = _density_xsph_fold(params, grid, x_star, new_vel, b.mass, m_rho)
        rho = torch.maximum(torch.where(b.valid, rho, 0.0), floor)
        new_vel = new_vel + params.xsph_eps * torch.where(valid, dv, 0.0)
        new_vel = torch.where(valid, clamp_speed(params, new_vel), 0.0)
    else:
        rho = density(params, grid, b)  # b.pos is x_star
        rho = torch.maximum(rho, floor)
        if pbf.use_vorticity:
            omega = _vorticity_fold(params, grid, x_star, new_vel, b.mass, rho)
            f_vort = _vorticity_force(params, grid, x_star, b.mass, rho, omega)
            new_vel = new_vel + (pbf.vort_eps * params.dt) * torch.where(valid, f_vort, 0.0)
            new_vel = torch.where(valid, clamp_speed(params, new_vel), 0.0)
        if params.use_xsph:
            _, dv = _density_xsph_fold(params, grid, x_star, new_vel, b.mass, m_rho)
            new_vel = new_vel + params.xsph_eps * torch.where(valid, dv, 0.0)
            new_vel = torch.where(valid, clamp_speed(params, new_vel), 0.0)

    return replace(b, vel=new_vel, density=rho, sim_time=b.sim_time + params.dt)


def simulate(
    params: FluidParams,
    grid: nb.BinnedGrid,
    pbf: PbfParams,
    b: nb.BinnedState,
    n_steps: int,
    obstacles=None,
) -> nb.BinnedState:
    """Roll ``n_steps`` steps."""
    for _ in range(int(n_steps)):
        b = step(params, grid, pbf, b, obstacles)
    return b
