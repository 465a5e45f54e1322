"""Position-Based Fluids (Macklin & Mueller 2013) on the binned layout.

The port of the reference's ``solvers/pbf.py``: the same physics,
constants, arithmetic order and update order. A step:

  predict x* from gravity, the wall and obstacle penalties (speed-clamped;
      ``solvers/integrate.predict``)
  repeat ``iters`` times (Jacobi projections):
      rho_i and the gradient sums        ->  lambda_i = -C_i / (denom + eps)
      dx_i = (1/rho0) sum_j m_j (lambda_i + lambda_j + s_corr) gradW_ij
      under-relaxed by ``sor``, capped at min(proj_cap_h h, skin/2), applied
      inside the box (``integrate.project``)
  v = (x* - x)/dt, speed-clamped, and the XSPH weights m/rho
  (``integrate.pbf_velocity``); a final fold for density and XSPH
  (optionally vorticity confinement first), each sum added to v by
  ``integrate.pbf_mix``.

The per-slot passes around the folds (``predict``, ``project``,
``pbf_velocity``, ``pbf_mix``) are modes of ``csrc/integrate.cu``'s
``integrate_slots`` on the card, one launch each, and their plain torch
versions on the CPU.

``maybe_rebin`` runs before every fold (``iters + 2`` host decisions a
step), since particles move between folds. The five pair folds are
``neighbors.pbf_folds``: the ``csrc/pbf.cu`` kernels on the card, which
read nothing back to the host, and their plain versions over
``binned.slab_fold`` on the CPU. The final density of the configurations
without the fused fold goes through ``neighbors.density.density`` (the
``density`` CUDA kernel on the card).

Each phase is a span of the profile while one records
(``utils.profiling.annotate``): ``sph.rebin_check`` around each of the
``iters + 2`` checks, ``sph.predict`` (the "gather" stashes, taken before
the entry check, are a second one), ``sph.project`` around each
projection after its check, ``sph.epilogue`` from the last check to the
returned state.

Empty slots: the folds give the slots of empty cells 0 where the reference
computes a sum from position 0. Their values reach nothing: every window
term carries ``m_j = 0`` and every update is masked by the slots that move.
"""

from __future__ import annotations

import dataclasses

import torch

from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors import pbf_folds as pf
from sph_pie_torch.neighbors.density import density
from sph_pie_torch.neighbors.pbf_folds import inv_r_of as _inv_r
from sph_pie_torch.solvers import integrate
from sph_pie_torch.solvers.wcsph_binned import maybe_rebin, wall_axes
from sph_pie_torch.utils.profiling import annotate
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


def _density_xsph_fold(params: FluidParams, grid, pos, vel, mass, m_rho, fold=pf.whole_grid):
    """One fold for the density and the XSPH sum: (rho_raw, dv). ``m_rho``
    is the Monaghan weight m_j / rho_j with rho_j the previous step's final
    density."""
    return fold(pf.density_xsph_fold, params, grid, pos=pos, vel=vel, mass=mass, m_rho=m_rho)


def _vorticity_fold(params: FluidParams, grid, pos, vel, mass, rho, fold=pf.whole_grid):
    """omega_i = sum_j (m/rho)_j (v_j - v_i) x grad_i W_ij (spiky gradient):
    [S, 3] in 3D, the scalar z-curl [S, 1] in 2D."""
    m_rho = mass / torch.maximum(rho, 1e-6 * params.rest_density)
    return fold(pf.vorticity_fold, params, grid, pos=pos, vel=vel, mass=mass, m_rho=m_rho)


def _vorticity_force(params: FluidParams, grid, pos, mass, rho, omega, fold=pf.whole_grid):
    """f = N x omega, N = eta / |eta|, eta_i = sum_j (m/rho)_j |omega_j|
    grad_i W_ij (towards higher vorticity)."""
    dim = params.dim
    m_rho = mass / torch.maximum(rho, 1e-6 * params.rest_density)
    wmag = torch.sqrt(torch.clamp((omega * omega).sum(-1), min=0.0))
    eta = fold(pf.vorticity_eta_fold, params, grid, pos=pos, mass=mass, m_rho_w=m_rho * wmag)
    n_hat = eta * _inv_r((eta * eta).sum(-1, keepdim=True))
    if dim == 3:
        return torch.linalg.cross(n_hat, omega, dim=-1)
    # omega is the scalar z-curl: N x (w zhat) = (N_y w, -N_x w)
    w_z = omega[:, 0]
    return torch.stack([n_hat[:, 1] * w_z, -n_hat[:, 0] * w_z], dim=-1)


@torch.no_grad()
def step(
    params: FluidParams,
    grid: nb.BinnedGrid,
    pbf: PbfParams,
    b: nb.BinnedState,
    obstacles=None,
    fold=pf.whole_grid,
) -> nb.BinnedState:
    """One PBF step in binned space (see the module docstring). Every fold
    is a call ``fold(fn, *args, **fields)`` of a ``neighbors.pbf_folds``
    function on whole-grid per-slot fields: ``pbf_folds.whole_grid`` runs
    it on the whole grid, ``parallel.sharding.mesh_fold`` on each shard of
    a mesh. Each projection's dx call takes the hit words its lambda call
    returned, as one more per-slot field.

    On a periodic grid every rebin check is followed by ``wrap_ghosts``,
    walls and the box projection act on the wall axes only, and the final
    displacement is folded to its minimum image: a rebin folds a
    seam-crossing x* into the primary box while the step-start position
    (stash or ride payload, unoffset in the ghosts) stays continuous."""
    ride = pbf.epilogue == "ride"
    if not ride:
        with annotate("sph.predict"):
            # Owner-indexed stashes, taken before the entry rebin: a fired
            # rebin permutes slots (owners stay) and zeroes the density.
            safe = torch.clamp(b.slot_of, 0, grid.num_slots - 1).to(torch.int64)
            pos0c = b.pos[safe]       # [K, dim] step-start positions
            rho_prev_c = b.density[safe]  # previous step's final density

    periodic = any(grid.periodic)
    walls = wall_axes(grid)

    def rebin_check(bb, **kw):
        with annotate("sph.rebin_check"):
            bb = maybe_rebin(grid, bb, **kw)
            return nb.wrap_ghosts(grid, bb) if periodic else bb

    b = rebin_check(b, carry_density=ride)

    with annotate("sph.predict"):
        x_star, travel = integrate.predict(params, grid, b, walls, obstacles)

        # "gather": vel is left as it is (light mid-step rebins drop it);
        # "ride": the vel slots carry the step-start positions through full,
        # density-carrying rebins.
        b = replace(b, pos=x_star, vel=b.pos if ride else b.vel, travel=travel)
        proj_cap = torch.clamp(pbf.proj_cap_h * params.h, max=0.5 * grid.skin)

    for _ in range(pbf.iters):
        b = rebin_check(b, light=not ride, carry_density=ride)
        with annotate("sph.project"):
            fields = {"pos": b.pos, "mass": b.mass}
            lam, _, words = fold(pf.lambda_fold, params, pbf, grid, **fields)
            dx = fold(pf.dx_fold, params, pbf, grid, **fields, lam=lam, words=words)
            del words  # [S, M] int32 on the card: gone before the next lambda makes its own
            pos, travel = integrate.project(params, grid, b, walls, dx, pbf.sor, proj_cap)
            b = replace(b, pos=pos, travel=travel)

    b = rebin_check(b, light=not ride, carry_density=ride)
    with annotate("sph.epilogue"):
        x_star = b.pos
        if ride:
            pos0, rho_prev = b.vel, b.density
        else:
            own = torch.clamp(b.owner, 0, pos0c.shape[0] - 1).to(torch.int64)
            pos0, rho_prev = pos0c[own], rho_prev_c[own]
        m_rho, new_vel = integrate.pbf_velocity(params, grid, b, pos0, rho_prev)

        if params.use_xsph and not pbf.use_vorticity:
            rho, dv = _density_xsph_fold(params, grid, x_star, new_vel, b.mass, m_rho, fold)
            rho, new_vel = integrate.pbf_mix(params, grid, b, new_vel, dv, params.xsph_eps, rho)
        else:
            rho = density(params, grid, b)  # b.pos is x_star
            rho = torch.maximum(rho, 1e-6 * params.rest_density)
            if pbf.use_vorticity:
                omega = _vorticity_fold(params, grid, x_star, new_vel, b.mass, rho, fold)
                f_vort = _vorticity_force(params, grid, x_star, b.mass, rho, omega, fold)
                _, new_vel = integrate.pbf_mix(params, grid, b, new_vel, f_vort,
                                               pbf.vort_eps * params.dt)
            if params.use_xsph:
                _, dv = _density_xsph_fold(params, grid, x_star, new_vel, b.mass, m_rho, fold)
                _, new_vel = integrate.pbf_mix(params, grid, b, new_vel, dv, params.xsph_eps)

        return replace(b, vel=new_vel, density=rho, sim_time=b.sim_time + params.dt)


def simulate(
    params: FluidParams,
    grid: nb.BinnedGrid,
    pbf: PbfParams,
    b: nb.BinnedState,
    n_steps: int,
    obstacles=None,
    fold=pf.whole_grid,
) -> nb.BinnedState:
    """Roll ``n_steps`` steps."""
    for _ in range(int(n_steps)):
        b = step(params, grid, pbf, b, obstacles, fold)
    return b
