"""The five pair folds of PBF over the binned slots.

Counterparts of the reference's XLA folds in ``solvers/pbf.py``
(``_lambda_fold``, ``_dx_fold``, ``_density_xsph_fold``,
``_vorticity_fold`` and the sum of ``_vorticity_force``), which reach no
Pallas kernel. With d = x_i - x_j, inv_r = rsqrt(max(r^2, 1e-12)),
W = W_poly6(r^2) and g = spiky_grad_mag(r) inv_r, over the slab windows of
each home slot i:

  ``lambda_fold``        rho = sum m_j W, the constraint gradients' sums, and
                         lambda = -(rho/rho0 - 1) / (denom + relax_eps)
  ``dx_fold``            (1/rho0) sum m_j (lam_i + lam_j + s_corr) g d,
                         s_corr = -k h^2 (W / W(dq h))^n
  ``density_xsph_fold``  rho = sum m_j W, dv = S1 - v_i S0 (the moment form)
  ``vorticity_fold``     omega = sum (m/rho)_j (v_j - v_i) x (g d) ([n, 3];
                         the scalar z-curl [n, 1] in 2D)
  ``vorticity_eta_fold`` eta = sum (m/rho |omega|)_j g d

Each function runs its plain version, the blocked ``binned.slab_fold``,
for CPU tensors, launches its kernel (``csrc/pbf.cu``, staged over runs of
cells: ``neighbors/runs.py``) for CUDA tensors, and raises on any other
device. No launcher reads anything back to the host.

Hit words: on the card ``lambda_fold`` also returns the words of its pair
walk, [n, ``words_per_slot``] int32, bit b of word w of slab s set when the
home slot's (32 w + b)-th occupied candidate of that slab's window (its
three cells, in slot order) lies within h. ``dx_fold`` given those words on
the same pos, mass and home range walks them and makes no distance test;
given none it makes its own tests, with the same bits. Words are per-slot
rows like any output, so ``fold`` carries them from the lambda call to the
dx call, on a mesh too; the rows of empty slots are not written. The plain
folds record no words: on the CPU ``words`` has 0 columns, and ``dx_fold``
ignores it.

All take ``home=(first, count)`` as ``neighbors/density.py`` does: the
per-slot inputs span a buffer, the outputs its home slots. The plain
versions give the slots of empty cells 0 and may give other empty slots a
sum; the kernels give every empty slot 0. Nothing reads those values: every
window term carries m_j = 0 and every update is masked by the slots that
move.

``whole_grid`` is the route of a fold over the whole grid;
``parallel.sharding.mesh_fold`` routes the same call over a mesh of shards.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.kernels import smoothing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.neighbors import runs

# Op codes of csrc/pbf.cu.
_OPS = {"lambda": 0, "dx": 1, "density_xsph": 2, "vorticity": 3, "vorticity_eta": 4}


def whole_grid(fn, *args, **fields):
    """``fn(*args, **fields)``: a fold of this module over the whole grid,
    its per-slot inputs ``fields`` given by name."""
    return fn(*args, **fields)


def integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
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


def inv_r_of(r2: torch.Tensor) -> torch.Tensor:
    """rsqrt(max(r^2, 1e-12)): 1/r without a divide, finite at r = 0."""
    return torch.rsqrt(torch.clamp(r2, min=1e-12))


def _fold(grid: nb.BinnedGrid, fields: dict, pair, n_out: int, home) -> tuple:
    """``n_out`` sums of ``pair`` over the home cells of the buffer
    ``fields`` (the whole grid when ``home`` is None)."""
    if home is None:
        zero = torch.zeros_like(fields["mass"])
        return nb.slab_fold(grid, fields, pair, (zero,) * n_out)
    first, count = nb.home_range(grid, fields["mass"].shape[0], home)
    local, halo = nb.split_home(grid, fields, (first, count))
    zero = torch.zeros_like(local["mass"])
    return nb.slab_fold(grid, local, pair, (zero,) * n_out, halo=halo, local_cells=count)


def _home_rows(grid: nb.BinnedGrid, x: torch.Tensor, home) -> torch.Tensor:
    first, count = nb.home_range(grid, x.shape[0], home)
    return x[first * grid.cap : (first + count) * grid.cap]


def words_per_slot(dim: int, cap: int) -> int:
    """M, the hit words of one home slot: ceil(3 cap / 32) for each of the
    3^(dim-1) slabs (a slab's candidates lie in three cells)."""
    return 3 ** (dim - 1) * -(-3 * cap // 32)


def _checked(op: str, grid: nb.BinnedGrid, pos, mass, prm, home, a=None, b=None,
             words=None) -> tuple[int, int, int]:
    """(S, first, count) of a launch of op ``op`` after checking its inputs
    (``a`` per-slot rows, ``b`` [S], ``words`` [S, M] int32)."""
    dt, dev, dim, cap = pos.dtype, pos.device, grid.dim, grid.cap
    S = pos.shape[0]
    first, count = nb.home_range(grid, S, home)
    if pos.shape != (S, dim) or mass.shape != (S,):
        raise ValueError(f"pbf {op}: pos must be [{S}, {dim}] and mass [{S}]")
    extra = {}
    if a is not None:
        if a.shape[0] != S:
            raise ValueError(f"pbf {op}: per-slot input of {a.shape[0]} rows, not {S}")
        extra["a"] = (a, None)
    if b is not None:
        if b.shape != (S,):
            raise ValueError(f"pbf {op}: per-slot input must be [{S}], got {tuple(b.shape)}")
        extra["b"] = (b, None)
    if words is not None:
        m = words_per_slot(dim, cap)
        if words.shape != (S, m):
            raise ValueError(f"pbf {op}: words must be [{S}, {m}], got {tuple(words.shape)}")
        extra["words"] = (words, torch.int32)
    _native.check_cuda(f"pbf {op}", dt, dev, pos=(pos, None), mass=(mass, None),
                       prm=(prm, None), **extra)
    runs.check_staging(f"pbf {op}", cap, pos=pos, mass=mass)
    return S, first, count


def _launch(op: str, grid: nb.BinnedGrid, pos, mass, prm, widths, home, a=None, b=None,
            n_pow: int = 0) -> list[torch.Tensor]:
    """Launch op ``op`` of ``csrc/pbf.cu``'s ``pbf_runs``; returns its
    outputs, one per entry of ``widths`` (trailing shape of a home row)."""
    dt, dev, dim, cap = pos.dtype, pos.device, grid.dim, grid.cap
    S, first, count = _checked(op, grid, pos, mass, prm, home, a=a, b=b)
    outs = [torch.empty((count * cap,) + w, dtype=dt, device=dev) for w in widths]
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "pbf", dt, _OPS[op], pos, mass, a, b, prm, outs[0], outs[1] if len(outs) > 1 else None,
        S, cap, dim, s0, s1, first, count, n_pow,
    )
    return outs


def _walk(op: str, grid: nb.BinnedGrid, pos, mass, prm, widths, home, lam=None, words=None,
          n_pow: int = 0) -> list[torch.Tensor]:
    """Launch op ``op`` of ``csrc/pbf.cu``'s ``pbf_walk``: lambda returns
    its outputs (``widths`` as ``_launch``) and its hit words; dx walks
    ``words`` with ``lam``."""
    dt, dev, dim, cap = pos.dtype, pos.device, grid.dim, grid.cap
    S, first, count = _checked(op, grid, pos, mass, prm, home, a=lam, words=words)
    if words is not None:  # lam is staged with the window, words read 16 bytes at a time
        runs.check_staging(f"pbf {op}", cap, lam=lam, words=words)
    m = words_per_slot(dim, cap)
    outs = [torch.empty((count * cap,) + w, dtype=dt, device=dev) for w in widths]
    made = None if words is not None else torch.empty((count * cap, m), dtype=torch.int32,
                                                      device=dev)
    s0, s1 = (grid.strides + (0,))[:2]
    _native.launch(
        "pbf_walk", dt, _OPS[op], pos, mass, lam, prm, outs[0],
        outs[1] if len(outs) > 1 else None, words, made, S, cap, dim, s0, s1, first, count, m,
        n_pow,
    )
    return outs if made is None else outs + [made]


def _prm(dtype: torch.dtype, *values) -> torch.Tensor:
    """The op's constants as one device vector of the kernel's type."""
    return torch.stack([torch.as_tensor(v).to(dtype) for v in values])


# ---------------------------------------------------------------- lambda


def lambda_fold_plain(params: FluidParams, pbf, grid, pos, mass, home=None):
    """(lambda, rho) of the home slots by the slab fold: the sums need no
    per-pair divide or mask (the kernel cut-offs zero far pairs, d == 0
    zeroes the self pair's gradient, empty slots carry mass 0); the 1/rho0
    factors are applied once, after the fold."""
    dim, h = params.dim, params.h
    rho0 = params.rest_density

    def pair(carry, hm, w):
        rho, grad_sq, *grad_sum = carry
        d, r2 = nb._r2(dim, hm, w)
        inv_r = inv_r_of(r2)
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

    fields = {**nb._planar("p", pos), "mass": mass}
    rho, grad_sq, *grad_sum = _fold(grid, fields, pair, 2 + dim, home)
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


def lambda_fold(params: FluidParams, pbf, grid, pos, mass, home=None):
    """(lambda, rho [n], words) of the n home slots: ``lambda_fold_plain``
    on the CPU (words [n, 0]), op ``lambda`` of ``csrc/pbf.cu``'s walk on
    the card (words [n, ``words_per_slot``], for ``dx_fold``)."""
    if not _native.on_card("lambda_fold", pos):
        lam, rho = lambda_fold_plain(params, pbf, grid, pos, mass, home)
        return lam, rho, torch.zeros((lam.shape[0], 0), dtype=torch.int32)
    h = params.h
    prm = _prm(pos.dtype, h, smoothing.poly6_coeff(params.dim, h),
               smoothing.spiky_grad_coeff(params.dim, h), 1.0 / params.rest_density,
               pbf.relax_eps)
    lam, rho, words = _walk("lambda", grid, pos, mass, prm, ((), ()), home)
    lambda_fold.launches += 1
    return lam, rho, words


# ---------------------------------------------------------------- dx


def _dx_constants(params: FluidParams, pbf):
    """(1/W(dq h), -k h^2) of the artificial pressure."""
    h = params.h
    w_dq = smoothing.poly6(params.dim, h, (pbf.s_corr_dq * h) ** 2)
    return 1.0 / w_dq, -(pbf.s_corr_k * h * h)


def dx_fold_plain(params: FluidParams, pbf, grid, pos, mass, lam, words=None, home=None):
    """[n, dim] position corrections of the home slots from the lambdas,
    with the artificial pressure -k h^2 (W / W(dq h))^n; ``words`` (the
    kernel's hit words) is ignored."""
    dim, h = params.dim, params.h
    rho0 = params.rest_density
    inv_wdq, neg_k_h2 = _dx_constants(params, pbf)

    def pair(carry, hm, w):
        d, r2 = nb._r2(dim, hm, w)
        inv_r = inv_r_of(r2)
        r = r2 * inv_r
        m_j = w["mass"][:, None, :]
        wk = smoothing.poly6(dim, h, r2)
        s_corr = neg_k_h2 * integer_pow(wk * inv_wdq, pbf.s_corr_n)
        lam_sum = hm["lam"][:, :, None] + w["lam"][:, None, :] + s_corr
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = (m_j * lam_sum) * gw
        return tuple(c_k + (coef * d[k]).sum(2) for k, c_k in enumerate(carry))

    fields = {**nb._planar("p", pos), "mass": mass, "lam": lam}
    dxs = _fold(grid, fields, pair, dim, home)
    return torch.stack(dxs, dim=-1) * (1.0 / rho0)


def dx_fold(params: FluidParams, pbf, grid, pos, mass, lam, words=None, home=None):
    """[n, dim] corrections of the n home slots: ``dx_fold_plain`` on the
    CPU (``words`` ignored), op ``dx`` of ``csrc/pbf.cu`` on the card: its
    walk over ``words``, the words ``lambda_fold`` returned on this pos,
    mass and home range, rows of the buffer; its own distance tests when
    ``words`` is None."""
    if not _native.on_card("dx_fold", pos):
        return dx_fold_plain(params, pbf, grid, pos, mass, lam, home=home)
    h = params.h
    inv_wdq, neg_k_h2 = _dx_constants(params, pbf)
    prm = _prm(pos.dtype, h, smoothing.poly6_coeff(params.dim, h),
               smoothing.spiky_grad_coeff(params.dim, h), 1.0 / params.rest_density, inv_wdq,
               neg_k_h2)
    if words is None:
        (dx,) = _launch("dx", grid, pos, mass, prm, ((grid.dim,),), home, a=lam,
                        n_pow=pbf.s_corr_n)
    else:
        (dx,) = _walk("dx", grid, pos, mass, prm, ((grid.dim,),), home, lam=lam, words=words,
                      n_pow=pbf.s_corr_n)
        dx_fold.word_launches += 1
    dx_fold.launches += 1
    return dx


# ---------------------------------------------------------------- density + XSPH


def density_xsph_fold_plain(params: FluidParams, grid, pos, vel, mass, m_rho, home=None):
    """(rho_raw [n], dv [n, dim]) of the home slots in one fold; ``m_rho``
    is the Monaghan weight m_j / rho_j. Moment form: sum_j w_j W (v_j - v_i)
    = S1 - v_i S0, with S0 = sum_j w_j W and S1 = sum_j w_j W v_j."""
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
    rho, s0, *s1 = _fold(grid, fields, pair, 2 + dim, home)
    return rho, torch.stack(s1, dim=-1) - _home_rows(grid, vel, home) * s0[:, None]


def density_xsph_fold(params: FluidParams, grid, pos, vel, mass, m_rho, home=None):
    """(rho_raw, dv) of the n home slots: ``density_xsph_fold_plain`` on
    the CPU, op ``density_xsph`` of ``csrc/pbf.cu`` on the card."""
    if not _native.on_card("density_xsph_fold", pos):
        return density_xsph_fold_plain(params, grid, pos, vel, mass, m_rho, home)
    h = params.h
    prm = _prm(pos.dtype, h, smoothing.poly6_coeff(params.dim, h))
    rho, dv = _launch("density_xsph", grid, pos, mass, prm, ((), (grid.dim,)), home, a=vel,
                      b=m_rho)
    density_xsph_fold.launches += 1
    return rho, dv


# ---------------------------------------------------------------- vorticity


def vorticity_fold_plain(params: FluidParams, grid, pos, vel, mass, m_rho, home=None):
    """omega_i = sum_j (m/rho)_j (v_j - v_i) x grad_i W_ij (spiky gradient)
    of the home slots: [n, 3] in 3D, the scalar z-curl [n, 1] in 2D."""
    dim, h = params.dim, params.h

    def pair(carry, hm, w):
        d, r2 = nb._r2(dim, hm, w)
        inv_r = inv_r_of(r2)
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
    out = _fold(grid, fields, pair, 3 if dim == 3 else 1, home)
    return torch.stack(out, dim=-1)


def vorticity_fold(params: FluidParams, grid, pos, vel, mass, m_rho, home=None):
    """omega of the n home slots: ``vorticity_fold_plain`` on the CPU, op
    ``vorticity`` of ``csrc/pbf.cu`` on the card."""
    if not _native.on_card("vorticity_fold", pos):
        return vorticity_fold_plain(params, grid, pos, vel, mass, m_rho, home)
    h = params.h
    prm = _prm(pos.dtype, h, smoothing.spiky_grad_coeff(params.dim, h))
    (omega,) = _launch("vorticity", grid, pos, mass, prm, ((3 if grid.dim == 3 else 1,),),
                       home, a=vel, b=m_rho)
    vorticity_fold.launches += 1
    return omega


def vorticity_eta_fold_plain(params: FluidParams, grid, pos, mass, m_rho_w, home=None):
    """eta_i = sum_j (m/rho |omega|)_j grad_i W_ij of the home slots, [n,
    dim]; ``m_rho_w`` is (m/rho) |omega| per slot."""
    dim, h = params.dim, params.h

    def pair(carry, hm, w):
        d, r2 = nb._r2(dim, hm, w)
        inv_r = inv_r_of(r2)
        r = r2 * inv_r
        gw = smoothing.spiky_grad_mag(dim, h, r) * inv_r
        coef = w["m_rho_w"][:, None, :] * gw
        return tuple(c + (coef * d[k]).sum(2) for k, c in enumerate(carry))

    fields = {**nb._planar("p", pos), "mass": mass, "m_rho_w": m_rho_w}
    return torch.stack(_fold(grid, fields, pair, dim, home), dim=-1)


def vorticity_eta_fold(params: FluidParams, grid, pos, mass, m_rho_w, home=None):
    """eta of the n home slots: ``vorticity_eta_fold_plain`` on the CPU,
    op ``vorticity_eta`` of ``csrc/pbf.cu`` on the card."""
    if not _native.on_card("vorticity_eta_fold", pos):
        return vorticity_eta_fold_plain(params, grid, pos, mass, m_rho_w, home)
    h = params.h
    prm = _prm(pos.dtype, h, smoothing.spiky_grad_coeff(params.dim, h))
    (eta,) = _launch("vorticity_eta", grid, pos, mass, prm, ((grid.dim,),), home, b=m_rho_w)
    vorticity_eta_fold.launches += 1
    return eta


FOLDS = (lambda_fold, dx_fold, density_xsph_fold, vorticity_fold, vorticity_eta_fold)
for _f in FOLDS:
    _f.launches = 0
dx_fold.word_launches = 0  # the dx launches that walked lambda's words
