"""CPU/NumPy oracle stepper — the trajectory-match reference.

The 2D dam break must match a CPU reference trajectory to 1e-3 over 1k
steps. This is a dense O(N^2) vectorised NumPy implementation that mirrors
the engine's math **term for term and in the same order** (same kernels and
constants, same EOS clamp, same masks, same integration order), so the
comparison is meaningful. Run in float64 it serves as the precision
reference; the engine's own f32/f64 parity is tested separately.

It is the JAX package's ``oracle.py`` with one change: parameters, states
and obstacles arrive as tensors on any device and are read back to the host
(``_host``), so the arithmetic, and its bits, are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _host(v, dtype=None) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


def _poly6_coeff(dim, h):
    return 4.0 / (math.pi * h**8) if dim == 2 else 315.0 / (64.0 * math.pi * h**9)


def _spiky_grad_coeff(dim, h):
    return -30.0 / (math.pi * h**5) if dim == 2 else -45.0 / (math.pi * h**6)


def _visc_lap_coeff(dim, h):
    return 40.0 / (math.pi * h**5) if dim == 2 else 45.0 / (math.pi * h**6)


def _cohesion(dim, h, r):
    k = 32.0 / (math.pi * h ** (9 if dim == 3 else 8))
    hr3 = np.maximum(h - r, 0.0) ** 3
    r3 = r**3
    c = np.where(r <= 0.5 * h, 2.0 * hr3 * r3 - h**6 / 64.0, hr3 * r3)
    return np.where((r > 0.0) & (r < h), k * c, 0.0)


class OracleSim:
    """Dense-pair NumPy mirror of sph_pie_torch.solvers.wcsph.step."""

    def __init__(self, params, pos, vel, mass, dtype=np.float64, obstacles=None):
        self.dim = int(params.dim)
        self.gamma = int(params.eos_gamma)
        f = lambda v: _host(v, dtype)
        self.h = float(params.h)
        self.dt = f(params.dt)
        self.rho0 = f(params.rest_density)
        self.c0 = f(params.sound_speed)
        self.mu = f(params.viscosity)
        self.xsph_eps = f(params.xsph_eps)
        self.st = f(params.surface_tension)
        self.gravity = f(params.gravity)
        self.bmin = f(params.bound_min)
        self.bmax = f(params.bound_max)
        self.bk = f(params.boundary_stiffness)
        self.bc = f(params.boundary_damping)
        self.vcap = f(params.max_speed)
        self.B = self.rho0 * self.c0**2 / self.gamma
        self.pos = np.array(pos, dtype)
        self.vel = np.array(vel, dtype)
        self.mass = np.array(mass, dtype)
        self.dtype = dtype
        self.obstacles = obstacles  # scenes.obstacles.Obstacles or None
        self.t = 0.0  # sim time (drives moving obstacles)

    def step(self):
        dim, h = self.dim, self.h
        h2 = h * h
        tiny = 1e-12
        pos, vel, mass = self.pos, self.vel, self.mass

        d = pos[:, None, :] - pos[None, :, :]          # x_ij [N, N, dim]
        r2 = np.sum(d * d, axis=-1)

        # --- density (self term included) + floor ---
        w = _poly6_coeff(dim, h) * np.maximum(h2 - r2, 0.0) ** 3
        rho = np.maximum((mass[None, :] * w).sum(axis=1), 1e-6 * self.rho0)

        # --- Tait EOS with free-surface clamp ---
        prs = np.maximum(self.B * ((rho / self.rho0) ** self.gamma - 1.0), 0.0)

        # --- pair forces ---
        live = (r2 < h2) & (r2 > tiny)
        r = np.sqrt(np.maximum(r2, tiny))
        rhat = d / r[..., None]
        m_j = np.where(live, mass[None, :], 0.0)
        inv_rho_j = 1.0 / rho[None, :]

        gw = _spiky_grad_coeff(dim, h) * np.maximum(h - r, 0.0) ** 2
        p_term = prs[:, None] / rho[:, None] ** 2 + prs[None, :] * inv_rho_j**2
        acc = -np.sum((m_j * p_term * gw)[..., None] * rhat, axis=1)

        dv = vel[None, :, :] - vel[:, None, :]
        lap = _visc_lap_coeff(dim, h) * np.maximum(h - r, 0.0)
        visc_w = m_j * inv_rho_j * lap
        acc += (self.mu / rho[:, None]) * np.sum(visc_w[..., None] * dv, axis=1)

        coh = _cohesion(dim, h, r)
        acc -= self.st * np.sum((m_j * coh)[..., None] * rhat, axis=1)

        xw = np.where(live, mass[None, :] * inv_rho_j * w, 0.0)
        xsph = np.sum(xw[..., None] * dv, axis=1)

        # --- gravity + boundary penalty (damping ramps over 0.1h; see
        # solvers/wcsph.py boundary_accel for why it must be continuous) ---
        acc += self.gravity
        pen_lo = np.maximum(self.bmin - pos, 0.0)
        pen_hi = np.maximum(pos - self.bmax, 0.0)
        pen = np.max(pen_lo + pen_hi, axis=-1, keepdims=True)
        ramp = np.minimum(pen / (0.1 * self.h), 1.0)
        acc += self.bk * (pen_lo - pen_hi) - self.bc * ramp * vel
        if self.obstacles is not None:
            acc += self._obstacle_accel(pos, vel)

        # --- symplectic Euler + CFL speed clamp + XSPH advection ---
        v = vel + self.dt * acc
        speed2 = np.sum(v * v, axis=-1, keepdims=True)
        scale = np.where(speed2 > self.vcap**2, self.vcap / np.sqrt(speed2), 1.0)
        self.vel = v * scale
        self.pos = pos + self.dt * (self.vel + self.xsph_eps * xsph)
        self.density, self.pressure = rho, prs
        self.t += float(self.dt)

    def _obstacle_accel(self, pos, vel):
        """NumPy mirror of scenes.obstacles.accel (incl. motion model and
        per-obstacle relative-velocity damping)."""
        ob = self.obstacles
        t = getattr(self, "t", 0.0)
        acc = np.zeros_like(pos)

        def offsets(lin, amp, freq, phase):
            ang = 2.0 * np.pi * freq * t + phase
            off = lin * t + amp * np.sin(ang)[:, None]
            v = lin + amp * (2.0 * np.pi * freq * np.cos(ang))[:, None]
            return off.astype(self.dtype), v.astype(self.dtype)

        sc = _host(ob.sphere_center, self.dtype)
        if sc.shape[0]:
            off, vob = offsets(
                _host(ob.sphere_lin, self.dtype),
                _host(ob.sphere_amp, self.dtype),
                _host(ob.sphere_freq, self.dtype),
                _host(ob.sphere_phase, self.dtype),
            )
            sr = _host(ob.sphere_radius, self.dtype)
            d = pos[:, None, :] - (sc + off)[None, :, :]
            dist = np.sqrt(np.maximum((d * d).sum(-1), 1e-12))
            pen = np.maximum(sr[None, :] - dist, 0.0)
            nrm = d / dist[..., None]
            acc += float(ob.stiffness) * (pen[..., None] * nrm).sum(1)
            ramp = np.minimum(pen / float(ob.ramp_dist), 1.0)
            rel = vel[:, None, :] - vob[None, :, :]
            acc -= float(ob.damping) * (ramp[..., None] * rel).sum(1)
        bl = _host(ob.box_lo, self.dtype)
        if bl.shape[0]:
            off, vob = offsets(
                _host(ob.box_lin, self.dtype),
                _host(ob.box_amp, self.dtype),
                _host(ob.box_freq, self.dtype),
                _host(ob.box_phase, self.dtype),
            )
            bh = _host(ob.box_hi, self.dtype) + off
            blo = bl + off
            p = pos[:, None, :]
            inside = ((p > blo[None]) & (p < bh[None])).all(-1)
            d_lo = p - blo[None]
            d_hi = bh[None] - p
            d_face = np.minimum(d_lo, d_hi)
            min_ax = np.argmin(d_face, -1)
            pen = np.min(d_face, -1)
            sign = np.where(
                np.take_along_axis(d_lo, min_ax[..., None], -1)
                <= np.take_along_axis(d_hi, min_ax[..., None], -1),
                -1.0,
                1.0,
            )[..., 0]
            push = sign[..., None] * np.eye(pos.shape[-1], dtype=self.dtype)[min_ax]
            w = np.where(inside, pen, 0.0)
            acc += float(ob.stiffness) * (w[..., None] * push).sum(1)
            ramp = np.minimum(w / float(ob.ramp_dist), 1.0)
            rel = vel[:, None, :] - vob[None, :, :]
            acc -= float(ob.damping) * (ramp[..., None] * rel).sum(1)
        return acc

    def run(self, n_steps: int):
        for _ in range(n_steps):
            self.step()
        return self.pos


def oracle_from_scene(scene, dtype=np.float64) -> OracleSim:
    """Build an oracle over a Scene's *active* particles (its tensors are
    read back from their device)."""
    act = _host(scene.state.active)
    return OracleSim(
        scene.params,
        _host(scene.state.pos)[act],
        _host(scene.state.vel)[act],
        _host(scene.state.mass)[act],
        dtype=dtype,
    )


class PbfOracle:
    """Brute-force O(N^2) mirror of solvers/pbf.step (see that docstring
    for the skin-budget scheme; here there is no cell list so only the
    projection clamp and update order must match).

    Mirrors, in order: predict (gravity + walls + obstacles, speed clamp),
    ``iters`` Jacobi projections (unclamped constraint C = rho/rho0 - 1,
    CFM denominator, s_corr artificial pressure, ``sor`` under-relaxation,
    per-projection cap ``proj_cap``, clip to bounds), velocity from
    (x - x0)/dt with speed clamp, final density, optional XSPH."""

    def __init__(self, params, pbf_params, pos, vel, mass, proj_cap,
                 dtype=np.float64):
        f = lambda v: _host(v, dtype)
        self.dim = int(params.dim)
        self.h = float(params.h)
        self.dt = float(params.dt)
        self.rho0 = float(params.rest_density)
        self.gravity = f(params.gravity)
        self.bmin = f(params.bound_min)
        self.bmax = f(params.bound_max)
        self.bk = float(params.boundary_stiffness)
        self.bc = float(params.boundary_damping)
        self.vcap = float(params.max_speed)
        self.xsph_eps = float(params.xsph_eps)
        self.use_xsph = bool(params.use_xsph)
        self.iters = int(pbf_params.iters)
        self.sor = float(pbf_params.sor)
        self.relax_eps = float(pbf_params.relax_eps)
        self.s_corr_k = float(pbf_params.s_corr_k)
        self.s_corr_n = float(pbf_params.s_corr_n)
        self.s_corr_dq = float(pbf_params.s_corr_dq)
        self.proj_cap = float(proj_cap)
        self.pos = np.array(pos, dtype)
        self.vel = np.array(vel, dtype)
        self.mass = np.array(mass, dtype)
        self.dtype = dtype
        # Previous step's final density — the Monaghan XSPH weight source
        # (engine: pbf.step's rho_prev_c stash). None = virgin (rest
        # density fallback), matching the engine's density-0 slots.
        self._rho_prev = None

    def _poly6(self, r2):
        h = self.h
        c = (
            4.0 / (np.pi * h**8)
            if self.dim == 2
            else 315.0 / (64.0 * np.pi * h**9)
        )
        q = np.maximum(h * h - r2, 0.0)
        return c * q * q * q

    def _spiky_grad(self, d, r):
        h = self.h
        c = -30.0 / (np.pi * h**5) if self.dim == 2 else -45.0 / (np.pi * h**6)
        q = np.maximum(h - r, 0.0)
        return (c * q * q / r)[..., None] * d

    def _pairs(self, x):
        d = x[:, None, :] - x[None, :, :]
        r2 = (d * d).sum(-1)
        np.fill_diagonal(r2, np.inf)  # self handled separately
        return d, r2

    def _lambda(self, x):
        tiny = 1e-12
        d, r2 = self._pairs(x)
        r = np.sqrt(np.maximum(r2, tiny))
        live = r2 < self.h * self.h
        m = np.where(live, self.mass[None, :], 0.0)
        rho = (self.mass[None, :] * self._poly6(np.where(live, r2, np.inf))).sum(1)
        rho = rho + self.mass * self._poly6(0.0)  # self term
        grad = np.where(live[..., None], self._spiky_grad(d, r), 0.0)
        g = m[..., None] * grad / self.rho0
        grad_sum = g.sum(1)
        grad_sq = (g * g).sum(-1).sum(1)
        denom = grad_sq + (grad_sum * grad_sum).sum(-1)
        c = rho / self.rho0 - 1.0
        lam = -c / (denom + self.relax_eps)
        return lam, rho

    def _dx(self, x, lam):
        tiny = 1e-12
        d, r2 = self._pairs(x)
        r = np.sqrt(np.maximum(r2, tiny))
        live = r2 < self.h * self.h
        m = np.where(live, self.mass[None, :], 0.0)
        wk = self._poly6(np.where(live, r2, np.inf))
        w_dq = self._poly6((self.s_corr_dq * self.h) ** 2)
        s_corr = -(self.s_corr_k * self.h * self.h) * (wk / w_dq) ** self.s_corr_n
        lam_sum = lam[:, None] + lam[None, :] + s_corr
        grad = np.where(live[..., None], self._spiky_grad(d, r), 0.0)
        return (m[..., None] * lam_sum[..., None] * grad).sum(1) / self.rho0

    def step(self):
        # predict
        acc = np.zeros_like(self.pos) + self.gravity
        pen_lo = np.maximum(self.bmin - self.pos, 0.0)
        pen_hi = np.maximum(self.pos - self.bmax, 0.0)
        pen = np.max(pen_lo + pen_hi, axis=-1, keepdims=True)
        ramp = np.minimum(pen / (0.1 * self.h), 1.0)
        acc += self.bk * (pen_lo - pen_hi) - self.bc * ramp * self.vel
        v = self.vel + self.dt * acc
        sp2 = (v * v).sum(-1, keepdims=True)
        v = v * np.where(sp2 > self.vcap**2, self.vcap / np.sqrt(sp2), 1.0)
        pos0 = self.pos
        x = self.pos + self.dt * v

        for _ in range(self.iters):
            lam, _ = self._lambda(x)
            dx = self.sor * self._dx(x, lam)
            n2 = (dx * dx).sum(-1, keepdims=True)
            n = np.sqrt(np.maximum(n2, 1e-30))
            dx = dx * np.minimum(1.0, self.proj_cap / n)
            x = np.clip(x + dx, self.bmin, self.bmax)

        v = (x - pos0) / self.dt
        sp2 = (v * v).sum(-1, keepdims=True)
        v = v * np.where(sp2 > self.vcap**2, self.vcap / np.sqrt(sp2), 1.0)
        _, rho = self._lambda(x)
        rho = np.maximum(rho, 1e-6 * self.rho0)

        if self.use_xsph:
            # Monaghan m_j/rho_j with rho_j from the PREVIOUS step's final
            # density (rest density on the first step) — mirrors
            # pbf._density_xsph_fold's fused form and staleness exactly.
            rp = (
                np.full((len(self.mass),), self.rho0, self.dtype)
                if self._rho_prev is None
                else self._rho_prev
            )
            rho_eff = np.where(rp > 0, rp, self.rho0)
            d, r2 = self._pairs(x)
            live = r2 < self.h * self.h
            m = np.where(live, self.mass[None, :], 0.0)
            wk = self._poly6(np.where(live, r2, np.inf))
            xw = m / rho_eff[None, :] * wk
            dv = v[None, :, :] - v[:, None, :]
            v = v + self.xsph_eps * (xw[..., None] * dv).sum(1)
            sp2 = (v * v).sum(-1, keepdims=True)
            v = v * np.where(sp2 > self.vcap**2, self.vcap / np.sqrt(sp2), 1.0)

        self.pos, self.vel, self.density = x, v, rho
        self._rho_prev = rho

    def run(self, n_steps: int):
        for _ in range(n_steps):
            self.step()
        return self.pos
