"""Obstacles: penalty forces from simple SDF shapes, optionally moving.

Spheres (circles in 2D) and axis-aligned boxes, each set a fixed-count
tensor (possibly zero-length). An empty set of shapes adds nothing and
launches nothing: ``accel`` tests its length on the host.

Motion model (per shape): center(t) = center0 + lin*t + amp*sin(2 pi f t
+ phase). Boxes translate rigidly (lo and hi share the offset). The
penetration damper acts on velocity relative to the obstacle surface, so
a moving obstacle drags fluid (stirrer/paddle scenes) instead of merely
blocking it. Everything is closed-form in the state's ``sim_time``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Obstacles:
    """Spheres (circles in 2D) and axis-aligned boxes."""

    sphere_center: torch.Tensor  # [Ms, dim]
    sphere_radius: torch.Tensor  # [Ms]
    box_lo: torch.Tensor         # [Mb, dim]
    box_hi: torch.Tensor         # [Mb, dim]
    sphere_lin: torch.Tensor     # [Ms, dim] linear velocity
    sphere_amp: torch.Tensor     # [Ms, dim] oscillation amplitude
    sphere_freq: torch.Tensor    # [Ms] oscillation frequency (Hz)
    sphere_phase: torch.Tensor   # [Ms]
    box_lin: torch.Tensor        # [Mb, dim]
    box_amp: torch.Tensor        # [Mb, dim]
    box_freq: torch.Tensor       # [Mb]
    box_phase: torch.Tensor      # [Mb]
    stiffness: torch.Tensor      # [] penalty spring constant
    damping: torch.Tensor        # [] velocity damping inside penetration
    ramp_dist: torch.Tensor      # [] damping ramps in over this depth


def empty(
    dim: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Obstacles:
    """No shapes, default constants."""
    return make(dim, dtype=dtype, device=device)


def make(
    dim: int,
    spheres=(),          # iterable of (center, radius)
    boxes=(),            # iterable of (lo, hi)
    stiffness: float = 1e4,
    damping: float = 10.0,
    ramp_dist: float = 2e-3,
    sphere_motions=(),   # iterable of (lin, amp, freq, phase) per sphere
    box_motions=(),      # iterable of (lin, amp, freq, phase) per box
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Obstacles:
    sc = [c for c, _ in spheres]
    sr = [r for _, r in spheres]
    bl = [lo for lo, _ in boxes]
    bh = [hi for _, hi in boxes]

    def motions(ms, n):
        ms = list(ms)
        while len(ms) < n:
            ms.append(([0.0] * dim, [0.0] * dim, 0.0, 0.0))
        return tuple([m[i] for m in ms] for i in range(4))

    s_lin, s_amp, s_freq, s_phase = motions(sphere_motions, len(sc))
    b_lin, b_amp, b_freq, b_phase = motions(box_motions, len(bl))

    def f(v, *shape):
        if not len(v):
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.tensor(v, dtype=dtype, device=device).reshape(len(v), *shape[1:])

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return Obstacles(
        sphere_center=f(sc, 0, dim),
        sphere_radius=f(sr, 0),
        box_lo=f(bl, 0, dim),
        box_hi=f(bh, 0, dim),
        sphere_lin=f(s_lin, 0, dim),
        sphere_amp=f(s_amp, 0, dim),
        sphere_freq=f(s_freq, 0),
        sphere_phase=f(s_phase, 0),
        box_lin=f(b_lin, 0, dim),
        box_amp=f(b_amp, 0, dim),
        box_freq=f(b_freq, 0),
        box_phase=f(b_phase, 0),
        stiffness=scalar(stiffness),
        damping=scalar(damping),
        ramp_dist=scalar(ramp_dist),
    )


def _offsets(lin, amp, freq, phase, t):
    """Rigid translation and surface velocity at sim time t."""
    two_pi = 6.283185307179586
    ang = two_pi * freq * t + phase
    off = lin * t + amp * torch.sin(ang)[:, None]
    v = lin + amp * (two_pi * freq * torch.cos(ang))[:, None]
    return off, v


def accel(obs: Obstacles, pos: torch.Tensor, vel: torch.Tensor, t=0.0) -> torch.Tensor:
    """Penalty acceleration pushing particles out of all obstacles.

    pos, vel: [N, dim]; ``t`` is the sim time (a 0-d tensor or a float)
    for moving shapes. Returns [N, dim]. The damper acts on velocity
    relative to the penetrated obstacle, weighted by that obstacle's
    penetration ramp. Temporaries are [N, M, dim] for M shapes of a kind.
    The sums start from the first term, not from zeros: the same values as
    the reference's ``0 + term`` but for the sign of a zero.
    """
    t = torch.as_tensor(t, dtype=pos.dtype, device=pos.device)
    acc = None

    if obs.sphere_center.shape[0]:
        off, vob = _offsets(
            obs.sphere_lin, obs.sphere_amp, obs.sphere_freq, obs.sphere_phase, t
        )
        center = obs.sphere_center + off
        d = pos[:, None, :] - center[None, :, :]                     # [N, Ms, dim]
        dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-12))  # [N, Ms]
        pen = torch.clamp(obs.sphere_radius[None, :] - dist, min=0.0)
        nrm = d / dist[..., None]
        acc = obs.stiffness * (pen[..., None] * nrm).sum(1)
        ramp = torch.clamp(pen / obs.ramp_dist, max=1.0)            # [N, Ms]
        rel = vel[:, None, :] - vob[None, :, :]
        acc = acc - obs.damping * (ramp[..., None] * rel).sum(1)

    if obs.box_lo.shape[0]:
        off, vob = _offsets(obs.box_lin, obs.box_amp, obs.box_freq, obs.box_phase, t)
        # Signed distance to an AABB; inside, push out along the closest face.
        lo = (obs.box_lo + off)[None, :, :]
        hi = (obs.box_hi + off)[None, :, :]
        p = pos[:, None, :]
        inside = ((p > lo) & (p < hi)).all(-1)       # [N, Mb]
        d_lo = p - lo    # distance to each low face (positive inside)
        d_hi = hi - p
        d_face = torch.minimum(d_lo, d_hi)           # [N, Mb, dim]
        min_ax = torch.argmin(d_face, dim=-1)        # [N, Mb], first on ties
        pen = d_face.amin(-1)                        # [N, Mb]
        at = min_ax[..., None]
        sign = torch.where(
            torch.gather(d_lo, -1, at) <= torch.gather(d_hi, -1, at), -1.0, 1.0
        )[..., 0].to(pos.dtype)                      # [N, Mb]
        push = sign[..., None] * torch.nn.functional.one_hot(
            min_ax, pos.shape[-1]
        ).to(pos.dtype)                              # [N, Mb, dim]
        w = torch.where(inside, pen, 0.0)
        spring = obs.stiffness * (w[..., None] * push).sum(1)
        acc = spring if acc is None else acc + spring
        ramp = torch.clamp(w / obs.ramp_dist, max=1.0)
        rel = vel[:, None, :] - vob[None, :, :]
        acc = acc - obs.damping * (ramp[..., None] * rel).sum(1)

    return torch.zeros_like(pos) if acc is None else acc
