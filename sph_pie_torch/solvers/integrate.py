"""The per-slot update of the binned solvers' step loop, in one pass.

Two call sites, one kernel (``csrc/integrate.cu``) in two instantiations:

``update`` (``wcsph_binned.step``, after the forces fold): gravity, the
wall penalty and the obstacle term added to the pair acceleration, then
on the slots that move symplectic Euler, the speed clamp and XSPH::

    a  = ((acc + g) + wall(x, v)) [+ extra]
    v' = clamp(v + dt a)               0 where the slot does not move
    va = v' + xsph_eps xsph            0 where the slot does not move
    x' = x + dt va                     x where the slot does not move
    travel' = travel + dt sqrt(max |va|^2)

``predict`` (``pbf.step``): the same body forces with no pair term, and
the predicted positions::

    x* = x + dt clamp(v + dt ((0 + g) + wall(x, v) [+ extra]))
    travel' = travel + max |x* - x|

``wall`` is ``wcsph.boundary_accel`` on the axes that have walls
(``walls``: ``wcsph_binned.wall_axes``), ``clamp`` is
``wcsph.clamp_speed``, and a slot moves when it is valid and not a frozen
boundary particle (``binned.frozen_mask``). ``extra`` is an acceleration
computed beside the step (the obstacles' penalty), added last.

On CPU tensors each runs its plain version, the torch composition the
kernel follows operation by operation; on CUDA tensors it launches the
kernel, which reads ``vel``, ``acc``, ``xsph`` and ``extra`` only for the
slots that move, writes every slot of new output tensors, and leaves
``travel`` on the card (no host read); any other device raises.
``update.launches`` and ``predict.launches`` count the launches.
"""

from __future__ import annotations

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed

_UPDATE, _PREDICT = 0, 1


def max_norm(v: torch.Tensor) -> torch.Tensor:
    """The largest row norm of ``v``."""
    return torch.sqrt(torch.clamp((v * v).sum(-1).amax(), min=0.0))


def _body_update(params, grid, b, walls, acc, extra):
    """(move mask, clamp(v + dt a)) with a = ((acc + g) + wall(x, v)) [+
    extra], the velocity 0 where the slot does not move."""
    acc = acc + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel, walls)
    if extra is not None:
        acc = acc + extra
    move = (b.valid & ~nb.frozen_mask(grid, b))[:, None]
    vel = torch.where(move, b.vel + params.dt * acc, 0.0)
    return move, clamp_speed(params, vel)


def update_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    acc: torch.Tensor,
    xsph: torch.Tensor,
    extra: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, vel, travel) after the WCSPH update, in torch."""
    move, vel = _body_update(params, grid, b, walls, acc, extra)
    vel_adv = torch.where(move, vel + params.xsph_eps * xsph, 0.0)
    pos = torch.where(move, b.pos + params.dt * vel_adv, b.pos)
    # Hard per-step displacement bound for the Verlet-skin guarantee.
    return pos, vel, b.travel + params.dt * max_norm(vel_adv)


def predict_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    extra: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x*, travel) of PBF's prediction, in torch."""
    move, vel = _body_update(params, grid, b, walls, torch.zeros_like(b.pos), extra)
    x_star = torch.where(move, b.pos + params.dt * vel, b.pos)
    return x_star, b.travel + max_norm(x_star - b.pos)


def _launch(mode, params, grid, b, walls, acc=None, xsph=None, extra=None):
    """Launch the kernel in ``mode``; returns (pos, vel or None, travel)."""
    dt, dev, dim = b.pos.dtype, b.pos.device, params.dim
    S = b.pos.shape[0]
    vec = (S, dim)
    for name, t in (("pos", b.pos), ("vel", b.vel), ("acc", acc), ("xsph", xsph),
                    ("extra", extra)):
        if t is not None and tuple(t.shape) != vec:
            raise ValueError(f"integrate: {name} must be [{S}, {dim}], got {tuple(t.shape)}")
    if b.valid.shape != (S,) or b.owner.shape != (S,) or b.travel.shape != ():
        raise ValueError(f"integrate: valid and owner must be [{S}], travel a scalar")
    consts = {k: getattr(params, k).to(dt) for k in (
        "dt", "xsph_eps", "max_speed", "h", "boundary_stiffness", "boundary_damping",
        "gravity", "bound_min", "bound_max")}
    if any(consts[k].shape != (dim,) for k in ("gravity", "bound_min", "bound_max")):
        raise ValueError(f"integrate: gravity and the bounds must be [{dim}]")
    tensors = {"pos": (b.pos, None), "vel": (b.vel, None), "valid": (b.valid, torch.bool),
               "owner": (b.owner, torch.int32), "travel": (b.travel, None),
               **{k: (c, None) for k, c in consts.items()}}
    for name, t in (("acc", acc), ("xsph", xsph), ("extra", extra)):
        if t is not None:
            tensors[name] = (t, None)
    _native.check_cuda("integrate", dt, dev, **tensors)
    wall_bits = sum(1 << k for k in range(dim) if walls is None or walls[k])
    frozen_from = grid.max_particles - grid.n_boundary if grid.n_boundary else -1
    pos = torch.empty_like(b.pos)
    vel = torch.empty_like(b.pos) if mode == _UPDATE else None
    travel = torch.empty_like(b.travel)
    scratch = torch.zeros(2, dtype=torch.int64, device=dev)  # max bits, blocks done
    _native.launch(
        "integrate", dt, mode, b.pos, b.vel, acc, xsph, extra, b.valid, b.owner,
        *consts.values(), pos, vel, b.travel, travel, scratch, S, dim, wall_bits,
        frozen_from,
    )
    return pos, vel, travel


def _device(fn: str, b: nb.BinnedState) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    if b.pos.device.type == "cpu":
        return False
    if b.pos.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {b.pos.device}")
    return True


def update(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    acc: torch.Tensor,
    xsph: torch.Tensor,
    extra: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, vel, travel) after the WCSPH update: ``update_plain`` on the
    CPU, the kernel on the card."""
    if not _device("update", b):
        return update_plain(params, grid, b, walls, acc, xsph, extra)
    out = _launch(_UPDATE, params, grid, b, walls, acc, xsph, extra)
    update.launches += 1
    return out


def predict(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    extra: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x*, travel) of PBF's prediction: ``predict_plain`` on the CPU, the
    kernel on the card."""
    if not _device("predict", b):
        return predict_plain(params, grid, b, walls, extra)
    x_star, _, travel = _launch(_PREDICT, params, grid, b, walls, extra=extra)
    predict.launches += 1
    return x_star, travel


update.launches = 0
predict.launches = 0
