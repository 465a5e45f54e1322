"""The per-slot update of the binned solvers' step loop, in one pass.

Two call sites, one kernel (``csrc/integrate.cu``) in two modes:

``update`` (``wcsph_binned.step``, after the forces fold): gravity, the
wall penalty and the obstacle term added to the pair acceleration, then
on the slots that move symplectic Euler, the speed clamp and XSPH::

    a  = ((acc + g) + wall(x, v)) [+ obstacle(x, v, t)]
    v' = clamp(v + dt a)               0 where the slot does not move
    va = v' + xsph_eps xsph            0 where the slot does not move
    x' = x + dt va                     x where the slot does not move
    travel' = travel + dt sqrt(max |va|^2)

``predict`` (``pbf.step``): the same body forces with no pair term, and
the predicted positions::

    x* = x + dt clamp(v + dt (((0 + g) + wall(x, v)) [+ obstacle(x, v, t)]))
    travel' = travel + max |x* - x|

``wall`` is ``wcsph.boundary_accel`` on the axes that have walls
(``walls``: ``wcsph_binned.wall_axes``), ``clamp`` is
``wcsph.clamp_speed``, and a slot moves when it is valid and not a frozen
boundary particle (``binned.frozen_mask``). ``obstacle`` is
``scenes/obstacles.accel`` of the ``obstacles`` passed (none: no term) at
the state's clock ``sim_time``, added last.

On CPU tensors each runs its plain version, the torch composition the
kernel follows operation by operation (there ``obstacles.accel`` runs over
every slot); on CUDA tensors it launches the kernel, which computes the
obstacle term itself, on the slots that move, reads ``vel``, ``acc`` and
``xsph`` only for those, writes every slot of new output tensors, and
leaves ``travel`` on the card (no host read); any other device raises.
``update.launches`` and ``predict.launches`` count the launches,
``update.obstacle_launches`` and ``predict.obstacle_launches`` those of
them with an obstacle term.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from sph_pie_torch import _native
from sph_pie_torch.core.params import FluidParams
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed

_UPDATE, _PREDICT = 0, 1


def max_norm(v: torch.Tensor) -> torch.Tensor:
    """The largest row norm of ``v``."""
    return torch.sqrt(torch.clamp((v * v).sum(-1).amax(), min=0.0))


def _body_update(params, grid, b, walls, acc, obstacles):
    """(move mask, clamp(v + dt a)) with a = ((acc + g) + wall(x, v)) [+
    obstacle(x, v, t)], the velocity 0 where the slot does not move."""
    acc = acc + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel, walls)
    if obstacles is not None:
        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)
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
    obstacles: obs_lib.Obstacles | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, vel, travel) after the WCSPH update, in torch."""
    move, vel = _body_update(params, grid, b, walls, acc, obstacles)
    vel_adv = torch.where(move, vel + params.xsph_eps * xsph, 0.0)
    pos = torch.where(move, b.pos + params.dt * vel_adv, b.pos)
    # Hard per-step displacement bound for the Verlet-skin guarantee.
    return pos, vel, b.travel + params.dt * max_norm(vel_adv)


def predict_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    obstacles: obs_lib.Obstacles | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x*, travel) of PBF's prediction, in torch."""
    move, vel = _body_update(params, grid, b, walls, torch.zeros_like(b.pos), obstacles)
    x_star = torch.where(move, b.pos + params.dt * vel, b.pos)
    return x_star, b.travel + max_norm(x_star - b.pos)


_VECTORS = ("center", "lo", "hi", "lin", "amp")


def _obstacle_tensors(obstacles: obs_lib.Obstacles, dim: int):
    """(the ``Obstacles``' tensors by field, in field order, the sphere
    count, the box count); raises on a tensor not of the shape the kernel
    reads: [M, dim] vectors, [M] per shape, [] constants."""
    counts = {"sphere": obstacles.sphere_center.shape[0], "box": obstacles.box_lo.shape[0]}
    out = {}
    for f in dataclasses.fields(obstacles):
        t = getattr(obstacles, f.name)
        kind, _, what = f.name.partition("_")
        n = counts.get(kind)
        want = () if n is None else (n, dim) if what in _VECTORS else (n,)
        if tuple(t.shape) != want:
            raise ValueError(f"integrate: obstacles.{f.name} must be {list(want)}, "
                             f"got {list(t.shape)}")
        out[f.name] = t
    return out, counts["sphere"], counts["box"]


def _launch(mode, params, grid, b, walls, acc=None, xsph=None, obstacles=None):
    """Launch the kernel in ``mode``; returns (pos, vel or None, travel)."""
    dt, dev, dim = b.pos.dtype, b.pos.device, params.dim
    S = b.pos.shape[0]
    vec = (S, dim)
    for name, t in (("pos", b.pos), ("vel", b.vel), ("acc", acc), ("xsph", xsph)):
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
    for name, t in (("acc", acc), ("xsph", xsph)):
        if t is not None:
            tensors[name] = (t, None)
    obs, n_spheres, n_boxes = None, 0, 0
    if obstacles is not None:
        shapes, n_spheres, n_boxes = _obstacle_tensors(obstacles, dim)
        if b.sim_time.shape != ():
            raise ValueError("integrate: sim_time must be a scalar")
        shapes["sim_time"] = b.sim_time
        tensors.update({f"obstacles.{k}": (t, None) for k, t in shapes.items()})
        obs = (ctypes.c_void_p * len(shapes))(*(t.data_ptr() for t in shapes.values()))
    _native.check_cuda("integrate", dt, dev, **tensors)
    wall_bits = sum(1 << k for k in range(dim) if walls is None or walls[k])
    frozen_from = grid.max_particles - grid.n_boundary if grid.n_boundary else -1
    pos = torch.empty_like(b.pos)
    vel = torch.empty_like(b.pos) if mode == _UPDATE else None
    travel = torch.empty_like(b.travel)
    scratch = torch.zeros(2, dtype=torch.int64, device=dev)  # max bits, blocks done
    _native.launch(
        "integrate", dt, mode, b.pos, b.vel, acc, xsph, obs, n_spheres, n_boxes, b.valid,
        b.owner, *consts.values(), pos, vel, b.travel, travel, scratch, S, dim, wall_bits,
        frozen_from,
    )
    return pos, vel, travel


def update(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    acc: torch.Tensor,
    xsph: torch.Tensor,
    obstacles: obs_lib.Obstacles | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, vel, travel) after the WCSPH update: ``update_plain`` on the
    CPU, the kernel on the card."""
    if not _native.on_card("update", b.pos):
        return update_plain(params, grid, b, walls, acc, xsph, obstacles)
    out = _launch(_UPDATE, params, grid, b, walls, acc, xsph, obstacles)
    update.launches += 1
    if obstacles is not None:
        update.obstacle_launches += 1
    return out


def predict(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    obstacles: obs_lib.Obstacles | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x*, travel) of PBF's prediction: ``predict_plain`` on the CPU, the
    kernel on the card."""
    if not _native.on_card("predict", b.pos):
        return predict_plain(params, grid, b, walls, obstacles)
    x_star, _, travel = _launch(_PREDICT, params, grid, b, walls, obstacles=obstacles)
    predict.launches += 1
    if obstacles is not None:
        predict.obstacle_launches += 1
    return x_star, travel


update.launches = 0
update.obstacle_launches = 0
predict.launches = 0
predict.obstacle_launches = 0
