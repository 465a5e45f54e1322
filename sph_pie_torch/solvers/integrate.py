"""The per-slot passes of the binned solvers' step loop, one launch each.

Five call sites, one kernel (``csrc/integrate.cu``'s ``integrate_slots``)
in five modes:

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

``project`` (``pbf.step``, after each projection's dx fold): the capped,
under-relaxed displacement applied inside the box::

    d  = sor dx;  d = d min(proj_cap / sqrt(max(|d|^2, 1e-30)), 1)
    x' = box(x + d)                    x where the slot does not move
    travel' = travel + max |d|         (d 0 where the slot does not move)

``pbf_velocity`` (``pbf.step``'s epilogue, before its density + XSPH fold)
and ``pbf_mix`` (after it, and after the vorticity folds)::

    m_rho = m / (rho_prev > 0 ? rho_prev : rho0)          every slot
    v     = clamp((x* - x0) / dt)      0 where the slot does not move
    rho   = max(valid ? rho_raw : 0, 1e-6 rho0)          every slot
    v'    = clamp(v + coef dv)         0 where the slot does not move

``wall`` is ``wcsph.boundary_accel`` and ``box`` the clamp to the domain,
each on the axes that have walls (``walls``: ``wcsph_binned.wall_axes``);
on the periodic axes ``x* - x0`` is folded to its minimum image. ``clamp``
is ``wcsph.clamp_speed``, and a slot moves when it is valid and not a
frozen boundary particle (``binned.frozen_mask``). ``obstacle`` is
``scenes/obstacles.accel`` of the ``obstacles`` passed (none: no term) at
the state's clock ``sim_time``, added last.

On CPU tensors each runs its plain version, the torch composition the
kernel follows operation by operation (there ``obstacles.accel`` runs over
every slot); on CUDA tensors it launches the kernel, which computes the
obstacle term itself, on the slots that move, reads ``vel``, ``acc``,
``xsph``, ``dx``, ``x0`` and ``dv`` only for those, writes every slot of
new output tensors, and leaves ``travel`` on the card (no host read); any
other device raises. ``update.launches``, ``predict.launches``,
``project.launches``, ``pbf_velocity.launches`` and ``pbf_mix.launches``
count the launches, ``update.obstacle_launches`` and
``predict.obstacle_launches`` those of them with an obstacle term.
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

_UPDATE, _PREDICT, _PROJECT, _VELOCITY, _MIX = 0, 1, 2, 3, 4


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
    move = _moves(grid, b)
    vel = torch.where(move, b.vel + params.dt * acc, 0.0)
    return move, clamp_speed(params, vel)


def _moves(grid, b) -> torch.Tensor:
    """[S, 1] bool: the slot is valid and not a frozen boundary particle."""
    return (b.valid & ~nb.frozen_mask(grid, b))[:, None]


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


def periods(grid: nb.BinnedGrid, dtype: torch.dtype, device) -> torch.Tensor | None:
    """[dim] period lengths by spatial axis (dims * cell_size), 0 on the
    axes with walls; None on a grid without periodic axes."""
    if not any(grid.periodic):
        return None
    order = grid.axis_order or tuple(range(grid.dim))
    lengths = [
        grid.dims[order.index(sa)] * grid.cell_size if grid.periodic[order.index(sa)] else 0.0
        for sa in range(grid.dim)
    ]
    return nb.axis_vector(lengths, dtype, device)


def project_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    dx: torch.Tensor,
    sor: torch.Tensor,
    proj_cap: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, travel) after one Jacobi projection, in torch; ``dx`` is the
    dx fold's sum."""
    move = _moves(grid, b)
    dx = sor * dx
    n = torch.sqrt(torch.clamp((dx * dx).sum(-1, keepdim=True), min=1e-30))
    dx = torch.where(move, dx * torch.clamp(proj_cap / n, max=1.0), 0.0)
    x = b.pos + dx
    box = torch.clamp(x, params.bound_min, params.bound_max)
    if walls is not None:  # periodic axes drift freely; the bin-time fold wraps them
        box = torch.where(nb.axis_vector(walls, torch.bool, x.device)[None, :], box, x)
    return torch.where(move, box, b.pos), b.travel + max_norm(dx)


def pbf_velocity_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    pos0: torch.Tensor,
    rho_prev: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m_rho, v) of PBF's epilogue from x* = ``b.pos``, in torch: the
    Monaghan XSPH weight from the previous step's density (rest density
    for rows that have none yet), and the speed-clamped (x* - x0) / dt."""
    move = _moves(grid, b)
    m_rho = b.mass / torch.where(rho_prev > 0, rho_prev, params.rest_density)
    disp = b.pos - pos0
    lengths = periods(grid, disp.dtype, disp.device)
    if lengths is not None:  # minimum image on the periodic axes
        L = lengths[None, :]
        safe_L = torch.where(L > 0, L, 1.0)
        disp = torch.where(L > 0, disp - L * torch.round(disp / safe_L), disp)
    vel = torch.where(move, disp / params.dt, 0.0)
    return m_rho, clamp_speed(params, vel)


def pbf_mix_plain(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    vel: torch.Tensor,
    dv: torch.Tensor,
    coef: torch.Tensor,
    rho: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(the floored density, or None without ``rho``; v') of a sum ``dv``
    added to PBF's velocity with ``coef``, speed-clamped, in torch."""
    move = _moves(grid, b)
    if rho is not None:
        rho = torch.maximum(torch.where(b.valid, rho, 0.0), 1e-6 * params.rest_density)
    vel = vel + coef * torch.where(move, dv, 0.0)
    return rho, torch.where(move, clamp_speed(params, vel), 0.0)


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


# The inputs of csrc/integrate.cu's PBF modes, in its order, by shape: a
# vector a slot, a number a slot, a vector an axis, a number.
_PBF_INPUTS = {
    "pos": "vec", "dx": "vec", "pos0": "vec", "vel": "vec", "dv": "vec", "rho": "slot",
    "mass": "slot", "sor": "num", "proj_cap": "num", "bound_min": "axis", "bound_max": "axis",
    "dt": "num", "max_speed": "num", "rest_density": "num", "period": "axis", "coef": "num",
    "floor": "num", "travel": "num",
}
_PBF_OUTPUTS = {"pos_out": "vec", "vel_out": "vec", "rho_out": "slot", "travel_out": "num"}
_PBF_KINDS = {**_PBF_INPUTS, **_PBF_OUTPUTS}


def _launch_pbf(mode, grid, b, walls=None, **given):
    """Launch a PBF mode of the kernel on the ``given`` tensors by name
    (None or left out: null), ``b``'s pos, valid and owner; the caller makes
    the outputs."""
    dt, dev, dim = b.pos.dtype, b.pos.device, grid.dim
    S = b.pos.shape[0]
    shapes = {"vec": (S, dim), "slot": (S,), "axis": (dim,), "num": ()}
    given = {"pos": b.pos, **{k: t for k, t in given.items() if t is not None}}
    tensors = {"valid": (b.valid, torch.bool), "owner": (b.owner, torch.int32)}
    for name, t in given.items():
        want = shapes[_PBF_KINDS[name]]
        if tuple(t.shape) != want:
            raise ValueError(f"integrate: {name} must be {list(want)}, got {list(t.shape)}")
        tensors[name] = (t, None)
    if b.valid.shape != (S,) or b.owner.shape != (S,):
        raise ValueError(f"integrate: valid and owner must be [{S}]")
    scratch = torch.zeros(2, dtype=torch.int64, device=dev) if mode == _PROJECT else None
    _native.check_cuda("integrate", dt, dev, **tensors)
    ins = (ctypes.c_void_p * len(_PBF_INPUTS))(
        *(given[k].data_ptr() if k in given else None for k in _PBF_INPUTS))
    wall_bits = sum(1 << k for k in range(dim) if walls is None or walls[k])
    frozen_from = grid.max_particles - grid.n_boundary if grid.n_boundary else -1
    _native.launch("integrate_pbf", dt, mode, ins, b.valid, b.owner,
                   *(given.get(k) for k in _PBF_OUTPUTS), scratch, S, dim, wall_bits,
                   frozen_from)


def project(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    walls: tuple[bool, ...] | None,
    dx: torch.Tensor,
    sor: torch.Tensor,
    proj_cap: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, travel) after one Jacobi projection: ``project_plain`` on the
    CPU, the kernel on the card."""
    if not _native.on_card("project", b.pos):
        return project_plain(params, grid, b, walls, dx, sor, proj_cap)
    dt = b.pos.dtype
    pos, travel = torch.empty_like(b.pos), torch.empty_like(b.travel)
    _launch_pbf(_PROJECT, grid, b, walls, dx=dx, sor=sor.to(dt), proj_cap=proj_cap.to(dt),
                bound_min=params.bound_min.to(dt), bound_max=params.bound_max.to(dt),
                travel=b.travel, pos_out=pos, travel_out=travel)
    project.launches += 1
    return pos, travel


def pbf_velocity(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    pos0: torch.Tensor,
    rho_prev: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m_rho, v) of PBF's epilogue: ``pbf_velocity_plain`` on the CPU, the
    kernel on the card."""
    if not _native.on_card("pbf_velocity", b.pos):
        return pbf_velocity_plain(params, grid, b, pos0, rho_prev)
    dt = b.pos.dtype
    m_rho, vel = torch.empty_like(b.mass), torch.empty_like(b.pos)
    _launch_pbf(_VELOCITY, grid, b, pos0=pos0, rho=rho_prev, mass=b.mass, dt=params.dt.to(dt),
                max_speed=params.max_speed.to(dt), rest_density=params.rest_density.to(dt),
                period=periods(grid, dt, b.pos.device), vel_out=vel, rho_out=m_rho)
    pbf_velocity.launches += 1
    return m_rho, vel


def pbf_mix(
    params: FluidParams,
    grid: nb.BinnedGrid,
    b: nb.BinnedState,
    vel: torch.Tensor,
    dv: torch.Tensor,
    coef: torch.Tensor,
    rho: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(the floored density or None, v') of PBF's epilogue: ``pbf_mix_plain``
    on the CPU, the kernel on the card."""
    if not _native.on_card("pbf_mix", b.pos):
        return pbf_mix_plain(params, grid, b, vel, dv, coef, rho)
    dt = b.pos.dtype
    out = torch.empty_like(vel)
    floor, rho_out = (None, None) if rho is None else (
        (1e-6 * params.rest_density).to(dt), torch.empty_like(rho))
    _launch_pbf(_MIX, grid, b, vel=vel, dv=dv, coef=coef.to(dt),
                max_speed=params.max_speed.to(dt), rho=rho, floor=floor, vel_out=out,
                rho_out=rho_out)
    pbf_mix.launches += 1
    return rho_out, out


update.launches = 0
update.obstacle_launches = 0
predict.launches = 0
predict.obstacle_launches = 0
project.launches = 0
pbf_velocity.launches = 0
pbf_mix.launches = 0
