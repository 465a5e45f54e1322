"""The step loop's per-slot update (``solvers/integrate.py``).

On the CPU ``update`` and ``predict`` must give the bits of the torch
composition the two steps ran before the update became one kernel
(``old_update`` and ``old_predict`` below, copied from them) and launch
nothing (a device with no kernel: ``test_torch_native.py``). The card test holds the kernel
(``csrc/integrate.cu``) against the plain version on the card, bit for bit.
The cases: 2D and 3D, a periodic channel (an axis without walls), frozen
boundary slots, an obstacle term (one still sphere; six moving spheres and
five boxes, four moving, with slots where a box's faces tie and past the
damper's ramp; an ``Obstacles`` with no shape), float32 and float64, with
particles past the walls (the ramp below and at 1) and speeds past the
clamp. A card test also holds ``wcsph_binned.step`` to one launch in its
``sph.integrate`` span besides the scratch fill and the clock's add.

    python -m pytest tests/test_torch_integrate.py -m card --noconftest  # on a card
"""

import re

import numpy as np
import pytest
import torch

from h100bench import spans, tracing
from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.solvers import integrate, wcsph_binned
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_torch.solvers.wcsph_binned import wall_axes

CASES = ("2d", "2d_frozen", "2d_obstacle", "3d", "3d_periodic", "3d_frozen_obstacle",
         "2d_shapes", "3d_shapes", "2d_no_shapes", "3d_no_shapes")
# The static box of the "shapes" cases, dyadic so that its faces' distances
# are exact: [1/8, 1/4] on every axis, and the offsets of the slots set
# inside it from its low corner, on every axis but where a pair says
# otherwise: past the ramp, in the ramp, at the centre (every face ties),
# and tied on the last axes only. Two more slots go into the first sphere
# where it is at the case's clock: in its ramp and past it.
BOX_LO, BOX_W = 0.125, 0.125
TIES = (1 / 256, 1 / 1024, BOX_W / 2, (2 / 256, 1 / 256))
SPHERE_DEPTHS = (1e-3, 1e-2)
DTYPES = (torch.float32, torch.float64)


def old_update(params, grid, b, acc, xsph, obstacles):
    """``wcsph_binned.step`` from the pair forces to the new state's pos,
    vel and travel, as it was written before the kernel."""
    acc = acc + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel, wall_axes(grid))
    if obstacles is not None:
        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)
    move = (b.valid & ~nb.frozen_mask(grid, b))[:, None]
    vel = torch.where(move, b.vel + params.dt * acc, 0.0)
    vel = clamp_speed(params, vel)
    vel_adv = torch.where(move, vel + params.xsph_eps * xsph, 0.0)
    pos = torch.where(move, b.pos + params.dt * vel_adv, b.pos)
    step_disp = params.dt * torch.sqrt(
        torch.clamp((vel_adv * vel_adv).sum(dim=-1).amax(), min=0.0)
    )
    return pos, vel, b.travel + step_disp


def old_predict(params, grid, b, obstacles):
    """``pbf.step``'s prediction of x* and travel, as it was written before
    the kernel."""
    valid = (b.valid & ~nb.frozen_mask(grid, b))[:, None]
    acc = torch.zeros_like(b.pos) + params.gravity
    acc = acc + boundary_accel(params, b.pos, b.vel, wall_axes(grid))
    if obstacles is not None:
        acc = acc + obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)
    vel = torch.where(valid, b.vel + params.dt * acc, 0.0)
    vel = clamp_speed(params, vel)
    x_star = torch.where(valid, b.pos + params.dt * vel, b.pos)
    d = x_star - b.pos
    return x_star, b.travel + torch.sqrt(torch.clamp((d * d).sum(-1).amax(), min=0.0))


def sphere_centres(o, t):
    """The spheres' centres at time ``t``."""
    off, _ = obs_lib._offsets(o.sphere_lin, o.sphere_amp, o.sphere_freq, o.sphere_phase, t)
    return o.sphere_center + off


def set_slots(b):
    """The slots ``several_shapes`` moves: the first occupied ones."""
    return torch.nonzero(b.valid).flatten()[:len(TIES) + len(SPHERE_DEPTHS)].tolist()


def several_shapes(b, h: float, dtype, device: str, rng):
    """(six moving spheres and five boxes over the fluid, the state with
    slots moved into the last box at ``TIES`` and into the first sphere at
    ``SPHERE_DEPTHS``): the spheres of radius 1.5 h to 3 h, four boxes of
    half-width h to 2 h moving, the fifth the static ``BOX_LO`` box."""
    fluid = b.pos[b.valid].cpu().numpy()
    dim = fluid.shape[1]

    def at():
        return fluid[rng.integers(len(fluid))].tolist()

    def motion():
        return (rng.normal(0.0, 0.5, dim).tolist(), rng.uniform(0.0, h, dim).tolist(),
                float(rng.uniform(1.0, 10.0)), float(rng.uniform(0.0, 6.3)))

    spheres = [(at(), float(rng.uniform(1.5 * h, 3 * h))) for _ in range(6)]
    boxes = []
    for _ in range(4):
        c, w = np.asarray(at()), rng.uniform(h, 2 * h, dim)
        boxes.append(((c - w).tolist(), (c + w).tolist()))
    boxes.append(([BOX_LO] * dim, [BOX_LO + BOX_W] * dim))
    obstacles = obs_lib.make(
        dim, spheres=spheres, boxes=boxes, sphere_motions=[motion() for _ in spheres],
        box_motions=[motion() for _ in boxes[:-1]], dtype=dtype, device=device)
    pos = b.pos.clone()
    slots = set_slots(b)
    for slot, tie in zip(slots, TIES):
        off = [tie] * dim if isinstance(tie, float) else [tie[0]] + [tie[1]] * (dim - 1)
        pos[slot] = torch.tensor([BOX_LO + o for o in off], dtype=dtype)
    centre = sphere_centres(obstacles, b.sim_time)[0]
    for slot, depth in zip(slots[len(TIES):], SPHERE_DEPTHS, strict=True):
        pos[slot] = centre
        pos[slot, 0] += obstacles.sphere_radius[0] - depth
    return obstacles, nb.BinnedState(**{**vars(b), "pos": pos})


def make_case(name: str, dtype, device: str, seed: int = 7):
    """(params, grid, state, acc, xsph, obstacles) of a small scene whose
    occupied slots are jittered by up to h/2 (some past a wall), with
    N(0, 30) velocities (many past the 40 m/s clamp) and N(0, 1e3)
    accelerations on every slot, empty ones included."""
    frozen = 1 if "frozen" in name else 0
    if name.startswith("2d"):
        s = tb.dam_break_2d(200, dtype=dtype, device=device, wall_layers=frozen)
    elif "periodic" in name:
        s = tb.dam_break_3d_periodic(400, dtype=dtype, device=device)
    else:
        s = tb.dam_break_3d(400, dtype=dtype, device=device, wall_layers=frozen)
    grid, b = s.bgrid, s.binned_state()
    rng = np.random.default_rng(seed)
    S, dim = b.pos.shape
    h = float(s.params.h)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    jitter = t(rng.uniform(-0.5, 0.5, (S, dim)) * h) * b.valid[:, None]
    b = nb.BinnedState(**{**vars(b), "pos": b.pos + jitter,
                          "vel": t(rng.normal(0.0, 30.0, (S, dim))),
                          "travel": t(0.01), "sim_time": t(0.125)})
    acc, xsph = t(rng.normal(0.0, 1e3, (S, dim))), t(rng.normal(0.0, 1.0, (S, dim)))
    obstacles = None
    if "no_shapes" in name:
        obstacles = obs_lib.make(dim, dtype=dtype, device=device)
    elif "shapes" in name:
        obstacles, b = several_shapes(b, h, dtype, device, rng)
    elif "obstacle" in name:
        centre = b.pos[b.valid].mean(0).tolist()
        obstacles = obs_lib.make(dim, spheres=[(centre, 4 * h)], dtype=dtype, device=device)
    return s.params, grid, b, acc, xsph, obstacles


def test_cases_exercise_every_branch():
    """The cases reach what they are named for: frozen slots, an axis
    without walls, slots past a wall and speeds past the clamp."""
    for name in CASES:
        params, grid, b, *_ = make_case(name, torch.float64, "cpu")
        assert bool(nb.frozen_mask(grid, b).any()) == ("frozen" in name)
        assert (wall_axes(grid) is not None) == ("periodic" in name)
        past = (b.pos < params.bound_min) | (b.pos > params.bound_max)
        assert bool((past & b.valid[:, None]).any())
        assert bool(((b.vel * b.vel).sum(-1) > params.max_speed**2).any())


def test_shapes_cases_reach_every_branch_of_the_obstacle_term():
    """Several moving spheres and boxes at a clock past 0, occupied slots
    inside the moving boxes, and the slots set inside the static box and the
    first sphere: ties of the box's faces where ``TIES`` puts them, depths
    in the ramp and past it."""
    for name in ("2d_shapes", "3d_shapes"):
        params, grid, b, _, _, o = make_case(name, torch.float64, "cpu")
        dim = b.pos.shape[1]
        assert o.sphere_center.shape[0] == 6 and o.box_lo.shape[0] == 5 and float(b.sim_time) > 0
        for t in (o.sphere_lin, o.sphere_amp, o.sphere_freq, o.sphere_phase,
                  o.box_lin[:4], o.box_amp[:4], o.box_freq[:4], o.box_phase[:4]):
            assert bool((t != 0).all())
        x = b.pos[b.valid]
        assert bool(((x[:, None] > o.box_lo[:4]) & (x[:, None] < o.box_hi[:4])).all(-1).any())
        slots = set_slots(b)
        x = b.pos[slots[:len(TIES)]]
        d_lo, d_hi = x - BOX_LO, BOX_LO + BOX_W - x
        face = torch.minimum(d_lo, d_hi)
        assert bool((face > 0).all())
        assert (face == face.amin(-1, keepdim=True)).all(-1).tolist() == [True] * 3 + [False]
        assert bool((d_lo[2] == d_hi[2]).all())
        assert bool((face[3, 1:] == face[3].amin()).all())
        ramp = float(o.ramp_dist)
        assert float(face[0].amin()) > ramp > float(face[1].amin())
        dist = torch.linalg.vector_norm(b.pos[slots[len(TIES):]] - sphere_centres(o, b.sim_time)[0],
                                        dim=-1)
        pen = (o.sphere_radius[0] - dist).tolist()
        assert 0 < pen[0] < ramp < pen[1]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", ["update", "predict"])
def test_cpu_gives_the_old_composition(mode, name, dtype):
    params, grid, b, acc, xsph, obstacles = make_case(name, dtype, "cpu")
    launches = integrate.update.launches, integrate.predict.launches
    if mode == "update":
        got = integrate.update(params, grid, b, wall_axes(grid), acc, xsph, obstacles)
        want = old_update(params, grid, b, acc, xsph, obstacles)
    else:
        got = integrate.predict(params, grid, b, wall_axes(grid), obstacles)
        want = old_predict(params, grid, b, obstacles)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert (integrate.update.launches, integrate.predict.launches) == launches


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return "cuda"


def ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units in the last place (both finite): the
    sign-magnitude bits mapped onto a monotone integer line."""
    it = torch.int32 if got.dtype == torch.float32 else torch.int64
    lo = torch.iinfo(it).min
    a, b = (torch.where(t < 0, lo - t, t).to(torch.int64)
            for t in (got.contiguous().view(it), want.contiguous().view(it)))
    return int((a - b).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", ["update", "predict"])
def test_kernel_gives_the_plain_bits(card, mode, name, dtype):
    params, grid, b, acc, xsph, obstacles = make_case(name, dtype, card)
    counters = (integrate.update.launches, integrate.predict.launches,
                integrate.update.obstacle_launches, integrate.predict.obstacle_launches)
    before = counters
    if mode == "update":
        got = integrate.update(params, grid, b, wall_axes(grid), acc, xsph, obstacles)
        want = integrate.update_plain(params, grid, b, wall_axes(grid), acc, xsph, obstacles)
        fields = ("pos", "vel", "travel")
    else:
        got = integrate.predict(params, grid, b, wall_axes(grid), obstacles)
        want = integrate.predict_plain(params, grid, b, wall_axes(grid), obstacles)
        fields = ("x_star", "travel")
    torch.cuda.synchronize()
    after = (integrate.update.launches, integrate.predict.launches,
             integrate.update.obstacle_launches, integrate.predict.obstacle_launches)
    k = mode == "predict"
    assert after[k] == before[k] + 1
    assert after[2 + k] == before[2 + k] + (obstacles is not None)
    gaps = {f: ulps(g, w) for f, g, w in zip(fields, got, want, strict=True)}
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True)), gaps


@pytest.mark.card
@pytest.mark.parametrize("stirred", [True, False], ids=["sphere", "none"])
def test_step_enqueues_one_update_and_no_obstacle_passes(card, stirred):
    """One ``wcsph_binned.step`` under the profiler: inside its
    ``sph.integrate`` span the card runs the update kernel, the scratch
    fill and the clock's add, and nothing else, with a moving sphere or
    none; only the step with the sphere counts an obstacle launch."""
    s = tb.dam_break_3d(400, dtype=torch.float32, device=card)
    grid, b = s.bgrid, s.binned_state()
    b = nb.BinnedState(**{**vars(b), "sim_time": torch.tensor(0.125, device=card)})
    centre = b.pos[b.valid].mean(0).tolist()
    sphere = obs_lib.make(3, spheres=[(centre, 2 * float(s.params.h))],
                          sphere_motions=[([0.1, 0.0, 0.0], [0.03, 0.0, 0.0], 5.0, 0.5)],
                          device=card) if stirred else None
    wcsph_binned.step(s.params, grid, b, sphere)  # builds and warms up
    before = integrate.update.launches, integrate.update.obstacle_launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wcsph_binned.step(s.params, grid, b, sphere)
        torch.cuda.synchronize()
    after = integrate.update.launches, integrate.update.obstacle_launches
    assert after == (before[0] + 1, before[1] + stirred)
    got = spans.ops_in(tracing.reduce(prof, 1, 0.0), "sph.integrate")
    assert got is not None and got[1] == 1, "the profile's enqueues and device ops do not pair"
    names = [name for name, _, _ in got[0]]
    kernel = [n for n in names if "integrate_slots<" in n]
    rest = sorted(n for n in names if n not in kernel)
    assert len(kernel) == 1 and len(rest) == 2, names
    assert not any(re.search("reduce", n, re.I) for n in rest), rest
    assert sum(bool(re.search("fill|memset", n, re.I)) for n in rest) == 1, rest
    assert sum(bool(re.search("add", n, re.I)) for n in rest) == 1, rest
