"""The step loop's per-slot update (``solvers/integrate.py``).

On the CPU ``update`` and ``predict`` must give the bits of the torch
composition the two steps ran before the update became one kernel
(``old_update`` and ``old_predict`` below, copied from them), launch
nothing, and refuse a device with no kernel. The card test holds the kernel
(``csrc/integrate.cu``) against the plain version on the card, bit for bit.
The cases: 2D and 3D, a periodic channel (an axis without walls), frozen
boundary slots, an obstacle term, float32 and float64, with particles past
the walls (the ramp below and at 1) and speeds past the clamp.

    python -m pytest tests/test_torch_integrate.py -m card --noconftest  # on a card
"""

import numpy as np
import pytest
import torch

from sph_pie_torch.neighbors import binned as nb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.scenes import obstacles as obs_lib
from sph_pie_torch.solvers import integrate
from sph_pie_torch.solvers.wcsph import boundary_accel, clamp_speed
from sph_pie_torch.solvers.wcsph_binned import wall_axes

CASES = ("2d", "2d_frozen", "2d_obstacle", "3d", "3d_periodic", "3d_frozen_obstacle")
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
    if "obstacle" in name:
        centre = b.pos[b.valid].mean(0).tolist()
        obstacles = obs_lib.make(dim, spheres=[(centre, 4 * h)], dtype=dtype, device=device)
    return s.params, grid, b, acc, xsph, obstacles


def extra_of(b, obstacles):
    return None if obstacles is None else obs_lib.accel(obstacles, b.pos, b.vel, b.sim_time)


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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", ["update", "predict"])
def test_cpu_gives_the_old_composition(mode, name, dtype):
    params, grid, b, acc, xsph, obstacles = make_case(name, dtype, "cpu")
    launches = integrate.update.launches, integrate.predict.launches
    extra = extra_of(b, obstacles)
    if mode == "update":
        got = integrate.update(params, grid, b, wall_axes(grid), acc, xsph, extra)
        want = old_update(params, grid, b, acc, xsph, obstacles)
    else:
        got = integrate.predict(params, grid, b, wall_axes(grid), extra)
        want = old_predict(params, grid, b, obstacles)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert (integrate.update.launches, integrate.predict.launches) == launches


def test_no_kernel_for_other_devices():
    params, grid, b, acc, xsph, _ = make_case("2d", torch.float32, "cpu")
    meta = nb.BinnedState(**{k: v.to("meta") for k, v in vars(b).items()})
    with pytest.raises(ValueError, match="no kernel for device meta"):
        integrate.update(params, grid, meta, None, acc.to("meta"), xsph.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        integrate.predict(params, grid, meta, None)


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
    extra = extra_of(b, obstacles)
    before = integrate.update.launches, integrate.predict.launches
    if mode == "update":
        got = integrate.update(params, grid, b, wall_axes(grid), acc, xsph, extra)
        want = integrate.update_plain(params, grid, b, wall_axes(grid), acc, xsph, extra)
        fields = ("pos", "vel", "travel")
    else:
        got = integrate.predict(params, grid, b, wall_axes(grid), extra)
        want = integrate.predict_plain(params, grid, b, wall_axes(grid), extra)
        fields = ("x_star", "travel")
    torch.cuda.synchronize()
    after = integrate.update.launches, integrate.predict.launches
    assert after[mode == "predict"] == before[mode == "predict"] + 1
    gaps = {f: ulps(g, w) for f, g, w in zip(fields, got, want, strict=True)}
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True)), gaps
