"""The reference's obstacles (``reference/obstacles.py``) on cases worked
by hand, and against the program's own model on random particles."""

from __future__ import annotations

import math

import pytest
import torch

from h100bench.reference import obstacles

F64 = torch.float64
K, C, RAMP = 100.0, 2.0, 0.8


def accel(obs, pos, vel, t):
    obs = {"stiffness": K, "damping": C, "ramp_dist": RAMP, **obs}
    return obstacles.accel(obs, torch.tensor(pos, dtype=F64), torch.tensor(vel, dtype=F64), t)


# A unit sphere at the origin, moving +1 m/s along x and 0.5 m along y at
# 0.25 Hz: at t = 1 its center is (1, 0.5, 0) and its velocity (1, 0, 0).
SPHERE = {"spheres": [{"center": [0.0, 0.0, 0.0], "radius": 1.0, "lin": [1.0, 0.0, 0.0],
                       "amp": [0.0, 0.5, 0.0], "freq": 0.25}]}


@pytest.mark.parametrize("pos,vel,want", [
    # pen 0.4 along +z, ramp 0.5, v - v_ob = (2, 0, 1): 40 z - 2 * 0.5 * (2, 0, 1)
    ([1.0, 0.5, 0.6], [3.0, 0.0, 1.0], [-2.0, 0.0, 39.0]),
    # pen 0.9 along +x, past the ramp (1), moving with the sphere: the spring alone
    ([1.1, 0.5, 0.0], [1.0, 0.0, 0.0], [90.0, 0.0, 0.0]),
    # outside: nothing, whatever the velocity
    ([1.0, 0.5, 2.0], [5.0, 5.0, 5.0], [0.0, 0.0, 0.0]),
])
def test_moving_sphere(pos, vel, want):
    got = accel(SPHERE, [pos], [vel], 1.0)[0]
    assert got.tolist() == pytest.approx(want, abs=1e-12)


# A 2 x 1 x 4 box bobbing along z at 0.5 Hz, 1 m: at t = 0 it is where it
# was made and moves at (0, 0, pi).
BOX = {"boxes": [{"lo": [0.0, 0.0, 0.0], "hi": [2.0, 1.0, 4.0], "amp": [0.0, 0.0, 1.0],
                  "freq": 0.5}]}


@pytest.mark.parametrize("pos,want", [
    # nearest face x = 2 (0.2 in): +x, ramp 0.25, v - v_ob = (0, 0, -pi)
    ([1.8, 0.5, 2.0], [20.0, 0.0, 0.25 * C * math.pi]),
    # x and y faces both 0.5 in: the first axis, its low face
    ([0.5, 0.5, 2.0], [-50.0, 0.0, 0.625 * C * math.pi]),
    # the two y faces equally near: the low one
    ([1.0, 0.5, 2.0], [0.0, -50.0, 0.625 * C * math.pi]),
    # on a face and outside: nothing
    ([2.0, 0.5, 2.0], [0.0, 0.0, 0.0]),
    ([2.5, 0.5, 2.0], [0.0, 0.0, 0.0]),
])
def test_moving_box(pos, want):
    got = accel(BOX, [pos], [[0.0, 0.0, 0.0]], 0.0)[0]
    assert got.tolist() == pytest.approx(want, abs=1e-12)


def test_box_moves_with_its_offset():
    """With a quarter turn of phase the box starts 1 m up (z from 1 to 5),
    at rest: a point 0.2 under its top face is pushed up. At t = 1 it is
    1 m down (z from -1 to 3), and the point is outside."""
    obs = {"boxes": [{**BOX["boxes"][0], "phase": 0.5 * math.pi}]}
    assert accel(obs, [[1.0, 0.5, 4.8]], [[0.0, 0.0, 0.0]], 0.0)[0].tolist() == \
        pytest.approx([0.0, 0.0, 20.0], abs=1e-9)
    assert accel(obs, [[1.0, 0.5, 4.8]], [[0.0, 0.0, 0.0]], 1.0)[0].tolist() == [0.0, 0.0, 0.0]


def test_shapes_add():
    both = {**SPHERE, **BOX}
    pos, vel = [[1.0, 0.5, 0.6]], [[3.0, 0.0, 1.0]]
    got = accel(both, pos, vel, 1.0)
    assert torch.equal(got, accel(SPHERE, pos, vel, 1.0) + accel(BOX, pos, vel, 1.0))


@pytest.mark.parametrize("dim", [2, 3])
def test_agrees_with_the_program(dim):
    """The program's ``scenes.obstacles.accel`` in float64 on random
    particles around two moving spheres and a moving box."""
    from h100bench.traffic import segments
    from sph_pie_torch.scenes import obstacles as program

    gen = torch.Generator().manual_seed(dim)
    pos = torch.rand((4000, dim), generator=gen, dtype=F64) * 2.0 - 0.5
    vel = torch.randn((4000, dim), generator=gen, dtype=F64)
    obs = {"spheres": [{"center": [0.5] * dim, "radius": 0.3, "amp": [0.1] + [0.0] * (dim - 1),
                        "freq": 3.0, "phase": 0.2},
                       {"center": [0.2] * dim, "radius": 0.25, "lin": [0.0] * (dim - 1) + [0.5]}],
           "boxes": [{"lo": [0.6] * dim, "hi": [1.2] * dim, "amp": [0.0] * (dim - 1) + [0.05],
                      "freq": 2.0}],
           "stiffness": 1e4, "damping": 10.0, "ramp_dist": 2e-3}
    prog = segments.obstacles({"obstacles": obs}, pos)
    for t in (0.0, 0.0375, 0.4):
        want = program.accel(prog, pos, vel, torch.tensor(t, dtype=F64))
        got = obstacles.accel(obs, pos, vel, t)
        assert (got - want).abs().max() <= 1e-9 * want.abs().max()
        assert bool((want != 0).any(dim=1).sum() > 100)
