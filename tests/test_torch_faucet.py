"""The faucet fill (BASELINE config #2) on the port's path, on the CPU,
against the benchmark's plain reference (``h100bench/reference/faucet.py``,
which emits on its own): ``emitter_2d`` at 512 rows in float64, driven as
the benchmark's ``faucet2d_4k.emit`` cell drives it (``traffic/emit.py``:
emit, bin, steps, and at each 50-step boundary unbin, emit, bin), from a
seeded jittered stream; and the builder's check of the port's scene and
stream plan against the configuration."""

import json
from pathlib import Path

import pytest
import torch

from h100bench import harness, judge
from h100bench.reference import faucet as reference
from h100bench.reference import sph

ROOT = Path(__file__).resolve().parents[1]
BENCH = harness.Bench(ROOT / "h100bench")
BUILDER = BENCH.module("scenes", "faucet")
CPU = torch.device("cpu")


def config(**changes) -> dict:
    cfg = json.loads((ROOT / "h100bench" / "configs" / "faucet2d_4k.json").read_text())
    return {**BUILDER.scaled(cfg, 512), "dtype": "float64", **changes}


def work(steps: int) -> dict:
    w = json.loads((ROOT / "h100bench" / "workloads" / "faucet2d_4k.emit.json").read_text())
    return {**w, "check": {**w["check"], "steps": steps}}


def emitting_boundaries(inp, epoch: int, steps: int) -> int:
    """Boundaries after step 0 and before ``steps`` at which rows join."""
    s = inp.spawn_step
    return sum(bool(((s > k - epoch) & (s <= k)).any()) for k in range(epoch, steps, epoch))


@pytest.mark.parametrize("steps", [203, 520], ids=["three_boundaries", "onto_the_circle"])
def test_port_faucet_matches_the_reference(steps):
    """Active masks equal, positions, velocities and densities within 1e-9
    after at least three boundaries that emit; the longer case runs until
    the stream presses into the circle (an active row inside it)."""
    cfg, w = config(), work(steps)
    inp = BUILDER.inputs(cfg, 2**40 + 9, CPU)
    drv = BENCH.module("traffic", "emit").Driver(cfg, w, BUILDER, inp)
    b = drv.begin()
    for _ in range(steps):
        b = drv.step(b)
    got = drv.particles(b)
    ref = reference.run(cfg, w, inp, torch.float64)
    assert torch.equal(got["alive"], ref["active"])
    assert emitting_boundaries(inp, w["epoch_steps"], steps) >= 3
    assert int(got["alive"].sum()) > 12 and int(drv.failed(b)) == 0
    h = sph.physics(cfg).h
    both = ref["active"]
    for name, scale in (("pos", h), ("vel", 1.0), ("rho", 1000.0)):
        gap = (got[name] - ref[name])[both].abs().max() / scale
        assert gap <= 1e-9, (name, float(gap))
    nums = judge.compare(cfg, w, ref, got)
    assert nums["lost"] == 0 and nums["time_gap"] <= 1e-9
    if steps > 500:
        circle = cfg["obstacles"]["spheres"][0]
        d = (ref["pos"][both] - torch.tensor(circle["center"], dtype=torch.float64)).norm(dim=1)
        assert float(d.min()) < circle["radius"]


@pytest.mark.parametrize("steps", [203, 320], ids=["held_back", "joined"])
def test_port_and_reference_hold_rows_back_alike(steps):
    """The first two rows spawned at rest at one place: the second, due at
    step 53, finds the first nearer than the clearance at the boundaries
    at 100, 150 and 200 and stays out, as do rows due after it whose places
    the first row crowds, on both sides alike; by step 320 it has joined.
    Active masks equal, positions within 1e-9."""
    import dataclasses

    cfg, w = config(), work(steps)
    inp = BUILDER.inputs(cfg, 2**40 + 11, CPU)
    first, second = inp.spawn_step == 0, inp.spawn_step == 53
    pos, vel = inp.pos.clone(), inp.vel.clone()
    vel[first | second] = 0.0
    pos[second] = pos[first]
    inp = dataclasses.replace(inp, pos=pos, vel=vel)
    drv = BENCH.module("traffic", "emit").Driver(cfg, w, BUILDER, inp)
    b = drv.begin()
    for _ in range(steps):
        b = drv.step(b)
    got = drv.particles(b)
    ref = reference.run(cfg, w, inp, torch.float64)
    assert torch.equal(got["alive"], ref["active"])
    both = ref["active"]
    assert float((got["pos"] - ref["pos"])[both].abs().max()) <= 1e-9
    due = (inp.spawn_step >= 0) & (inp.spawn_step <= (steps - 1) // 50 * 50)
    assert bool(got["alive"][second].all()) == (steps > 250)
    assert int(both.sum()) < int(due.sum())


def test_builder_takes_the_port_scene():
    cfg = config()
    inp = BUILDER.inputs(cfg, 5, CPU)
    params, grid, state = BUILDER.program(cfg, inp)
    assert grid.num_slots == cfg["slots"] and grid.cap == cfg["cap"] == 24
    assert not bool(state.active.any()) and state.capacity == 512
    assert float(params.dt) == pytest.approx(sph.physics(cfg).dt, rel=1e-12)


def test_builder_plan_at_full_size_is_the_port_stream():
    """At the configuration's own numbers the plan is ``emitter_2d(4096)``'s:
    12 a row, a row every 53 steps, 341 rows, the last at step 18,020."""
    from sph_pie_torch.scenes.builders import emitter_2d

    cfg = json.loads((ROOT / "h100bench" / "configs" / "faucet2d_4k.json").read_text())
    step, pos, vel = BUILDER.plan(cfg, CPU)
    em = emitter_2d(4096, dtype=torch.float64, device="cpu").emitter
    assert torch.equal(step, em.spawn_step.to(torch.int64))
    assert int((step >= 0).sum()) == 4092 and int(step.max()) == 18020
    assert int((step == 53).sum()) == 12
    assert float((pos - em.spawn_pos).abs().max()) <= 1e-15
    assert torch.equal(vel, em.spawn_vel)


@pytest.mark.parametrize("changes", [
    {"emit_speed": 1.2},                            # spawn steps and velocities
    {"nozzle_lo": [0.44, 0.92]},                    # spawn positions
    {"emit_direction": [0.0, 1.0]},                 # velocities
    {"cap": 32},                                    # the grid
    {"skin_frac": 0.3},                             # the grid
    {"viscosity": 0.1},                             # params
    {"gravity": -9.8},                              # params
    {"obstacles": {"spheres": [{"center": [0.5, 0.5], "radius": 0.1}], "boxes": [],
                   "stiffness": 1e4, "damping": 10.0, "ramp_dist": 2e-3}},
    {"emit_clearance": 0.5},                        # the emission rule
], ids=["speed", "nozzle", "direction", "cap", "skin", "viscosity", "gravity", "circle",
        "clearance"])
def test_builder_refuses_a_scene_other_than_the_configuration(changes):
    cfg = config(**changes)
    inp = BUILDER.inputs(cfg, 5, CPU)
    with pytest.raises(ValueError, match="differs from the configuration"):
        BUILDER.program(cfg, inp)


def test_inputs_jitter_the_plan_by_the_seed():
    cfg = config()
    a, b = BUILDER.inputs(cfg, 2**62 + 1, CPU), BUILDER.inputs(cfg, 2**62 + 2, CPU)
    step, pos, vel = BUILDER.plan(cfg, CPU)
    dx = sph.spacing(cfg)
    spawns = step >= 0
    off = (a.pos - pos)[spawns]
    assert 0.5 * cfg["jitter"] * dx < float(off.abs().max()) <= cfg["jitter"] * dx
    assert not torch.equal(a.pos, b.pos)
    assert torch.equal(a.pos, BUILDER.inputs(cfg, 2**62 + 1, CPU).pos)
    assert torch.equal(a.spawn_step, step) and torch.equal(a.vel, vel)
    assert not bool(a.pos[~spawns].any())


def _schedule(steps, pos, vel):
    from sph_pie_torch.scenes.emitter import EmitterSchedule

    f64 = dict(dtype=torch.float64)
    return EmitterSchedule(spawn_step=torch.tensor(steps, dtype=torch.int32),
                           spawn_pos=torch.tensor(pos, **f64), spawn_vel=torch.tensor(vel, **f64),
                           spawn_mass=torch.ones(len(steps), **f64))


def test_a_late_row_joins_where_its_spawn_velocity_carried_it():
    """A particle due at step 3 that joins at step 10 is placed 7 dt along
    its spawn velocity, one due at 10 at its spawn position; with dt = 0
    both at their spawn positions, and one never due stays out."""
    from sph_pie_torch.core.state import allocate
    from sph_pie_torch.scenes.emitter import emit_due

    em = _schedule([3, 10, -1], [[0.5, 0.9], [0.6, 0.9], [0.7, 0.9]],
                   [[0.0, -1.5], [0.0, -1.5], [0.0, -1.5]])
    empty = allocate(3, 2, torch.float64, device="cpu")
    st = emit_due(empty, em, 10, 1e-3, 0.0)
    assert st.active.tolist() == [True, True, False]
    assert torch.allclose(st.pos[:2], torch.tensor([[0.5, 0.9 - 7 * 1.5e-3], [0.6, 0.9]],
                                                   dtype=torch.float64), rtol=0, atol=1e-15)
    assert torch.equal(st.vel[:2], em.spawn_vel[:2])
    assert torch.equal(emit_due(empty, em, 10, 0.0, 0.0).pos[:2], em.spawn_pos[:2])


def test_a_row_waits_for_a_clear_place():
    """A due particle whose place has an active particle nearer than the
    clearance stays inactive and untouched, and joins at a later call
    once the place is clear; an inactive particle there does not block
    it, nor does another due one."""
    from sph_pie_torch.core.state import allocate
    from sph_pie_torch.scenes.emitter import emit_due
    from sph_pie_torch.utils.struct import replace

    em = _schedule([0, 0, -1, -1], [[0.5, 0.9], [0.503, 0.9], [0.0, 0.0], [0.0, 0.0]],
                   [[0.0, -1.0]] * 4)
    st = allocate(4, 2, torch.float64, device="cpu")
    spray = torch.tensor([[0.51, 0.9], [0.5, 0.901]], dtype=torch.float64)  # active, not
    st = replace(st, pos=torch.cat([st.pos[:2], spray]),
                 active=torch.tensor([False, False, True, False]))
    blocked = emit_due(st, em, 0, 1e-3, 0.009)
    assert blocked.active.tolist() == [True, False, True, False]
    assert torch.equal(blocked.pos[1], st.pos[1]) and float(blocked.mass[1]) == 0.0
    moved = replace(blocked, pos=blocked.pos.index_put((torch.tensor(2),),
                                                       torch.tensor([0.3, 0.9], dtype=torch.float64)))
    later = emit_due(moved, em, 50, 1e-3, 0.009)
    assert later.active.tolist() == [True, True, True, False]
    assert torch.allclose(later.pos[1], torch.tensor([0.503, 0.85], dtype=torch.float64),
                          rtol=0, atol=1e-15)
