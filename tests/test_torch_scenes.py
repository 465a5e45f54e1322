"""Port vs reference: obstacles, emitters, scene files and the epoch loop
(``sph_pie_torch/scenes/{obstacles,emitter,config}.py``,
``sph_pie_torch/solvers/run.py``), on the CPU. The reference runs as its
own tests run it, float64 under ``jax.enable_x64()`` where stated."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_held, assert_same, jax_fields, port_inputs, scaled_err
from sph_pie_torch import convert
from sph_pie_torch.core import state as tstate
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.scenes import config as tconfig
from sph_pie_torch.scenes import emitter as tem
from sph_pie_torch.scenes import obstacles as tobs
from sph_pie_torch.solvers import pbf as tpbf
from sph_pie_torch.solvers import wcsph_binned as tw
from sph_pie_tpu.core import state as jstate
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.scenes import config as jconfig
from sph_pie_tpu.scenes import emitter as jem
from sph_pie_tpu.scenes import obstacles as jobs
from sph_pie_tpu.solvers import wcsph_binned as jw

ROOT = Path(__file__).resolve().parents[1]
SCENE_FILES = sorted(p.name for p in (ROOT / "config").glob("scene-*.json"))


def _assert_same_scene(ts, js):
    assert ts.name == js.name
    assert_same(ts.params, js.params)
    assert ts.gspec == convert.scene(js, device="cpu").gspec
    assert ts.bgrid == convert.binned_grid(dataclasses.asdict(js.bgrid))
    assert_same(ts.state, js.state)
    for k in ("obstacles", "emitter"):
        if getattr(js, k) is None:
            assert getattr(ts, k) is None, k
        else:
            assert_same(getattr(ts, k), getattr(js, k))
    assert (ts.boundary is None) == (js.boundary is None)


# ---- obstacles ------------------------------------------------------------

# Box faces on dyadic coordinates, so points at equal distance from two
# faces tie exactly: the centre (ties on every face) and points equidistant
# from a low and a high face or from faces of two axes.
BOX2 = ([0.25, 0.25], [0.75, 1.25])
BOX3 = ([0.25, 0.25, 0.25], [0.75, 1.25, 0.5])
TIES = {
    2: [[0.5, 0.75], [0.5, 0.5], [0.375, 0.375], [0.625, 1.125], [0.25, 0.5]],
    3: [[0.5, 0.75, 0.375], [0.5, 0.5, 0.375], [0.375, 0.375, 0.375], [0.75, 0.5, 0.375]],
}


def _obstacle_kw(dim, kind, moving):
    sphere = ([0.5] * dim, 0.3)
    box = BOX2 if dim == 2 else BOX3
    kw = {}
    if kind in ("sphere", "both"):
        kw["spheres"] = [sphere, ([0.2] * dim, 0.15)]
    if kind in ("box", "both"):
        kw["boxes"] = [box]
    if moving:
        lin, amp = [0.05] + [0.0] * (dim - 1), [0.0] * (dim - 1) + [0.04]
        kw["sphere_motions"] = [(lin, amp, 3.0, 0.5)] if "spheres" in kw else []
        kw["box_motions"] = [(amp, lin, 2.0, 0.25)] if "boxes" in kw else []
    return kw


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["sphere", "box", "both", "none"])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_accel_matches_reference(dim, kind, moving):
    """``accel`` on random points (and on a box's tie faces) against the
    reference, float64, at several sim times: scaled error <= 1e-12. An
    empty set gives exact zeros."""
    rng = np.random.default_rng(dim * 10 + len(kind) + moving)
    pos = np.concatenate([rng.uniform(0.0, 1.3, (400, dim)), TIES[dim]])
    vel = rng.normal(size=pos.shape)
    kw = _obstacle_kw(dim, kind, moving)
    with jax.enable_x64():
        jo = jobs.make(dim, dtype=jnp.float64, **kw)
        to = tobs.make(dim, dtype=torch.float64, device="cpu", **kw)
        assert_same(to, jo)
        for t in (0.0, 0.013, 0.21):
            want = np.asarray(jobs.accel(jo, jnp.asarray(pos), jnp.asarray(vel), t))
            got = tobs.accel(to, torch.tensor(pos), torch.tensor(vel), torch.tensor(t, dtype=torch.float64)).numpy()
            if kind == "none":
                assert not got.any() and not want.any()
            else:
                assert np.abs(want).max() > 0
                assert scaled_err(got, want) <= 1e-12, (t, scaled_err(got, want))
                if kind == "box" and t == 0.0:
                    # the tie points are inside and pushed along the same face
                    assert np.array_equal(got[-len(TIES[dim]):] != 0,
                                          want[-len(TIES[dim]):] != 0)


def test_empty_matches_reference():
    with jax.enable_x64():
        assert_same(tobs.empty(3, torch.float64, device="cpu"), jobs.empty(3, jnp.float64))


# ---- emitters -------------------------------------------------------------

STREAMS = [
    dict(start_index=0, capacity=300, dim=2, nozzle_lo=[0.45, 0.92],
         nozzle_hi=[0.55, 0.925], direction=[0.0, -1.0], speed=1.5, dx=0.00866,
         mass=0.075, dt=1.0825e-4),
    dict(start_index=40, capacity=300, dim=2, nozzle_lo=[0.7, 0.92],
         nozzle_hi=[0.82, 0.925], direction=[-0.25, -1.0], speed=1.2, dx=0.00866,
         mass=0.075, dt=1.0825e-4, t_start=0.005, t_end=0.05, n_slots=150),
    dict(start_index=5, capacity=700, dim=3, nozzle_lo=[0.4, 0.4, 0.9],
         nozzle_hi=[0.5, 0.48, 0.91], direction=[0.1, 0.0, -1.0], speed=2.0, dx=0.02,
         mass=0.008, dt=2.5e-4, t_start=0.001),
    dict(start_index=0, capacity=50, dim=2, nozzle_lo=[0.45, 0.92],
         nozzle_hi=[0.55, 0.925], direction=[0.0, -1.0], speed=1.5, dx=0.00866,
         mass=0.075, dt=1.0825e-4, t_start=1.0, t_end=0.5),  # no row: no_emitter
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plan_stream_merge_and_emit_due_bit_for_bit(dtype):
    """``plan_stream`` (each case), ``merge_schedules`` of the two disjoint
    2D plans and ``emit_due`` at several step counts, equal to the
    reference's bit for bit (``emit_due`` with dt = clearance = 0, the
    reference's rule)."""
    with jax.enable_x64(dtype == "float64"):
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        plans = []
        for kw in STREAMS:
            jp = jem.plan_stream(**kw, dtype=jd)
            tp = tem.plan_stream(**kw, dtype=td, device="cpu")
            assert_same(tp, jp)
            plans.append((tp, jp))
        tm = tem.merge_schedules([plans[0][0], plans[1][0]])
        jm = jem.merge_schedules([plans[0][1], plans[1][1]])
        assert_same(tm, jm)
        assert (np.asarray(jm.spawn_step) >= 0).sum() > 100
        assert_same(tem.no_emitter(9, 3, td, device="cpu"), jem.no_emitter(9, 3, jd))
        ts, js = tstate.allocate(300, 2, td, device="cpu"), jstate.allocate(300, 2, jd)
        for step in (0, 45, 60, 120, 1000):
            ts, js = tem.emit_due(ts, tm, step, 0.0, 0.0), jem.emit_due(js, jm, step)
            assert_same(ts, js)


# ---- scene files and builders ---------------------------------------------

@pytest.mark.parametrize("name", SCENE_FILES)
def test_scene_file_matches_reference(name):
    """params, grids, state, schedule and obstacles of every scene file equal
    to the reference's (float32, the files' dtype)."""
    path = ROOT / "config" / name
    _assert_same_scene(tconfig.load_scene_file(path, device="cpu"),
                       jconfig.load_scene_file(path))


def test_scene_from_spec_variants_match_reference():
    """Explicit geometry with a fluid block, a box, explicit slots and dt,
    a builder spec with arguments, in float64."""
    spec = json.loads((ROOT / "config" / "scene-twin-jets-2d.json").read_text())
    spec.update(
        fluid_blocks=[{"lo": [0.0, 0.0], "hi": [0.2, 0.1]}], capacity=900, skin_frac=0.4,
        obstacles={"boxes": [{"lo": [0.6, 0.1], "hi": [0.7, 0.3]}]},
        params={"viscosity": 0.02, "dt": 1e-4},
    )
    spec["emitters"][0]["slots"] = 100
    builder = {"name": "b", "builder": "emitter_2d", "builder_args": {"n_target": 512}}
    with jax.enable_x64():
        for sp in (spec, builder):
            _assert_same_scene(tconfig.scene_from_spec(sp, torch.float64, device="cpu"),
                               jconfig.scene_from_spec(sp, jnp.float64))


def test_steps_with_obstacles_match_reference():
    """One WCSPH and one PBF step with a static box and a moving sphere,
    float64, from a state the reference advanced 10 steps."""
    from sph_pie_tpu.solvers import pbf as jpbf

    kw = dict(spheres=[([0.2, 0.15], 0.08)], boxes=[([0.3, 0.0], [0.45, 0.1])],
              sphere_motions=[([0.05, 0.0], [0.0, 0.04], 3.0, 0.5)])
    with jax.enable_x64():
        js = jb.dam_break_2d(300, dtype=jnp.float64)
        jo = jobs.make(2, dtype=jnp.float64, **kw)
        b0 = jw.simulate(js.params, js.bgrid, js.binned_state(), 10, jo)
        params, grid, tb0 = port_inputs(js, b0)
        to = tobs.make(2, dtype=torch.float64, device="cpu", **kw)
        jp = jpbf.make_pbf_params(iters=2, dtype=jnp.float64)
        tp = convert.pbf_params(jax_fields(jp), device="cpu")
        cap = js.state.capacity
        for want_b, got_b in (
            (jw.step(js.params, js.bgrid, b0, jo), tw.step(params, grid, tb0, to)),
            (jpbf.step(js.params, js.bgrid, jp, b0, jo), tpbf.step(params, grid, tp, tb0, to)),
        ):
            want = jnb.unbin(js.bgrid, want_b, cap)
            got = tnb.unbin(grid, got_b, cap)
            assert_held(got, want, 1e-13)
    # the obstacle term acted: without it the step differs
    plain = tnb.unbin(grid, tw.step(params, grid, tb0), cap)
    assert (plain.vel - tnb.unbin(grid, tw.step(params, grid, tb0, to), cap).vel).abs().max() > 1e-3
