"""Port vs reference: the scene run loop (``sph_pie_torch/solvers/run.py``)
with emitters, obstacles and PBF, on the CPU. The float64 comparisons run
the reference's epoch body from its own functions (``_ref_run_epochs``):
its jitted ``run_epochs`` carries an int32 overflow that x64 promotes, so
it runs in float32 only."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_held, jax_fields
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.scenes import emitter as tem
from sph_pie_torch.scenes import obstacles as tobs
from sph_pie_torch.solvers import pbf as tpbf
from sph_pie_torch.solvers import run as trun
from sph_pie_torch.solvers import wcsph_binned as tw
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.scenes import config as jconfig
from sph_pie_tpu.scenes import emitter as jem
from sph_pie_tpu.scenes import obstacles as jobs
from sph_pie_tpu.solvers import pbf as jpbf
from sph_pie_tpu.solvers import run as jrun
from sph_pie_tpu.solvers import wcsph_binned as jw

ROOT = Path(__file__).resolve().parents[1]


def _ref_emit_due(state, emitter, step0, dt, h):
    """The reference's ``emit_due`` with the port's ``run_epochs`` rule: a
    row that joins after its spawn step is moved on along its spawn
    velocity by (step0 - spawn step) dt, and a row with an active row
    nearer than ``CLEARANCE`` h to that place stays as it was."""
    out = jem.emit_due(state, emitter, step0)
    late = jnp.asarray(step0 - emitter.spawn_step, dt.dtype) * dt
    place = out.pos + emitter.spawn_vel * late[:, None]
    gap = jnp.linalg.norm(place[:, None, :] - state.pos[None, :, :], axis=-1)
    near = ((gap < tem.CLEARANCE * h) & state.active[None, :]).any(1)
    joined = out.active & ~state.active & ~near
    j2 = joined[:, None]
    return dataclasses.replace(
        out, pos=jnp.where(j2, place, state.pos), vel=jnp.where(j2, out.vel, state.vel),
        mass=jnp.where(joined, out.mass, state.mass), active=state.active | joined)


def _ref_run_epochs(params, grid, state, emitter, obstacles, epoch_steps, n_epochs,
                    start_step=0, pbf_params=None):
    """The reference's epoch loop (``sph_pie_tpu/solvers/run.py``, ``epoch``)
    from its own functions, one epoch at a time, with the port's emission
    (``_ref_emit_due``). Returns (state, overflow)."""
    overflow = 0
    for e in range(n_epochs):
        step0 = start_step + e * epoch_steps
        if emitter is not None:
            state = _ref_emit_due(state, emitter, step0, params.dt, params.h)
        b = jnb.bin_state(grid, state, None,
                          sim_time=jnp.asarray(step0, params.dt.dtype) * params.dt)
        if pbf_params is not None:
            b = jpbf.simulate(params, grid, pbf_params, b, epoch_steps, obstacles)
        else:
            b = jw.simulate(params, grid, b, epoch_steps, obstacles)
        state = jnb.unbin(grid, b, state.capacity)
        overflow = max(overflow, int(b.overflow))
    return state, overflow


def test_emitter_2d_epochs_match_reference():
    """BASELINE config #2's scene at 512 in float64, 4 epochs of 50 steps:
    the port's ``run_scene`` against the reference's epoch loop, active mask
    equal, |dpos| <= 1e-9 (the stream meets the sphere only after ~430
    steps: the slow test below and ``chip_smoke.py`` Phase E1 run there)."""
    with jax.enable_x64():
        js = jb.emitter_2d(512, dtype=jnp.float64)
        want, jov = _ref_run_epochs(js.params, js.bgrid, js.state, js.emitter,
                                    js.obstacles, 50, 4)
    got, tov = trun.run_scene(tb.emitter_2d(512, dtype=torch.float64, device="cpu"), 200)
    assert_held(got, want, 1e-9)
    # a row of 4 every 53 steps: the epochs at steps 0, 50, 100, 150 emit
    # the rows due at 0, 53 and 106
    assert int(tov) == jov == 0 and int(got.active.sum()) == 12


def test_epoch_edge_cases_match_reference():
    """A float64 faucet against the reference, epoch by epoch, where the
    state is empty or loses rows. The emitter starts after the first epoch,
    so that epoch bins and steps a state with no active row. Cells of cap 4
    take rows that arrive together at one spawn position, so rows drop:
    they leave the active set at the epoch's unbin (whatever the last
    binning's overflow says) and the emitter re-emits them the next epoch,
    along their spawn velocity as a late row joins. Active masks are compared, not just
    positions."""
    spec = json.loads((ROOT / "config" / "scene-faucet-2d.json").read_text())
    spec["emitters"][0].update(speed=3.0, t_start=0.005)
    epoch_steps = 60
    with jax.enable_x64():
        js = jconfig.scene_from_spec(spec, jnp.float64)
        js = dataclasses.replace(js, bgrid=dataclasses.replace(js.bgrid, cap=4))
        ts = convert.scene(js, device="cpu")
        jst, tst = js.state, ts.state
        counts = []
        for e in range(5):
            step0 = e * epoch_steps
            jst, jov = _ref_run_epochs(js.params, js.bgrid, jst, js.emitter, js.obstacles,
                                       epoch_steps, 1, start_step=step0)
            tst, tov = trun.run_epochs(ts.params, ts.bgrid, tst, ts.emitter, ts.obstacles,
                                       epoch_steps, 1, start_step=step0)
            assert_held(tst, jst, 1e-9)
            assert int(tov) == jov
            due = (ts.emitter.spawn_step >= 0) & (ts.emitter.spawn_step <= step0)
            counts.append((int(due.sum()), int(tst.active.sum())))
    assert counts[0] == (0, 0)
    dropped = [n_due - n_act for n_due, n_act in counts]
    assert max(dropped) > 0, counts
    # a re-emitted row is active again in a later epoch
    assert any(b[1] > a[0] - (a[0] - a[1]) for a, b in zip(counts, counts[1:]) if a[0] > a[1])


def test_run_epochs_moving_obstacle_keeps_phase():
    """Moving obstacles keep their phase across epoch boundaries: a
    two-epoch run matches the one-epoch run of the same horizon (float32,
    the reference's test and bound; against the reference itself the PBF
    test below runs a moving sphere across an epoch boundary)."""
    ts = tb.dam_break_2d(400, device="cpu")
    dt = float(ts.params.dt)
    # oscillation period ~ 40 steps: phase error at step 40 is gross
    to = tobs.make(2, spheres=[([0.5, 0.15], 0.06)],
                   sphere_motions=[([0.0, 0.0], [0.2, 0.0], 1.0 / (40 * dt), 0.0)],
                   device="cpu")
    outs = {}
    for epoch_steps in (80, 40):
        st, ov = trun.run_epochs(ts.params, ts.bgrid, ts.state, None, to,
                                 epoch_steps, 80 // epoch_steps)
        assert int(ov) == 0
        outs[epoch_steps] = st
    one, two = outs[80], outs[40]
    err = (one.pos[one.active] - two.pos[two.active]).abs().max().item()
    assert err < 1e-3, err


def test_run_scene_float32_matches_reference_run_scene():
    """The reference's own jitted ``run_scene`` (float32) on BASELINE config
    #2's scene at 512, 4 epochs of 53 steps, the stream's row interval, so
    that every row joins at its spawn step and the port's emission is the
    reference's: active mask equal, |dpos| <= 1e-5 (float32 rounding of a
    free-falling stream, domain 1 m)."""
    js = jb.emitter_2d(512)
    want, jov = jrun.run_scene(js, 212, 53)
    got, tov = trun.run_scene(tb.emitter_2d(512, device="cpu"), 212, 53)
    assert_held(got, want, 1e-5)
    assert int(tov) == int(jov) == 0 and int(got.active.sum()) == 16


def test_run_scene_plain_dam_break_matches_simulate():
    """Without emitter or obstacles the epoch loop is the binned roll up to
    the summation order of the bin/unbin round trip (float32, the
    reference's bound 1e-4)."""
    ts = tb.dam_break_2d(400, device="cpu")
    st, ov = trun.run_scene(ts, 100, 50)
    b = tw.simulate(ts.params, ts.bgrid, ts.binned_state(), 100)
    direct = tnb.unbin(ts.bgrid, b, ts.state.capacity)
    assert int(ov) == 0 and torch.equal(st.active, direct.active)
    assert (st.pos[st.active] - direct.pos[direct.active]).abs().max().item() < 1e-4


def test_run_scene_pbf_epochs_match_simulate():
    """Epoch loop with ``pbf_params`` against ``pbf.simulate`` at
    ``dam_break_2d(400)``, 2 epochs of 30 steps (the reference's test and
    bound, 3e-3: the epoch boundary forces a rebin the direct roll lacks,
    and PBF's projection cap amplifies the summation-order change); the
    round trip keeps density, so rho stays near rest."""
    ts = tb.dam_break_2d(400, device="cpu")
    pp = tpbf.make_pbf_params(iters=2, device="cpu")
    st, ov = trun.run_scene(ts, 60, 30, pbf_params=pp)
    assert int(ov) == 0
    b = tpbf.simulate(ts.params, ts.bgrid, pp, ts.binned_state(), 60)
    direct = tnb.unbin(ts.bgrid, b, ts.state.capacity)
    act = direct.active
    assert torch.equal(st.active, act)
    assert (st.pos[act] - direct.pos[act]).abs().max().item() < 3e-3
    rho = st.density[act]
    assert torch.quantile(rho, 0.9).item() < 1.2 * float(ts.params.rest_density)
    assert bool((rho > 0).all())


def test_pbf_epochs_with_obstacle_match_reference():
    """PBF epochs with a moving sphere, float64, against the reference's
    epoch loop (the sphere's phase at the second epoch's start comes from
    ``sim_time = step0 dt``): 2 epochs of 6 steps, active mask equal, |dpos| <= 1e-9, and
    the density carried across the boundary within 1e-10 relative."""
    kw = dict(spheres=[([0.2, 0.1], 0.06)],
              sphere_motions=[([0.1, 0.0], [0.0, 0.02], 20.0, 0.3)])
    with jax.enable_x64():
        js = jb.dam_break_2d(300, dtype=jnp.float64)
        jp = jpbf.make_pbf_params(iters=2, dtype=jnp.float64)
        want, _ = _ref_run_epochs(js.params, js.bgrid, js.state, None,
                                  jobs.make(2, dtype=jnp.float64, **kw), 6, 2, pbf_params=jp)
        ts = convert.scene(js, device="cpu")
        tp = convert.pbf_params(jax_fields(jp), device="cpu")
    got, _ = trun.run_epochs(ts.params, ts.bgrid, ts.state, None,
                             tobs.make(2, dtype=torch.float64, device="cpu", **kw),
                             6, 2, pbf_params=tp)
    assert_held(got, want, 1e-9)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density), rtol=1e-10)


@pytest.mark.slow
def test_emitter_2d_4096_500_steps_match_reference():
    """bench.py's row length: ``emitter_2d(4096)``, 500 steps (10 epochs of
    50) in float64, port against the reference: active mask equal, |dpos|
    <= 1e-9."""
    with jax.enable_x64():
        js = jb.emitter_2d(4096, dtype=jnp.float64)
        want, jov = _ref_run_epochs(js.params, js.bgrid, js.state, js.emitter,
                                    js.obstacles, 50, 10)
    got, tov = trun.run_scene(tb.emitter_2d(4096, dtype=torch.float64, device="cpu"), 500)
    assert_held(got, want, 1e-9)
    assert int(tov) == jov == 0
