"""The faucet cell (``faucet2d_4k.emit``) at CPU size: its driver against the
program's own scene runner, its check against the program, the control
and the planted emission faults, the workload's check and profiled slice
across the boundaries that emit, and the ``emit_ms`` reader."""

from __future__ import annotations

import json
import math

import pytest
import torch

from h100bench import emit_readings, harness, judge, tracing
from h100bench.reference import sph
from h100bench.readings import clock_left_at_zero, obstacles_left_out
from h100bench.tests.conftest import copy_bench
from h100bench.tests.test_h100bench_check import answer_altered, half_left_out, unchanged

CELL = "faucet2d_4k.emit"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def faucet(tmp_path_factory) -> harness.Bench:
    """The benchmark with the faucet at 512 rows: the cell's 50-step epochs
    (a row every 53 steps) and a check of 520 steps, past the stream's
    first contact with the circle (~460 steps in at this size), segments
    of 540 steps, a slice of 60 steps over the boundary at 100."""
    root = copy_bench(tmp_path_factory.mktemp("faucet"))
    hb = root / "h100bench"
    builder = harness.Bench(hb).module("scenes", "faucet")
    path = hb / "configs" / "faucet2d_4k.json"
    path.write_text(json.dumps(builder.scaled(json.loads(path.read_text()), 512)))
    path = hb / "workloads" / f"{CELL}.json"
    work = json.loads(path.read_text())
    work.update(segment_steps=540, warm_steps=51,
                profile={"segment": 0, "from_step": 71, "steps": 60})
    work["check"]["steps"] = 520
    path.write_text(json.dumps(work))
    return harness.Bench(hb)


def _inputs(bench, seed):
    work = bench.workload(CELL)
    cfg = bench.config(work["config"])
    return work, cfg, bench.module("scenes", cfg["builder"]).inputs(cfg, seed, CPU)


def _run(bench, fault=None):
    return harness.run(CELL, 2**41 + 5, 0.3, False, bench=bench, device="cpu", fault=fault)


def test_program_agrees_with_the_reference(faucet):
    result, check = _run(faucet)
    assert result["correct"], check
    assert result["failed"] == 0 and check["lost"][0] == 0
    for name in ("pos_gap", "vel_gap", "rho_gap"):
        assert check[name][0] < 1e-4, (name, check[name])


@pytest.mark.parametrize("seed", [3, 2**40 + 1, 2**62 + 5])
def test_control_is_not_correct(faucet, seed):
    work, cfg, inp = _inputs(faucet, seed)
    nums = judge.numbers(cfg, work, inp, judge.control(cfg, work, inp))
    assert not judge.verdict(work["check"]["limits"], nums), nums


@pytest.mark.parametrize("fault", [
    emit_readings.emission_skipped, emit_readings.emitted_late, emit_readings.spawned_still,
    clock_left_at_zero, obstacles_left_out, unchanged, half_left_out, answer_altered,
], ids=lambda f: f.__name__)
def test_faults_are_not_correct(faucet, fault):
    result, check = _run(faucet, fault)
    assert not result["correct"], check


def test_skipped_emission_is_seen_by_the_gaps(faucet):
    """The row that joins one boundary late is caught by where it is, not
    by a count: every row is alive on both sides."""
    result, check = _run(faucet, emit_readings.emission_skipped)
    assert check["lost"][0] == 0 and check["pos_gap"][0] > check["pos_gap"][1]


def test_emit_driver_is_the_scene_runner(faucet):
    """The emit driver's state after two epochs and three steps is
    ``solvers.run.run_epochs``' with the same stream and obstacles, field
    for field, to the bit."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.solvers import run

    work, cfg, inp = _inputs(faucet, 2**40 + 7)
    builder = faucet.module("scenes", cfg["builder"])
    drv = faucet.module("traffic", "emit").Driver(cfg, work, builder, inp)
    E = work["epoch_steps"]
    b = drv.begin()
    for _ in range(2 * E + 3):
        b = drv.step(b)
    got = nb.unbin(drv.grid, b, drv.state.capacity)

    params, grid, state = builder.program(cfg, inp)
    em = builder.schedule(inp)
    want, overflow = run.run_epochs(params, grid, state, em, drv.obstacles, E, 2)
    want, _ = run.run_epochs(params, grid, want, em, drv.obstacles, 3, 1, start_step=2 * E)
    for name in ("pos", "vel", "mass", "density", "pressure", "active"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(overflow) == 0 and int(drv.failed(b)) == 0
    assert int(want.active.sum()) == int((inp.spawn_step.le(2 * E) & inp.spawn_step.ge(0)).sum())


def _emitting(spawn, boundaries, epoch):
    return [k for k in boundaries if bool(((spawn > k - epoch) & (spawn <= k)).any())]


def test_check_and_slice_cross_boundaries_that_emit():
    """In the cell as it runs: the check's steps cross 26 boundaries that
    emit and end past the time a row leaving the nozzle falls freely to
    the circle's top; the profiled slice crosses two boundaries, each
    emitting; the warm-up crosses one; a segment runs past the last row's
    spawn."""
    bench = harness.Bench()
    work = bench.workload(CELL)
    cfg = bench.config(work["config"])
    step, _, _ = bench.module("scenes", cfg["builder"]).plan(cfg, CPU)
    E, K = work["epoch_steps"], work["check"]["steps"]
    assert len(_emitting(step, range(E, K, E), E)) == 26
    circle = cfg["obstacles"]["spheres"][0]
    drop = cfg["nozzle_lo"][1] - circle["center"][1] - circle["radius"]
    v, g = cfg["emit_speed"], -cfg["gravity"]
    fall = (math.sqrt(v * v + 2.0 * g * drop) - v) / g
    assert K * sph.physics(cfg).dt > fall
    prof = work["profile"]
    inside = [k for k in range(prof["from_step"], prof["from_step"] + prof["steps"]) if k % E == 0]
    assert len(inside) == 2 and _emitting(step, inside, E) == inside
    assert work["warm_steps"] > E and work["segment_steps"] > int(step.max())


def test_emit_ms_reads_the_emission_span():
    """Device time under ``sph.emit`` over its spans; none without one."""
    host = [("h100bench.epoch", 0.0, 30.0), ("sph.emit", 1.0, 9.0),
            ("cudaLaunchKernel", 2.0, 2.5), ("cudaLaunchKernel", 3.0, 3.5),
            ("cudaLaunchKernel", 12.0, 12.5),
            ("h100bench.epoch", 40.0, 60.0), ("sph.emit", 41.0, 45.0),
            ("cudaLaunchKernel", 42.0, 42.5)]
    ops = [("where", 5.0, 7.0), ("where", 7.0, 10.0), ("sort", 13.0, 20.0), ("where", 46.0, 47.0)]
    sl = tracing.Slice(steps=100, ops=ops, host=host, span_device_us={}, wall_us=60.0)
    read = harness.Bench().module("metrics", "emit_ms").read
    r = harness.Reading(cfg={}, work={}, grid=None, n=0, steps=1, seconds=1.0, setup_s=0.0,
                        peak_bytes=0, slice=sl)
    assert read(r) == pytest.approx((2.0 + 3.0 + 1.0) / 2 / 1e3)
    sl.host = [s for s in host if s[0] != "sph.emit"]
    assert read(r) is None
