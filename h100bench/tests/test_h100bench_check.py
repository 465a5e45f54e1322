"""The comparison that decides ``correct``, at CPU size: the program's
segments against the reference, the control, and the timed path broken
underneath a run; the reference the judge picks, and the epochs driver
against the program's own scene runner."""

from __future__ import annotations

import pytest
import torch

from h100bench import harness, judge
from h100bench.readings import clock_left_at_zero, obstacles_left_out
from h100bench.reference import pbf, sph, wcsph

CELLS = ["dam3d_1m.wcsph", "dam2d_4k.wcsph", "dam3d_1m.pbf_frame", "dam3d_1m.wcsph_sphere"]
SPHERE = "dam3d_1m.wcsph_sphere"
CPU = torch.device("cpu")


def _inputs(small, cell, seed):
    work = small.workload(cell)
    cfg = small.config(work["config"])
    return work, cfg, small.module("scenes", cfg["builder"]).inputs(cfg, seed, CPU)


def _run(small, cell, fault=None):
    return harness.run(cell, 2**33 + 17, 0.5, False, bench=small, device="cpu", fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(small, cell):
    """The driver's segments on the program's plain CPU path agree with the
    reference within the cell's limits; nothing is lost or failed."""
    result, check = _run(small, cell)
    assert result["correct"], check
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert check["lost"][0] == 0
    for name in ("pos_gap", "vel_gap", "rho_gap"):
        assert check[name][0] < 1e-3, (name, check[name])


@pytest.mark.parametrize("seed", [3, 2**40 + 1, 2**62 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small, cell, seed):
    """The reference in bfloat16, put in the program's place, fails."""
    work, cfg, inp = _inputs(small, cell, seed)
    nums = judge.numbers(cfg, work, inp, judge.control(cfg, work, inp))
    assert not judge.verdict(work["check"]["limits"], nums), nums


def unchanged(drv):
    drv._step = lambda b: b


def half_left_out(drv):
    """Half of the slots left out of the step's sums (their mass hidden
    from it), the step taken over the rest; every particle keeps its mass
    after it."""
    real = drv._step

    def step(b):
        m = b.mass.max()
        gone = torch.arange(b.mass.shape[0]) % 2 == 0
        new = real(type(b)(**{**vars(b), "mass": torch.where(gone, 0.0, b.mass)}))
        mass = torch.where(new.owner >= 0, m, 0.0)
        return type(b)(**{**vars(new), "mass": mass, "valid": mass > 0})

    drv._step = step


def answer_altered(drv):
    """One occupied slot's velocity set to the solver's speed limit, where
    the step makes it."""
    real = drv._step

    def step(b):
        new = real(b)
        i = int(new.valid.nonzero()[0, 0])
        vel = new.vel.clone()
        vel[i] = 0.0
        vel[i, 0] = drv.params.max_speed
        return type(b)(**{**vars(new), "vel": vel})

    drv._step = step


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(small, cell, fault):
    result, check = _run(small, cell, fault)
    assert not result["correct"], check


@pytest.mark.parametrize("fault", [obstacles_left_out, clock_left_at_zero])
def test_sphere_faults_are_not_correct(small, fault):
    """The sphere's own faults: its obstacles left out of the step, or the
    clock they move by not carried over an epoch's boundary."""
    result, check = _run(small, SPHERE, fault)
    assert not result["correct"], check


def test_check_crosses_an_epoch_boundary(small):
    work = small.workload(SPHERE)
    assert work["epoch_steps"] < work["check"]["steps"] < 2 * work["epoch_steps"]
    assert work["warm_steps"] > work["epoch_steps"]
    prof = work["profile"]
    assert prof["from_step"] < work["epoch_steps"] <= prof["from_step"] + prof["steps"] - 1


@pytest.mark.parametrize("cell", CELLS[:3])
def test_default_reference_is_the_solvers_steps(small, cell):
    """With no ``check.reference`` (and with it naming the default) the
    judge's reference is the solver's steps called directly, to the bit."""
    work, cfg, inp = _inputs(small, cell, 2**35 + 3)
    p = sph.physics(cfg)
    pos, vel = inp.pos.double(), inp.vel.double()
    mass = torch.full((pos.shape[0],), inp.mass, dtype=torch.float64)
    rho = torch.zeros_like(mass)
    for _ in range(work["check"]["steps"]):
        if work["solver"]["name"] == "wcsph":
            pos, vel, rho, _ = wcsph.step(p, pos, vel, mass)
        else:
            pos, vel, rho = pbf.step(p, pbf.knobs(work["solver"]), pos, vel, mass, rho)
    named = {**work, "check": {**work["check"], "reference": "steps"}}
    for w in (work, named):
        got = judge.reference(cfg, w, inp, torch.float64)
        assert "active" not in got
        for name, want in (("pos", pos), ("vel", vel), ("rho", rho), ("mass", mass)):
            assert torch.equal(got[name], want), name


def test_rows_that_exist_in_one_state_only_are_lost(small):
    """With a reference that names its active rows: a row inactive in both
    is no loss and no gap; a row alive on one side only is lost."""
    work, cfg, _ = _inputs(small, "dam2d_4k.wcsph", 1)
    n = 6
    ref = {"pos": torch.zeros(n, 2, dtype=torch.float64), "vel": torch.ones(n, 2, dtype=torch.float64),
           "rho": torch.full((n,), 1000.0, dtype=torch.float64),
           "active": torch.tensor([True, True, True, True, False, False])}
    got = {"pos": ref["pos"].float(), "vel": ref["vel"].float(), "rho": ref["rho"].float(),
           "alive": ref["active"].clone()}
    got["pos"][5] = 99.0  # an inactive row's leftovers
    assert judge.compare(cfg, work, ref, got) == {"lost": 0.0, "pos_gap": 0.0, "vel_gap": 0.0,
                                                  "rho_gap": 0.0}
    got["alive"] = torch.tensor([True, True, False, True, False, True])
    nums = judge.compare(cfg, work, ref, got)
    assert nums["lost"] == 2.0 and not judge.verdict(work["check"]["limits"], nums)


def test_epochs_driver_is_the_scene_runner(small):
    """The epochs driver's state after two epochs and three steps is
    ``solvers.run.run_epochs``' after as many steps, field for field, to
    the bit, and its rebins and overflow run over the epochs."""
    from sph_pie_torch.neighbors import binned as nb
    from sph_pie_torch.solvers import run

    work, cfg, inp = _inputs(small, SPHERE, 2**40 + 7)
    builder = small.module("scenes", cfg["builder"])
    drv = small.module("traffic", "epochs").Driver(cfg, work, builder, inp)
    E = work["epoch_steps"]
    b = drv.begin()
    for _ in range(2 * E + 3):
        b = drv.step(b)
    got = nb.unbin(drv.grid, b, drv.state.capacity)

    params, grid, state = builder.program(cfg, inp)
    want, overflow = run.run_epochs(params, grid, state, None, drv.obstacles, E, 2)
    want, _ = run.run_epochs(params, grid, want, None, drv.obstacles, 3, 1, start_step=2 * E)
    for name in ("pos", "vel", "mass", "density", "pressure", "active"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(overflow) == 0 and int(drv.failed(b)) == 0
    assert int(drv.rebins(b)) >= int(b.n_rebins)
    assert float(b.sim_time) == pytest.approx((2 * E + 3) * float(params.dt), rel=1e-5)
