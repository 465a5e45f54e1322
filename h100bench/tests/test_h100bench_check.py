"""The comparison that decides ``correct``, at CPU size: the program's
segments against the reference, the control, and the timed path broken
underneath a run."""

from __future__ import annotations

import pytest
import torch

from h100bench import harness, judge

CELLS = ["dam3d_1m.wcsph", "dam2d_4k.wcsph", "dam3d_1m.pbf_frame"]


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
    work = small.workload(cell)
    cfg = small.config(work["config"])
    inp = small.module("scenes", cfg["builder"]).inputs(cfg, seed, torch.device("cpu"))
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
