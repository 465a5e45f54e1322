"""The port's entry points run on the card unless the caller asks for the
CPU, and the host-side helpers of the staged pair kernels
(``sph_pie_torch/neighbors/runs.py``) against the kernels' constants."""

import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from sph_pie_torch.core import params, state
from sph_pie_torch.micro import center_slab
from sph_pie_torch.neighbors import runs
from sph_pie_torch.scenes import builders, config, emitter, obstacles

ROOT = Path(__file__).resolve().parents[1]

ENTRY_POINTS = {
    "block_scene": builders.block_scene,
    "dam_break_2d": builders.dam_break_2d,
    "dam_break_3d": builders.dam_break_3d,
    "emitter_2d": builders.emitter_2d,
    "make_params": params.make_params,
    "allocate": state.allocate,
    "from_positions": state.from_positions,
    "obstacles.make": obstacles.make,
    "obstacles.empty": obstacles.empty,
    "plan_stream": emitter.plan_stream,
    "no_emitter": emitter.no_emitter,
    "scene_from_spec": config.scene_from_spec,
    "load_scene_file": config.load_scene_file,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_default_device_without_a_card_raises():
    """No fallback to the CPU: without a CUDA device the default fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        builders.dam_break_2d(200)


SCENE_CALLS = {
    "emitter_2d": lambda: builders.emitter_2d(512),
    "obstacles.make": lambda: obstacles.make(2, spheres=[([0.5, 0.5], 0.1)]),
    "plan_stream": lambda: emitter.plan_stream(
        start_index=0, capacity=64, dim=2, nozzle_lo=[0.4, 0.9], nozzle_hi=[0.5, 0.91],
        direction=[0.0, -1.0], speed=1.0, dx=0.01, mass=0.1, dt=1e-4),
    "load_scene_file": lambda: config.load_scene_file(ROOT / "config" / "scene-faucet-2d.json"),
    "scene_from_spec": lambda: config.scene_from_spec(
        {"builder": "dam_break_2d", "builder_args": {"n_target": 200}}),
}


@pytest.mark.parametrize("name", sorted(SCENE_CALLS))
def test_scene_entry_points_without_a_card_raise(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        SCENE_CALLS[name]()


def test_cli_defaults_to_the_card_and_fails_without_one(capsys):
    """``python -m sph_pie_torch simulate`` runs on ``cuda`` unless told
    ``--device cpu``; without a card it exits with an error, having run
    nothing on the CPU."""
    from sph_pie_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(SystemExit) as exc:
        main(["simulate", "dam_break_2d", "--steps", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and not err.out


@pytest.mark.parametrize("cap", [4, 8, 32, 40, 64, 76, 80, 96, 128, 192, 200, 384])
def test_run_cells_fit_the_home_slots(cap):
    R = runs.run_cells(cap)
    assert 1 <= R <= runs.RUN_CELLS and R * cap <= runs.HOME_SLOTS
    assert R == runs.RUN_CELLS or (R + 1) * cap > runs.HOME_SLOTS
    runs.check_staging("k", cap)


@pytest.mark.parametrize("cap", [0, 2, 6, 42, 388, 512])
def test_run_cells_reject_what_the_bulk_copies_cannot_take(cap):
    with pytest.raises(ValueError, match="multiple of 4"):
        runs.check_staging("k", cap)


@pytest.mark.parametrize("cap,ok", [(8, True), (32, True), (384, True), (30, False), (388, False)])
def test_stageable_is_the_rule_check_staging_raises_on(cap, ok):
    t = torch.zeros(64)
    assert runs.stageable(cap, t, t[4:]) is ok
    assert not runs.stageable(cap, t, t[1:])
    if not ok:
        with pytest.raises(ValueError):
            runs.check_staging("k", cap, pos=t)


def _slab_inputs(cap, off=None):
    """Eight center-slab inputs [2, cap] / [2, 3 cap] on 16-byte boundaries,
    input ``off`` moved 4 bytes past one."""
    def at(n, i):
        buf = torch.zeros(n + 8)
        return buf[1 : n + 1] if i == off else buf[:n]

    return tuple(at(2 * cap * (1 if i < 4 else 3), i) for i in range(8))


@pytest.mark.parametrize("off,groups", [
    (None, True), (0, False), (1, False), (2, False), (3, True),  # 3 is home mass: not given
    (4, False), (5, False), (6, False), (7, False),
])
def test_center_slab_group_arm_is_the_launchers_rule(off, groups):
    """``go`` in ``csrc/center_slab.cu``: the arm over groups of cells for a
    cap that is a multiple of 4 up to 384 when the seven tensors it is given
    and the output start on 16-byte boundaries, else the per-slot arm."""
    grid, inputs = SimpleNamespace(cap=40), _slab_inputs(40, off)
    out = torch.zeros(88)
    assert center_slab.group_arm(grid, inputs) is groups
    assert center_slab.group_arm(grid, inputs, out[:80]) is groups
    assert not center_slab.group_arm(grid, inputs, out[1:81])
    for cap in (30, 388):
        assert not center_slab.group_arm(SimpleNamespace(cap=cap), _slab_inputs(cap))


def test_center_slab_launcher_tests_what_group_arm_tests():
    src = (Path(runs.__file__).parents[1] / "csrc" / "center_slab.cu").read_text()
    assert "in[] = {hx, hy, hz, wx, wy, wz, wm, out}" in src
    assert "bool groups = sph::run_cap_ok(cap);" in src
    assert "groups = groups && sph::aligned16(p)" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("field", ["pos", "mass"])
def test_check_staging_rejects_an_unaligned_start(field, dtype):
    t = torch.zeros(64, dtype=dtype)
    step = 16 // t.element_size()
    runs.check_staging("k", 40, pos=t, mass=t[step:])
    bad = {"pos": t, "mass": t, field: t[1:]}
    with pytest.raises(ValueError, match=f"{field} must start on a 16-byte boundary"):
        runs.check_staging("k", 40, **bad)


@pytest.mark.parametrize("name,const", [
    ("RUN_CELLS", "kRunCells"), ("HOME_SLOTS", "kHomeSlots"),
    ("EXPAND_SLOTS", "kExpandSlots"), ("EXPAND_BYTES", "kExpandBytes"),
])
def test_run_constants_are_the_kernels(name, const):
    src = (Path(runs.__file__).parents[1] / "csrc" / "common.cuh").read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(runs, name)
