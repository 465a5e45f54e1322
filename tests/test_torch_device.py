"""The port's entry points run on the card unless the caller asks for the
CPU, and the host-side helpers of the staged pair kernels
(``sph_pie_torch/neighbors/runs.py``) against the kernels' constants."""

import inspect
import re
from pathlib import Path

import pytest
import torch

from sph_pie_torch.core import params, state
from sph_pie_torch.neighbors import runs
from sph_pie_torch.scenes import builders

ENTRY_POINTS = {
    "block_scene": builders.block_scene,
    "dam_break_2d": builders.dam_break_2d,
    "dam_break_3d": builders.dam_break_3d,
    "make_params": params.make_params,
    "allocate": state.allocate,
    "from_positions": state.from_positions,
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
