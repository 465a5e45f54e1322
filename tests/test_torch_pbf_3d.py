"""Port vs reference: the PBF folds and one step on the 3D dam break
(1500 particles, float32), on the CPU. The checks are those of
``test_torch_pbf.py``; this file holds their 3D cases so that each file
stays short."""

import pytest

from test_torch_pbf import CONFIGS, check_folds, check_one_step


def test_folds_match_reference_3d():
    check_folds("3d_f32")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_one_step_matches_reference_3d(config):
    check_one_step("3d_f32", config)
