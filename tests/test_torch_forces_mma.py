"""Port vs reference: the moment-form forces of
``scripts/micro_mxu_vmem.py`` ``forces_mxu`` (interpret mode) on the cap-32
scenes of ``tests/test_pallas_pair.py`` (2D 700; 3D 1500 at skin 0.25,
with surface tension 0 as the harness runs it: the kernel has no cohesion
term), advanced 10 steps with density and pressure set.

Tolerances, scale-normalised (max |diff| / max |ref|) on valid slots:
  * float32 arm against the JAX float32 arm: 2e-5 (summation order and the
    centering group: the port centers per cell over 3 cells, the TPU kernel
    over a 4-cell lane row);
  * bf16 arm against the JAX bf16 arm and against the fold ``_forces``:
    5e-2 (the JAX arm is 1.7-2.4e-2 from the fold, and the two centering
    groups round to bf16 differently).
"""

import numpy as np
import pytest
import torch

from _torch_parity import load_script, port_inputs, scaled_err
from sph_pie_torch.micro.forces_mma import forces_mma, forces_mma_plain
from sph_pie_tpu.kernels import eos as jeos
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw
from sph_pie_tpu.utils.struct import replace as jreplace

CASES = {
    "2d": ("dam_break_2d", 700, {}),
    "3d": ("dam_break_3d", 1500, {"skin_frac": 0.25, "surface_tension": 0.0}),
}
F32_TOL = 2e-5
BF16_TOL = 5e-2


@pytest.fixture(scope="module", params=sorted(CASES))
def forces_case(request):
    """(reference outputs by arm and the fold, port inputs)."""
    make, n, kw = CASES[request.param]
    scene = getattr(jb, make)(n, **kw)
    g = scene.bgrid
    assert g.cap == 32 and not scene.params.use_cohesion
    b = jw.simulate(scene.params, g, scene.binned_state(), 10)
    rho = jw._density(scene.params, g, b)
    b = jreplace(b, density=rho, pressure=jeos.tait_pressure(scene.params, rho))
    mm = load_script("micro_mxu_vmem")
    ref = {
        arm: tuple(np.asarray(x) for x in mm.forces_mxu(scene.params, g, b, bf16=bf, interpret=True))
        for arm, bf in (("f32", False), ("bf16", True))
    }
    ref["fold"] = tuple(np.asarray(x) for x in jw._forces(scene.params, g, b))
    return ref, port_inputs(scene, b)


@pytest.mark.heavy
def test_forces_mma_f32_plain_matches_forces_mxu(forces_case):
    ref, (params, grid, b) = forces_case
    acc, xsph = (x.numpy() for x in forces_mma_plain(params, grid, b))
    v = b.valid.numpy()
    assert scaled_err(acc[v], ref["f32"][0][v]) < F32_TOL
    assert scaled_err(xsph[v], ref["f32"][1][v]) < F32_TOL


@pytest.mark.heavy
def test_forces_mma_bf16_plain_matches_the_bf16_arm_and_the_fold(forces_case):
    ref, (params, grid, b) = forces_case
    acc, xsph = (x.numpy() for x in forces_mma_plain(params, grid, b, bf16=True))
    v = b.valid.numpy()
    assert scaled_err(acc[v], ref["bf16"][0][v]) < BF16_TOL
    assert scaled_err(xsph[v], ref["bf16"][1][v]) < BF16_TOL
    assert scaled_err(acc[v], ref["fold"][0][v]) < BF16_TOL
    if params.use_xsph:  # the fold's XSPH is 0 without it; forces_mxu's is not
        assert scaled_err(xsph[v], ref["fold"][1][v]) < BF16_TOL
    # bf16 rounding is visible: the arm is not the float32 one
    assert scaled_err(acc[v], ref["f32"][0][v]) > 1e-4


@pytest.mark.heavy
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_forces_mma_is_zero_on_invalid_slots(forces_case, bf16):
    _, (params, grid, b) = forces_case
    acc, xsph = forces_mma_plain(params, grid, b, bf16=bf16)
    v = b.valid
    assert (~v).any() and acc[v].abs().max() > 0
    assert not acc[~v].any() and not xsph[~v].any()


@pytest.mark.heavy
def test_forces_mma_wrapper_on_cpu_is_the_plain_version(forces_case):
    _, (params, grid, b) = forces_case
    launches = dict(forces_mma.launches)
    for bf16 in (False, True):
        a1, x1 = forces_mma(params, grid, b, bf16=bf16)
        a2, x2 = forces_mma_plain(params, grid, b, bf16=bf16)
        assert torch.equal(a1, a2) and torch.equal(x1, x2)
    assert forces_mma.launches == launches


def _binned(make, n, **kw):
    scene = getattr(jb, make)(n, **kw)
    return port_inputs(scene, scene.binned_state())


def test_forces_mma_rejects_cohesion():
    params, grid, b = _binned("dam_break_3d", 1500, skin_frac=0.25)
    assert params.use_cohesion and grid.cap == 32
    for fn in (forces_mma, forces_mma_plain):
        with pytest.raises(ValueError, match="cohesion"):
            fn(params, grid, b)


def test_forces_mma_rejects_other_caps_dtypes_and_devices():
    params, grid, b = _binned("dam_break_3d", 1500, surface_tension=0.0)
    assert grid.cap == 40
    with pytest.raises(ValueError, match="cap == 32"):
        forces_mma(params, grid, b)
    params, grid, b = _binned("dam_break_2d", 400)
    b64 = type(b)(**{k: v.double() if v.is_floating_point() else v for k, v in vars(b).items()})
    with pytest.raises(TypeError, match="float32"):
        forces_mma(params, grid, b64)
    meta = type(b)(**{k: v.to("meta") for k, v in vars(b).items()})
    with pytest.raises(ValueError, match="no kernel"):
        forces_mma(params, grid, meta)
