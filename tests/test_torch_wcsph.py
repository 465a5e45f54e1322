"""Port vs reference: the WCSPH binned step and roll, end to end on the CPU
(plain versions of every kernel), plus the package's import and build
contracts."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields, port_inputs, scaled_err
from sph_pie_torch import _native, convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import wcsph_binned as tw
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.oracle import oracle_from_scene
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import wcsph_binned as jw

ROOT = Path(__file__).resolve().parents[1]


def _unbinned(jscene, jb_state, tb_state):
    """Reference and port states after unbin, as numpy dicts (owner order)."""
    cap = jscene.state.capacity
    grid = convert.binned_grid(dataclasses.asdict(jscene.bgrid))
    return (
        jax_fields(jnb.unbin(jscene.bgrid, jb_state, cap)),
        convert.to_numpy(tnb.unbin(grid, tb_state, cap)),
    )


@pytest.mark.parametrize(
    "make,n,f64,tol,kw",
    [
        ("dam_break_2d", 400, True, 1e-12, {}),
        ("dam_break_2d", 400, True, 1e-12, {"wall_layers": 2}),
        ("dam_break_3d", 1500, False, 1e-4, {}),
    ],
    ids=["2d_f64", "2d_f64_walls", "3d_f32"],
)
def test_one_step_matches_reference(make, n, f64, tol, kw):
    """One step from a state the reference advanced 10 steps (with wall
    ghosts: frozen rows that never move). Velocity
    carries the pressure's float32 sensitivity (the Tait EOS amplifies a
    1e-7 density difference ~7x and B/p), hence 1e-4 in 3D float32;
    pressure is compared against the stiffness B."""
    with jax.enable_x64(f64):
        scene = getattr(jb, make)(n, dtype=jnp.float64 if f64 else jnp.float32, **kw)
        b0 = jw.simulate(scene.params, scene.bgrid, scene.binned_state(), 10)
        b1 = jw.simulate(scene.params, scene.bgrid, b0, 1)
        params, grid, tb0 = port_inputs(scene, b0)
        want, got = _unbinned(scene, b1, tw.step(params, grid, tb0))
    stiff = float(params.eos_stiffness)
    assert np.array_equal(got["active"], want["active"])
    assert np.abs(got["pos"] - want["pos"]).max() < (1e-14 if f64 else 1e-6)
    assert scaled_err(got["vel"], want["vel"]) < tol
    np.testing.assert_allclose(got["density"], want["density"], rtol=tol * 0.03)
    assert np.abs(got["pressure"] - want["pressure"]).max() < tol * 0.1 * stiff


def test_100_steps_f64_match_reference_and_oracle():
    """2D dam break, 400 particles, float64, 100 steps: against the
    reference binned engine (max |dpos| < 1e-9) and the documented NumPy
    oracle (< 1e-6, the bound of tests/test_wcsph.py)."""
    with jax.enable_x64():
        scene = jb.dam_break_2d(n_target=400, dtype=jnp.float64, viscosity=0.05)
        jb100 = jw.simulate(scene.params, scene.bgrid, scene.binned_state(), 100)
        want = np.asarray(jnb.unbin(scene.bgrid, jb100, scene.state.capacity).pos)
    ts = tb.dam_break_2d(n_target=400, dtype=torch.float64, viscosity=0.05, device="cpu")
    b = tw.simulate(ts.params, ts.bgrid, ts.binned_state(), 100)
    assert int(b.overflow) == 0 and int(b.n_rebins) == int(jb100.n_rebins)
    st = tnb.unbin(ts.bgrid, b, ts.state.capacity)
    got = st.pos.numpy()[st.active.numpy()]
    assert np.abs(got - want).max() < 1e-9
    oracle = oracle_from_scene(scene, dtype=np.float64).run(100)
    assert np.abs(got - oracle).max() < 1e-6


def test_port_runs_without_jax():
    """Importing the port (every module of the scene runner and the CLI
    included) and running a WCSPH step, a PBF step, a frame and two epochs
    of the faucet scene leaves jax unimported."""
    code = (
        "import sys\n"
        "from sph_pie_torch.scenes import dam_break_2d\n"
        "from sph_pie_torch.solvers import pbf, wcsph_binned\n"
        "from sph_pie_torch.render import png, splat\n"
        "from sph_pie_torch import __main__, convert\n"
        "from sph_pie_torch.scenes import config, emitter_2d\n"
        "from sph_pie_torch.solvers import adaptive, run\n"
        "from sph_pie_torch.service import metrics\n"
        "s = dam_break_2d(200, device='cpu')\n"
        "b = wcsph_binned.step(s.params, s.bgrid, s.binned_state())\n"
        "assert int(b.overflow) == 0\n"
        "b = pbf.step(s.params, s.bgrid, pbf.flagship_params(device='cpu'), b)\n"
        "assert int(b.overflow) == 0\n"
        "png.encode_gray_png(splat.render_binned_u8(s.bgrid, b, (32, 32)).numpy())\n"
        "st, ov = run.run_scene(emitter_2d(256, device='cpu'), 2, 1)\n"
        "assert int(ov) == 0 and metrics.state_metrics(st, s.params)['n_active'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sph_pie_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.slow
def test_full_contract_4k_1000_steps():
    """The correctness anchor held for the port: 2D dam break ~4k, float64,
    1000 steps of the port's binned WCSPH on the CPU, within 1e-3 of the
    oracle (the native C++ oracle when built, else the NumPy one), as
    tests/test_wcsph.py holds the reference."""
    from sph_pie_tpu import native

    with jax.enable_x64():
        scene = jb.dam_break_2d(n_target=4096, dtype=jnp.float64)
        oracle = oracle_from_scene(scene, dtype=np.float64)
        if native.available():
            want, _ = native.oracle_run(scene.params, oracle.pos, oracle.vel, oracle.mass, 1000)
        else:
            want = oracle.run(1000)
    ts = tb.dam_break_2d(n_target=4096, dtype=torch.float64, device="cpu")
    b = tw.simulate(ts.params, ts.bgrid, ts.binned_state(), 1000)
    assert int(b.overflow) == 0
    st = tnb.unbin(ts.bgrid, b, ts.state.capacity)
    got = st.pos.numpy()[st.active.numpy()]
    err = np.abs(got - want).max()
    assert err < 1e-3, f"contract violated: max |dx| = {err}"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(_native, "_DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.library()
    assert not (tmp_path / "build").exists()


def test_unported_features_raise():
    """Periodic grids are not ported yet; obstacles are (a step with an
    empty obstacle set is the step without one)."""
    from sph_pie_torch.scenes import obstacles

    s = tb.dam_break_2d(200, device="cpu")
    b = s.binned_state()
    with_empty = tw.step(s.params, s.bgrid, b, obstacles=obstacles.empty(2, device="cpu"))
    plain = tw.step(s.params, s.bgrid, b)
    assert all(torch.equal(getattr(with_empty, k), getattr(plain, k)) for k in vars(plain))
    periodic = dataclasses.replace(s.bgrid, periodic=(False, True))
    with pytest.raises(NotImplementedError, match="periodic"):
        tw.step(s.params, periodic, b)
