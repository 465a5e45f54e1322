"""The port's oracles (``sph_pie_torch/oracle.py``, ``sph_pie_torch/native/``)
and the trajectory contract (``sph_pie_torch/verify.py``) against the JAX
package's, on the CPU.

The NumPy oracles are the reference's arithmetic on arrays read back from
tensors, so they are held bit for bit; so is the C++ oracle, built from the
same source with the same flags. ``verify.run`` at 256 particles and 100
steps is held within 1e-6 of the oracle, the bound
``tests/test_torch_wcsph.py`` holds the port's float64 roll to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_pie_torch import native as tnative
from sph_pie_torch import oracle as toracle
from sph_pie_torch import verify
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.scenes import obstacles as tobs
from sph_pie_torch.solvers import pbf as tp
from sph_pie_tpu import native as jnative
from sph_pie_tpu import oracle as joracle
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.scenes import obstacles as jobs
from sph_pie_tpu.solvers import pbf as jp

N = 256
OBSTACLES = dict(
    spheres=[([0.3, 0.3], 0.08)], boxes=[([0.05, 0.05], [0.15, 0.12])],
    sphere_motions=[([0.1, 0.0], [0.02, 0.01], 2.0, 0.3)],
    box_motions=[([0.0, 0.05], [0.0, 0.0], 0.0, 0.0)],
)


def scenes():
    """dam_break_2d(256) in float64: (reference scene, port scene)."""
    with jax.enable_x64(True):
        js = jb.dam_break_2d(n_target=N, dtype=jnp.float64)
    ts = tb.dam_break_2d(n_target=N, dtype=torch.float64, device="cpu")
    return js, ts


@pytest.mark.parametrize("with_obstacles", [False, True])
def test_oracle_sim_is_the_reference_bit_for_bit(with_obstacles):
    """30 steps of ``OracleSim`` from ``oracle_from_scene``, with and without
    a moving sphere and a moving box: positions, velocities, densities and
    pressures equal bit for bit."""
    js, ts = scenes()
    with jax.enable_x64(True):
        want = joracle.oracle_from_scene(js)
        if with_obstacles:
            want.obstacles = jobs.make(2, dtype=jnp.float64, **OBSTACLES)
        want.run(30)
    got = toracle.oracle_from_scene(ts)
    if with_obstacles:
        got.obstacles = tobs.make(2, dtype=torch.float64, device="cpu", **OBSTACLES)
    got.run(30)
    for k in ("pos", "vel", "density", "pressure"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.t == want.t


def test_pbf_oracle_is_the_reference_bit_for_bit():
    """10 steps of ``PbfOracle`` (iters 3, XSPH on from the second step's
    previous density) on the same scene and parameters: bit for bit."""
    js, ts = scenes()
    kw = dict(iters=3, sor=0.9)
    with jax.enable_x64(True):
        jpp = jp.make_pbf_params(dtype=jnp.float64, **kw)
        cap = min(float(jpp.proj_cap_h) * float(js.params.h), 0.5 * js.bgrid.skin)
        act = np.asarray(js.state.active)
        want = joracle.PbfOracle(
            js.params, jpp, np.asarray(js.state.pos)[act], np.asarray(js.state.vel)[act],
            np.asarray(js.state.mass)[act], proj_cap=cap,
        )
        want.run(10)
    tpp = tp.make_pbf_params(dtype=torch.float64, device="cpu", **kw)
    act = ts.state.active
    got = toracle.PbfOracle(
        ts.params, tpp, ts.state.pos[act], ts.state.vel[act], ts.state.mass[act], proj_cap=cap,
    )
    got.run(10)
    for k in ("pos", "vel", "density"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


@pytest.fixture(scope="module")
def both_native():
    if not (tnative.available() and jnative.available()):
        pytest.skip(f"no C++ toolchain: {tnative.build_error() or jnative.build_error()}")


def test_native_oracle_is_the_reference_bit_for_bit(both_native):
    """The C++ oracle, 3D with cohesion and XSPH (``dam_break_3d(600)``) and
    2D, 40 steps from the same arrays: the port's build and the reference's
    give equal bits; the port's parameters pack to the reference's."""
    for make, n in ((tb.dam_break_3d, 600), (tb.dam_break_2d, N)):
        ts = make(n_target=n, device="cpu")
        js = getattr(jb, make.__name__)(n_target=n)
        assert np.array_equal(tnative.pack_params(ts.params), jnative.pack_params(js.params))
        o = toracle.oracle_from_scene(ts)
        got = tnative.oracle_run(ts.params, o.pos, o.vel, o.mass, 40)
        want = jnative.oracle_run(js.params, o.pos, o.vel, o.mass, 40)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert np.abs(got[0] - o.run(40)).max() < 1e-9  # against the NumPy oracle, tests/test_native_oracle.py


def test_native_builds_into_the_build_directory(both_native):
    """The library lives in ``sph_pie_torch/_build/`` (ignored by git) under
    a name keyed by its source and flags, not beside the source."""
    path, err = tnative.gxx_build(tnative._SRC, "liboracle", ".so", tnative._ORACLE_FLAGS,
                                  ("-shared", "-fPIC"))
    assert err is None and path.parent == tnative.BUILD_DIR
    assert path.name.startswith("liboracle-") and path.suffix == ".so"
    assert not list(tnative._DIR.glob("*.so"))


def test_verify_holds_the_contract_small(both_native, capsys):
    """``verify.run`` at 256 particles, 100 steps, on the CPU: the native
    oracle ran, overflow 0, max |dx| under 1e-6; no kernel launched."""
    out = verify.run(n_target=N, steps=100, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert out["ok"] and out["oracle"] == "native" and out["overflow"] == 0
    assert out["max_abs_dx"] < 1e-6 and out["particles"] == 260
    assert out["launches"] == {"density": 0, "forces": 0, "expand": 0}
    assert any(line.startswith("oracle: native C++") for line in lines)
    assert lines[-1].endswith("PASS")


def test_verify_digests_repeat(both_native, capsys):
    """Two ``verify.run``s of one small contract print and return the same
    16-hex-digit digests of the engine's and the oracle's final positions."""
    a = verify.run(n_target=N, steps=20, device="cpu")
    b = verify.run(n_target=N, steps=20, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    for k in ("engine_digest", "oracle_digest"):
        assert a[k] == b[k] and len(a[k]) == 16 and int(a[k], 16) >= 0
    assert sum(line == f"final positions: engine digest {a['engine_digest']}, oracle digest "
               f"{a['oracle_digest']}" for line in lines) == 2


def test_native_build_name_keys_the_host_cpu(monkeypatch):
    """The oracle's build name changes with the host's CPU (what
    ``-march=native`` resolves to), so a ``_build/`` copied from another
    host is not reused."""
    cmd = ["g++", *tnative._ORACLE_FLAGS[0], str(tnative._SRC)]
    names = set()
    for cpu in ("-march= skylake-avx512", "-march= sapphirerapids"):
        monkeypatch.setattr(tnative, "host_cpu", lambda cpu=cpu: cpu)
        names.add(tnative.build_path(tnative._SRC, "liboracle", ".so", cmd).name)
    assert len(names) == 2 and all(n.startswith("liboracle-") for n in names)
