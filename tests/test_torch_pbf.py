"""Port vs reference: the PBF solver on the CPU (plain folds).

The rebin payload rules, each fold, one step in four configurations, a
step whose checks rebin mid-step, a 40-step float64 roll against the
reference and the O(N^2) oracle, ride == gather, the flagship quality bars
and the step's contract (checks per step, what raises). The 3D float32
cases of the folds and the step are in ``test_torch_pbf_3d.py``, which
runs ``check_folds`` and ``check_one_step`` from here."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields, port_inputs, scaled_err
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import pbf as tp
from sph_pie_torch.solvers import wcsph_binned as tw
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.oracle import PbfOracle
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import pbf as jp
from sph_pie_tpu.solvers import wcsph_binned as jw
from sph_pie_tpu.utils.struct import replace as jreplace

# Configurations of the step tests; the same keywords in both packages.
CONFIGS = {
    "flagship": dict(flagship=True),
    "gather": dict(flagship=True, epilogue="gather"),
    "iters3": dict(iters=3),
    "vorticity": dict(iters=2, vort_eps=5.0),
}
SCENES = {
    "2d_f64": ("dam_break_2d", 300, True, {}),
    "2d_f64_walls": ("dam_break_2d", 300, True, {"wall_layers": 2}),
    "3d_f32": ("dam_break_3d", 1500, False, {}),
    "3d_f32_walls": ("dam_break_3d", 1500, False, {"wall_layers": 2}),
}


def _jax_pbf(cfg: dict, f64: bool):
    kw = dict(cfg)
    make = jp.flagship_params if kw.pop("flagship", False) else jp.make_pbf_params
    return make(dtype=jnp.float64 if f64 else jnp.float32, **kw)


def _port_pbf(jpp):
    return convert.pbf_params(jax_fields(jpp), device="cpu")


@functools.cache
def _scene(scene_id: str):
    """The reference scene. Call inside ``jax.enable_x64`` for a float64
    scene."""
    make, n, f64, kw = SCENES[scene_id]
    return getattr(jb, make)(n, dtype=jnp.float64 if f64 else jnp.float32, **kw)


@functools.cache
def _advanced(scene_id: str, steps: int = 10):
    """(reference scene, its state after ``steps`` flagship steps)."""
    scene = _scene(scene_id)
    pp = _jax_pbf(CONFIGS["flagship"], SCENES[scene_id][2])
    b = scene.binned_state()
    for _ in range(steps):
        b = jp.step(scene.params, scene.bgrid, pp, b)
    return scene, b


def _unbinned(scene, jstate, tstate):
    cap = scene.state.capacity
    grid = convert.binned_grid(dataclasses.asdict(scene.bgrid))
    return (
        jax_fields(jnb.unbin(scene.bgrid, jstate, cap)),
        convert.to_numpy(tnb.unbin(grid, tstate, cap)),
    )


def _assert_states_match(want, got, f64: bool):
    """Unbinned states: float64 to rounding; float32 velocities carry the
    position rounding divided by dt."""
    assert np.array_equal(got["active"], want["active"])
    assert np.abs(got["pos"] - want["pos"]).max() < (1e-13 if f64 else 1e-6)
    assert scaled_err(got["vel"], want["vel"]) < (1e-12 if f64 else 1e-4)
    np.testing.assert_allclose(got["density"], want["density"], rtol=1e-12 if f64 else 1e-5)


# ---------------------------------------------------------------- rebin


def _drifted(scene_id: str, amp: float, seed: int):
    """The binned scene with every moving particle nudged by up to ``amp``
    skins on each axis and given a velocity, a density on every particle,
    and ``travel`` past the check threshold."""
    scene = _scene(scene_id)
    b, g = scene.binned_state(), scene.bgrid
    rng = np.random.default_rng(seed)
    dt = np.asarray(b.pos).dtype
    valid = np.asarray(b.valid)
    move = (valid & ~np.asarray(jnb.frozen_mask(g, b)))[:, None]
    shape = b.pos.shape
    pos = np.asarray(b.pos) + (rng.uniform(-amp, amp, shape) * g.skin * move).astype(dt)
    vel = (rng.normal(size=shape) * move).astype(dt)
    rho = (1000.0 * rng.uniform(0.95, 1.05, valid.shape) * valid).astype(dt)
    return scene, jreplace(
        b, pos=jnp.asarray(pos), vel=jnp.asarray(vel), density=jnp.asarray(rho),
        travel=jnp.asarray(g.skin, dt),
    )


@pytest.mark.parametrize("scene_id,f64", [("2d_f64_walls", True), ("3d_f32_walls", False)])
@pytest.mark.parametrize("light,carry", [(False, False), (True, False), (False, True), (True, True)])
def test_rebin_payload_rules_match_reference(scene_id, f64, light, carry):
    """All 13 fields of a light / density-carrying rebin, bit for bit."""
    with jax.enable_x64(f64):
        scene, jb0 = _drifted(scene_id, 0.6, 1)
        want = jnb.rebin(scene.bgrid, jb0, light=light, carry_density=carry)
        _, grid, tb0 = port_inputs(scene, jb0)
        got = tnb.rebin(grid, tb0, light=light, carry_density=carry)
        want = jax_fields(want)
    for k, v in convert.to_numpy(got).items():
        assert np.array_equal(v, want[k]), k
    dens = convert.to_numpy(got)["density"]
    assert (np.abs(dens).max() > 0) == carry
    assert (np.abs(convert.to_numpy(got)["vel"]).max() > 0) == (not light)


@pytest.mark.parametrize("amp,fires", [(0.6, True), (0.2, False)], ids=["fires", "tightens"])
@pytest.mark.parametrize("light,carry", [(True, False), (False, True)], ids=["gather", "ride"])
def test_maybe_rebin_matches_reference(amp, fires, light, carry):
    with jax.enable_x64(True):
        scene, jb0 = _drifted("2d_f64_walls", amp, 2)
        want = jw.maybe_rebin(scene.bgrid, jb0, light=light, carry_density=carry)
        _, grid, tb0 = port_inputs(scene, jb0)
        got = tw.maybe_rebin(grid, tb0, light=light, carry_density=carry)
        want = jax_fields(want)
    assert int(got.n_rebins) == int(tb0.n_rebins) + fires
    for k, v in convert.to_numpy(got).items():
        assert np.array_equal(v, want[k]), k


# ---------------------------------------------------------------- folds


def test_folds_match_reference():
    check_folds("2d_f64")


def check_folds(scene_id: str):
    """The five folds on valid slots: float64 to 1e-12, float32 to 1e-5
    (scale-normalised; density relative). Inputs that feed a fold from
    another (lambda, rho, omega) are the reference's, so each fold is held
    on its own."""
    f64 = SCENES[scene_id][2]
    tol = 1e-12 if f64 else 1e-5
    rng = np.random.default_rng(5)
    with jax.enable_x64(f64):
        scene, jst = _advanced(scene_id)
        jpp = _jax_pbf(CONFIGS["vorticity"], f64)
        params, grid, tst = port_inputs(scene, jst)
        tpp = _port_pbf(jpp)
        jg = scene.bgrid
        v = np.asarray(jst.valid)
        dtype = np.asarray(jst.pos).dtype
        m_rho = np.asarray(jst.mass) / 1000.0 * rng.uniform(0.9, 1.1, v.shape).astype(dtype)
        jf = {**jw._planar("p", jst.pos), "mass": jst.mass}
        tf = {**tnb._planar("p", tst.pos), "mass": tst.mass}

        def close(got, want, rel=False):
            got, want = got.numpy()[v], np.asarray(want)[v]
            err = (np.abs(got - want) / np.abs(want)).max() if rel else scaled_err(got, want)
            assert err < tol, err

        jlam, jrho = jp._lambda_fold(scene.params, jpp, jg, jf)
        tlam, trho = tp._lambda_fold(params, tpp, grid, tf)
        close(trho, jrho, rel=True)
        close(tlam, jlam)

        lam = torch.tensor(np.asarray(jlam))
        close(tp._dx_fold(params, tpp, grid, {**tf, "lam": lam}),
              jp._dx_fold(scene.params, jpp, jg, {**jf, "lam": jlam}))

        jr, jdv = jp._density_xsph_fold(scene.params, jg, jst.pos, jst.vel, jst.mass,
                                        jnp.asarray(m_rho))
        tr, tdv = tp._density_xsph_fold(params, grid, tst.pos, tst.vel, tst.mass,
                                        torch.tensor(m_rho))
        close(tr, jr, rel=True)
        close(tdv, jdv)

        rho = jnp.maximum(jrho, 1e-6 * scene.params.rest_density)
        jom = jp._vorticity_fold(scene.params, jg, jst.pos, jst.vel, jst.mass, rho)
        trho_in = torch.tensor(np.asarray(rho))
        close(tp._vorticity_fold(params, grid, tst.pos, tst.vel, tst.mass, trho_in), jom)
        close(tp._vorticity_force(params, grid, tst.pos, tst.mass, trho_in,
                                  torch.tensor(np.asarray(jom))),
              jp._vorticity_force(scene.params, jg, jst.pos, jst.mass, rho, jom))


def test_integer_pow_is_repeated_squaring():
    x = torch.tensor([0.3, 1.7, 2.0], dtype=torch.float64)
    for n in (1, 2, 3, 4, 5, 8):
        assert torch.allclose(tp._integer_pow(x, n), x**n, rtol=1e-15)
    x4 = x * x
    assert torch.equal(tp._integer_pow(x, 4), x4 * x4)


# ---------------------------------------------------------------- step


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("scene_id", ["2d_f64", "2d_f64_walls"])
def test_one_step_matches_reference(scene_id, config):
    check_one_step(scene_id, config)


def check_one_step(scene_id: str, config: str):
    """One step from a state the reference advanced 10 steps."""
    f64 = SCENES[scene_id][2]
    with jax.enable_x64(f64):
        scene, jb0 = _advanced(scene_id)
        jpp = _jax_pbf(CONFIGS[config], f64)
        jb1 = jp.step(scene.params, scene.bgrid, jpp, jb0)
        params, grid, tb0 = port_inputs(scene, jb0)
        got = tp.step(params, grid, _port_pbf(jpp), tb0)
        want, got_u = _unbinned(scene, jb1, got)
    assert int(got.n_rebins) == int(jb1.n_rebins)
    assert int(got.overflow) == int(jb1.overflow) == 0
    _assert_states_match(want, got_u, f64)


@pytest.mark.parametrize("epilogue", ["ride", "gather"])
def test_steps_with_mid_step_rebins_match_reference(epilogue):
    """A skin of 0.05 h makes the checks between folds rebin: 3 steps with
    more rebins than steps (so some fire mid-step), against the reference.
    A gather step that read the density after a rebin, or a ride rebin that
    dropped it, would miss here."""
    with jax.enable_x64(True):
        scene = jb.dam_break_2d(300, dtype=jnp.float64, skin_frac=0.05)
        jpp = jp.flagship_params(epilogue=epilogue, dtype=jnp.float64)
        jb0 = scene.binned_state()
        for _ in range(5):
            jb0 = jp.step(scene.params, scene.bgrid, jpp, jb0)
        params, grid, tb0 = port_inputs(scene, jb0)
        tpp, jb1, tb1 = _port_pbf(jpp), jb0, tb0
        for _ in range(3):
            jb1 = jp.step(scene.params, scene.bgrid, jpp, jb1)
            tb1 = tp.step(params, grid, tpp, tb1)
        want, got = _unbinned(scene, jb1, tb1)
    fired = int(tb1.n_rebins) - int(tb0.n_rebins)
    assert fired > 3 and int(tb1.n_rebins) == int(jb1.n_rebins)
    _assert_states_match(want, got, True)


def test_40_steps_f64_match_reference_and_oracle():
    """2D dam break, 300 particles, float64, iters 3, 40 steps: against
    the reference (|dpos| < 1e-9, same rebins) and PbfOracle (< 1e-6, the
    bound of tests/test_pbf.py)."""
    steps = 40
    with jax.enable_x64(True):
        scene = jb.dam_break_2d(n_target=300, dtype=jnp.float64)
        g = scene.bgrid
        jpp = jp.make_pbf_params(iters=3, dtype=jnp.float64)
        jb40 = jp.simulate(scene.params, g, jpp, scene.binned_state(), steps)
        want = np.asarray(jnb.unbin(g, jb40, scene.state.capacity).pos)
        act = np.asarray(scene.state.active)
        oracle = PbfOracle(
            scene.params, jpp,
            np.asarray(scene.state.pos)[act], np.asarray(scene.state.vel)[act],
            np.asarray(scene.state.mass)[act],
            proj_cap=min(float(jpp.proj_cap_h) * float(scene.params.h), 0.5 * g.skin),
        ).run(steps)
    ts = tb.dam_break_2d(n_target=300, dtype=torch.float64, device="cpu")
    tpp = tp.make_pbf_params(iters=3, dtype=torch.float64, device="cpu")
    b = tp.simulate(ts.params, ts.bgrid, tpp, ts.binned_state(), steps)
    assert int(b.overflow) == 0 and int(b.n_rebins) == int(jb40.n_rebins) > 0
    st = tnb.unbin(ts.bgrid, b, ts.state.capacity)
    got = st.pos.numpy()[st.active.numpy()]
    assert np.abs(got - want).max() < 1e-9
    assert np.abs(got - oracle).max() < 1e-6


def _roll(pp, steps, n=400):
    s = tb.dam_break_2d(n_target=n, device="cpu")
    b = tp.simulate(s.params, s.bgrid, pp, s.binned_state(), steps)
    return s, b, tnb.unbin(s.bgrid, b, s.state.capacity)


def test_epilogue_ride_matches_gather():
    """Same physics, other data movement: 60 steps with rebins, atol 1e-6
    (the bar of tests/test_pbf.py)."""
    outs = {}
    for mode in ("gather", "ride"):
        _, b, st = _roll(tp.flagship_params(epilogue=mode, device="cpu"), 60)
        assert int(b.overflow) == 0 and int(b.n_rebins) > 0
        act = st.active
        outs[mode] = (st.pos[act], st.vel[act], st.density[act])
    for a, b_ in zip(outs["gather"], outs["ride"]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=1e-6)


def test_flagship_quality_guard():
    """The default-tier bars of tests/test_pbf.py on the port: 350 steps of
    dam_break_2d(300) under flagship_params: spread > 1.2h, vmax < 9,
    rho_q90 < 1.10 rho0."""
    s = tb.dam_break_2d(n_target=300, device="cpu")
    x0 = s.state.pos[s.state.active][:, 0].max().item()
    b = tp.simulate(s.params, s.bgrid, tp.flagship_params(device="cpu"), s.binned_state(), 350)
    assert int(b.overflow) == 0
    st = tnb.unbin(s.bgrid, b, s.state.capacity)
    act = st.active
    pos = st.pos[act]
    h = float(s.params.h)
    assert torch.isfinite(pos).all()
    spread = (pos[:, 0].max().item() - x0) / h
    assert spread > 1.2, spread
    vmax = st.vel[act].abs().max().item()
    assert vmax < 9.0, vmax
    q90 = torch.quantile(st.density[act].double(), 0.9).item()
    assert q90 < 1.10 * float(s.params.rest_density), q90


@pytest.mark.parametrize("iters", [2, 3])
def test_step_checks_rebin_before_every_fold(monkeypatch, iters):
    calls = []

    def counting(grid, b, light=False, carry_density=False):
        calls.append((light, carry_density))
        return tw.maybe_rebin(grid, b, light, carry_density)

    monkeypatch.setattr(tp, "maybe_rebin", counting)
    s = tb.dam_break_2d(200, device="cpu")
    for epilogue in ("ride", "gather"):
        calls.clear()
        pp = tp.flagship_params(iters=iters, epilogue=epilogue, device="cpu")
        tp.step(s.params, s.bgrid, pp, s.binned_state())
        ride = epilogue == "ride"
        assert calls == [(False, ride)] + [(not ride, ride)] * (iters + 1)


def test_unported_features_raise():
    """Periodic grids and obstacles are ported: a step with an empty
    obstacle set is the step without one, and a grid marked periodic along
    x, whose edge planes the 2-cell margin keeps empty (no images, no wall
    contact yet), steps exactly as the walled grid but for the positions
    of its empty ghost slots, which hold the +-L images of empty slots as
    in the reference. The periodic physics is held in
    ``tests/test_torch_periodic.py``."""
    from sph_pie_torch.scenes import obstacles

    s = tb.dam_break_2d(200, device="cpu")
    b, pp = s.binned_state(), tp.flagship_params(device="cpu")
    with_empty = tp.step(s.params, s.bgrid, pp, b, obstacles=obstacles.empty(2, device="cpu"))
    plain = tp.step(s.params, s.bgrid, pp, b)
    assert all(torch.equal(getattr(with_empty, k), getattr(plain, k)) for k in vars(plain))
    periodic = dataclasses.replace(s.bgrid, periodic=(False, True))
    got = tp.step(s.params, periodic, pp, b)
    v = plain.valid[:, None]
    for k in vars(plain):
        a, want = getattr(got, k), getattr(plain, k)
        if k in ("pos", "bin_pos"):
            a, want = torch.where(v, a, 0.0), torch.where(v, want, 0.0)
        assert torch.equal(a, want), k
    with pytest.raises(ValueError, match="epilogue"):
        tp.make_pbf_params(epilogue="stash", device="cpu")


def test_convert_pbf_params_round_trip():
    jpp = jp.make_pbf_params(iters=3, vort_eps=2.0, s_corr_n=3)
    tpp = _port_pbf(jpp)
    assert (tpp.iters, tpp.epilogue, tpp.use_vorticity, tpp.s_corr_n) == (3, "gather", True, 3)
    for k in tp.ARRAY_FIELDS:
        assert getattr(tpp, k).dtype == torch.float32
        assert getattr(tpp, k).item() == pytest.approx(float(getattr(jpp, k)), rel=1e-7)
