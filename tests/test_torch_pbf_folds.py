"""The PBF folds' launchers (``neighbors/pbf_folds.py``) on the CPU.

Each fold against the reference's fold on the same inputs made from a
numpy seed (a binned dam break whose moving particles are nudged, with
random velocities, lambdas, XSPH weights and vorticities): float64 to
1e-12, float32 to 1e-5, scale-normalised (densities relative), as
``test_torch_pbf.check_folds`` holds them. Then ``home=`` on a buffer cut
from the grid against the whole grid's rows, the routing of every fold
of a step through ``fold``, the sharded PBF on an in-process
mesh against one device bit for bit, and the launchers' reading nothing
back to the host. The kernels themselves run on the card
(``chip_smoke.py`` Phase A and D)."""

import ast
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields, port_inputs, scaled_err
from sph_pie_torch import _native, convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.neighbors import pbf_folds as pf
from sph_pie_torch.parallel import comm, sharding
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.solvers import pbf as tp
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.solvers import pbf as jp
from sph_pie_tpu.solvers import wcsph_binned as jw

SCENES = {
    "2d_f64": ("dam_break_2d", 300, True),
    "3d_f32": ("dam_break_3d", 1500, False),
}
OPS = ("lambda", "dx", "density_xsph", "vorticity", "vorticity_eta")


@functools.cache
def _inputs(scene_id: str):
    """(reference scene, its binned state with seeded inputs, extras): the
    moving particles nudged by up to 0.3 skin, random velocities, and
    lambdas, XSPH weights and vorticities per slot, as numpy arrays."""
    make, n, f64 = SCENES[scene_id]
    with jax.enable_x64(f64):
        scene = getattr(jb, make)(n, dtype=jnp.float64 if f64 else jnp.float32)
        b, g = scene.binned_state(), scene.bgrid
        rng = np.random.default_rng(11)
        dt = np.asarray(b.pos).dtype
        valid = np.asarray(b.valid)
        move = (valid & ~np.asarray(jnb.frozen_mask(g, b)))[:, None]
        shape = b.pos.shape
        pos = np.asarray(b.pos) + (rng.uniform(-0.3, 0.3, shape) * g.skin * move).astype(dt)
        extras = {
            "vel": (rng.normal(size=shape) * valid[:, None]).astype(dt),
            "lam": (rng.uniform(-1e-3, 1e-3, valid.shape) * valid).astype(dt),
            "m_rho": (np.asarray(b.mass) / 1000.0 * rng.uniform(0.9, 1.1, valid.shape)).astype(dt),
            "rho": (1000.0 * rng.uniform(0.9, 1.1, valid.shape) * valid).astype(dt),
            "omega": (rng.normal(size=(valid.shape[0], 3 if g.dim == 3 else 1))
                      * valid[:, None]).astype(dt),
        }
        b = dataclasses.replace(b, pos=jnp.asarray(pos), vel=jnp.asarray(extras["vel"]))
    return scene, b, extras


def _port(scene, b):
    with jax.enable_x64(b.pos.dtype == jnp.float64):
        params, grid, tst = port_inputs(scene, b)
        jpp = jp.make_pbf_params(iters=2, vort_eps=5.0, dtype=b.pos.dtype)
    return params, grid, tst, convert.pbf_params(jax_fields(jpp), device="cpu")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("scene_id", list(SCENES))
def test_fold_matches_reference(scene_id, op):
    """``pbf_folds.<op>_fold`` on the CPU against the reference's fold on the
    valid slots (the vorticity's eta through the force it steers)."""
    f64 = SCENES[scene_id][2]
    tol = 1e-12 if f64 else 1e-5
    scene, jst, ex = _inputs(scene_id)
    with jax.enable_x64(f64):
        jpp = jp.make_pbf_params(iters=2, vort_eps=5.0, dtype=jst.pos.dtype)
        jg, jpar = scene.bgrid, scene.params
        params, grid, tst, tpp = _port(scene, jst)
        t = {k: torch.tensor(v) for k, v in ex.items()}
        jf = {**jw._planar("p", jst.pos), "mass": jst.mass}
        floor = 1e-6 * float(params.rest_density)
        if op == "lambda":
            want = jp._lambda_fold(jpar, jpp, jg, jf)
            got = pf.lambda_fold(params, tpp, grid, tst.pos, tst.mass)
        elif op == "dx":
            want = (jp._dx_fold(jpar, jpp, jg, {**jf, "lam": jnp.asarray(ex["lam"])}),)
            got = (pf.dx_fold(params, tpp, grid, tst.pos, tst.mass, t["lam"]),)
        elif op == "density_xsph":
            want = jp._density_xsph_fold(jpar, jg, jst.pos, jst.vel, jst.mass,
                                         jnp.asarray(ex["m_rho"]))
            got = pf.density_xsph_fold(params, grid, tst.pos, tst.vel, tst.mass, t["m_rho"])
        elif op == "vorticity":
            want = (jp._vorticity_fold(jpar, jg, jst.pos, jst.vel, jst.mass,
                                       jnp.asarray(ex["rho"] + floor)),)
            m_rho = tst.mass / torch.maximum(t["rho"] + floor, 1e-6 * params.rest_density)
            got = (pf.vorticity_fold(params, grid, tst.pos, tst.vel, tst.mass, m_rho),)
        else:
            rho = jnp.asarray(ex["rho"] + floor)
            want = (jp._vorticity_force(jpar, jg, jst.pos, jst.mass, rho,
                                        jnp.asarray(ex["omega"])),)
            seen = []

            def recording(fn, *args, **fields):
                seen.append(fn)
                return pf.whole_grid(fn, *args, **fields)

            got = (tp._vorticity_force(params, grid, tst.pos, tst.mass, t["rho"] + floor,
                                       t["omega"], fold=recording),)
            assert seen == [pf.vorticity_eta_fold]
    v = np.asarray(jst.valid)
    for k, (g_, w_) in enumerate(zip(got, want)):
        g_, w_ = g_.numpy()[v], np.asarray(w_)[v]
        density = (op, k) in (("lambda", 1), ("density_xsph", 0))
        err = (np.abs(g_ - w_) / np.abs(w_)).max() if density else scaled_err(g_, w_)
        assert err < tol, (k, err)


def _fold_args(scene_id: str):
    """{op: (fold, arguments)} on the port's copy of the seeded inputs."""
    scene, jst, ex = _inputs(scene_id)
    params, grid, tst, tpp = _port(scene, jst)
    t = {k: torch.tensor(v) for k, v in ex.items()}
    m_rho = tst.mass / (t["rho"] + 1.0)
    wmag = t["omega"].square().sum(-1).sqrt()
    return grid, tst, {
        "lambda": (pf.lambda_fold, (params, tpp, grid, tst.pos, tst.mass)),
        "dx": (pf.dx_fold, (params, tpp, grid, tst.pos, tst.mass, t["lam"])),
        "density_xsph": (pf.density_xsph_fold,
                         (params, grid, tst.pos, tst.vel, tst.mass, t["m_rho"])),
        "vorticity": (pf.vorticity_fold, (params, grid, tst.pos, tst.vel, tst.mass, m_rho)),
        "vorticity_eta": (pf.vorticity_eta_fold, (params, grid, tst.pos, tst.mass, m_rho * wmag)),
    }


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("scene_id", list(SCENES))
def test_home_range_equals_whole_grid(scene_id, op):
    """``home=(first, count)`` on a buffer of the home cells with a halo's
    margin each side, cut from the grid: the whole grid's rows of those
    cells on every valid slot, bit for bit; a range outside the buffer
    raises."""
    grid, tst, calls = _fold_args(scene_id)
    fn, args = calls[op]
    C, cap, S, hc = grid.num_cells, grid.cap, grid.num_slots, tnb.halo_cells(grid)
    first, count = C // 3, C // 4
    lo, hi = first - hc, first + count + hc
    cut = tuple(a[lo * cap:hi * cap].clone() if isinstance(a, torch.Tensor)
                and a.shape[:1] == (S,) else a for a in args)
    whole = _as_tuple(fn(*args))
    part = _as_tuple(fn(*cut, home=(first - lo, count)))
    rows = slice(first * cap, (first + count) * cap)
    v = tst.valid[rows]
    assert v.any()
    for p_, w_ in zip(part, whole):
        assert p_.shape[0] == count * cap
        assert torch.equal(p_[v], w_[rows][v])
    with pytest.raises(ValueError, match="do not lie in a buffer"):
        fn(*cut, home=(hi - lo - count + 1, count))


@pytest.mark.parametrize("config,order", [
    ("flagship", ["lambda", "dx", "lambda", "dx", "density_xsph"]),
    ("vorticity", ["lambda", "dx", "lambda", "dx", "vorticity", "vorticity_eta",
                   "density_xsph"]),
    ("no_xsph", ["lambda", "dx", "lambda", "dx"]),
])
def test_step_routes_every_fold(config, order):
    """Every pair fold of a step is one call of ``fold`` naming a
    ``pbf_folds`` function, with whole-grid fields."""
    s = tb.dam_break_2d(200, device="cpu", xsph_eps=0.0 if config == "no_xsph" else 0.05)
    pp = (tp.make_pbf_params(iters=2, vort_eps=5.0, device="cpu") if config == "vorticity"
          else tp.flagship_params(device="cpu"))
    seen = []

    def recording(fn, *args, **fields):
        seen.append(fn.__name__.removesuffix("_fold"))
        assert all(x.shape[0] == s.bgrid.num_slots for x in fields.values())
        return pf.whole_grid(fn, *args, **fields)

    got = tp.step(s.params, s.bgrid, pp, s.binned_state(), fold=recording)
    want = tp.step(s.params, s.bgrid, pp, s.binned_state())
    assert seen == order
    assert all(torch.equal(getattr(got, k), getattr(want, k)) for k in vars(want))


@pytest.mark.parametrize("scene_id,config", [
    ("2d", "flagship"), ("2d", "vorticity"), ("3d", "gather"),
])
def test_sharded_pbf_equals_one_device(scene_id, config):
    """``sharded_pbf_simulate`` on 4 in-process CPU shards (each fold on
    each shard's home range, after an exchange) gives the single device's
    state bit for bit, in every field."""
    s = (tb.dam_break_2d(1024, device="cpu") if scene_id == "2d"
         else tb.dam_break_3d(2000, device="cpu"))
    pp = {
        "flagship": lambda: tp.flagship_params(device="cpu"),
        "vorticity": lambda: tp.make_pbf_params(iters=2, vort_eps=5.0, device="cpu"),
        "gather": lambda: tp.flagship_params(epilogue="gather", device="cpu"),
    }[config]()
    roll = sharding.sharded_pbf_simulate(comm.make_mesh(4, device="cpu"), s.params, s.bgrid, pp)
    got = roll(s.binned_state(), 2)
    want = tp.simulate(s.params, s.bgrid, pp, s.binned_state(), 2)
    assert [k for k in vars(want) if not torch.equal(getattr(got, k), getattr(want, k))] == []


def test_launchers_read_nothing_back():
    """The kernel path of every fold (the launchers and what they call in
    this module) calls no ``.item()``, ``.tolist()``, ``nonzero``,
    ``.cpu()`` or ``.numpy()``, and no ``bool`` / ``int`` / ``float``."""
    banned_attrs = {"item", "tolist", "nonzero", "cpu", "numpy"}
    banned_names = {"bool", "int", "float"}
    for fn in (*pf.FOLDS, pf._launch, pf._walk, pf._checked, pf.words_per_slot, pf._prm,
               _native.on_card, pf._dx_constants):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            assert not (isinstance(f, ast.Attribute) and f.attr in banned_attrs), (fn, f.attr)
            assert not (isinstance(f, ast.Name) and f.id in banned_names), (fn, f.id)
