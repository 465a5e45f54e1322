"""Port vs reference: the spatial decompositions of ``parallel/``.

The fold with halos against the reference's ``slab_fold(halo=,
local_cells=)`` on the same halos; the port's halo and sharded steps (an
in-process mesh of 8 shards, as the reference's 8 virtual devices) against
the reference's on scenes without frozen walls, a moving obstacle among
them, and against the reference's single-device step on every scene, a
frozen-wall scene included, where the reference's halo step moves the
frozen particles, and against the port's own single-device step bit for
bit; a 100-step roll through a rebin; the guards; sharded PBF;
the dry run; and a gloo process group of 4 ranks against the in-process
mesh, bit for bit. Bars are the reference tests' own
(``tests/test_halo.py``, ``tests/test_sharding.py``): positions 1e-6 over
10 steps, density rtol 1e-5, PBF 1e-6 in owner order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_gloo
from _torch_parity import jax_fields
from sph_pie_torch import convert
from sph_pie_torch.neighbors import binned as tnb
from sph_pie_torch.parallel import comm, dryrun, halo, sharding
from sph_pie_torch.solvers import pbf as tp
from sph_pie_torch.solvers import wcsph_binned as tw
from sph_pie_tpu.kernels import smoothing as jsm
from sph_pie_tpu.neighbors import binned as jnb
from sph_pie_tpu.parallel import halo as jhalo
from sph_pie_tpu.parallel import sharding as jsh
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.scenes import obstacles as jobs
from sph_pie_tpu.solvers import pbf as jp
from sph_pie_tpu.solvers import wcsph_binned as jw

N_DEV = 8
STEPS = 10
POS_ATOL = 1e-6      # positions after 10 steps (tests/test_halo.py)
DENSITY_RTOL = 1e-5  # density (tests/test_halo.py)
PBF_ATOL = 1e-6      # 2 PBF steps in owner order (the reference's dry run)


def _padded(ref_scene):
    """The scene with its leading axis padded so the cells divide by 8
    (``tests/test_halo.py``'s ``_scene8``)."""
    g = ref_scene.bgrid
    return dataclasses.replace(ref_scene, bgrid=dryrun.padded_grid(g, N_DEV))


SCENES = {
    "dam_break": lambda: _padded(jb.dam_break_2d(n_target=1024, viscosity=0.05)),
    "frozen_walls": lambda: _padded(jb.dam_break_2d(n_target=400, wall_layers=2)),
}
OBSTACLE = dict(spheres=[([0.3, 0.2], 0.07)],
                sphere_motions=[([0.0, 0.0], [0.05, 0.0], 10.0, 0.0)])


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(N_DEV)


@pytest.fixture(scope="module")
def mesh():
    return comm.make_mesh(N_DEV, device="cpu")


@pytest.fixture(scope="module")
def runs(jmesh, mesh):
    """{(scene, obstacle?): {run name: final BinnedState fields}}: the
    reference's single-device, halo and (without walls) sharded steps, and
    the port's single-device, halo and sharded steps, 10 steps each from the
    same state."""
    out = {}
    for name, make in SCENES.items():
        for with_obs in ((False, True) if name == "dam_break" else (False,)):
            ref = make()
            g, params = ref.bgrid, ref.params
            obs = jobs.make(2, **OBSTACLE) if with_obs else None
            b0 = ref.binned_state()
            got = {}
            b = b0
            for _ in range(STEPS):
                b = jw.step(params, g, b, obs)
            got["jax single"] = jax_fields(b)
            hstep = jax.jit(jhalo.make_halo_step(jmesh, params, g, obstacles=obs)[0])
            b = jsh.shard_binned(jmesh, g, b0)
            for _ in range(STEPS):
                b = hstep(b)
            got["jax halo"] = jax_fields(b)
            if name == "dam_break" and not with_obs:
                sstep = jsh.sharded_step(jmesh, params, g)
                b = jsh.shard_binned(jmesh, g, b0)
                for _ in range(STEPS):
                    b = sstep(b)
                got["jax sharded"] = jax_fields(b)

            scene = convert.scene(ref, device="cpu")
            tobs = None if obs is None else convert.obstacles(jax_fields(obs), device="cpu")
            b = scene.binned_state()
            for _ in range(STEPS):
                b = tw.step(scene.params, scene.bgrid, b, tobs)
            got["port single"] = convert.to_numpy(b)
            for kind, step in (
                ("port halo", halo.make_halo_step(mesh, scene.params, scene.bgrid, tobs)[0]),
                ("port sharded", sharding.sharded_step(mesh, scene.params, scene.bgrid, tobs)),
            ):
                st = sharding.shard_binned(mesh, scene.bgrid, scene.binned_state())
                for _ in range(STEPS):
                    st = step(st)
                got[kind] = convert.to_numpy(sharding.gather_binned(mesh, scene.bgrid, st))
            out[(name, with_obs)] = got
    return out


def _close(got, want):
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=POS_ATOL)
    v = want["valid"]
    np.testing.assert_allclose(got["density"][v], want["density"][v], rtol=DENSITY_RTOL)


CASES = [("dam_break", False, k) for k in ("jax halo", "jax sharded", "jax single")] + [
    ("dam_break", True, "jax halo"), ("dam_break", True, "jax single"),
    ("frozen_walls", False, "jax single"),
]


@pytest.mark.parametrize("port", ["port halo", "port sharded"])
@pytest.mark.parametrize("scene,obstacle,ref", CASES)
def test_steps_match_the_reference(runs, scene, obstacle, ref, port):
    """The port's halo and sharded steps against the reference's halo,
    sharded and single-device steps, 10 steps (a moving obstacle threads
    ``sim_time``; frozen walls held still)."""
    got = runs[(scene, obstacle)]
    _close(got[port], got[ref])
    assert got[port]["sim_time"] == pytest.approx(float(got[ref]["sim_time"]))


@pytest.mark.parametrize("port", ["port halo", "port sharded"])
@pytest.mark.parametrize("scene,obstacle", [("dam_break", False), ("dam_break", True),
                                            ("frozen_walls", False)])
def test_steps_equal_the_ports_single_device_step(runs, scene, obstacle, port):
    """The port's halo and sharded steps run the single-device step's own
    pair sums and update (``integrate.update``) on each shard, so after 10
    steps they equal ``wcsph_binned.step`` bit for bit."""
    got = runs[(scene, obstacle)]
    for k in ("pos", "vel", "density", "pressure", "travel", "sim_time"):
        assert torch.equal(torch.as_tensor(got[port][k]), torch.as_tensor(got["port single"][k])), k


def test_reference_halo_step_moves_frozen_particles(runs):
    """The reference's halo step masks its update with ``valid`` alone
    (``parallel/halo.py:141-146``), so the frozen boundary particles move,
    where its single-device step holds them (``valid & ~frozen_mask``); the
    port's halo step holds them."""
    got = runs[("frozen_walls", False)]
    ref = SCENES["frozen_walls"]()
    g = ref.bgrid
    frozen = got["jax single"]["owner"] >= g.max_particles - g.n_boundary
    b0 = jax_fields(ref.binned_state())
    assert frozen.any() and np.array_equal(b0["pos"][frozen], got["jax single"]["pos"][frozen])
    moved = np.abs(got["jax halo"]["pos"][frozen] - b0["pos"][frozen]).max()
    assert moved > 1e-4
    assert np.array_equal(got["port halo"]["pos"][frozen], b0["pos"][frozen])


def _jpair(dim, h):
    def pair(carry, home, w):
        d2 = sum((home[f"p{k}"][:, :, None] - w[f"p{k}"][:, None, :]) ** 2 for k in range(dim))
        return (carry[0] + (w["mass"][:, None, :] * jsm.poly6(dim, h, d2)).sum(2),)

    return pair


def _tpair(dim, h):
    from sph_pie_torch.kernels import smoothing

    def pair(carry, home, w):
        _, r2 = tnb._r2(dim, home, w)
        return (carry[0] + (w["mass"][:, None, :] * smoothing.poly6(dim, h, r2)).sum(2),)

    return pair


@pytest.mark.parametrize("case", ["equal", "short", "whole"])
def test_slab_fold_with_halos_matches_reference(case):
    """``slab_fold(halo=, local_cells=)`` on the same fields and halos as
    the reference's: a shard of the equal split, a shard whose home cells
    end before its room (the hi halo right after them), and the whole grid;
    the occupied slots agree with the reference's fold and with the
    whole-grid fold (the port gives the slots of empty cells 0)."""
    ref = jb.dam_break_2d(n_target=1024, viscosity=0.05)
    g, h = ref.bgrid, float(ref.params.h)
    b = {k: np.array(v) for k, v in jax_fields(ref.binned_state()).items()}
    cap, C, hc = g.cap, g.num_cells, jnb.halo_cells(g)
    fields = {"p0": b["pos"][:, 0], "p1": b["pos"][:, 1], "mass": b["mass"]}
    first, count = {"equal": (2 * C // 8, C // 8), "short": (300, 50), "whole": (0, C)}[case]
    lo_c, hi_c = first, first + count

    def rows(x, a, e):  # cells [a, e) of a global field, zeros past the grid
        out = np.zeros((max(e - a, 0) * cap,) + x.shape[1:], x.dtype)
        s, t = max(a, 0), min(e, C)
        out[(s - a) * cap : (t - a) * cap] = x[s * cap : t * cap]
        return out

    local = {k: rows(v, lo_c, hi_c) for k, v in fields.items()}
    lo = {k: rows(v, lo_c - hc, lo_c) for k, v in fields.items()}
    hi = {k: rows(v, hi_c, hi_c + hc) for k, v in fields.items()}
    (want,) = jnb.slab_fold(
        g, {k: jnp.asarray(v) for k, v in local.items()}, _jpair(2, h),
        (jnp.zeros(count * cap, jnp.float32),),
        halo=({k: jnp.asarray(v) for k, v in lo.items()},
              {k: jnp.asarray(v) for k, v in hi.items()}),
        local_cells=count,
    )
    tg = convert.binned_grid(dataclasses.asdict(g))
    t = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in
         (("local", local), ("lo", lo), ("hi", hi))}
    (got,) = tnb.slab_fold(
        tg, t["local"], _tpair(2, h), (torch.zeros(count * cap),),
        halo=(t["lo"], t["hi"]), local_cells=count,
    )
    (whole,) = tnb.slab_fold(
        tg, {k: torch.from_numpy(v) for k, v in fields.items()}, _tpair(2, h),
        (torch.zeros(C * cap),),
    )
    occ = local["mass"] > 0
    assert occ.any()
    np.testing.assert_allclose(got.numpy()[occ], np.asarray(want)[occ], rtol=1e-6)
    assert np.array_equal(got.numpy(), whole.numpy()[lo_c * cap : hi_c * cap])
    empty_cells = ~occ.reshape(count, cap).any(1)
    assert empty_cells.any() and not got.numpy().reshape(count, cap)[empty_cells].any()


def test_sharded_simulate_through_a_rebin_keeps_every_particle(mesh):
    """100 sharded steps of a frozen-wall dam break, whose two-stage
    trigger rebins at the last step: overflow 0, every particle kept, and
    the single-device roll's state bit for bit."""
    from sph_pie_torch.scenes import builders

    scene = builders.dam_break_2d(1024, wall_layers=2, device="cpu")
    g = scene.bgrid
    st = sharding.shard_binned(mesh, g, scene.binned_state())
    st = sharding.sharded_simulate(mesh, scene.params, g)(st, 100)
    assert int(st.n_rebins) >= 1 and int(st.overflow) == 0
    got = sharding.gather_binned(mesh, g, st)
    ps = tnb.unbin(g, got, scene.state.capacity)
    assert int(ps.active.sum()) == int(scene.state.n_active())
    assert bool(torch.isfinite(ps.pos[ps.active]).all())
    want = tw.simulate(scene.params, g, scene.binned_state(), 100)
    assert all(torch.equal(getattr(got, k), getattr(want, k))
               for k in sharding.SLOT_FIELDS + ("slot_of", "travel", "n_rebins"))


def test_guards_raise(tmp_path):
    """The reference's guards: cells that do not divide by the mesh (halo),
    a shard thinner than its halo (equal split), a mesh size that is not
    the process group's, gloo with a CUDA device."""
    from sph_pie_torch.scenes import builders

    scene = builders.dam_break_2d(256, device="cpu")
    g = scene.bgrid
    assert g.num_cells % 7
    with pytest.raises(ValueError, match="divisible"):
        halo.make_halo_step(comm.make_mesh(7, device="cpu"), scene.params, g)
    many = comm.make_mesh(g.num_cells // tnb.halo_cells(g) + 1, device="cpu")
    with pytest.raises(ValueError, match="thinner"):
        sharding.shard_binned(many, g, scene.binned_state())
    g2 = dryrun.padded_grid(g, many.n)
    with pytest.raises(ValueError, match="thinner"):
        halo.make_halo_step(many, scene.params, g2)
    with pytest.raises(ValueError):
        comm.make_mesh(0, device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="process group has 1"):
            comm.make_mesh(2, device="cpu", group=dist.group.WORLD)
        with pytest.raises((ValueError, RuntimeError)):
            comm.make_mesh(device="cuda", group=dist.group.WORLD)
        assert comm.make_mesh(device="cpu", group=dist.group.WORLD).n == 1
    finally:
        dist.destroy_process_group()


def test_sharded_pbf_matches_reference_single_device(mesh):
    """PBF with its folds over 8 shards against the reference's
    single-device PBF, 2 flagship steps, owner order."""
    ref = jb.dam_break_2d(n_target=1024, viscosity=0.05)
    pp = jp.flagship_params()
    want = jp.simulate(ref.params, ref.bgrid, pp, ref.binned_state(), 2)
    want = jax_fields(jnb.unbin(ref.bgrid, want, ref.state.capacity))
    scene = convert.scene(ref, device="cpu")
    tpp = convert.pbf_params(jax_fields(pp), device="cpu")
    roll = sharding.sharded_pbf_simulate(mesh, scene.params, scene.bgrid, tpp)
    b = roll(scene.binned_state(), 2)
    got = convert.to_numpy(tnb.unbin(scene.bgrid, b, scene.state.capacity))
    act = want["active"]
    assert np.array_equal(got["active"], act)
    np.testing.assert_allclose(got["pos"][act], want["pos"][act], rtol=0, atol=PBF_ATOL)
    one = tp.simulate(scene.params, scene.bgrid, tpp, scene.binned_state(), 2)
    assert torch.equal(b.pos, one.pos)


def test_dryrun_on_the_cpu():
    """Every leg of the dry run on 8 in-process CPU shards, legs 4 and 7 cut
    to the 1M geometry and 20k particles."""
    out = dryrun.dryrun_multichip(N_DEV, device="cpu", n_shape=1_000_000, n_periodic=20_000)
    assert out["balanced"]["err"] < dryrun.BALANCED_TOL
    assert out["pbf"]["err"] < dryrun.PBF_TOL
    assert out["periodic"]["err"] < dryrun.BALANCED_TOL
    assert out["shape"]["slots"] == int(np.prod([d + 2 for d in out["shape"]["dims"]])) * 8


def test_gloo_group_matches_in_process_mesh(tmp_path):
    """4 gloo ranks, one shard each, 5 halo steps: the same bits as the
    in-process mesh of 4 shards."""
    world = 4
    mp.start_processes(
        _torch_gloo.worker,
        args=(world, str(tmp_path / "store"), str(tmp_path), "halo", 5, 1024),
        nprocs=world, start_method="spawn", join=True,
    )
    got = {}
    for r in range(world):
        got.update(torch.load(tmp_path / f"rank{r}.pt"))
    scene = _torch_gloo.padded_scene(1024, world, viscosity=0.05)
    want = _torch_gloo.run("halo", comm.make_mesh(world, device="cpu"), scene, 5)
    assert got.keys() == want.keys()
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


def test_wrappers_take_a_home_range():
    """``density`` / ``forces`` with ``home=(first, count)`` on a buffer
    ``[margin | home cells | margin]`` cut from the whole grid give the
    whole-grid results of those cells bit for bit (on the CPU: the fold with
    the buffer's margins as halos); a range outside the buffer raises."""
    from sph_pie_torch.kernels import eos
    from sph_pie_torch.neighbors import density as tden
    from sph_pie_torch.neighbors import forces as tfor
    from sph_pie_torch.scenes import builders

    scene = builders.dam_break_2d(1024, device="cpu")
    p, g = scene.params, scene.bgrid
    b = scene.binned_state()
    rho = tden.density(p, g, b)
    b = dataclasses.replace(b, density=rho, pressure=eos.tait_pressure(p, rho))
    acc, xsph = tfor.forces(p, g, b)
    cap, hc = g.cap, tnb.halo_cells(g)
    for first, count in ((0, hc), (hc + 3, 2 * hc), (g.num_cells - hc, hc)):
        lo, hi = max(first - hc, 0), min(first + count + hc, g.num_cells)
        rows = slice(lo * cap, hi * cap)
        home = slice(first * cap, (first + count) * cap)
        view = sharding.View(b.pos[rows], b.vel[rows], b.mass[rows], b.valid[home],
                             b.owner[home], b.travel, b.sim_time)
        per = tuple(x[rows] for x in tfor.per_slot(b.density, b.pressure, b.mass))
        r = tden.density(p, g, view, home=(first - lo, count))
        a, x = tfor.forces(p, g, view, home=(first - lo, count), hoisted=per)
        assert torch.equal(r, rho[home])
        assert torch.equal(a, acc[home]) and torch.equal(x, xsph[home])
    with pytest.raises(ValueError, match="do not lie"):
        tden.density(p, g, b, home=(g.num_cells - 1, 2))
    with pytest.raises(ValueError, match="whole-grid"):
        tden.density(p, g, view)
