"""The port's checkpoint, memory-budget and profiling utilities.

Checkpoints cross-load with the reference's ``sph_pie_tpu.utils.checkpoint``
in both directions, bit for bit (the same ``.npz`` keys); rotation and the
version guard as ``tests/test_checkpoint_config.py``; the budget against
the shape math of the grid it reckons; ``StepTimer`` and ``device_trace``
on the CPU.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_fields
from sph_pie_torch import convert
from sph_pie_torch.scenes import builders as tb
from sph_pie_torch.utils import checkpoint as tck
from sph_pie_torch.utils import membudget, profiling
from sph_pie_tpu.scenes import builders as jb
from sph_pie_tpu.utils import checkpoint as jck


def _ref_scene(f64: bool):
    return jb.dam_break_2d(n_target=300, dtype=jnp.float64 if f64 else jnp.float32)


def _assert_equal(port_obj, ref_obj):
    """Every field equal, values and dtypes (a float64 file keeps its
    dtype in both packages)."""
    got, want = convert.to_numpy(port_obj), jax_fields(ref_obj)
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert np.array_equal(np.asarray(got[k]), w), k
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == w.dtype, k
        else:
            assert type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_checkpoint_saved_by_the_port_loads_in_the_reference(tmp_path, f64):
    with jax.enable_x64(f64):
        scene = _ref_scene(f64)
        ts = convert.scene(scene, device="cpu")
        st = dataclasses.replace(ts.state, vel=torch.randn_like(ts.state.vel))
        path = tck.save_state(tmp_path / "c.npz", st, ts.params, step=17, extra={"k": 1})
        jst, jparams, step, extra = jck.load_state(path)
        assert (step, extra) == (17, {"k": 1})
        _assert_equal(st, jst)
        _assert_equal(ts.params, jparams)
    assert not list(tmp_path.glob(".*"))  # the temp file was renamed


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_checkpoint_saved_by_the_reference_loads_in_the_port(tmp_path, f64):
    with jax.enable_x64(f64):
        scene = _ref_scene(f64)
        path = jck.save_state(tmp_path / "c.npz", scene.state, scene.params, step=5)
        st, params, step, extra = tck.load_state(path, device="cpu")
        assert (step, extra) == (5, {})
        _assert_equal(st, scene.state)
        _assert_equal(params, scene.params)
        # without params, as the reference writes a bare state
        jck.save_state(tmp_path / "s.npz", scene.state, step=1)
        st2, params2, _, _ = tck.load_state(tmp_path / "s.npz", device="cpu")
        assert params2 is None
        _assert_equal(st2, scene.state)


def test_checkpoint_manager_rotation_and_stray_files(tmp_path):
    scene = tb.dam_break_2d(64, device="cpu")
    mgr = tck.CheckpointManager(tmp_path, keep=2)
    assert mgr.latest() is None and mgr.restore_latest(device="cpu") is None
    (tmp_path / "ckpt_notes.npz").write_bytes(b"")   # never breaks the rotation
    (tmp_path / ".ckpt_9.tmp.npz").write_bytes(b"")  # a crash's leftover
    for s in (10, 20, 30):
        mgr.save(scene.state, scene.params, step=s)
    names = sorted(p.name for p in tmp_path.glob("ckpt_*.npz"))
    assert names == ["ckpt_20.npz", "ckpt_30.npz", "ckpt_notes.npz"]
    st, params, step, _ = mgr.restore_latest(device="cpu")
    assert step == 30 and params.dim == 2
    assert torch.equal(st.pos, scene.state.pos)


def test_checkpoint_version_guard(tmp_path):
    scene = tb.dam_break_2d(64, device="cpu")
    p = tck.save_state(tmp_path / "c.npz", scene.state, step=1)
    with np.load(p) as z:
        data = dict(z)
    meta = json.loads(bytes(data["__meta__"]).decode())
    meta["version"] = tck.FORMAT_VERSION + 1
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError):
        tck.load_state(tmp_path / "bad.npz", device="cpu")
    with pytest.raises(ValueError):
        jck.load_state(tmp_path / "bad.npz")


def test_load_state_without_a_card_raises(tmp_path):
    """``load_state`` defaults to the card, with no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    scene = tb.dam_break_2d(64, device="cpu")
    p = tck.save_state(tmp_path / "c.npz", scene.state, step=1)
    with pytest.raises((AssertionError, RuntimeError)):
        tck.load_state(p)


@pytest.mark.parametrize("dim", [2, 3])
def test_budget_matches_shape_math(dim):
    """Each term from the grid's shapes (float32): the dense state, the
    compact rows, the rebin workspace with expand's output, no fold
    temporaries; the same slot count as the grid the engine builds."""
    scene = (tb.dam_break_2d(2000, device="cpu") if dim == 2
             else tb.dam_break_3d(20_000, device="cpu"))
    g, n = scene.bgrid, int(scene.state.n_active())
    b = membudget.budget(g, n)
    S, K, C, ncol = g.num_slots, g.max_particles, g.num_cells, 2 * dim + 2
    assert (b.num_slots, b.num_cells, b.slots_per_device) == (S, C, S)
    assert b.dense_state_bytes == S * ((3 * dim + 3) * 4 + 1 + 4)
    assert b.compact_bytes == K * (4 + (2 * dim + 1) * 4 + 1)
    assert b.sort_workspace_bytes == (K * (8 + 40 + 1 + 4 + 2 * ncol * 4) + C * 12
                                      + S * (ncol * 4 + 4))
    assert b.fold_temp_bytes == 0
    assert b.total_bytes == (2 * b.dense_state_bytes + b.compact_bytes
                             + b.sort_workspace_bytes)
    assert b.hbm_bytes == 80 << 30 and b.fits
    assert set(b.row()) == {"n", "devices", "slots_per_device", "dense_gb", "compact_gb",
                            "sort_gb", "fold_gb", "total_gb", "hbm_gb", "fits"}
    half = membudget.budget(g, n, n_devices=2)
    assert half.slots_per_device == -(-S // 2)


def test_dam_break_budget_is_the_built_grid():
    """The shape-only scene (meta tensors, no lattice) has the grid and the
    capacity of the built one, and the reference's slot count."""
    built = tb.dam_break_3d(30_000, device="cpu")
    shape_only = tb.dam_break_3d(30_000, build_state=False, device="meta")
    assert shape_only.bgrid == built.bgrid
    assert shape_only.state.capacity == built.state.capacity
    b = membudget.dam_break_budget(30_000)
    assert b.num_slots == built.bgrid.num_slots == jb.dam_break_3d(
        30_000, build_state=False).bgrid.num_slots
    big = membudget.dam_break_budget(16_000_000)
    assert big.fits  # 16M on one 80 GiB card, reckoned
    assert big.dense_state_bytes > big.compact_bytes


def test_step_timer_on_the_cpu():
    t = profiling.StepTimer(window=3)
    for _ in range(5):
        with t.time("phase") as out:
            out["result"] = torch.ones(1000).cumsum(0)
    with t.time("other", device="cpu"):
        pass
    s = t.stats()
    assert s["phase"]["count"] == 3 and s["other"]["count"] == 1
    assert set(s["phase"]) == {"count", "mean_ms", "p50_ms", "max_ms"}
    assert 0 <= s["phase"]["p50_ms"] <= s["phase"]["max_ms"]


def test_device_trace_and_annotate_on_the_cpu(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as prof:
        with profiling.annotate("sph.span"):
            torch.ones(64).sum()
    names = {e.name for e in prof.events()}
    assert "sph.span" in names
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
