"""The port's run executor and scene previews (``service/executor.py``,
``App.preview_frame``) against the JAX package's, on the CPU: the same runs
submitted over HTTP to the reference's ``App`` and to the port's
``App(device="cpu")``.

Bounds (float32 runs; the two engines sum in different orders): positions,
read through the centre of mass, within 1e-5 m, the bound
``tests/test_torch_run.py`` holds float32 ``run_epochs`` to (domain 1 m);
every other metric within 1e-4 of its scale: its own magnitude, and for a
momentum component the most that velocity errors of 1e-4 of the largest
speed could move it, total mass x ``max_speed`` (``tests/test_torch_pbf.py``
holds float32 PBF velocities to 1e-4 of the largest; PBF's velocity is
(x - x0) / dt, and a momentum component is a sum with cancellation).
Single-particle extremes (``max_speed``) differ by up to 3e-5 relative
after 50 WCSPH steps, sums by ~1e-6. Preview frames (uint8) within one
count at every pixel.
"""

import struct
import time
import urllib.request
import zlib

import numpy as np
import pytest

from sph_pie_torch.service import api as tapi
from sph_pie_torch.utils import checkpoint as tckpt
from sph_pie_tpu.service import api as japi
from sph_pie_tpu.utils import checkpoint as jckpt
from tests.test_api import _login_admin
from tests.test_torch_service import start, stop

COM_ATOL = 1e-5
METRIC_RTOL = 1e-4


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """{"jax": (app, client, dir), "torch": ...}, both on the jsonfile provider
    (the reference's sqlite provider shares one connection between threads
    without locking its reads: see tests/test_torch_service.py), logged in."""
    out, servers = {}, []
    for name, api, kw in (("jax", japi, {}), ("torch", tapi, {"device": "cpu"})):
        d = tmp_path_factory.mktemp(name)
        app, srv, c = start(api, d, "jsonfile", **kw)
        servers.append((app, srv))
        _login_admin(c)
        out[name] = (app, c, d)
    yield out
    for app, srv in servers:
        stop(app, srv)


def execute(c, name, params, steps, record_every, want="completed", timeout=240):
    """Create a dam_break_2d run with ``params``, execute it over HTTP and
    wait for ``want``; returns the run record."""
    day = len(c.req("GET", "/api/runs", expect=200)[1]["runs"]) + 1  # at most 5 runs a date
    _, body = c.req("POST", "/api/runs", {"name": name, "scene": "dam_break_2d",
                                          "runDate": f"2026-08-{day:02d}", "params": params}, 201)
    rid = body["run"]["id"]
    _, body = c.req("POST", f"/api/runs/{rid}/execute",
                    {"steps": steps, "recordEvery": record_every}, 202)
    assert body["run"]["status"] == "queued"
    t0 = time.time()
    while time.time() - t0 < timeout:
        _, body = c.req("GET", f"/api/runs/{rid}", expect=200)
        if body["run"].get("status") in ("completed", "failed"):
            break
        time.sleep(0.2)
    assert body["run"]["status"] == want, body["run"].get("error")
    return body["run"]


def both(apps, name, params, steps, record_every, want="completed"):
    return {k: execute(apps[k][1], name, params, steps, record_every, want) for k in apps}


def total_mass(apps, run) -> float:
    """Active mass of the port's run, from its final checkpoint."""
    (path,) = (apps["torch"][2] / "checkpoints" / run["id"]).glob("ckpt_*.npz")
    st = tckpt.load_state(path, device="cpu")[0]
    return float(st.mass[st.active].sum())


def assert_rows_close(got: list[dict], want: list[dict], mass: float) -> None:
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert (g["n_active"], g["overflow"]) == (w["n_active"], w["overflow"])
        assert g["time"] == pytest.approx(w["time"], rel=1e-12)
        mom = mass * w["max_speed"]
        for k, v in w.items():
            if not isinstance(v, float) or k == "time":
                continue
            if k.startswith("com_"):
                assert abs(g[k] - v) <= COM_ATOL, (w["step"], k)
            else:
                scale = mom if k.startswith("momentum_") else abs(v)
                assert abs(g[k] - v) <= METRIC_RTOL * scale, (w["step"], k, g[k], v)


def test_wcsph_run_records_the_reference_metrics_and_checkpoint(apps):
    """dam_break_2d(256), 100 steps, a record every 50: the same step rows
    (steps, n_active, overflow 0, metrics within the bounds above) and a
    final checkpoint that each package's ``load_state`` reads from the
    other's file."""
    runs = both(apps, "exec", {"n_target": 256}, 100, 50)
    got, want = runs["torch"]["steps"], runs["jax"]["steps"]
    assert [r["step"] for r in want] == [50, 100] and want[0]["n_active"] == 260
    assert all(r["overflow"] == 0 for r in want) and want[-1]["kinetic_energy"] > 0
    assert_rows_close(got, want, total_mass(apps, runs["torch"]))
    assert set(runs["torch"]["timing"]) == {"buildSeconds", "stepSeconds", "checkpointSeconds"}

    (tpath,) = (apps["torch"][2] / "checkpoints" / runs["torch"]["id"]).glob("ckpt_*.npz")
    (jpath,) = (apps["jax"][2] / "checkpoints" / runs["jax"]["id"]).glob("ckpt_*.npz")
    assert tpath.name == jpath.name == "ckpt_100.npz"
    t_by_jax, _, t_step, _ = jckpt.load_state(tpath)
    j_by_torch, params, j_step, _ = tckpt.load_state(jpath, device="cpu")
    assert t_step == j_step == 100 and params.dim == 2
    act = np.asarray(t_by_jax.active)
    assert int(act.sum()) == int(j_by_torch.active.sum()) == got[-1]["n_active"]
    assert np.array_equal(act, j_by_torch.active.numpy())
    err = np.abs(np.asarray(t_by_jax.pos)[act] - j_by_torch.pos.numpy()[act]).max()
    assert err <= COM_ATOL


def test_pbf_selection_matches_the_reference(apps):
    """``params.solver = "pbf"`` with ``pbf`` kwargs runs the PBF epoch loop
    on both: 5 steps of dam_break_2d(256), rows within the bounds above (PBF
    at this size is violent: a few m/s after 5 steps, so a WCSPH run, at
    ~0.05 m/s, could not pass)."""
    runs = both(apps, "pbf", {"n_target": 256, "solver": "pbf",
                              "pbf": {"iters": 2, "sor": 0.9}}, 5, 5)
    want = runs["jax"]["steps"]
    assert want[0]["max_speed"] > 1.0
    assert_rows_close(runs["torch"]["steps"], want, total_mass(apps, runs["torch"]))


@pytest.mark.parametrize("params,error", [
    ({"solver": "nope"}, "unknown solver 'nope'"),
    ({"no_such_option": 1}, "bad scene params"),
])
def test_runs_that_fail_on_both(apps, params, error):
    runs = both(apps, "bad", {"n_target": 256, **params}, 10, 10, want="failed")
    for run in runs.values():
        assert error in run["error"] and not run.get("steps")


@pytest.mark.parametrize("params", [
    {"device": "cuda"}, {"device": "cpu"}, {"dtype": "float64"},
    {"solver": "pbf", "pbf": {"device": "cuda"}},
])
def test_a_run_cannot_choose_the_device_or_dtype(apps, params):
    """A ``device`` or ``dtype`` key (in the scene's or PBF's params) fails the
    run: the run stays on the service's device."""
    run = execute(apps["torch"][1], "moved", {"n_target": 256, **params}, 10, 10, "failed")
    assert "bad scene params" in run["error"] and "service's to choose" in run["error"]


def png_pixels(data: bytes) -> np.ndarray:
    """uint8 [H, W] of an 8-bit grayscale PNG whose rows use filter 0."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, idat, shape = 8, b"", None
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        tag, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 0)
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        i += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], shape[1] + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def test_preview_frames_match_the_reference(apps):
    """``/api/scenes/dam_break_2d/preview.png?steps=50``: 2 epochs of 25 steps
    of dam_break_2d(2048), rendered 256 x 256; the port's frame within one
    count of the reference's at every pixel. A second request at fewer
    steps rebuilds the scene (the reference's memo rule)."""
    frames = {}
    for name, (_, c, _) in apps.items():
        req = urllib.request.Request(c.base + "/api/scenes/dam_break_2d/preview.png?steps=50",
                                     headers={"Cookie": c.cookie})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "image/png"
            frames[name] = png_pixels(resp.read())
    got, want = frames["torch"].astype(int), frames["jax"].astype(int)
    assert got.shape == want.shape == (256, 256) and want.sum() > 0
    assert np.abs(got - want).max() <= 1
    app = apps["torch"][0]
    assert app._previews["dam_break_2d"]["step"] == 50
    app.preview_frame("dam_break_2d", 0, 32)
    assert app._previews["dam_break_2d"]["step"] == 0
