"""The port's HTTP service (``sph_pie_torch/service/``) against the JAX
package's, on the CPU: one scripted session, the same requests in the same
order, against the reference's ``App`` and the port's ``App(device="cpu")``
on ephemeral ports, for each storage provider. Every response (status and
body) must be equal once ids, timestamps, cookies and the data directory
are replaced by placeholders; of ``/api/health`` the keys and the storage
provider are compared (its version and device are each package's own)."""

import json
import re
import sys
import threading
import time

import pytest

from sph_pie_torch.service import api as tapi
from sph_pie_torch.service.storage.piedb_provider import build_server_binary
from sph_pie_tpu.service import api as japi
from sph_pie_tpu.service.users import DEFAULT_TEMP_PASSWORD
from tests.test_api import GOOD_PW, Client

PROVIDERS = ("jsonfile", "sqlite", "piedb")
_TIME_KEY = re.compile(r"At(_avg|_max|_min)?$")  # a timestamp, or a statistic of them
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def start(api, tmp_path, provider, **kw):
    """An App of ``api`` on ``provider`` with all its files under
    ``tmp_path``, served on an ephemeral port; returns (app, server, client)."""
    cfg = {"storageProvider": provider, "piedb": {"dataDir": str(tmp_path / "piedb")}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    app = api.App(config_path=tmp_path / "cfg.json", data_dir=str(tmp_path), env={}, **kw)
    srv = api.make_server(app, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return app, srv, Client(f"http://127.0.0.1:{srv.server_port}")


def stop(app, srv):
    srv.shutdown()
    srv.server_close()
    app.registry.get_provider().dispose()  # stops a spawned piedb server


class Normaliser:
    """Ids (in order of first appearance), timestamps and the data directory
    replaced by placeholders, so two sessions' responses compare."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.ids: dict[str, str] = {}

    def _id(self, m) -> str:
        return self.ids.setdefault(m.group(0), f"<id{len(self.ids)}>")

    def __call__(self, v, key=""):
        if isinstance(v, dict):
            return {k: self(x, k) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(self(x, key) for x in v)
        if isinstance(v, str):
            return _UUID.sub(self._id, v.replace(self.data_dir, "<dir>"))
        if isinstance(v, (int, float)) and _TIME_KEY.search(key):
            return "<t>"
        return v


def session(c: Client, app) -> list:
    """The scripted session; returns [(method, path, status, body)]."""
    out = []

    def req(method, path, body=None, client=None):
        status, got = (client or c).req(method, path, body)
        out.append((method, path, status, got))
        return got

    health = req("GET", "/api/health")
    out[-1] = ("GET", "/api/health", out[-1][2], {
        "keys": sorted(health), "device keys": sorted(health["device"]),
        "storage": health["storage"]["provider"], "status": health["status"],
    })
    req("GET", "/api/runs")  # 401
    req("POST", "/api/auth/login", {"email": "admin@local", "password": "nope"})
    req("POST", "/api/auth/login", {"email": "admin@local", "password": DEFAULT_TEMP_PASSWORD})
    req("GET", "/api/runs")  # 423: the forced reset
    req("GET", "/api/auth/session")
    req("POST", "/api/auth/password", {"currentPassword": DEFAULT_TEMP_PASSWORD, "password": "short"})
    req("POST", "/api/auth/password", {"currentPassword": DEFAULT_TEMP_PASSWORD, "password": GOOD_PW})
    req("GET", "/api/auth/session")
    # users and roles
    req("GET", "/api/domains")
    req("GET", "/api/users")
    user = req("POST", "/api/users", {"name": "New Lead", "email": "lead2@local", "roles": ["lead"]})
    req("POST", "/api/users", {"name": "Dup", "email": "lead2@local", "roles": ["lead"]})
    req("PUT", f"/api/users/{user['user']['id']}", {"name": "Renamed Lead"})
    req("POST", f"/api/users/{user['user']['id']}/reset-password")
    req("GET", "/api/staff")
    req("PUT", "/api/staff", {"directory": {}})
    # an operator: RBAC refusals and the forced identity
    op = Client(c.base)
    req("POST", "/api/auth/login", {"email": "sim.operator@local",
                                    "password": DEFAULT_TEMP_PASSWORD}, op)
    req("POST", "/api/auth/password", {"currentPassword": DEFAULT_TEMP_PASSWORD,
                                       "password": GOOD_PW}, op)
    req("POST", "/api/runs", {"name": "x", "scene": "s", "runDate": "2026-08-16"}, op)
    req("GET", "/api/users", client=op)
    req("PUT", "/api/config", {}, op)
    # runs CRUD and steps
    r1 = req("POST", "/api/runs", {"name": "r1", "scene": "dam_break_2d", "runDate": "2026-08-16",
                                   "params": {"n_target": 256}})["run"]["id"]
    req("POST", "/api/runs", {"name": "", "scene": "dam_break_2d"})  # 400
    req("GET", f"/api/runs/{r1}")
    req("PUT", f"/api/runs/{r1}", {"name": "r1-renamed"})
    for k, ke in ((0, 2.0), (50, 1.5), (100, 0.75)):
        req("POST", f"/api/runs/{r1}/steps", {"step": k, "kinetic_energy": ke, "max_speed": ke / 2})
    req("POST", f"/api/runs/{r1}/steps", {"step": 0})  # 409: duplicate index
    run = req("POST", f"/api/runs/{r1}/steps", {"step": 150, "operator": "Spoofed"}, op)
    sid = run["run"]["steps"][-1]["id"]
    req("PUT", f"/api/runs/{r1}/steps/{sid}", {"step": 150, "status": "ok", "max_speed": 1.25})
    req("DELETE", f"/api/runs/{r1}/steps/{sid}")
    req("GET", "/api/runs")
    req("GET", f"/api/runs/{r1}/export?format=csv")
    req("GET", f"/api/runs/{r1}/export?format=json")
    req("GET", "/api/runs/nope")
    # archive and analytics
    req("POST", f"/api/runs/{r1}/archive")
    req("GET", "/api/runs/archive")
    req("GET", f"/api/runs/{r1}")  # 404 once archived
    req("GET", f"/api/runs/{r1}/export?format=csv")  # archived runs still export
    req("GET", "/api/runs/archive/analytics?metric=kinetic_energy,max_speed")
    req("GET", "/api/runs/archive/analytics?scene=dam_break_3d")
    r2 = req("POST", "/api/runs", {"name": "r2", "scene": "dam_break_3d",
                                   "runDate": "2026-08-17"})["run"]["id"]
    req("DELETE", f"/api/runs/{r2}")
    req("GET", "/api/runs")
    # config round trip: the webhook secret is masked and survives a PUT of the mask
    cfg = req("GET", "/api/config")["config"]
    cfg["webhook"] = dict(cfg["webhook"], secret="s3cret", url="", enabled=False)
    req("PUT", "/api/config", cfg)
    cfg = req("GET", "/api/config")["config"]
    req("PUT", "/api/config", cfg)  # secret "***" sent back
    out.append(("secret kept", "", 0, app.config["webhook"]["secret"]))
    req("GET", "/api/webhook/status")
    req("GET", "/api/webhook/preview")
    req("POST", "/api/webhook/simulate")
    # catalog, events, static shell, unknown routes, logout
    req("GET", "/api/scenes")
    req("GET", "/api/scenes/no_such_scene/preview.png")
    req("GET", "/api/calendar")
    req("GET", "/api/events?max=0")
    req("GET", "/api/nope")
    req("POST", "/api/auth/logout")
    req("GET", "/api/auth/session")
    req("GET", "/api/runs")
    return out


@pytest.mark.parametrize("provider", PROVIDERS)
def test_session_matches_the_reference(provider, tmp_path):
    if provider == "piedb" and build_server_binary() is None:
        pytest.skip("no C++ toolchain for the piedb server")
    transcripts = []
    for name, api, kw in (("jax", japi, {}), ("torch", tapi, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        app, srv, c = start(api, d, provider, **kw)
        try:
            transcripts.append(Normaliser(str(d))(session(c, app)))
        finally:
            stop(app, srv)
    want, got = transcripts
    assert [t[:3] for t in got] == [t[:3] for t in want]
    for g, w in zip(got, want):
        assert g == w, g[:2]
    statuses = {(m, p): s for m, p, s, _ in want}
    # the session reaches the refusals it is meant to
    assert statuses[("GET", "/api/runs")] == 401
    assert statuses[("PUT", "/api/staff")] == 410
    assert [s for m, p, s, _ in want if p == "/api/users" and m == "POST"] == [201, 409]
    assert ("secret kept", "", 0, "s3cret") in want
    health = want[0][3]
    assert health["storage"] == provider and health["status"] == "ok"


def test_sqlite_reads_beside_writes_from_many_threads(tmp_path):
    """The port's sqlite provider shares one connection between every thread;
    its reads take the mutex as its writes do. 8 reader threads and 2 writer
    threads for 2 s at a short switch interval: no read fails or returns a
    torn record (the JAX package's provider, whose reads are unlocked, was
    seen to return a row without its data under this load)."""
    from sph_pie_torch.service.storage import SqliteProvider

    p = SqliteProvider({"filename": str(tmp_path / "t.sqlite")}).init()
    run = p.create_run({"name": "r", "scene": "dam_break_2d", "runDate": "2026-08-16"})
    errors, stop_at = [], time.time() + 2.0

    def writer():
        k = 0
        while time.time() < stop_at:
            p.replace_run(dict(run, status=str(k)))
            k += 1

    def reader():
        while time.time() < stop_at:
            try:
                assert p.get_run(run["id"])["id"] == run["id"]
                p.list_runs()
            except Exception as e:  # collected: a thread's exception is lost otherwise
                errors.append(repr(e))

    threads = [threading.Thread(target=writer) for _ in range(2)]
    threads += [threading.Thread(target=reader) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
        p.dispose()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
