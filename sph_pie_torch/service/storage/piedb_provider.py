"""piedb provider: the networked second storage engine.

Counterpart of the reference's PostgresProvider
(sphereisaiahmin-dev/sph-pie `server/storage/postgresProvider.js`): talks
to an out-of-process C++ document-store server
(``sph_pie_torch/native/piedb_server.cpp``) over TCP through a connection
POOL, with env-driven configuration (PIEDB_* mirroring the PG* family,
postgresProvider.js:894-962), transactions wrapping delete/archive
(:865-888), and automatic CREATE DATABASE when the probe fails with the
missing-database error (ENODB — the SQLSTATE 3D000 analogue, :964-1033).

The pool factory is an injectable seam (``_create_pool``) so tests can
substitute a protocol-level stub, exactly like the reference's StubPool
harness (scripts/simulate-storage-connections.js:189).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import threading
import time
from pathlib import Path

from sph_pie_torch import native
from sph_pie_torch.service.storage import base
from sph_pie_torch.service.storage.base import now_ms

_SRC = Path(__file__).resolve().parents[2] / "native" / "piedb_server.cpp"


def build_server_binary() -> Path | None:
    """Lazy g++ build of the server into ``sph_pie_torch/_build/`` (the
    oracle's builder, ``native.gxx_build``)."""
    binary, _ = native.gxx_build(
        _SRC, "piedb_server", "", (["-O2", "-std=c++17", "-pthread"], ["-O2", "-std=c++17"])
    )
    return binary


def spawn_server(port: int = 0, data_dir: str = "data/piedb") -> tuple:
    """Start a local server; returns (process, bound_port)."""
    binary = build_server_binary()
    if binary is None:
        raise RuntimeError("piedb server binary unavailable (no toolchain)")
    proc = subprocess.Popen(
        [str(binary), str(port), str(data_dir)],
        stdout=subprocess.PIPE,
        text=True,
    )
    line = proc.stdout.readline().strip()
    if not line.startswith("LISTENING "):
        proc.kill()
        raise RuntimeError(f"piedb server failed to start: {line!r}")
    return proc, int(line.split()[1])


class PieDbError(RuntimeError):
    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class Connection:
    """One wire connection. Request framing per piedb_server.cpp."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.f = self.sock.makefile("rb")

    def request(self, op: str, db="-", tbl="-", key="-", payload: bytes = b"") -> bytes:
        head = f"{op} {db} {tbl} {key} {len(payload)}\n".encode()
        self.sock.sendall(head + payload)
        line = self.f.readline()
        if not line:
            raise ConnectionError("piedb server closed connection")
        parts = line.decode().rstrip("\n").split(" ", 2)
        if parts[0] == "OK":
            n = int(parts[1])
            data = self.f.read(n)
            if len(data) != n:
                raise ConnectionError("short read")
            return data
        raise PieDbError(parts[1], parts[2] if len(parts) > 2 else "")

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Pool:
    """Bounded connection pool (reference default: max 10 clients,
    configStore.js:20-22)."""

    def __init__(self, host: str, port: int, max_size: int = 10, timeout: float = 5.0):
        self.host, self.port, self.max_size, self.timeout = host, port, max_size, timeout
        self._idle: list[Connection] = []
        self._count = 0
        self._lock = threading.Condition()

    def acquire(self) -> Connection:
        with self._lock:
            while True:
                if self._idle:
                    return self._idle.pop()
                if self._count < self.max_size:
                    self._count += 1
                    break
                self._lock.wait(timeout=self.timeout)
        try:
            return Connection(self.host, self.port, self.timeout)
        except OSError:
            with self._lock:
                self._count -= 1
                self._lock.notify()
            raise

    def release(self, conn: Connection, broken: bool = False):
        with self._lock:
            if broken:
                conn.close()
                self._count -= 1
            else:
                self._idle.append(conn)
            self._lock.notify()

    def dispose(self):
        with self._lock:
            for c in self._idle:
                c.close()
            self._idle.clear()
            self._count = 0


def _decode_scan(data: bytes) -> dict[str, bytes]:
    out = {}
    i = 0
    while i < len(data):
        nl = data.index(b"\n", i)
        klen, vlen = (int(x) for x in data[i:nl].split(b" "))
        key = data[nl + 1 : nl + 1 + klen]
        val = data[nl + 1 + klen : nl + 1 + klen + vlen]
        out[key.decode()] = val
        i = nl + 1 + klen + vlen
    return out


@base.lock_mutators
class PieDbProvider:
    provider_type = "piedb"

    RUNS = "runs"
    ARCHIVE = "run_archive"
    CALENDAR = "calendar_events"

    def __init__(self, options: dict | None = None, on_event=None):
        opts = dict(options or {})
        env = os.environ
        self.host = env.get("PIEDB_HOST", opts.get("host", "127.0.0.1"))
        self.port = int(env.get("PIEDB_PORT", opts.get("port", 7487)))
        self.database = env.get("PIEDB_DATABASE", opts.get("database", "sph_pie"))
        self.pool_max = int(opts.get("pool", {}).get("max", 10))
        self.spawn = bool(opts.get("spawn", False))
        self.data_dir = opts.get("dataDir", "data/piedb")
        self.auto_archive_hours = opts.get("autoArchiveHours", base.AUTO_ARCHIVE_HOURS)
        self.retention_months = opts.get("retentionMonths", base.RETENTION_MONTHS)
        self.on_event = on_event or (lambda event, run, meta=None: None)
        self._mutex = threading.RLock()
        self._pool: Pool | None = None
        self._proc = None

    # -- DI seam (the reference's _createPool hook) -------------------------
    def _create_pool(self) -> Pool:
        return Pool(self.host, self.port, self.pool_max)

    # -- lifecycle -----------------------------------------------------------
    def init(self):
        if self.spawn and self._proc is None:
            self._proc, self.port = spawn_server(self.port if self.port else 0, self.data_dir)
        self._pool = self._create_pool()
        self._ensure_database()
        return self

    def _ensure_database(self):
        """Probe; on the missing-database error, create it — the
        postgresProvider.js:964-1033 bootstrap behavior."""
        try:
            self._req("COUNT", tbl=self.RUNS)
        except PieDbError as e:
            if e.code != "ENODB":
                raise
            self._req("CREATEDB")

    def dispose(self):
        if self._pool is not None:
            self._pool.dispose()
            self._pool = None
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None

    def get_storage_metadata(self) -> dict:
        return {
            "provider": self.provider_type,
            "address": f"{self.host}:{self.port}",
            "database": self.database,
            "runs": int(self._req("COUNT", tbl=self.RUNS)),
            "archived": int(self._req("COUNT", tbl=self.ARCHIVE)),
        }

    # -- wire helpers --------------------------------------------------------
    def _req(self, op, tbl="-", key="-", payload: bytes = b"", conn=None):
        if conn is not None:
            return conn.request(op, self.database, tbl, key, payload)
        c = self._pool.acquire()
        try:
            out = c.request(op, self.database, tbl, key, payload)
        except (ConnectionError, OSError):
            self._pool.release(c, broken=True)
            raise
        except PieDbError:
            self._pool.release(c)
            raise
        self._pool.release(c)
        return out

    def _get_doc(self, tbl, key) -> dict | None:
        try:
            return json.loads(self._req("GET", tbl=tbl, key=key))
        except PieDbError as e:
            if e.code == "ENOKEY":
                return None
            raise
        except json.JSONDecodeError:
            return None  # corrupt document skipped

    def _put_doc(self, tbl, key, doc, conn=None):
        self._req("PUT", tbl=tbl, key=key, payload=json.dumps(doc).encode(), conn=conn)

    def _scan(self, tbl) -> list[dict]:
        out = []
        for raw in _decode_scan(self._req("SCAN", tbl=tbl)).values():
            try:
                out.append(json.loads(raw))
            except json.JSONDecodeError:
                continue
        return out

    def _txn(self, fn):
        """Run fn(conn) inside BEGIN/COMMIT, rolling back on error
        (postgresProvider.js _withClient, :865-888)."""
        c = self._pool.acquire()
        broken = False
        try:
            c.request("BEGIN", self.database)
            try:
                result = fn(c)
                c.request("COMMIT", self.database)
                return result
            except BaseException:
                c.request("ROLLBACK", self.database)
                raise
        except (ConnectionError, OSError):
            broken = True
            raise
        finally:
            self._pool.release(c, broken=broken)

    # -- run CRUD -------------------------------------------------------------
    def list_runs(self) -> list[dict]:
        self.run_archive_maintenance()
        runs = self._scan(self.RUNS)
        runs.sort(key=lambda r: (r.get("runDate", ""), r.get("createdAt", 0)))
        return runs

    def get_run(self, run_id: str) -> dict | None:
        self.run_archive_maintenance()
        return self._get_doc(self.RUNS, run_id)

    def create_run(self, payload: dict) -> dict:
        run = base.normalize_run(payload)
        base.assert_date_capacity(self._scan(self.RUNS), run["runDate"])
        self._put_doc(self.RUNS, run["id"], run)
        return run

    def update_run(self, run_id: str, payload: dict) -> dict:
        existing = self._get_doc(self.RUNS, run_id)
        if existing is None:
            raise KeyError(run_id)
        run = base.normalize_run(payload, existing)
        base.assert_date_capacity(self._scan(self.RUNS), run["runDate"], exclude_id=run_id)
        self._put_doc(self.RUNS, run["id"], run)
        return run

    def replace_run(self, run: dict) -> dict:
        run = base.normalize_run(run, self._get_doc(self.RUNS, run.get("id")) or {})
        self._put_doc(self.RUNS, run["id"], run)
        return run

    def delete_run(self, run_id: str) -> dict:
        run = self._get_doc(self.RUNS, run_id)
        if run is None:
            raise KeyError(run_id)
        ts = now_ms()
        archived = dict(run, archivedAt=ts, deletedAt=ts)

        def work(conn):
            self._put_doc(self.ARCHIVE, run_id, archived, conn=conn)
            self._req("DEL", tbl=self.RUNS, key=run_id, conn=conn)

        self._txn(work)
        self.on_event("run.deleted", run)
        return run

    # -- step metrics ----------------------------------------------------------
    def add_step(self, run_id: str, payload: dict) -> dict:
        run = self._get_doc(self.RUNS, run_id)
        if run is None:
            raise KeyError(run_id)
        step = base.normalize_step(payload)
        base.assert_unique_step(run, step["step"])
        run.setdefault("steps", []).append(step)
        run["updatedAt"] = now_ms()
        self._put_doc(self.RUNS, run_id, run)
        return run

    def update_step(self, run_id: str, step_id: str, payload: dict) -> dict:
        run = self._get_doc(self.RUNS, run_id)
        if run is None:
            raise KeyError(run_id)
        for i, s in enumerate(run.get("steps", [])):
            if s.get("id") == step_id:
                merged = base.normalize_step({**s, **payload, "id": step_id})
                base.assert_unique_step(run, merged["step"], exclude_id=step_id)
                run["steps"][i] = merged
                run["updatedAt"] = now_ms()
                self._put_doc(self.RUNS, run_id, run)
                return run
        raise KeyError(step_id)

    def delete_step(self, run_id: str, step_id: str) -> dict:
        run = self._get_doc(self.RUNS, run_id)
        if run is None:
            raise KeyError(run_id)
        n = len(run.get("steps", []))
        run["steps"] = [s for s in run["steps"] if s.get("id") != step_id]
        if len(run["steps"]) == n:
            raise KeyError(step_id)
        run["updatedAt"] = now_ms()
        self._put_doc(self.RUNS, run_id, run)
        return run

    # -- archive ----------------------------------------------------------------
    def list_archived_runs(self) -> list[dict]:
        self.run_archive_maintenance()
        runs = [r for r in self._scan(self.ARCHIVE) if not r.get("deletedAt")]
        runs.sort(key=lambda r: r.get("archivedAt", 0), reverse=True)
        return runs

    def get_archived_run(self, run_id: str) -> dict | None:
        return self._get_doc(self.ARCHIVE, run_id)

    def archive_run_now(self, run_id: str) -> dict:
        run = self._get_doc(self.RUNS, run_id)
        if run is None:
            raise KeyError(run_id)
        archived = dict(run, archivedAt=now_ms())

        def work(conn):
            self._put_doc(self.ARCHIVE, run_id, archived, conn=conn)
            self._req("DEL", tbl=self.RUNS, key=run_id, conn=conn)

        self._txn(work)
        self.on_event("run.archived", run, {"source": "manual"})
        return run

    def run_archive_maintenance(self, now=None) -> dict:
        keep, to_archive = base.split_archivable(
            self._scan(self.RUNS), self.auto_archive_hours, now
        )
        ts = now if now is not None else now_ms()
        if to_archive:
            def work(conn):
                for run in to_archive:
                    self._put_doc(
                        self.ARCHIVE, run["id"], dict(run, archivedAt=ts), conn=conn
                    )
                    self._req("DEL", tbl=self.RUNS, key=run["id"], conn=conn)

            self._txn(work)
        purged = 0
        for run in self._scan(self.ARCHIVE):
            if base.is_expired(run, self.retention_months, now):
                self._req("DEL", tbl=self.ARCHIVE, key=run["id"])
                purged += 1
        for run in to_archive:
            self.on_event("run.archived", run, {"source": "auto-archive"})
        return {"archived": len(to_archive), "purged": purged}

    # -- calendar events ----------------------------------------------------------
    def list_calendar_events(self) -> list[dict]:
        evs = self._scan(self.CALENDAR)
        evs.sort(key=lambda e: e.get("start") or 0)
        return evs

    def sync_calendar_events(self, events: list[dict]) -> dict:
        events = [base.normalize_calendar_event(e) for e in events]
        keep = {e["id"] for e in events}
        existing = _decode_scan(self._req("SCAN", tbl=self.CALENDAR))
        pruned = 0

        def work(conn):
            nonlocal pruned
            for e in events:
                self._put_doc(self.CALENDAR, _cal_key(e["id"]), e, conn=conn)
            for k, raw in existing.items():
                try:
                    eid = json.loads(raw).get("id")
                except json.JSONDecodeError:
                    eid = None
                if eid not in keep:
                    self._req("DEL", tbl=self.CALENDAR, key=k, conn=conn)
                    pruned += 1

        self._txn(work)
        return {"upserted": len(events), "pruned": pruned}


def _cal_key(event_id: str) -> str:
    """Calendar ids come from external feeds (may contain @, dots...);
    hex-encode to satisfy the server's identifier rules, hashing when too
    long (the original id lives inside the stored document)."""
    h = event_id.encode().hex()
    if len(h) <= 64:
        return h
    import hashlib

    return hashlib.sha1(event_id.encode()).hexdigest()
