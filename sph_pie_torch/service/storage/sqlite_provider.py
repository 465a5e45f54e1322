"""SQLite run-store engine.

Counterpart of the reference's sql.js provider
(sphereisaiahmin-dev/sph-pie `server/storage/sqlProvider.js`): JSON
documents in a file-backed SQLite database with idempotent schema +
additive column migration. Unlike the reference — which serialises the
ENTIRE database to disk after every write (sqlProvider.js:737-744, the
known write-amplification anti-pattern, SURVEY.md §7.4) — this uses real
sqlite3 transactions, so a write costs one page set, not the whole file.
"""

from __future__ import annotations

import threading

import json
import sqlite3
from pathlib import Path

from sph_pie_torch.service.storage import base
from sph_pie_torch.service.storage.base import now_ms

_SCHEMA = {
    "runs": (
        "CREATE TABLE IF NOT EXISTS runs ("
        " id TEXT PRIMARY KEY, data TEXT NOT NULL, updated_at INTEGER)"
    ),
    "run_archive": (
        "CREATE TABLE IF NOT EXISTS run_archive ("
        " id TEXT PRIMARY KEY, data TEXT NOT NULL, run_date TEXT,"
        " created_at INTEGER, archived_at INTEGER, deleted_at INTEGER)"
    ),
    "calendar_events": (
        "CREATE TABLE IF NOT EXISTS calendar_events ("
        " id TEXT PRIMARY KEY, data TEXT NOT NULL,"
        " start_ts INTEGER, end_ts INTEGER, created_at INTEGER)"
    ),
}


@base.lock_mutators
class SqliteProvider:
    provider_type = "sqlite"

    def __init__(self, options: dict | None = None, on_event=None):
        opts = options or {}
        self.filename = opts.get("filename", "data/sph_pie.sqlite")
        self.auto_archive_hours = opts.get("autoArchiveHours", base.AUTO_ARCHIVE_HOURS)
        self.retention_months = opts.get("retentionMonths", base.RETENTION_MONTHS)
        self.on_event = on_event or (lambda event, run, meta=None: None)
        self._db: sqlite3.Connection | None = None
        # Serialises read-modify-write mutations: API handler threads and
        # the run executor mutate the same records concurrently.
        self._mutex = threading.RLock()

    # -- lifecycle ---------------------------------------------------------
    def init(self):
        Path(self.filename).parent.mkdir(parents=True, exist_ok=True)
        self._db = sqlite3.connect(self.filename, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        for ddl in _SCHEMA.values():
            self._db.execute(ddl)
        self._migrate_columns()
        self._db.commit()
        return self

    def dispose(self):
        if self._db is not None:
            self._db.close()
            self._db = None

    def _migrate_columns(self):
        """Additive column migration (reference pattern:
        sqlProvider.js:459-585 ALTER-based presence checks)."""
        cols = {r[1] for r in self._db.execute("PRAGMA table_info(run_archive)")}
        for col, ddl in (
            ("deleted_at", "ALTER TABLE run_archive ADD COLUMN deleted_at INTEGER"),
        ):
            if col not in cols:
                self._db.execute(ddl)

    def get_storage_metadata(self) -> dict:
        return {
            "provider": self.provider_type,
            "filename": str(self.filename),
            "runs": self._count("runs"),
            "archived": self._count("run_archive"),
        }

    def _count(self, table) -> int:
        return self._db.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]

    # -- run CRUD ----------------------------------------------------------
    def list_runs(self) -> list[dict]:
        self.run_archive_maintenance()
        return self._all_runs()

    def _all_runs(self) -> list[dict]:
        rows = self._db.execute("SELECT data FROM runs").fetchall()
        out = []
        for (data,) in rows:
            try:
                out.append(json.loads(data))
            except json.JSONDecodeError:
                continue  # corrupt row skipped (reference: sqlProvider.js:141-151)
        out.sort(key=lambda r: (r.get("runDate", ""), r.get("createdAt", 0)))
        return out

    def get_run(self, run_id: str) -> dict | None:
        self.run_archive_maintenance()
        row = self._db.execute(
            "SELECT data FROM runs WHERE id=?", (run_id,)
        ).fetchone()
        return json.loads(row[0]) if row else None

    def create_run(self, payload: dict) -> dict:
        run = base.normalize_run(payload)
        base.assert_date_capacity(self._all_runs(), run["runDate"])
        self._put(run)
        return run

    def update_run(self, run_id: str, payload: dict) -> dict:
        existing = self.get_run(run_id)
        if existing is None:
            raise KeyError(run_id)
        run = base.normalize_run(payload, existing)
        base.assert_date_capacity(self._all_runs(), run["runDate"], exclude_id=run_id)
        self._put(run)
        return run

    def replace_run(self, run: dict) -> dict:
        run = base.normalize_run(run, self.get_run(run.get("id")) or {})
        self._put(run)
        return run

    def delete_run(self, run_id: str) -> dict:
        """Delete == archive with deletedAt (reference: sqlProvider.js:133-160)."""
        run = self.get_run(run_id)
        if run is None:
            raise KeyError(run_id)
        self._archive(run, deleted=True)
        self._db.execute("DELETE FROM runs WHERE id=?", (run_id,))
        self._db.commit()
        self.on_event("run.deleted", run)
        return run

    def _put(self, run: dict):
        self._db.execute(
            "INSERT INTO runs(id, data, updated_at) VALUES(?,?,?) "
            "ON CONFLICT(id) DO UPDATE SET data=excluded.data,"
            " updated_at=excluded.updated_at",
            (run["id"], json.dumps(run), now_ms()),
        )
        self._db.commit()

    # -- step metrics (the entries analogue) -------------------------------
    def add_step(self, run_id: str, payload: dict) -> dict:
        run = self.get_run(run_id)
        if run is None:
            raise KeyError(run_id)
        step = base.normalize_step(payload)
        base.assert_unique_step(run, step["step"])
        run["steps"].append(step)
        run["updatedAt"] = now_ms()
        self._put(run)
        return run

    def update_step(self, run_id: str, step_id: str, payload: dict) -> dict:
        run = self.get_run(run_id)
        if run is None:
            raise KeyError(run_id)
        for i, s in enumerate(run["steps"]):
            if s.get("id") == step_id:
                merged = base.normalize_step({**s, **payload, "id": step_id})
                base.assert_unique_step(run, merged["step"], exclude_id=step_id)
                run["steps"][i] = merged
                run["updatedAt"] = now_ms()
                self._put(run)
                return run
        raise KeyError(step_id)

    def delete_step(self, run_id: str, step_id: str) -> dict:
        run = self.get_run(run_id)
        if run is None:
            raise KeyError(run_id)
        n = len(run["steps"])
        run["steps"] = [s for s in run["steps"] if s.get("id") != step_id]
        if len(run["steps"]) == n:
            raise KeyError(step_id)
        run["updatedAt"] = now_ms()
        self._put(run)
        return run

    # -- archive -----------------------------------------------------------
    def list_archived_runs(self) -> list[dict]:
        self.run_archive_maintenance()
        rows = self._db.execute(
            "SELECT data FROM run_archive WHERE deleted_at IS NULL"
        ).fetchall()
        out = [json.loads(d) for (d,) in rows]
        out.sort(key=lambda r: r.get("archivedAt", 0), reverse=True)
        return out

    def get_archived_run(self, run_id: str) -> dict | None:
        row = self._db.execute(
            "SELECT data FROM run_archive WHERE id=?", (run_id,)
        ).fetchone()
        return json.loads(row[0]) if row else None

    def archive_run_now(self, run_id: str) -> dict:
        # Direct read (no maintenance sweep): an already-stale run must be
        # manually archivable without racing the auto-archiver.
        row = self._db.execute(
            "SELECT data FROM runs WHERE id=?", (run_id,)
        ).fetchone()
        run = json.loads(row[0]) if row else None
        if run is None:
            raise KeyError(run_id)
        self._archive(run)
        self._db.execute("DELETE FROM runs WHERE id=?", (run_id,))
        self._db.commit()
        self.on_event("run.archived", run, {"source": "manual"})
        return run

    def _archive(self, run: dict, deleted: bool = False, archived_at=None):
        archived_at = archived_at or now_ms()
        run = dict(run, archivedAt=archived_at, **({"deletedAt": archived_at} if deleted else {}))
        self._db.execute(
            "INSERT INTO run_archive(id, data, run_date, created_at,"
            " archived_at, deleted_at) VALUES(?,?,?,?,?,?) "
            "ON CONFLICT(id) DO UPDATE SET data=excluded.data,"
            " archived_at=excluded.archived_at, deleted_at=excluded.deleted_at",
            (
                run["id"],
                json.dumps(run),
                run.get("runDate"),
                run.get("createdAt"),
                archived_at,
                archived_at if deleted else None,
            ),
        )

    # -- calendar events (persisted feed mirror) ----------------------------
    def list_calendar_events(self) -> list[dict]:
        """Stored feed mirror (reference: listCalendarEvents,
        sqlProvider.js:274-279) — served even when the upstream feed is
        unreachable."""
        rows = self._db.execute(
            "SELECT data FROM calendar_events ORDER BY start_ts"
        ).fetchall()
        out = []
        for (data,) in rows:
            try:
                out.append(json.loads(data))
            except json.JSONDecodeError:
                continue
        return out

    def sync_calendar_events(self, events: list[dict]) -> dict:
        """Upsert the fetched feed + prune events that left it
        (reference: syncCalendarEvents, sqlProvider.js:940-968)."""
        events = [base.normalize_calendar_event(e) for e in events]
        keep_ids = {e["id"] for e in events}
        ts = now_ms()
        for e in events:
            self._db.execute(
                "INSERT INTO calendar_events(id, data, start_ts, end_ts,"
                " created_at) VALUES(?,?,?,?,?) "
                "ON CONFLICT(id) DO UPDATE SET data=excluded.data,"
                " start_ts=excluded.start_ts, end_ts=excluded.end_ts",
                (e["id"], json.dumps(e), e.get("start"), e.get("end"), ts),
            )
        pruned = 0
        for (eid,) in self._db.execute("SELECT id FROM calendar_events"):
            if eid not in keep_ids:
                self._db.execute("DELETE FROM calendar_events WHERE id=?", (eid,))
                pruned += 1
        self._db.commit()
        return {"upserted": len(events), "pruned": pruned}

    def run_archive_maintenance(self, now=None) -> dict:
        """Auto-archive stale date groups + purge expired archives.

        Exposed as an explicit hook rather than piggy-backed on every read
        path the way the reference does (sqlProvider.js:746 — flagged in
        SURVEY.md §7.4); list/get call it, bulk internal paths do not.
        """
        keep, to_archive = base.split_archivable(
            self._all_runs(), self.auto_archive_hours, now
        )
        for run in to_archive:
            self._archive(run, archived_at=now)
            self._db.execute("DELETE FROM runs WHERE id=?", (run["id"],))
        purged = 0
        for (data,) in self._db.execute("SELECT data FROM run_archive").fetchall():
            run = json.loads(data)
            if base.is_expired(run, self.retention_months, now):
                self._db.execute("DELETE FROM run_archive WHERE id=?", (run["id"],))
                purged += 1
        self._db.commit()
        for run in to_archive:
            self.on_event("run.archived", run, {"source": "auto-archive"})
        return {"archived": len(to_archive), "purged": purged}


# The one connection serves every thread, so reads take the mutex too: a
# read on an HTTP thread beside the run executor's write on the same
# connection fails with sqlite3.InterfaceError (the JAX package's provider
# locks its mutators only).
base.lock_mutators(
    SqliteProvider,
    ("get_storage_metadata", "list_runs", "get_run", "list_archived_runs",
     "get_archived_run", "list_calendar_events"),
)
