"""JSON-file run-store engine (second storage backend).

Fills the role of the reference's PostgresProvider
(sphereisaiahmin-dev/sph-pie `server/storage/postgresProvider.js`): a
second engine behind the same duck-typed contract, hot-swappable at
runtime via config. A network database isn't available in this
environment, so the second engine is a document-per-file store with:

  * auto-creation of its directory tree when missing — the analogue of the
    reference's CREATE DATABASE on error 3D000 (postgresProvider.js:964-1033)
  * atomic writes (tmp + rename) so a crash never leaves a torn document
  * the same domain semantics via storage.base
"""

from __future__ import annotations

import threading

import json
from pathlib import Path

from sph_pie_torch.service.storage import base
from sph_pie_torch.service.storage.base import now_ms


@base.lock_mutators
class JsonFileProvider:
    provider_type = "jsonfile"

    def __init__(self, options: dict | None = None, on_event=None):
        opts = options or {}
        self.root = Path(opts.get("directory", "data/runs"))
        self.auto_archive_hours = opts.get("autoArchiveHours", base.AUTO_ARCHIVE_HOURS)
        self.retention_months = opts.get("retentionMonths", base.RETENTION_MONTHS)
        self.on_event = on_event or (lambda event, run, meta=None: None)
        # Serialises read-modify-write mutations: API handler threads and
        # the run executor mutate the same records concurrently.
        self._mutex = threading.RLock()

    # -- lifecycle ---------------------------------------------------------
    def init(self):
        (self.root / "active").mkdir(parents=True, exist_ok=True)
        (self.root / "archive").mkdir(parents=True, exist_ok=True)
        return self

    def dispose(self):
        pass

    def get_storage_metadata(self) -> dict:
        return {
            "provider": self.provider_type,
            "directory": str(self.root),
            "runs": len(list((self.root / "active").glob("*.json"))),
            "archived": len(list((self.root / "archive").glob("*.json"))),
        }

    # -- document IO -------------------------------------------------------
    def _path(self, folder: str, run_id) -> Path:
        # Defense in depth: normalize_run already rejects unsafe ids, but
        # every filesystem touch re-validates so no call path can traverse
        # outside the data directory.
        return self.root / folder / f"{base.safe_id(run_id)}.json"

    def _write(self, folder: str, run: dict):
        path = self._path(folder, run["id"])
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(run))
        tmp.replace(path)

    def _read_all(self, folder: str) -> list[dict]:
        out = []
        for p in (self.root / folder).glob("*.json"):
            try:
                out.append(json.loads(p.read_text()))
            except (json.JSONDecodeError, OSError):
                continue  # corrupt document skipped
        return out

    def _read(self, folder: str, run_id: str) -> dict | None:
        try:
            p = self._path(folder, run_id)
        except base.ValidationError:
            return None
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return None

    def _remove(self, folder: str, run_id: str):
        try:
            self._path(folder, run_id).unlink(missing_ok=True)
        except base.ValidationError:
            pass  # hostile id: nothing of ours can exist at such a path

    # -- run CRUD ----------------------------------------------------------
    def list_runs(self) -> list[dict]:
        self.run_archive_maintenance()
        runs = self._read_all("active")
        runs.sort(key=lambda r: (r.get("runDate", ""), r.get("createdAt", 0)))
        return runs

    def get_run(self, run_id: str) -> dict | None:
        self.run_archive_maintenance()
        return self._read("active", run_id)

    def create_run(self, payload: dict) -> dict:
        run = base.normalize_run(payload)
        base.assert_date_capacity(self._read_all("active"), run["runDate"])
        self._write("active", run)
        return run

    def update_run(self, run_id: str, payload: dict) -> dict:
        existing = self._read("active", run_id)
        if existing is None:
            raise KeyError(run_id)
        run = base.normalize_run(payload, existing)
        base.assert_date_capacity(
            self._read_all("active"), run["runDate"], exclude_id=run_id
        )
        self._write("active", run)
        return run

    def replace_run(self, run: dict) -> dict:
        run = base.normalize_run(run, self._read("active", run.get("id")) or {})
        self._write("active", run)
        return run

    def delete_run(self, run_id: str) -> dict:
        run = self._read("active", run_id)
        if run is None:
            raise KeyError(run_id)
        ts = now_ms()
        self._write("archive", dict(run, archivedAt=ts, deletedAt=ts))
        self._remove("active", run_id)
        self.on_event("run.deleted", run)
        return run

    # -- step metrics ------------------------------------------------------
    def add_step(self, run_id: str, payload: dict) -> dict:
        run = self._read("active", run_id)
        if run is None:
            raise KeyError(run_id)
        step = base.normalize_step(payload)
        base.assert_unique_step(run, step["step"])
        run["steps"].append(step)
        run["updatedAt"] = now_ms()
        self._write("active", run)
        return run

    def update_step(self, run_id: str, step_id: str, payload: dict) -> dict:
        run = self._read("active", run_id)
        if run is None:
            raise KeyError(run_id)
        for i, s in enumerate(run["steps"]):
            if s.get("id") == step_id:
                merged = base.normalize_step({**s, **payload, "id": step_id})
                base.assert_unique_step(run, merged["step"], exclude_id=step_id)
                run["steps"][i] = merged
                run["updatedAt"] = now_ms()
                self._write("active", run)
                return run
        raise KeyError(step_id)

    def delete_step(self, run_id: str, step_id: str) -> dict:
        run = self._read("active", run_id)
        if run is None:
            raise KeyError(run_id)
        n = len(run["steps"])
        run["steps"] = [s for s in run["steps"] if s.get("id") != step_id]
        if len(run["steps"]) == n:
            raise KeyError(step_id)
        run["updatedAt"] = now_ms()
        self._write("active", run)
        return run

    # -- calendar events (persisted feed mirror) ----------------------------
    def _calendar_path(self) -> Path:
        return self.root / "calendar.json"

    def list_calendar_events(self) -> list[dict]:
        p = self._calendar_path()
        if not p.exists():
            return []
        try:
            events = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return []
        return sorted(events, key=lambda e: e.get("start") or 0)

    def sync_calendar_events(self, events: list[dict]) -> dict:
        """Upsert + prune against the fetched feed (same contract as the
        sqlite engine; reference: sqlProvider.js:940-968)."""
        events = [base.normalize_calendar_event(e) for e in events]
        existing = {e["id"]: e for e in self.list_calendar_events()}
        keep_ids = {e["id"] for e in events}
        pruned = sum(1 for eid in existing if eid not in keep_ids)
        merged = {e["id"]: e for e in events}
        p = self._calendar_path()
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(list(merged.values())))
        tmp.replace(p)
        return {"upserted": len(events), "pruned": pruned}

    # -- archive -----------------------------------------------------------
    def list_archived_runs(self) -> list[dict]:
        self.run_archive_maintenance()
        runs = [r for r in self._read_all("archive") if not r.get("deletedAt")]
        runs.sort(key=lambda r: r.get("archivedAt", 0), reverse=True)
        return runs

    def get_archived_run(self, run_id: str) -> dict | None:
        return self._read("archive", run_id)

    def archive_run_now(self, run_id: str) -> dict:
        run = self._read("active", run_id)
        if run is None:
            raise KeyError(run_id)
        self._write("archive", dict(run, archivedAt=now_ms()))
        self._remove("active", run_id)
        self.on_event("run.archived", run, {"source": "manual"})
        return run

    def run_archive_maintenance(self, now=None) -> dict:
        keep, to_archive = base.split_archivable(
            self._read_all("active"), self.auto_archive_hours, now
        )
        ts = now if now is not None else now_ms()
        for run in to_archive:
            self._write("archive", dict(run, archivedAt=ts))
            self._remove("active", run["id"])
        purged = 0
        for run in self._read_all("archive"):
            if base.is_expired(run, self.retention_months, now):
                self._remove("archive", run["id"])
                purged += 1
        for run in to_archive:
            self.on_event("run.archived", run, {"source": "auto-archive"})
        return {"archived": len(to_archive), "purged": purged}
