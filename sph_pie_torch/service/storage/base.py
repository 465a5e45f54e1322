"""Shared run-record semantics for all storage providers.

The reference implements identical domain logic twice (compare
sphereisaiahmin-dev/sph-pie `server/storage/sqlProvider.js:319-457` with
`server/storage/postgresProvider.js:66-309`); here the domain rules live
once and the engines only persist.

Domain model (the simulation-framework analogue of shows/entries):

  run       — one simulation run: {id, name, scene, runDate, params,
              steps: [metric rows], createdAt, updatedAt}
  archive   — runs move here ``auto_archive_hours`` after the first run of
              their date (reference: 12 h, sqlProvider.js:9,746-861) and
              are purged ``retention_months`` after creation
              (reference: 2 months, sqlProvider.js:10,863-890).
"""

from __future__ import annotations

import functools
import re
import time
import uuid

MAX_RUNS_PER_DATE = 5          # reference caps 5 shows/date (sqlProvider.js:427)
AUTO_ARCHIVE_HOURS = 12
RETENTION_MONTHS = 2
_MONTH_S = 30 * 24 * 3600


class ValidationError(ValueError):
    """400-class error: bad payload."""


class ConflictError(ValueError):
    """409-class error: duplicate/limit conflicts."""


def now_ms() -> int:
    return int(time.time() * 1000)


def new_id() -> str:
    return str(uuid.uuid4())


_SAFE_ID = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def safe_id(value) -> str:
    """Validate a record id for safe use anywhere (SQL params, file names).

    The reference only ever uses ids as parameterized SQL values; our
    jsonfile engine also uses them as file names, so ids must never carry
    path separators or dots (a client-supplied id like
    '../../config/app-config' would otherwise escape the data directory).
    """
    s = str(value or "").strip()
    if not _SAFE_ID.match(s):
        raise ValidationError("id must match [A-Za-z0-9_-]{1,64}")
    return s


def normalize_run(payload: dict, existing: dict | None = None) -> dict:
    """Validate + normalise a run record (reference: _normalizeShow +
    required-field validation, sqlProvider.js:319-409)."""
    if not isinstance(payload, dict):
        raise ValidationError("run payload must be an object")
    base = dict(existing or {})
    out = {**base, **payload}
    name = str(out.get("name") or "").strip()
    scene = str(out.get("scene") or "").strip()
    run_date = str(out.get("runDate") or "").strip()
    if not name:
        raise ValidationError("run name is required")
    if not scene:
        raise ValidationError("scene is required")
    if not run_date:
        raise ValidationError("runDate is required (YYYY-MM-DD)")
    out["name"] = name
    out["scene"] = scene
    out["runDate"] = run_date
    out.setdefault("params", {})
    out.setdefault("steps", [])
    out["id"] = safe_id(base.get("id") or out.get("id") or new_id())
    out["createdAt"] = base.get("createdAt") or out.get("createdAt") or now_ms()
    out["updatedAt"] = now_ms()
    if not isinstance(out["steps"], list):
        raise ValidationError("steps must be a list")
    return out


def normalize_step(payload: dict) -> dict:
    if not isinstance(payload, dict):
        raise ValidationError("step payload must be an object")
    out = dict(payload)
    if "step" not in out:
        raise ValidationError("step index is required")
    out["step"] = int(out["step"])
    out.setdefault("recordedAt", now_ms())
    out["id"] = safe_id(out.get("id") or new_id())
    return out


def assert_date_capacity(runs: list[dict], run_date: str, exclude_id=None):
    n = sum(
        1
        for r in runs
        if r.get("runDate") == run_date and r.get("id") != exclude_id
    )
    if n >= MAX_RUNS_PER_DATE:
        raise ConflictError(
            f"limit of {MAX_RUNS_PER_DATE} runs for {run_date} reached"
        )


def assert_unique_step(run: dict, step_index: int, exclude_id=None):
    """One metrics row per step index (the analogue of the reference's
    one-entry-per-operator rule, sqlProvider.js:434-457)."""
    for s in run.get("steps", []):
        if s.get("step") == step_index and s.get("id") != exclude_id:
            raise ConflictError(f"step {step_index} already recorded")


def split_archivable(runs: list[dict], auto_archive_hours: float, now=None):
    """Group active runs by date; groups whose EARLIEST createdAt is older
    than the window archive wholesale (reference semantics,
    sqlProvider.js:758-833). Returns (keep, archive)."""
    now = now_ms() if now is None else now
    window_ms = auto_archive_hours * 3600 * 1000
    groups: dict[str, list[dict]] = {}
    for r in runs:
        groups.setdefault(r.get("runDate", ""), []).append(r)
    keep, archive = [], []
    for date, group in groups.items():
        earliest = min(r.get("createdAt", now) for r in group)
        if now - earliest >= window_ms:
            archive.extend(group)
        else:
            keep.extend(group)
    return keep, archive


def is_expired(archived_run: dict, retention_months: float, now=None) -> bool:
    now = now_ms() if now is None else now
    created = archived_run.get("createdAt", now)
    return now - created >= retention_months * _MONTH_S * 1000


def normalize_calendar_event(ev: dict) -> dict:
    """Minimal calendar-event shape (reference: calendarFeed.js:52-80 +
    sqlProvider upsert columns :940-968)."""
    if not isinstance(ev, dict) or not ev.get("id"):
        raise ValidationError("calendar event needs an id")
    out = dict(ev)
    out["id"] = str(out["id"])[:128]
    out.setdefault("title", "")
    out.setdefault("start", None)
    out.setdefault("end", None)
    return out


MUTATORS = (
    "create_run", "update_run", "replace_run", "delete_run",
    "add_step", "update_step", "delete_step",
    "archive_run_now", "run_archive_maintenance",
    "sync_calendar_events",
)


def lock_mutators(cls, names=MUTATORS):
    """Wrap a provider's mutating methods (or ``names``) in its self._mutex:
    API handler threads and the run executor perform read-modify-write on
    the same records (the reference's sql.js store has the equivalent
    unguarded last-writer-wins race — SURVEY.md section 5)."""

    def locked(fn):
        @functools.wraps(fn)
        def wrapper(self, *a, **kw):
            with self._mutex:
                return fn(self, *a, **kw)

        return wrapper

    for name in names:
        setattr(cls, name, locked(getattr(cls, name)))
    return cls
