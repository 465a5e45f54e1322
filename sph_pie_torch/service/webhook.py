"""Outbound webhook event egress.

Counterpart of sphereisaiahmin-dev/sph-pie `server/webhookDispatcher.js`:
a verification handshake (HEAD -> OPTIONS -> GET with method fallback),
a schemaVersion-2 payload envelope carrying a flat metrics table + CSV +
human message, per-record fan-out on archive events, bearer-secret auth,
and a self-timing verification state machine. Implemented on stdlib
urllib (zero-dependency); no module-level singleton — the app owns a
``WebhookDispatcher`` instance.
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request

from sph_pie_torch.service.metrics import METRIC_COLUMNS

SCHEMA_VERSION = 2
HANDSHAKE_METHODS = ("HEAD", "OPTIONS", "GET")


def csv_escape(value) -> str:
    """Reference-compatible CSV quoting (webhookDispatcher.js:332-342)."""
    s = "" if value is None else str(value)
    if any(c in s for c in ",\"\n"):
        s = '"' + s.replace('"', '""') + '"'
    return s


def build_csv(columns, rows) -> str:
    buf = io.StringIO()
    buf.write(",".join(csv_escape(c) for c in columns) + "\n")
    for row in rows:
        buf.write(",".join(csv_escape(v) for v in row) + "\n")
    return buf.getvalue()


class WebhookDispatcher:
    def __init__(self, config: dict | None = None, opener=None):
        self.opener = opener or urllib.request.urlopen
        self.config: dict = {}
        self.state: dict = self._fresh_state()
        if config:
            self.set_config(config)

    @staticmethod
    def _fresh_state() -> dict:
        return {
            "verified": False,
            "method": None,
            "status": None,
            "detail": "not configured",
            "durationMs": None,
            "lastEvent": None,
            "lastError": None,
            "sent": 0,
            "failed": 0,
        }

    # -- config + handshake ------------------------------------------------
    def set_config(self, config: dict) -> dict:
        self.config = dict(config or {})
        self.state = self._fresh_state()
        if self.enabled:
            self.verify_connection()
        return self.state

    @property
    def enabled(self) -> bool:
        return bool(self.config.get("enabled")) and bool(self.config.get("url"))

    def verify_connection(self) -> dict:
        """HEAD -> OPTIONS -> GET probe; any status < 500 counts as
        reachable, 405/501 advances to the next method
        (reference: webhookDispatcher.js:147-244)."""
        url = self.config.get("url", "")
        timeout = float(self.config.get("handshakeTimeoutSeconds", 5))
        t0 = time.time()
        last_detail = "unreachable"
        for method in HANDSHAKE_METHODS:
            status = self._probe(url, method, timeout)
            if status is None:
                last_detail = f"{method} failed"
                continue
            if status in (405, 501):
                last_detail = f"{method} not allowed ({status})"
                continue
            if status < 500:
                self.state.update(
                    verified=True,
                    method=method,
                    status=status,
                    detail=f"{method} {status}",
                    durationMs=int((time.time() - t0) * 1000),
                )
                return self.state
            last_detail = f"{method} {status}"
        self.state.update(
            verified=False,
            detail=last_detail,
            durationMs=int((time.time() - t0) * 1000),
        )
        return self.state

    def _probe(self, url, method, timeout):
        req = urllib.request.Request(url, method=method, headers=self._headers())
        try:
            with self.opener(req, timeout=timeout) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code
        except Exception:
            return None

    def get_status(self) -> dict:
        return {"enabled": self.enabled, **self.state}

    # -- payloads ----------------------------------------------------------
    def _headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        headers.update(self.config.get("headers") or {})
        secret = self.config.get("secret")
        if secret and "Authorization" not in headers:
            headers["Authorization"] = f"Bearer {secret}"
        return headers

    def build_metric_rows(self, run: dict) -> list[list]:
        rows = []
        for s in sorted(run.get("steps", []), key=lambda s: s.get("step", 0)):
            rows.append([s.get(c, "") for c in METRIC_COLUMNS])
        return rows

    def build_payload(self, event: str, run: dict, meta=None) -> dict:
        rows = self.build_metric_rows(run)
        message = (
            f"{event}: run '{run.get('name')}' ({run.get('scene')}) on "
            f"{run.get('runDate')} with {len(rows)} recorded steps"
        )
        return {
            "schemaVersion": SCHEMA_VERSION,
            "event": event,
            "table": {"columns": list(METRIC_COLUMNS), "rows": rows},
            "csv": build_csv(METRIC_COLUMNS, rows),
            "message": message,
            "run": {k: v for k, v in run.items() if k != "steps"},
            "metrics": run.get("steps", []),
            "meta": meta or {},
        }

    def build_archive_step_payload(self, run: dict, step: dict, meta=None) -> dict:
        """Reduced per-step payload for archive fan-out
        (reference: one POST per entry, webhookDispatcher.js:315-330,519-554)."""
        return {
            "schemaVersion": SCHEMA_VERSION,
            "event": "run.archived",
            "run": {
                "id": run.get("id"),
                "name": run.get("name"),
                "scene": run.get("scene"),
                "runDate": run.get("runDate"),
            },
            "step": step,
            "meta": meta or {},
        }

    # -- dispatch ----------------------------------------------------------
    def dispatch_run_event(self, event: str, run: dict, meta=None) -> bool:
        if not self.enabled:
            return False
        payload = self.build_payload(event, run, meta)
        return self._send(payload)

    def dispatch_archive_event(self, run: dict, meta=None) -> dict:
        """run.archived fans out one POST per recorded step."""
        if not self.enabled:
            return {"sent": 0, "failed": 0}
        sent = failed = 0
        for step in run.get("steps", []):
            ok = self._send(self.build_archive_step_payload(run, step, meta))
            sent += ok
            failed += not ok
        if not run.get("steps"):
            self._send(self.build_payload("run.archived", run, meta))
            sent += 1
        return {"sent": sent, "failed": failed}

    def _send(self, payload: dict) -> bool:
        url = self.config.get("url", "")
        timeout = float(self.config.get("timeoutSeconds", 8))
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            method="POST",
            headers=self._headers(),
        )
        t0 = time.time()
        try:
            with self.opener(req, timeout=timeout) as resp:
                ok = 200 <= resp.status < 300
        except urllib.error.HTTPError as e:
            ok = False
            self.state["lastError"] = f"HTTP {e.code}"
        except Exception as e:
            ok = False
            self.state["lastError"] = f"{type(e).__name__}: {e}"
        self.state["durationMs"] = int((time.time() - t0) * 1000)
        self.state["lastEvent"] = payload.get("event")
        self.state["sent" if ok else "failed"] += 1
        return ok
