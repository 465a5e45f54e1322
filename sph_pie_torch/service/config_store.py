"""Layered app configuration: defaults <- persisted JSON <- env overrides.

Mirrors the reference's three-tier config system (SURVEY.md §5; behavior of
sphereisaiahmin-dev/sph-pie `server/configStore.js:5-101`): a defaults
record deep-merged with a persisted, auto-created JSON file, environment
variables winning over both, plus tolerance for legacy key spellings.
No module-level singleton — callers own the store instance (SURVEY.md
§7.4 flags the reference's singletons as an anti-pattern to avoid).
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path

DEFAULTS: dict = {
    "host": "127.0.0.1",
    "port": 8411,
    "unitLabel": "Particle",
    "storageProvider": "sqlite",       # sqlite | jsonfile | piedb
    "sqlite": {"filename": "data/sph_pie.sqlite"},
    "jsonfile": {"directory": "data/runs"},
    "piedb": {
        # networked engine: empty host => spawn a local server on an
        # ephemeral port (PIEDB_HOST/PIEDB_PORT/PIEDB_DATABASE env win;
        # pool settings mirror the reference's pg pool defaults,
        # configStore.js:20-22)
        "database": "sph_pie",
        "dataDir": "data/piedb",
        "pool": {"max": 10},
    },
    "archive": {
        "autoArchiveHours": 12,        # reference: 12 h after first run of a date
        "retentionMonths": 2,          # reference: 2-month archive retention
    },
    "webhook": {
        "enabled": False,
        "url": "",
        "secret": "",
        "headers": {},
        "timeoutSeconds": 8,
        "handshakeTimeoutSeconds": 5,
    },
    "scene": {"default": "dam_break_2d", "epochSteps": 50},
    "calendar": {"feedUrl": ""},
}

ENV_OVERRIDES = {
    "SPH_PIE_HOST": ("host", str),
    "HOST": ("host", str),
    "SPH_PIE_PORT": ("port", int),
    "PORT": ("port", int),
    "STORAGE_PROVIDER": ("storageProvider", str),
    "SPH_PIE_DB": ("sqlite.filename", str),
    "WEBHOOK_URL": ("webhook.url", str),
    "CALENDAR_FEED_URL": ("calendar.feedUrl", str),
}

# Legacy spellings accepted on read and rewritten to the canonical keys
# (the reference migrates `provider` / `storage.*` the same way,
# configStore.js:49-60).
LEGACY_KEYS = {
    "provider": "storageProvider",
    "db": "sqlite",
    "unit_label": "unitLabel",
}


def _deep_merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_path(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


class ConfigStore:
    """Owns one JSON config file; auto-creates it with defaults on first load."""

    def __init__(self, path: str | os.PathLike = "config/app-config.json", env=None):
        self.path = Path(path)
        self.env = dict(os.environ if env is None else env)

    def load(self) -> dict:
        persisted: dict = {}
        if self.path.exists():
            try:
                persisted = json.loads(self.path.read_text() or "{}")
            except (json.JSONDecodeError, OSError):
                persisted = {}  # corrupt config -> fall back to defaults
        persisted = self._migrate(persisted)
        cfg = _deep_merge(DEFAULTS, persisted)
        for env_key, (dotted, cast) in ENV_OVERRIDES.items():
            if env_key in self.env and str(self.env[env_key]).strip():
                try:
                    _set_path(cfg, dotted, cast(self.env[env_key]))
                except (TypeError, ValueError):
                    pass
        if not self.path.exists():
            self.save(cfg)
        return cfg

    def save(self, cfg: dict) -> dict:
        cfg = _deep_merge(DEFAULTS, self._migrate(cfg))
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(cfg, indent=2, sort_keys=True) + "\n")
        tmp.replace(self.path)  # atomic on POSIX
        return cfg

    @staticmethod
    def _migrate(cfg: dict) -> dict:
        out = dict(cfg or {})
        for old, new in LEGACY_KEYS.items():
            if old in out and new not in out:
                out[new] = out.pop(old)
        return out
