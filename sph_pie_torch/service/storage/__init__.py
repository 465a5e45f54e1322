"""Provider registry: selection + hot swap.

Counterpart of sphereisaiahmin-dev/sph-pie `server/storage/index.js:7-49`
(singleton select/init/dispose), reworked as an explicit registry object —
no module-level global (SURVEY.md §7.4).
"""

from __future__ import annotations

import os

from sph_pie_torch.service.storage.base import ConflictError, ValidationError
from sph_pie_torch.service.storage.jsonfile_provider import JsonFileProvider
from sph_pie_torch.service.storage.sqlite_provider import SqliteProvider

_ALIASES = {
    "sqlite": "sqlite",
    "sqljs": "sqlite",       # legacy spelling accepted (reference default)
    "jsonfile": "jsonfile",
    "json": "jsonfile",
    "piedb": "piedb",        # networked engine (C++ server + pooled client)
    "postgres": "piedb",     # legacy configs map to the networked engine
    "postgresql": "piedb",
}


class ProviderRegistry:
    """Owns the active provider; re-init disposes the old one
    (reference: storage/index.js:24-26)."""

    def __init__(self, on_event=None):
        self.on_event = on_event
        self._provider = None
        self._type = None

    def init_provider(self, config: dict):
        requested = str(config.get("storageProvider", "sqlite")).lower()
        ptype = _ALIASES.get(requested, "sqlite")
        opts = dict(config.get(ptype, {}))
        opts.setdefault(
            "autoArchiveHours", config.get("archive", {}).get("autoArchiveHours", 12)
        )
        opts.setdefault(
            "retentionMonths", config.get("archive", {}).get("retentionMonths", 2)
        )
        if self._provider is not None:
            self._provider.dispose()
        if ptype == "piedb":
            from sph_pie_torch.service.storage.piedb_provider import PieDbProvider

            cls = PieDbProvider
            # default to a locally-spawned server unless an address is
            # configured (PIEDB_HOST env or explicit host in config)
            if "host" not in opts and "PIEDB_HOST" not in os.environ:
                opts.setdefault("spawn", True)
                opts.setdefault("port", 0)
        else:
            cls = SqliteProvider if ptype == "sqlite" else JsonFileProvider
        self._provider = cls(opts, on_event=self.on_event).init()
        self._type = ptype
        return self._provider

    def get_provider(self):
        if self._provider is None:
            raise RuntimeError("storage provider accessed before init")
        return self._provider

    def get_active_provider_type(self):
        return self._type


__all__ = [
    "ConflictError",
    "JsonFileProvider",
    "ProviderRegistry",
    "SqliteProvider",
    "ValidationError",
]
