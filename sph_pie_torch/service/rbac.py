"""Role/domain-based access control.

Counterpart of sphereisaiahmin-dev/sph-pie `server/disciplineConfig.js`:
roles are ``admin`` plus ``<domain>.<level>`` keys over a static JSON
config of domains x levels, with legacy single-word aliases resolving to
the default domain. Domains here are the framework's functional areas
(simulation / rendering / analysis ...) rather than venue departments.
"""

from __future__ import annotations

import json
from pathlib import Path

DEFAULT_CONFIG = {
    "levels": ["lead", "operator", "crew"],
    "domains": [
        {"id": "simulation", "label": "Simulation", "default": True, "forms": True},
        {"id": "rendering", "label": "Rendering"},
        {"id": "analysis", "label": "Analysis"},
        {"id": "infrastructure", "label": "Infrastructure"},
    ],
}

LEGACY_ALIASES = {"lead": "lead", "operator": "operator", "crew": "crew",
                  "stagecrew": "crew"}


class RoleConfig:
    def __init__(self, path: str | None = "config/roles.json"):
        cfg = DEFAULT_CONFIG
        if path and Path(path).exists():
            try:
                cfg = json.loads(Path(path).read_text())
            except (json.JSONDecodeError, OSError):
                cfg = DEFAULT_CONFIG
        self.levels: list[str] = list(cfg.get("levels", DEFAULT_CONFIG["levels"]))
        self.domains: list[dict] = list(cfg.get("domains", DEFAULT_CONFIG["domains"]))

    @property
    def default_domain(self) -> dict:
        for d in self.domains:
            if d.get("default"):
                return d
        return self.domains[0]

    def find_domain(self, domain_id: str) -> dict | None:
        for d in self.domains:
            if d["id"] == domain_id:
                return d
        return None

    def role_key(self, domain_id: str, level: str) -> str:
        return f"{domain_id}.{level}"

    def list_role_keys(self) -> list[str]:
        keys = ["admin"]
        for d in self.domains:
            keys += [self.role_key(d["id"], lv) for lv in self.levels]
        return keys

    def normalize_role(self, role) -> str | None:
        """Accept canonical keys, admin, and legacy single-word aliases
        (mapped onto the default domain — disciplineConfig.js:58-63)."""
        r = str(role or "").strip().lower()
        if not r:
            return None
        if r == "admin":
            return "admin"
        if r in LEGACY_ALIASES:
            return self.role_key(self.default_domain["id"], LEGACY_ALIASES[r])
        if r in self.list_role_keys():
            return r
        return None

    def parse_role_key(self, role: str):
        if role == "admin":
            return ("admin", None)
        if "." in role:
            domain, level = role.split(".", 1)
            if self.find_domain(domain) and level in self.levels:
                return (domain, level)
        return (None, None)

    def role_matches_level(self, role: str, level: str) -> bool:
        return self.parse_role_key(role)[1] == level

    def role_matches_domain(self, role: str, domain_id: str) -> bool:
        return self.parse_role_key(role)[0] == domain_id

    def display_name(self, role: str) -> str:
        if role == "admin":
            return "Admin"
        domain, level = self.parse_role_key(role)
        if not domain:
            return role
        d = self.find_domain(domain)
        return f"{d.get('label', domain)} {level.title()}"


def user_has_role(user: dict, *wanted: str) -> bool:
    """Admin bypasses every check (reference: server/index.js:649-672)."""
    roles = set(user.get("roles", []))
    if "admin" in roles:
        return True
    return any(r in roles for r in wanted)


def is_operator_only(user: dict, cfg: RoleConfig) -> bool:
    """True when the user's only non-crew capability is operator-level
    (reference: isOperatorOnly, server/index.js:564-579 — such users get
    their identity forced onto records they create)."""
    roles = [r for r in user.get("roles", []) if r != "admin"]
    if "admin" in user.get("roles", []):
        return False
    levels = {cfg.parse_role_key(r)[1] for r in roles}
    return "operator" in levels and "lead" not in levels
