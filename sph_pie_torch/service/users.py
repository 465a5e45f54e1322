"""File-backed user directory with scrypt credentials.

Counterpart of sphereisaiahmin-dev/sph-pie `server/userStore.js`: JSON
file persistence, scrypt password hashing (N=16384, r=8, p=1, dklen=64,
16-byte random salt — userStore.js:21,136-147), timing-safe verification,
a strong password policy, temp-password + forced-reset flow, and a
role-keyed staff directory derived from the user list. Seed accounts are
generic service roles, not people.
"""

from __future__ import annotations

import hmac
import json
import os
import re
import uuid
from pathlib import Path

from sph_pie_torch.service.rbac import RoleConfig
from sph_pie_torch.service.storage.base import ConflictError, ValidationError, now_ms

SCRYPT = {"n": 16384, "r": 8, "p": 1, "dklen": 64}
SALT_BYTES = 16
DEFAULT_TEMP_PASSWORD = "change-me-now-1!"

PASSWORD_RULES = (
    (re.compile(r".{12,}"), "at least 12 characters"),
    (re.compile(r"[a-z]"), "a lowercase letter"),
    (re.compile(r"[A-Z]"), "an uppercase letter"),
    (re.compile(r"\d"), "a digit"),
    (re.compile(r"[^A-Za-z0-9]"), "a symbol"),
)

DEFAULT_SEED = [
    {"name": "Administrator", "email": "admin@local", "roles": ["admin"]},
    {"name": "Sim Lead", "email": "sim.lead@local", "roles": ["simulation.lead"]},
    {
        "name": "Sim Operator",
        "email": "sim.operator@local",
        "roles": ["simulation.operator"],
    },
    {"name": "Render Crew", "email": "render.crew@local", "roles": ["rendering.crew"]},
]


def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or os.urandom(SALT_BYTES)
    key = __import__("hashlib").scrypt(password.encode(), salt=salt, **SCRYPT)
    return f"{salt.hex()}:{key.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        salt_hex, key_hex = stored.split(":", 1)
        key = __import__("hashlib").scrypt(
            password.encode(), salt=bytes.fromhex(salt_hex), **SCRYPT
        )
        return hmac.compare_digest(key.hex(), key_hex)  # timing-safe
    except (ValueError, TypeError):
        return False


def check_password_policy(password: str):
    missing = [msg for rx, msg in PASSWORD_RULES if not rx.search(password or "")]
    if missing:
        raise ValidationError("password needs " + ", ".join(missing))


class UserStore:
    def __init__(
        self,
        path: str | os.PathLike = "data/users.json",
        role_config: RoleConfig | None = None,
        temp_password: str = DEFAULT_TEMP_PASSWORD,
    ):
        self.path = Path(path)
        self.roles = role_config or RoleConfig(None)
        self.temp_password = temp_password
        self.users: list[dict] = []

    # -- persistence -------------------------------------------------------
    def init(self):
        if self.path.exists():
            try:
                self.users = json.loads(self.path.read_text())
                if not isinstance(self.users, list):
                    raise ValueError
            except (json.JSONDecodeError, ValueError, OSError):
                self.users = []  # corrupt file -> reseed (userStore.js:82-86)
        if not self.users:
            self._seed()
        return self

    def _persist(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.users, indent=2))
        tmp.replace(self.path)

    def _seed(self):
        temp_hash = hash_password(self.temp_password)
        self.users = [
            {
                "id": str(uuid.uuid4()),
                "name": u["name"],
                "email": u["email"],
                "roles": u["roles"],
                "password": temp_hash,
                "needsPasswordReset": True,
                "createdAt": now_ms(),
            }
            for u in DEFAULT_SEED
        ]
        self._persist()

    # -- queries -----------------------------------------------------------
    def find_by_email(self, email: str) -> dict | None:
        e = str(email or "").strip().lower()
        for u in self.users:
            if u["email"].lower() == e:
                return u
        return None

    def find_by_id(self, user_id: str) -> dict | None:
        for u in self.users:
            if u["id"] == user_id:
                return u
        return None

    def list_users(self) -> list[dict]:
        return [self.sanitize(u) for u in self.users]

    @staticmethod
    def sanitize(user: dict) -> dict:
        return {k: v for k, v in user.items() if k != "password"}

    def role_directory(self) -> dict[str, list[str]]:
        """role key -> member names (reference: getRoleDirectory,
        userStore.js:330-344)."""
        out: dict[str, list[str]] = {}
        for u in self.users:
            for r in u.get("roles", []):
                out.setdefault(r, []).append(u["name"])
        return {k: sorted(v) for k, v in out.items()}

    # -- mutations ---------------------------------------------------------
    def _validate(self, payload: dict, exclude_id=None) -> dict:
        name = str(payload.get("name") or "").strip()
        email = str(payload.get("email") or "").strip().lower()
        if not name:
            raise ValidationError("name is required")
        if not re.match(r"^[^@\s]+@[^@\s]+$", email):
            raise ValidationError("valid email is required")
        existing = self.find_by_email(email)
        if existing and existing["id"] != exclude_id:
            raise ConflictError("email already in use")  # 409 (userStore.js:221)
        roles = []
        for r in payload.get("roles") or []:
            norm = self.roles.normalize_role(r)
            if norm is None:
                raise ValidationError(f"unknown role: {r}")
            if norm not in roles:
                roles.append(norm)
        if not roles:
            raise ValidationError("at least one role is required")
        return {"name": name, "email": email, "roles": roles}

    def create_user(self, payload: dict) -> dict:
        clean = self._validate(payload)
        user = {
            "id": str(uuid.uuid4()),
            **clean,
            "password": hash_password(self.temp_password),
            "needsPasswordReset": True,
            "createdAt": now_ms(),
        }
        self.users.append(user)
        self._persist()
        return self.sanitize(user)

    def update_user(self, user_id: str, payload: dict) -> dict:
        user = self.find_by_id(user_id)
        if user is None:
            raise KeyError(user_id)
        clean = self._validate({**user, **payload}, exclude_id=user_id)
        user.update(clean)
        self._persist()
        return self.sanitize(user)

    def delete_user(self, user_id: str) -> dict:
        user = self.find_by_id(user_id)
        if user is None:
            raise KeyError(user_id)
        self.users = [u for u in self.users if u["id"] != user_id]
        self._persist()
        return self.sanitize(user)

    def set_password(self, user_id: str, new_password: str) -> dict:
        user = self.find_by_id(user_id)
        if user is None:
            raise KeyError(user_id)
        check_password_policy(new_password)
        user["password"] = hash_password(new_password)
        user["needsPasswordReset"] = False
        self._persist()
        return self.sanitize(user)

    def reset_password(self, user_id: str) -> dict:
        """Back to the temp password + forced reset (userStore.js:303-315)."""
        user = self.find_by_id(user_id)
        if user is None:
            raise KeyError(user_id)
        user["password"] = hash_password(self.temp_password)
        user["needsPasswordReset"] = True
        self._persist()
        return self.sanitize(user)

    def authenticate(self, email: str, password: str) -> dict | None:
        user = self.find_by_email(email)
        if user and verify_password(password, user["password"]):
            return user
        return None
