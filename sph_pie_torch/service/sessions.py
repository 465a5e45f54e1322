"""In-memory session store.

Counterpart of sphereisaiahmin-dev/sph-pie `server/sessionStore.js`:
opaque 48-byte tokens stored only as SHA-256 hashes, 12 h TTL with lazy
expiry on read, deliberate non-persistence (restart logs everyone out).
"""

from __future__ import annotations

import hashlib
import secrets
import time

SESSION_TTL_S = 12 * 3600
COOKIE_NAME = "sph_session"


def _hash(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()


class SessionStore:
    def __init__(self, ttl_s: float = SESSION_TTL_S):
        self.ttl = ttl_s
        self._sessions: dict[str, dict] = {}

    def create(self, user_id: str) -> str:
        token = secrets.token_urlsafe(48)
        now = time.time()
        self._sessions[_hash(token)] = {
            "userId": user_id,
            "createdAt": now,
            "expiresAt": now + self.ttl,
        }
        return token

    def get(self, token: str) -> dict | None:
        rec = self._sessions.get(_hash(token or ""))
        if rec is None:
            return None
        if rec["expiresAt"] < time.time():  # lazy expiry on read
            del self._sessions[_hash(token)]
            return None
        return dict(rec)

    def touch(self, token: str):
        rec = self._sessions.get(_hash(token or ""))
        if rec:
            rec["expiresAt"] = time.time() + self.ttl

    def delete(self, token: str):
        self._sessions.pop(_hash(token or ""), None)

    def delete_for_user(self, user_id: str):
        self._sessions = {
            k: v for k, v in self._sessions.items() if v["userId"] != user_id
        }

    def purge_expired(self):
        now = time.time()
        self._sessions = {
            k: v for k, v in self._sessions.items() if v["expiresAt"] >= now
        }

    def count(self) -> int:
        return len(self._sessions)
