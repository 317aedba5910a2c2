"""Signed session cookies for the dashboard login (port of
gorse_tpu/serve/oidc.py's ``SessionManager``).

``SessionManager`` issues and verifies HMAC-signed session values with an
expiry, as gorilla/securecookie does for gorse's dashboard
(master/rest.go:285-287), with a key drawn per process. The OpenID Connect
client (``OIDCClient``) verifies RS256 id tokens with ``cryptography``,
which the port does not use: ``oidc.enable = true`` raises in
``MasterRestServer`` (ROADMAP.md, M21).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import time


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class SessionManager:
    """HMAC-signed session values (reference: securecookie, master/rest.go:285)."""

    COOKIE = "gorse_session"

    def __init__(self, ttl: float = 3600.0, secret: bytes | None = None) -> None:
        self._secret = secret or secrets.token_bytes(32)
        self._ttl = ttl

    def issue(self, user_info: dict) -> str:
        payload = _b64url(
            json.dumps({"u": user_info, "exp": time.time() + self._ttl}).encode()
        )
        sig = _b64url(hmac.new(self._secret, payload.encode(), hashlib.sha256).digest())
        return f"{payload}.{sig}"

    def verify(self, token: str) -> dict | None:
        """Returns the user-info dict, or None when invalid/expired."""
        try:
            payload, sig = token.split(".", 1)
            want = _b64url(hmac.new(self._secret, payload.encode(), hashlib.sha256).digest())
            if not hmac.compare_digest(sig, want):
                return None
            data = json.loads(_b64url_decode(payload))
            if data["exp"] < time.time():
                return None
            return data["u"]
        except (ValueError, KeyError):
            return None

    def from_cookie_header(self, cookie_header: str | None) -> dict | None:
        if not cookie_header:
            return None
        for part in cookie_header.split(";"):
            name, _, value = part.strip().partition("=")
            if name == self.COOKIE:
                return self.verify(value)
        return None
