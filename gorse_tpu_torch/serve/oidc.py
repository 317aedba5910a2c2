"""OIDC sign-on for the dashboard and signed session cookies (port of
gorse_tpu/serve/oidc.py).

- ``SessionManager``: HMAC-signed session values with an expiry, as
  gorilla/securecookie does for gorse's dashboard (master/rest.go:285-287),
  with a key drawn per process.
- ``OIDCClient``: OpenID Connect discovery, the CSRF state, the
  authorization URL, the code exchange and RS256 id-token verification
  against the provider's JWKS (gorse: master/master.go:402-418,
  master/rest.go:369-418), with the reference's ``iss``, ``aud`` and
  ``exp`` checks.
- ``MockOIDCProvider``: an in-process issuer (discovery, /auth, /token,
  JWKS) signing real RS256 id tokens; the test backend.

RSA is written here in the standard library (the reference package uses
``cryptography``). :func:`rs256_verify` checks that the signature is as
long as the modulus and below it, computes ``s^e mod n`` and compares the
WHOLE encoded message with the one it expects, ``00 01 FF..FF 00 ||
DigestInfo(SHA-256) || H`` (RFC 8017, EMSA-PKCS1-v1_5), with
``hmac.compare_digest``: it never parses the padding, which is how loose
verifiers accept forged signatures. :func:`generate_rsa_key` draws the
mock's primes by Miller-Rabin from a ``random.Random`` (seeded in the
tests; the system's randomness otherwise).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import math
import random
import secrets
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


# --------------------------------------------------------------------------
# RSA: RS256 (RSASSA-PKCS1-v1_5 with SHA-256)

# DER of DigestInfo { AlgorithmIdentifier { sha256, NULL }, OCTET STRING(32) }
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_SMALL_PRIMES = [p for p in range(3, 2000) if all(p % d for d in range(2, int(p ** 0.5) + 1))]


def emsa_pkcs1_v15_sha256(message: bytes, k: int) -> bytes:
    """The ``k``-byte encoded message of RFC 8017 section 9.2 for SHA-256."""
    t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        raise ValueError("RSA modulus too short for an RS256 signature")
    return b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


def rs256_verify(n: int, e: int, message: bytes, signature: bytes) -> bool:
    """True when ``signature`` is the RS256 signature of ``message`` under
    the public key ``(n, e)``."""
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    return hmac.compare_digest(em, emsa_pkcs1_v15_sha256(message, k))


@dataclasses.dataclass(frozen=True)
class RSAKey:
    """An RSA private key: the modulus, both exponents and the primes."""

    n: int
    e: int
    d: int
    p: int
    q: int

    def sign(self, message: bytes) -> bytes:
        """The RS256 signature of ``message`` (by the CRT)."""
        k = (self.n.bit_length() + 7) // 8
        m = int.from_bytes(emsa_pkcs1_v15_sha256(message, k), "big")
        s1 = pow(m, self.d % (self.p - 1), self.p)
        s2 = pow(m, self.d % (self.q - 1), self.q)
        h = (pow(self.q, -1, self.p) * (s1 - s2)) % self.p
        return (s2 + h * self.q).to_bytes(k, "big")


def is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    """Trial division by the primes under 2,000, then ``rounds`` rounds of
    Miller-Rabin with bases drawn from ``rng``."""
    if n < 2:
        return False
    for p in [2] + _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int, e: int, rng: random.Random) -> int:
    while True:
        # the top two bits set, so that two such primes make a full-width n
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (c - 1) % e and is_probable_prime(c, rng):
            return c


def generate_rsa_key(bits: int = 2048, e: int = 65537,
                     rng: random.Random | None = None) -> RSAKey:
    """An RSA key of ``bits`` bits: two Miller-Rabin primes of half the
    width each, ``d = e^-1 mod lcm(p-1, q-1)``."""
    rng = rng or random.SystemRandom()
    while True:
        p, q = _prime(bits // 2, e, rng), _prime(bits - bits // 2, e, rng)
        if p == q:
            continue
        n = p * q
        if n.bit_length() != bits:
            continue
        lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
        return RSAKey(n=n, e=e, d=pow(e, -1, lam), p=max(p, q), q=min(p, q))


def _int_b64(x: int) -> str:
    return _b64url(x.to_bytes((x.bit_length() + 7) // 8, "big"))


# --------------------------------------------------------------------------
# session cookies


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


# --------------------------------------------------------------------------
# OIDC relying party


class OIDCClient:
    """Authorization-code flow client (reference: master/master.go:402-418)."""

    def __init__(self, issuer: str, client_id: str, client_secret: str, redirect_url: str) -> None:
        self.issuer = issuer.rstrip("/")
        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_url = redirect_url
        self._discovery: dict | None = None
        self._jwks: dict | None = None
        self._states: dict[str, float] = {}
        self._lock = threading.Lock()

    def _get_json(self, url: str) -> dict:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.loads(resp.read().decode())

    @property
    def discovery(self) -> dict:
        if self._discovery is None:
            self._discovery = self._get_json(
                self.issuer + "/.well-known/openid-configuration"
            )
        return self._discovery

    def new_state(self) -> str:
        """CSRF state nonce, valid for 10 minutes."""
        state = secrets.token_urlsafe(16)
        with self._lock:
            now = time.time()
            self._states = {s: t for s, t in self._states.items() if now - t < 600}
            self._states[state] = now
        return state

    def check_state(self, state: str) -> bool:
        with self._lock:
            return self._states.pop(state, None) is not None

    def auth_url(self, state: str) -> str:
        q = urllib.parse.urlencode(
            {
                "response_type": "code",
                "client_id": self.client_id,
                "redirect_uri": self.redirect_url,
                "scope": "openid profile email",
                "state": state,
            }
        )
        return f"{self.discovery['authorization_endpoint']}?{q}"

    def exchange(self, code: str) -> dict:
        """Exchange an authorization code; returns verified id_token claims."""
        body = urllib.parse.urlencode(
            {
                "grant_type": "authorization_code",
                "code": code,
                "redirect_uri": self.redirect_url,
                "client_id": self.client_id,
                "client_secret": self.client_secret,
            }
        ).encode()
        req = urllib.request.Request(
            self.discovery["token_endpoint"],
            data=body,
            headers={"Content-Type": "application/x-www-form-urlencoded"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            tokens = json.loads(resp.read().decode())
        return self.verify_id_token(tokens["id_token"])

    # --- id_token verification (the oidc.Verifier analog)

    def _key_for(self, kid: str | None) -> tuple[int, int]:
        """``(n, e)`` of the JWKS key named ``kid`` (the first key when the
        token names none)."""
        if self._jwks is None:
            self._jwks = self._get_json(self.discovery["jwks_uri"])
        for jwk in self._jwks.get("keys", []):
            if kid is not None and jwk.get("kid") != kid:
                continue
            n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
            e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
            return n, e
        raise ValueError(f"no JWKS key matching kid={kid!r}")

    def verify_id_token(self, token: str) -> dict:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") != "RS256":
            raise ValueError(f"unsupported id_token alg {header.get('alg')!r}")
        n, e = self._key_for(header.get("kid"))
        if not rs256_verify(n, e, f"{header_b64}.{payload_b64}".encode(),
                            _b64url_decode(sig_b64)):
            raise ValueError("invalid id_token signature")
        claims = json.loads(_b64url_decode(payload_b64))
        if claims.get("iss", "").rstrip("/") != self.issuer:
            raise ValueError(f"issuer mismatch: {claims.get('iss')!r}")
        aud = claims.get("aud")
        if self.client_id not in (aud if isinstance(aud, list) else [aud]):
            raise ValueError("audience mismatch")
        if claims.get("exp", 0) < time.time():
            raise ValueError("id_token expired")
        return claims


# --------------------------------------------------------------------------
# mock provider (test backend)


class MockOIDCProvider:
    """In-process OIDC issuer signing real RS256 id_tokens; ``seed`` makes
    its key reproducible."""

    KID = "mock-1"

    def __init__(self, client_id: str = "gorse", client_secret: str = "secret",
                 user: dict | None = None, host: str = "127.0.0.1", port: int = 0,
                 seed: int | None = None) -> None:
        self.client_id = client_id
        self.client_secret = client_secret
        self.user = user or {"sub": "u-test", "name": "Test User", "email": "test@example.com"}
        self._key = generate_rsa_key(rng=random.Random(seed) if seed is not None else None)
        self._codes: dict[str, dict] = {}
        provider = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, payload: dict, status: int = 200) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/.well-known/openid-configuration":
                    self._json(provider.discovery())
                elif parsed.path == "/keys":
                    self._json(provider.jwks())
                elif parsed.path == "/auth":
                    # auto-approve: immediately redirect back with a code
                    q = dict(urllib.parse.parse_qsl(parsed.query))
                    code = secrets.token_urlsafe(12)
                    provider._codes[code] = {"redirect_uri": q.get("redirect_uri", "")}
                    target = (
                        q["redirect_uri"]
                        + "?"
                        + urllib.parse.urlencode({"code": code, "state": q.get("state", "")})
                    )
                    self.send_response(302)
                    self.send_header("Location", target)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                form = dict(urllib.parse.parse_qsl(self.rfile.read(length).decode()))
                if urllib.parse.urlparse(self.path).path != "/token":
                    self._json({"error": "not found"}, 404)
                    return
                if form.get("client_secret") != provider.client_secret:
                    self._json({"error": "invalid_client"}, 401)
                    return
                if form.get("code") not in provider._codes:
                    self._json({"error": "invalid_grant"}, 400)
                    return
                del provider._codes[form["code"]]
                self._json(
                    {
                        "access_token": secrets.token_urlsafe(12),
                        "token_type": "Bearer",
                        "id_token": provider.sign_id_token(),
                    }
                )

        class Server(ThreadingHTTPServer):
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.issuer = f"http://{self._server.server_address[0]}:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def discovery(self) -> dict:
        return {
            "issuer": self.issuer,
            "authorization_endpoint": self.issuer + "/auth",
            "token_endpoint": self.issuer + "/token",
            "jwks_uri": self.issuer + "/keys",
            "id_token_signing_alg_values_supported": ["RS256"],
        }

    def jwks(self) -> dict:
        return {
            "keys": [
                {"kty": "RSA", "alg": "RS256", "use": "sig", "kid": self.KID,
                 "n": _int_b64(self._key.n), "e": _int_b64(self._key.e)}
            ]
        }

    def sign_id_token(self, claims: dict | None = None, key: RSAKey | None = None) -> str:
        """An id token for the provider's user, valid for an hour; ``claims``
        override its claims, ``key`` signs it in place of the provider's
        (a token the verifier must refuse)."""
        head = _b64url(json.dumps({"alg": "RS256", "kid": self.KID, "typ": "JWT"}).encode())
        now = time.time()
        body = dict(self.user)
        body.update({"iss": self.issuer, "aud": self.client_id, "iat": now, "exp": now + 3600})
        body.update(claims or {})
        payload = _b64url(json.dumps(body).encode())
        sig = (key or self._key).sign(f"{head}.{payload}".encode())
        return f"{head}.{payload}.{_b64url(sig)}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
