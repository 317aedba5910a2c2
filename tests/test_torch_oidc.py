"""The port's OIDC sign-on (gorse_tpu_torch/serve/oidc.py: RS256 in the
standard library, ``OIDCClient``, ``MockOIDCProvider``; the login routes of
serve/dashboard.py) against ``cryptography`` and gorse_tpu's, on the CPU.

- RS256 tokens that ``cryptography`` signed (PKCS#1 v1.5, SHA-256) with
  keys of 1,024, 2,048 and 3,072 bits are accepted, and ``cryptography``
  accepts the port's signatures, which are byte-equal to its own (PKCS#1
  v1.5 is deterministic).
- Refused: a tampered payload, header or signature, a wrong ``kid``, an
  ``alg`` other than RS256, a bad ``iss``, ``aud`` or ``exp``, a signature
  one byte short or long, ``s = n`` and ``s > n``, and forged encodings
  whose RSA arithmetic is right (signed with the private key): a short FF
  run, bytes after the hash, a DigestInfo without its NULL, another hash's
  DigestInfo, block type 02. ``cryptography`` refuses each forged encoding
  too.
- The mock provider's Miller-Rabin key: prime factors (checked by
  ``cryptography``'s own key construction), reproducible from a seed.
- The login flow (``/login`` -> the provider -> ``/callback/oauth2`` ->
  the session cookie -> ``/api/dashboard/userinfo``) on the port's master,
  against the port's mock provider and against the reference's; the
  reference's client verifies the port's provider's tokens.
- ``GET /`` serves bytes equal to the reference's dashboard.html.
"""

import base64
import hashlib
import json
import random
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import pytest
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import padding, rsa

from gorse_tpu.serve import oidc as ref_oidc
from gorse_tpu_torch.serve import oidc

ROOT = Path(__file__).resolve().parents[1]


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _int_b64(x: int) -> str:
    return _b64(x.to_bytes((x.bit_length() + 7) // 8, "big"))


def _crypto_key(bits: int):
    return rsa.generate_private_key(public_exponent=65537, key_size=bits)


def _jwt(key, claims: dict, header: dict | None = None) -> str:
    head = _b64(json.dumps(header or {"alg": "RS256", "kid": "k1", "typ": "JWT"}).encode())
    body = _b64(json.dumps(claims).encode())
    sig = key.sign(f"{head}.{body}".encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{head}.{body}.{_b64(sig)}"


def _client(pub, issuer="http://issuer", client_id="gorse", kid="k1"):
    """A port client holding a JWKS of ``pub`` (no discovery call)."""
    c = oidc.OIDCClient(issuer, client_id, "s3cret", "http://127.0.0.1/cb")
    nums = pub.public_numbers()
    c._jwks = {"keys": [{"kty": "RSA", "alg": "RS256", "kid": kid, "n": _int_b64(nums.n),
                         "e": _int_b64(nums.e)}]}
    return c


def _claims(**over):
    claims = {"iss": "http://issuer", "aud": "gorse", "sub": "s", "email": "a@b.c",
              "exp": time.time() + 600}
    claims.update(over)
    return claims


@pytest.fixture(scope="module")
def key():
    return _crypto_key(2048)


@pytest.mark.parametrize("bits", [1024, 2048, 3072])
def test_accepts_what_cryptography_signs(bits):
    k = _crypto_key(bits)
    c = _client(k.public_key())
    for n in range(3):
        token = _jwt(k, _claims(n=n, aud=["x", "gorse"] if n else "gorse"))
        assert c.verify_id_token(token)["n"] == n
    nums = k.private_numbers()
    port_key = oidc.RSAKey(n=nums.public_numbers.n, e=nums.public_numbers.e, d=nums.d,
                           p=nums.p, q=nums.q)
    for msg in (b"", b"m", b"x" * 1000):
        sig = port_key.sign(msg)
        assert sig == k.sign(msg, padding.PKCS1v15(), hashes.SHA256())
        k.public_key().verify(sig, msg, padding.PKCS1v15(), hashes.SHA256())
        assert oidc.rs256_verify(port_key.n, port_key.e, msg, sig)


def _forge(key, message: bytes, em: bytes) -> bytes:
    """A signature whose RSA arithmetic is right (s^e = em mod n) over a
    chosen encoded message: s = em^d mod n."""
    nums = key.private_numbers()
    n = nums.public_numbers.n
    k = (n.bit_length() + 7) // 8
    assert len(em) == k
    return pow(int.from_bytes(em, "big"), nums.d, n).to_bytes(k, "big")


SHA256_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
FORGED = {
    # the FF run 8 bytes short, the gap zero-filled before the DigestInfo
    "short_ff_run": lambda k, h: b"\x00\x01" + b"\xff" * (k - 54 - 8) + b"\x00" * 9
    + SHA256_INFO + h,
    # the FF run 4 bytes short and 4 bytes of garbage after the hash
    "bytes_after_hash": lambda k, h: b"\x00\x01" + b"\xff" * (k - 54 - 4) + b"\x00"
    + SHA256_INFO + h + b"\xde\xad\xbe\xef",
    # DigestInfo without the NULL parameters (a variant loose parsers take)
    "digestinfo_no_null": lambda k, h: b"\x00\x01" + b"\xff" * (k - 49 - 3) + b"\x00"
    + bytes.fromhex("302f300b0609608648016503040201" "0420") + h,
    # SHA-512's algorithm identifier around the SHA-256 hash
    "wrong_digest_oid": lambda k, h: b"\x00\x01" + b"\xff" * (k - 51 - 3) + b"\x00"
    + bytes.fromhex("3031300d060960864801650304020305000420") + h,
    # block type 02 (encryption padding)
    "block_type_02": lambda k, h: b"\x00\x02" + b"\xff" * (k - 51 - 3) + b"\x00"
    + SHA256_INFO + h,
    # the right layout over another message's hash
    "other_hash": lambda k, h: b"\x00\x01" + b"\xff" * (k - 51 - 3) + b"\x00" + SHA256_INFO
    + hashlib.sha256(b"other").digest(),
}


@pytest.mark.parametrize("shape", sorted(FORGED))
def test_forged_encodings_are_refused(key, shape):
    head = _b64(json.dumps({"alg": "RS256", "kid": "k1"}).encode())
    body = _b64(json.dumps(_claims()).encode())
    msg = f"{head}.{body}".encode()
    k = (key.key_size + 7) // 8
    sig = _forge(key, msg, FORGED[shape](k, hashlib.sha256(msg).digest()))
    with pytest.raises(InvalidSignature):
        key.public_key().verify(sig, msg, padding.PKCS1v15(), hashes.SHA256())
    nums = key.public_key().public_numbers()
    assert not oidc.rs256_verify(nums.n, nums.e, msg, sig)
    with pytest.raises(ValueError, match="signature"):
        _client(key.public_key()).verify_id_token(f"{head}.{body}.{_b64(sig)}")


def test_the_right_encoding_forged_the_same_way_is_accepted(key):
    """The control for the forged cases: ``_forge`` over the correct
    encoding is a valid signature."""
    msg = b"header.payload"
    k = (key.key_size + 7) // 8
    em = oidc.emsa_pkcs1_v15_sha256(msg, k)
    sig = _forge(key, msg, em)
    nums = key.public_key().public_numbers()
    assert oidc.rs256_verify(nums.n, nums.e, msg, sig)
    assert sig == key.sign(msg, padding.PKCS1v15(), hashes.SHA256())


def _tamper(token: str, part: int, new: str) -> str:
    parts = token.split(".")
    parts[part] = new
    return ".".join(parts)


def test_malformed_tokens_are_refused(key):
    c = _client(key.public_key())
    good = _jwt(key, _claims())
    assert c.verify_id_token(good)["sub"] == "s"
    head, body, sig = good.split(".")
    raw = base64.urlsafe_b64decode(sig + "=" * (-len(sig) % 4))
    n = key.public_key().public_numbers().n
    k = (n.bit_length() + 7) // 8
    cases = {
        "payload": _tamper(good, 1, _b64(json.dumps(_claims(sub="evil")).encode())),
        "signature_bit": _tamper(good, 2, _b64(raw[:-1] + bytes([raw[-1] ^ 1]))),
        "short_signature": _tamper(good, 2, _b64(raw[1:])),
        "long_signature": _tamper(good, 2, _b64(b"\x00" + raw)),
        "s_equals_n": _tamper(good, 2, _b64(n.to_bytes(k, "big"))),
        "s_above_n": _tamper(good, 2, _b64((n + 1).to_bytes(k, "big"))),
        "empty_signature": _tamper(good, 2, ""),
    }
    for name, token in cases.items():
        with pytest.raises(ValueError, match="signature"):
            c.verify_id_token(token)
    with pytest.raises(ValueError, match="kid"):
        c.verify_id_token(_jwt(key, _claims(), {"alg": "RS256", "kid": "other"}))
    for alg in ("none", "HS256", "RS512", "PS256", None):
        header = {"kid": "k1"} if alg is None else {"alg": alg, "kid": "k1"}
        with pytest.raises(ValueError, match="alg"):
            c.verify_id_token(_jwt(key, _claims(), header))
    with pytest.raises(ValueError, match="issuer"):
        c.verify_id_token(_jwt(key, _claims(iss="http://evil")))
    with pytest.raises(ValueError, match="audience"):
        c.verify_id_token(_jwt(key, _claims(aud="other")))
    with pytest.raises(ValueError, match="audience"):
        c.verify_id_token(_jwt(key, _claims(aud=["a", "b"])))
    with pytest.raises(ValueError, match="expired"):
        c.verify_id_token(_jwt(key, _claims(exp=time.time() - 1)))
    with pytest.raises(ValueError, match="expired"):
        c.verify_id_token(_jwt(key, {k: v for k, v in _claims().items() if k != "exp"}))
    # the trailing slash of an issuer is not a difference, as in the reference
    assert c.verify_id_token(_jwt(key, _claims(iss="http://issuer/")))["sub"] == "s"
    # a token without a kid takes the JWKS's first key
    assert c.verify_id_token(_jwt(key, _claims(), {"alg": "RS256"}))["sub"] == "s"


def test_the_same_cases_as_the_reference_client(key):
    """Every case above, the reference's client (cryptography) decides
    the same."""
    nums = key.public_key().public_numbers()
    jwks = {"keys": [{"kty": "RSA", "kid": "k1", "n": _int_b64(nums.n), "e": _int_b64(nums.e)}]}
    clients = []
    for mod in (ref_oidc, oidc):
        c = mod.OIDCClient("http://issuer", "gorse", "s", "http://cb")
        c._jwks = jwks
        clients.append(c)
    tokens = [_jwt(key, _claims()), _jwt(key, _claims(aud="x")), _jwt(key, _claims(exp=1)),
              _tamper(_jwt(key, _claims()), 1, _b64(b'{"iss": "http://issuer"}')),
              _jwt(key, _claims(), {"alg": "RS256", "kid": "zz"})]
    for token in tokens:
        outcomes = []
        for c in clients:
            try:
                outcomes.append(c.verify_id_token(token)["sub"])
            except ValueError:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1], token


def test_mock_key_is_reproducible_and_prime():
    a = oidc.generate_rsa_key(rng=random.Random(5))
    b = oidc.generate_rsa_key(rng=random.Random(5))
    assert a == b and a.n.bit_length() == 2048 and a.n == a.p * a.q
    # cryptography checks the CRT values and the exponents when it builds
    # a private key from them
    priv = rsa.RSAPrivateNumbers(a.p, a.q, a.d, a.d % (a.p - 1), a.d % (a.q - 1),
                                 pow(a.q, -1, a.p), rsa.RSAPublicNumbers(a.e, a.n)).private_key()
    priv.public_key().verify(a.sign(b"m"), b"m", padding.PKCS1v15(), hashes.SHA256())
    rng = random.Random(1)
    for p in (2, 3, 65537, 2**61 - 1, 2**89 - 1):
        assert oidc.is_probable_prime(p, rng)
    for c in (1, 561, 41041, 2**61 + 1, (2**31 - 1) * (2**61 - 1), 3215031751):
        assert not oidc.is_probable_prime(c, rng)


# ------------------------------------------------------------- login flow


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def _get(url, cookie=None):
    req = urllib.request.Request(url)
    if cookie:
        req.add_header("Cookie", cookie)
    try:
        resp = urllib.request.build_opener(_NoRedirect()).open(req, timeout=10)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _port_master(provider_issuer: str, tmp_path):
    from gorse_tpu_torch.serve.dashboard import MasterRestServer
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.utils.config import Config

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    config = Config()
    config.oidc.enable = True
    config.oidc.issuer = provider_issuer
    config.oidc.client_id, config.oidc.client_secret = "gorse", "s3cret"
    config.oidc.redirect_url = base + "/callback/oauth2"
    master = Master(config, MemoryDataStore(), MemoryCacheStore(), BlobStore(tmp_path / "b"),
                    MetaStore(), device="cpu")
    rest = MasterRestServer(master)
    httpd = rest.serve("127.0.0.1", port)
    return rest, httpd, base


@pytest.mark.parametrize("provider_pkg", ["port", "ref"])
def test_login_flow(provider_pkg, tmp_path):
    mod = oidc if provider_pkg == "port" else ref_oidc
    kw = {"seed": 3} if provider_pkg == "port" else {}
    provider = mod.MockOIDCProvider(client_id="gorse", client_secret="s3cret", **kw)
    rest, httpd, base = _port_master(provider.issuer, tmp_path)
    try:
        assert _get(base + "/api/dashboard/stats")[0] == 401
        status, headers, _ = _get(base + "/login")
        assert status == 302 and headers["Location"].startswith(provider.issuer + "/auth")
        status, headers, _ = _get(headers["Location"])
        assert status == 302 and headers["Location"].startswith(base + "/callback/oauth2")
        status, headers, _ = _get(headers["Location"])
        assert status == 302 and headers["Location"] == "/"
        cookie = headers["Set-Cookie"].split(";")[0]
        status, _, body = _get(base + "/api/dashboard/userinfo", cookie=cookie)
        info = json.loads(body)
        assert status == 200 and info["Email"] == "test@example.com"
        assert info["Name"] == "Test User" and info["AuthType"] == "oidc"
        assert _get(base + "/api/dashboard/stats", cookie=cookie)[0] == 200
        # a replayed callback (its state is spent) and a forged state: 401
        assert _get(base + "/callback/oauth2?code=x&state=forged")[0] == 401
        status, headers, _ = _get(base + "/logout")
        assert status == 302 and "Max-Age=0" in headers["Set-Cookie"]
    finally:
        httpd.shutdown()
        provider.close()


def test_port_provider_tokens_for_both_clients():
    """The port's provider signs; both packages' clients verify, and both
    refuse a token signed by another key and one past its exp."""
    provider = oidc.MockOIDCProvider(client_id="gorse", client_secret="s", seed=9)
    try:
        other = oidc.generate_rsa_key(rng=random.Random(10))
        for mod in (oidc, ref_oidc):
            client = mod.OIDCClient(provider.issuer, "gorse", "s", "http://cb")
            assert client.verify_id_token(provider.sign_id_token())["sub"] == "u-test"
            with pytest.raises(ValueError):
                client.verify_id_token(provider.sign_id_token(key=other))
            with pytest.raises(ValueError, match="expired"):
                client.verify_id_token(provider.sign_id_token({"exp": time.time() - 5}))
    finally:
        provider.close()


def test_dashboard_page_is_the_references(tmp_path):
    page = (ROOT / "gorse_tpu_torch" / "serve" / "dashboard.html").read_bytes()
    assert page == (ROOT / "gorse_tpu" / "serve" / "dashboard.html").read_bytes()
    rest, httpd, base = _port_master("http://127.0.0.1:9", tmp_path)
    try:
        status, headers, body = _get(base + "/")
        assert status == 200 and body == page
        assert headers["Content-Type"].startswith("text/html")
    finally:
        httpd.shutdown()
