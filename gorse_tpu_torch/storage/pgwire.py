"""Pure-Python PostgreSQL wire-protocol (v3) client (copy of
gorse_tpu/storage/pgwire.py).

Startup, authentication (trust, cleartext, MD5, SCRAM-SHA-256 per RFC
7677) and the simple-query protocol with text-format results. Statements
are sent pre-interpolated (sqlstores.sql_interpolate).

The module also implements the server side of SCRAM, so MiniPostgres
(minisql.py) and MiniMongo verify client proofs."""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
import threading

__all__ = ["PGConnection", "PGError", "scram_server_exchange"]


class PGError(Exception):
    pass


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PGError("connection closed by server")
        buf += chunk
    return buf


def _scram_hi(password: bytes, salt: bytes, iterations: int) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password, salt, iterations)


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def scram_client_first(username: str) -> tuple[str, str]:
    nonce = base64.b64encode(os.urandom(18)).decode()
    bare = f"n={username},r={nonce}"
    return nonce, "n,," + bare


def scram_client_final(
    password: str, client_first: str, server_first: str
) -> tuple[str, bytes]:
    """Return (client-final-message, expected ServerSignature)."""
    fields = dict(kv.split("=", 1) for kv in server_first.split(","))
    full_nonce, salt, iters = fields["r"], base64.b64decode(fields["s"]), int(fields["i"])
    salted = _scram_hi(password.encode(), salt, iters)
    client_key = _hmac(salted, b"Client Key")
    stored_key = hashlib.sha256(client_key).digest()
    bare = client_first[3:]  # strip "n,,"
    without_proof = f"c=biws,r={full_nonce}"
    auth_message = f"{bare},{server_first},{without_proof}".encode()
    proof = _xor(client_key, _hmac(stored_key, auth_message))
    server_key = _hmac(salted, b"Server Key")
    server_sig = _hmac(server_key, auth_message)
    return f"{without_proof},p={base64.b64encode(proof).decode()}", server_sig


def scram_server_exchange(password: str, client_first: str):
    """Server-side SCRAM-SHA-256 (for MiniPostgres): returns
    (server_first, verify(client_final) -> server_final | None)."""
    bare = client_first.split(",", 2)[2]
    client_nonce = dict(kv.split("=", 1) for kv in bare.split(","))["r"]
    full_nonce = client_nonce + base64.b64encode(os.urandom(18)).decode()
    salt, iters = os.urandom(16), 4096
    server_first = f"r={full_nonce},s={base64.b64encode(salt).decode()},i={iters}"
    salted = _scram_hi(password.encode(), salt, iters)
    stored_key = hashlib.sha256(_hmac(salted, b"Client Key")).digest()
    server_key = _hmac(salted, b"Server Key")

    def verify(client_final: str) -> str | None:
        fields = dict(kv.split("=", 1) for kv in client_final.split(","))
        without_proof = client_final.rsplit(",p=", 1)[0]
        auth_message = f"{bare},{server_first},{without_proof}".encode()
        proof = base64.b64decode(fields["p"])
        client_key = _xor(proof, _hmac(stored_key, auth_message))
        if hashlib.sha256(client_key).digest() != stored_key or fields["r"] != full_nonce:
            return None
        return "v=" + base64.b64encode(_hmac(server_key, auth_message)).decode()

    return server_first, verify


# type OIDs we convert from text (everything else stays str)
_BOOL, _INT_OIDS, _FLOAT_OIDS = 16, {20, 21, 23, 26, 28}, {700, 701, 1700}


def _convert(oid: int, text: str | None):
    if text is None:
        return None
    if oid == _BOOL:
        return text == "t"
    if oid in _INT_OIDS:
        return int(text)
    if oid in _FLOAT_OIDS:
        return float(text)
    return text


class PGConnection:
    """A single Postgres connection speaking the simple-query protocol."""

    def __init__(
        self,
        host: str,
        port: int = 5432,
        user: str = "postgres",
        password: str = "",
        database: str = "postgres",
        timeout: float = 30.0,
    ) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self.user, self.password = user, password
        self._startup(user, database)

    # -- framing -----------------------------------------------------------
    def _send(self, tag: bytes, payload: bytes) -> None:
        self.sock.sendall(tag + struct.pack(">I", len(payload) + 4) + payload)

    def _recv(self) -> tuple[bytes, bytes]:
        tag = _read_exact(self.sock, 1)
        (length,) = struct.unpack(">I", _read_exact(self.sock, 4))
        return tag, _read_exact(self.sock, length - 4)

    # -- startup / auth ----------------------------------------------------
    def _startup(self, user: str, database: str) -> None:
        params = f"user\0{user}\0database\0{database}\0\0".encode()
        payload = struct.pack(">I", 196608) + params  # protocol 3.0
        self.sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        client_first = nonce = None
        while True:
            tag, body = self._recv()
            if tag == b"E":
                raise PGError(_parse_error(body))
            if tag == b"R":
                (code,) = struct.unpack(">I", body[:4])
                if code == 0:  # AuthenticationOk
                    continue
                if code == 3:  # cleartext password
                    self._send(b"p", self.password.encode() + b"\0")
                elif code == 5:  # MD5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        self.password.encode() + self.user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(inner.encode() + salt).hexdigest()
                    self._send(b"p", b"md5" + digest.encode() + b"\0")
                elif code == 10:  # SASL mechanisms
                    mechs = body[4:].split(b"\0")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PGError(f"no supported SASL mechanism in {mechs}")
                    nonce, client_first = scram_client_first(self.user)
                    data = client_first.encode()
                    self._send(
                        b"p",
                        b"SCRAM-SHA-256\0" + struct.pack(">I", len(data)) + data,
                    )
                elif code == 11:  # SASLContinue
                    server_first = body[4:].decode()
                    final, self._server_sig = scram_client_final(
                        self.password, client_first, server_first
                    )
                    self._send(b"p", final.encode())
                elif code == 12:  # SASLFinal
                    fields = dict(
                        kv.split("=", 1) for kv in body[4:].decode().split(",")
                    )
                    if base64.b64decode(fields["v"]) != self._server_sig:
                        raise PGError("server SCRAM signature mismatch")
                else:
                    raise PGError(f"unsupported auth method {code}")
            elif tag == b"Z":  # ReadyForQuery
                return
            # ParameterStatus (S), BackendKeyData (K), NoticeResponse (N): skip

    # -- queries -----------------------------------------------------------
    def query(self, sql: str) -> list[tuple]:
        """Run one simple-protocol statement; returns rows (typed from text)."""
        with self._lock:
            self._send(b"Q", sql.encode() + b"\0")
            rows: list[tuple] = []
            oids: list[int] = []
            error: str | None = None
            while True:
                tag, body = self._recv()
                if tag == b"T":  # RowDescription
                    (nfields,) = struct.unpack(">H", body[:2])
                    off, oids = 2, []
                    for _ in range(nfields):
                        end = body.index(b"\0", off)
                        off = end + 1
                        _, _, oid, _, _, _ = struct.unpack(
                            ">IHIhiH", body[off : off + 18]
                        )
                        off += 18
                        oids.append(oid)
                elif tag == b"D":  # DataRow
                    (nfields,) = struct.unpack(">H", body[:2])
                    off, vals = 2, []
                    for i in range(nfields):
                        (flen,) = struct.unpack(">i", body[off : off + 4])
                        off += 4
                        if flen == -1:
                            vals.append(None)
                        else:
                            vals.append(
                                _convert(oids[i], body[off : off + flen].decode())
                            )
                            off += flen
                    rows.append(tuple(vals))
                elif tag == b"E":
                    error = _parse_error(body)
                elif tag == b"Z":
                    if error:
                        raise PGError(error)
                    return rows
                # CommandComplete (C), EmptyQueryResponse (I), Notice (N): skip

    def ping(self) -> bool:
        try:
            self.query("SELECT 1")
            return True
        except Exception:
            return False

    def close(self) -> None:
        try:
            self._send(b"X", b"")
        except Exception:
            pass
        self.sock.close()


def _parse_error(body: bytes) -> str:
    parts = {}
    for chunk in body.split(b"\0"):
        if chunk:
            parts[chr(chunk[0])] = chunk[1:].decode(errors="replace")
    return parts.get("M", "unknown postgres error")
