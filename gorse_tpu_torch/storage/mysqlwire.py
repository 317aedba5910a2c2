"""Pure-Python MySQL client protocol, handshake v10 + text protocol (copy
of gorse_tpu/storage/mysqlwire.py).

HandshakeV10, ``mysql_native_password`` auth, COM_QUERY with text result
sets, COM_PING. Statements arrive pre-interpolated
(sqlstores.sql_interpolate); the connection sets
``sql_mode='NO_BACKSLASH_ESCAPES'`` so ''-doubled string literals mean the
same thing on MySQL as everywhere else.

``native_password_scramble`` is exported so MiniMySQL (minisql.py) can
verify the auth response."""

from __future__ import annotations

import hashlib
import socket
import struct
import threading

__all__ = ["MySQLConnection", "MySQLError", "native_password_scramble"]

CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_CONNECT_WITH_DB = 0x8

_CAPS = (
    CLIENT_LONG_PASSWORD
    | CLIENT_PROTOCOL_41
    | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION
    | CLIENT_PLUGIN_AUTH
)


class MySQLError(Exception):
    pass


def native_password_scramble(password: str, salt: bytes) -> bytes:
    """token = SHA1(pass) XOR SHA1(salt + SHA1(SHA1(pass)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise MySQLError("connection closed by server")
        buf += chunk
    return buf


def _lenenc_int(data: bytes, off: int) -> tuple[int, int]:
    first = data[off]
    if first < 0xFB:
        return first, off + 1
    if first == 0xFC:
        return struct.unpack("<H", data[off + 1 : off + 3])[0], off + 3
    if first == 0xFD:
        return int.from_bytes(data[off + 1 : off + 4], "little"), off + 4
    if first == 0xFE:
        return struct.unpack("<Q", data[off + 1 : off + 9])[0], off + 9
    raise MySQLError(f"bad length-encoded integer 0x{first:x}")


def _lenenc_str(data: bytes, off: int) -> tuple[bytes | None, int]:
    if data[off] == 0xFB:  # NULL
        return None, off + 1
    n, off = _lenenc_int(data, off)
    return data[off : off + n], off + n


def encode_lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little")
    return b"\xfe" + struct.pack("<Q", n)


def encode_lenenc_str(s: bytes) -> bytes:
    return encode_lenenc_int(len(s)) + s


class MySQLConnection:
    """A single MySQL connection speaking the text protocol."""

    def __init__(
        self,
        host: str,
        port: int = 3306,
        user: str = "root",
        password: str = "",
        database: str = "",
        timeout: float = 30.0,
    ) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._seq = 0
        self._handshake(user, password, database)
        # append, don't replace — wiping the default mode would drop
        # STRICT_TRANS_TABLES and turn length overflows into silent truncation
        self.query("SET SESSION sql_mode=CONCAT(@@sql_mode, ',NO_BACKSLASH_ESCAPES')")

    # -- framing -----------------------------------------------------------
    def _read_packet(self) -> bytes:
        header = _read_exact(self.sock, 4)
        length = int.from_bytes(header[:3], "little")
        self._seq = (header[3] + 1) & 0xFF
        return _read_exact(self.sock, length)

    def _send_packet(self, payload: bytes) -> None:
        self.sock.sendall(
            len(payload).to_bytes(3, "little") + bytes([self._seq]) + payload
        )
        self._seq = (self._seq + 1) & 0xFF

    # -- handshake ---------------------------------------------------------
    def _handshake(self, user: str, password: str, database: str) -> None:
        greeting = self._read_packet()
        if greeting[0] == 0xFF:
            raise MySQLError(_parse_err(greeting))
        if greeting[0] != 10:
            raise MySQLError(f"unsupported protocol version {greeting[0]}")
        off = greeting.index(b"\0", 1) + 1  # server version
        off += 4  # connection id
        salt = greeting[off : off + 8]
        off += 8 + 1  # filler
        off += 2 + 1 + 2  # caps low, charset, status
        off += 2  # caps high
        auth_len = greeting[off]
        off += 1 + 10  # reserved
        if auth_len:
            salt += greeting[off : off + max(13, auth_len - 8)].rstrip(b"\0")
        caps = _CAPS | (CLIENT_CONNECT_WITH_DB if database else 0)
        token = native_password_scramble(password, salt[:20])
        payload = struct.pack("<IIB23x", caps, 1 << 24, 33)  # utf8 charset
        payload += user.encode() + b"\0"
        payload += bytes([len(token)]) + token
        if database:
            payload += database.encode() + b"\0"
        payload += b"mysql_native_password\0"
        self._send_packet(payload)
        resp = self._read_packet()
        if resp[0] == 0xFF:
            raise MySQLError(_parse_err(resp))
        if resp[0] == 0xFE:  # AuthSwitchRequest
            end = resp.index(b"\0", 1)
            plugin = resp[1:end].decode()
            if plugin != "mysql_native_password":
                raise MySQLError(f"unsupported auth plugin {plugin}")
            new_salt = resp[end + 1 :].rstrip(b"\0")
            self._send_packet(native_password_scramble(password, new_salt[:20]))
            resp = self._read_packet()
            if resp[0] == 0xFF:
                raise MySQLError(_parse_err(resp))

    # -- queries -----------------------------------------------------------
    def query(self, sql: str) -> list[tuple]:
        """COM_QUERY; returns rows of str|None (text protocol)."""
        with self._lock:
            self._seq = 0
            self._send_packet(b"\x03" + sql.encode())
            first = self._read_packet()
            if first[0] == 0xFF:
                raise MySQLError(_parse_err(first))
            if first[0] == 0x00:  # OK packet — no result set
                return []
            ncols, _ = _lenenc_int(first, 0)
            for _ in range(ncols):  # column definitions
                self._read_packet()
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:  # EOF after columns
                pkt = self._read_packet()
            rows: list[tuple] = []
            # rows terminate with an EOF packet (CLIENT_DEPRECATE_EOF unset);
            # don't test for OK (0x00) — an empty first column starts with 0x00
            while not (pkt[0] == 0xFE and len(pkt) < 9):
                off, vals = 0, []
                for _ in range(ncols):
                    v, off = _lenenc_str(pkt, off)
                    vals.append(v.decode() if v is not None else None)
                rows.append(tuple(vals))
                pkt = self._read_packet()
            return rows

    def ping(self) -> bool:
        try:
            with self._lock:
                self._seq = 0
                self._send_packet(b"\x0e")
                return self._read_packet()[0] == 0x00
        except Exception:
            return False

    def close(self) -> None:
        try:
            with self._lock:
                self._seq = 0
                self._send_packet(b"\x01")  # COM_QUIT
        except Exception:
            pass
        self.sock.close()


def _parse_err(pkt: bytes) -> str:
    # 0xff, errno u16, '#' + 5-byte sqlstate (protocol 4.1), message
    msg = pkt[3:]
    if msg[:1] == b"#":
        msg = msg[6:]
    return msg.decode(errors="replace")
