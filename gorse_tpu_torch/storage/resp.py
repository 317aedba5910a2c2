"""Minimal RESP (REdis Serialization Protocol) client and embedded server
(copy of gorse_tpu/storage/resp.py).

The client speaks RESP over a socket, with no third-party driver, and
works against a real Redis unchanged. ``MiniRedis`` (and
``MiniRedisCluster``) is an in-process server implementing the command
subset the cache store uses."""

from __future__ import annotations

import fnmatch
import socket
import socketserver
import threading


class Simple(str):
    """RESP simple-string status reply (+OK/+PONG) — distinct from data."""


class RespError(Exception):
    pass


class RespClient:
    """Pipelining RESP2 client (SET/GET/ZADD/HSET/... command subset)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, db: int = 0, password: str | None = None) -> None:
        self._sock = socket.create_connection((host, port), timeout=10)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # replies not yet read: ``_buf`` from offset ``_pos`` (an offset, so
        # reading a long pipeline's replies stays linear in its length)
        self._buf, self._pos = bytearray(), 0
        self._lock = threading.RLock()
        if password:
            self.call("AUTH", password)
        if db:
            self.call("SELECT", str(db))

    # --- wire format
    @staticmethod
    def _encode(args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, (int, float)):
                a = repr(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _fill(self) -> None:
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis connection closed")
        del self._buf[: self._pos]
        self._pos = 0
        self._buf += chunk

    def _read_line(self) -> bytes:
        while (end := self._buf.find(b"\r\n", self._pos)) < 0:
            self._fill()
        line = bytes(self._buf[self._pos : end])
        self._pos = end + 2
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n + 2:
            self._fill()
        data = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n + 2
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self._read_exact(n).decode()
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self._read_reply() for _ in range(n)]
        raise RespError(f"bad RESP type byte {kind!r}")

    # --- public API
    def call(self, *args):
        with self._lock:
            self._sock.sendall(self._encode(args))
            return self._read_reply()

    def pipeline(self, commands: list[tuple]) -> list:
        """Send many commands in one round trip; returns replies in order."""
        if not commands:
            return []
        with self._lock:
            self._sock.sendall(b"".join(self._encode(c) for c in commands))
            return [self._read_reply() for _ in commands]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _MiniRedisState:
    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.strings: dict[str, str] = {}
        self.lists: dict[str, list[str]] = {}
        self.sets: dict[str, set[str]] = {}
        self.zsets: dict[str, dict[str, float]] = {}
        self.hashes: dict[str, dict[str, str]] = {}

    def delete(self, key: str) -> int:
        n = 0
        for space in (self.strings, self.lists, self.sets, self.zsets, self.hashes):
            if key in space:
                del space[key]
                n = 1
        return n

    def exists(self, key: str) -> bool:
        return any(key in space for space in (self.strings, self.lists, self.sets,
                                              self.zsets, self.hashes))

    def keys(self) -> set[str]:
        out: set[str] = set()
        for space in (self.strings, self.lists, self.sets, self.zsets, self.hashes):
            out.update(space)
        return out


class MiniRedis:
    """In-process Redis-compatible server (test fixture).

    Implements: PING, AUTH, SELECT, SET, GET, DEL, EXISTS, KEYS, FLUSHDB,
    FLUSHALL, RPUSH, LPOP, LLEN, SADD, SREM, SISMEMBER, SMEMBERS, ZADD, ZREM,
    ZRANGE [REV] [WITHSCORES], ZCARD, HSET, HGET, HGETALL, HDEL.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        cluster_slots: tuple[int, int] | None = None,
    ) -> None:
        state = self.state = _MiniRedisState()
        # cluster mode (MiniRedisCluster): this node's owned slot range and
        # the full peer table [(host, port, lo, hi)], set post-construction
        self.cluster_slots = cluster_slots
        self.cluster_peers: list[tuple[str, int, int, int]] = []
        mini = self

        class Handler(socketserver.StreamRequestHandler):
            disable_nagle_algorithm = True

            def handle(self) -> None:
                # every command already received is answered, and the
                # replies leave in one send: a pipeline costs one write
                sock, buf = self.connection, bytearray()
                while True:
                    try:
                        data = sock.recv(1 << 16)
                    except OSError:
                        return
                    if not data:
                        return
                    buf += data
                    replies, pos = [], 0
                    while True:
                        try:
                            parsed = self._parse_command(buf, pos)
                        except ValueError:
                            return
                        if parsed is None:
                            break
                        args, pos = parsed
                        try:
                            reply = self._dispatch(args)
                        except Exception as e:  # noqa: BLE001 — protocol error reply
                            reply = RespError(str(e))
                        replies.append(self._encode(reply))
                    del buf[:pos]
                    if replies:
                        try:
                            sock.sendall(b"".join(replies))
                        except OSError:
                            return

            @staticmethod
            def _parse_command(buf: bytearray, pos: int):
                """(args, the offset past them) for the command at ``pos``,
                or None when ``buf`` does not hold all of it yet."""
                end = buf.find(b"\r\n", pos)
                if end < 0:
                    return None
                if buf[pos:pos + 1] != b"*":
                    raise ValueError("inline commands unsupported")
                n = int(buf[pos + 1:end])
                pos = end + 2
                args = []
                for _ in range(n):
                    end = buf.find(b"\r\n", pos)
                    if end < 0:
                        return None
                    size = int(buf[pos + 1:end])
                    start = end + 2
                    if len(buf) < start + size + 2:
                        return None
                    args.append(bytes(buf[start:start + size]).decode())
                    pos = start + size + 2
                return args, pos

            @staticmethod
            def _encode(v) -> bytes:
                if isinstance(v, RespError):
                    msg = str(v)
                    # redirects/typed errors carry their own code word
                    if msg.startswith(("MOVED ", "ASK ", "CROSSSLOT", "WRONGTYPE", "ERR ")):
                        return b"-%s\r\n" % msg.encode()
                    return b"-ERR %s\r\n" % msg.encode()
                if isinstance(v, Simple):
                    return b"+%s\r\n" % str(v).encode()
                if isinstance(v, bool):
                    return b":%d\r\n" % int(v)
                if isinstance(v, int):
                    return b":%d\r\n" % v
                if v is None:
                    return b"$-1\r\n"
                if isinstance(v, str):
                    # data strings are ALWAYS bulk strings — encoding values
                    # that merely start with '+' as simple strings corrupts
                    # them on read-back (and \r\n in a value would break
                    # protocol framing)
                    b = v.encode()
                    return b"$%d\r\n%s\r\n" % (len(b), b)
                if isinstance(v, list):
                    return b"*%d\r\n" % len(v) + b"".join(Handler._encode(x) for x in v)
                raise TypeError(type(v))

            def _dispatch(self, args: list[str]):
                cmd, rest = args[0].upper(), args[1:]
                s = state
                # cluster mode: bounce keys outside this node's slot range
                if (
                    mini.cluster_slots is not None
                    and rest
                    and cmd not in (
                        "PING", "AUTH", "SELECT", "CLIENT", "CLUSTER",
                        "KEYS", "FLUSHDB", "FLUSHALL", "ASKING",
                    )
                ):
                    slot = keyslot(rest[0])
                    lo, hi = mini.cluster_slots
                    if not (lo <= slot <= hi):
                        for (ph, pp, plo, phi) in mini.cluster_peers:
                            if plo <= slot <= phi:
                                raise RespError(f"MOVED {slot} {ph}:{pp}")
                        raise RespError(f"MOVED {slot} unknown:0")
                if cmd == "CLUSTER" and rest and rest[0].upper() == "NODES":
                    lines = []
                    for i, (ph, pp, plo, phi) in enumerate(mini.cluster_peers):
                        myself = ",myself" if (ph, pp) == (mini.host, mini.port) else ""
                        lines.append(
                            f"node{i} {ph}:{pp}@{pp + 10000} "
                            f"master{myself} - 0 0 {i} connected {plo}-{phi}"
                        )
                    return "\n".join(lines)
                if cmd == "ASKING":
                    return Simple("OK")
                with s.lock:
                    if cmd == "PING":
                        return Simple("PONG")
                    if cmd in ("AUTH", "SELECT"):
                        return Simple("OK")
                    if cmd == "SET":
                        s.delete(rest[0])
                        s.strings[rest[0]] = rest[1]
                        return Simple("OK")
                    if cmd == "GET":
                        return s.strings.get(rest[0])
                    if cmd == "DEL":
                        return sum(s.delete(k) for k in rest)
                    if cmd == "EXISTS":
                        return sum(s.exists(k) for k in rest)
                    if cmd == "KEYS":
                        return sorted(k for k in s.keys() if fnmatch.fnmatchcase(k, rest[0]))
                    if cmd in ("FLUSHDB", "FLUSHALL"):
                        for space in (s.strings, s.lists, s.sets, s.zsets, s.hashes):
                            space.clear()
                        return Simple("OK")
                    if cmd == "RPUSH":
                        q = s.lists.setdefault(rest[0], [])
                        q.extend(rest[1:])
                        return len(q)
                    if cmd == "LPOP":
                        q = s.lists.get(rest[0])
                        return q.pop(0) if q else None
                    if cmd == "LLEN":
                        return len(s.lists.get(rest[0], []))
                    if cmd == "SADD":
                        st = s.sets.setdefault(rest[0], set())
                        added = sum(1 for m in rest[1:] if m not in st)
                        st.update(rest[1:])
                        return added
                    if cmd == "SREM":
                        st = s.sets.get(rest[0], set())
                        removed = sum(1 for m in rest[1:] if m in st)
                        st.difference_update(rest[1:])
                        return removed
                    if cmd == "SISMEMBER":
                        return int(rest[1] in s.sets.get(rest[0], set()))
                    if cmd == "SMEMBERS":
                        return sorted(s.sets.get(rest[0], set()))
                    if cmd == "ZADD":
                        z = s.zsets.setdefault(rest[0], {})
                        pairs = rest[1:]
                        added = 0
                        for i in range(0, len(pairs), 2):
                            member = pairs[i + 1]
                            added += member not in z
                            z[member] = float(pairs[i])
                        return added
                    if cmd == "ZREM":
                        z = s.zsets.get(rest[0], {})
                        removed = sum(1 for m in rest[1:] if m in z)
                        for m in rest[1:]:
                            z.pop(m, None)
                        return removed
                    if cmd == "ZCARD":
                        return len(s.zsets.get(rest[0], {}))
                    if cmd == "ZRANGE":
                        z = s.zsets.get(rest[0], {})
                        opts = [o.upper() for o in rest[3:]]
                        rows = sorted(z.items(), key=lambda kv: (kv[1], kv[0]))
                        if "REV" in opts:
                            rows = rows[::-1]
                        start, stop = int(rest[1]), int(rest[2])
                        stop = len(rows) if stop == -1 else stop + 1
                        rows = rows[start:stop]
                        if "WITHSCORES" in opts:
                            return [x for m, sc in rows for x in (m, repr(sc))]
                        return [m for m, _ in rows]
                    if cmd == "HSET":
                        h = s.hashes.setdefault(rest[0], {})
                        pairs = rest[1:]
                        added = 0
                        for i in range(0, len(pairs), 2):
                            added += pairs[i] not in h
                            h[pairs[i]] = pairs[i + 1]
                        return added
                    if cmd == "HGET":
                        return s.hashes.get(rest[0], {}).get(rest[1])
                    if cmd == "HGETALL":
                        return [x for kv in s.hashes.get(rest[0], {}).items() for x in kv]
                    if cmd == "HDEL":
                        h = s.hashes.get(rest[0], {})
                        removed = sum(1 for f in rest[1:] if f in h)
                        for f in rest[1:]:
                            h.pop(f, None)
                        return removed
                    raise ValueError(f"unknown command '{cmd}'")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"redis://{self.host}:{self.port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# ---------------------------------------------------------------------------
# Redis Cluster (reference: storage/cache/redis.go uses go-redis
# ClusterClient for redis+cluster:// URIs; scans run per-master via
# ForEachMaster, redis.go:133-166)
# ---------------------------------------------------------------------------


def crc16_xmodem(data: bytes) -> int:
    """CRC16/XMODEM — the Redis Cluster key-slot hash."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
        crc &= 0xFFFF
    return crc


def keyslot(key: str) -> int:
    """Cluster slot for a key, honoring {hash tags}."""
    raw = key.encode()
    start = raw.find(b"{")
    if start != -1:
        end = raw.find(b"}", start + 1)
        if end > start + 1:  # non-empty tag
            raw = raw[start + 1 : end]
    return crc16_xmodem(raw) % 16384


# commands that carry no routable key (routed to any node)
_KEYLESS = {
    "PING", "AUTH", "SELECT", "CLIENT", "CLUSTER", "KEYS", "FLUSHDB",
    "FLUSHALL", "ASKING", "INFO", "SCRIPT",
}


class RespClusterClient:
    """Redis Cluster client over :class:`RespClient` connections.

    Routing: each single-key command goes to the cached slot owner (learned
    lazily from ``-MOVED`` redirects, the protocol's own teaching mechanism;
    ``-ASK`` redirects are honored one-shot with ``ASKING``). Pipelines are
    split per target node and reassembled in order; commands a node bounces
    are retried individually through the redirect path. ``call_all`` runs a
    (keyless) command on every master — the go-redis ``ForEachMaster``
    analog the reference uses for scans/flushes.
    """

    is_cluster = True
    _MAX_REDIRECTS = 5

    def __init__(self, nodes: list[tuple[str, int]], password: str | None = None) -> None:
        if not nodes:
            raise ValueError("redis+cluster:// needs at least one node")
        self._password = password
        self._addrs = [(h, int(p)) for h, p in nodes]
        self._conns: dict[tuple[str, int], RespClient] = {}
        self._slot_owner: dict[int, tuple[str, int]] = {}
        self._lock = threading.RLock()

    # --- connections / topology
    def _conn(self, addr: tuple[str, int]) -> RespClient:
        with self._lock:
            c = self._conns.get(addr)
            if c is None:
                c = RespClient(addr[0], addr[1], password=self._password)
                self._conns[addr] = c
                if addr not in self._addrs:
                    self._addrs.append(addr)
            return c

    def masters(self) -> list[tuple[str, int]]:
        """Master node addresses from CLUSTER NODES (fallback: known nodes)."""
        for addr in list(self._addrs):
            try:
                raw = self._conn(addr).call("CLUSTER", "NODES")
            except (RespError, OSError, ConnectionError):
                continue
            out = []
            for line in (raw or "").splitlines():
                parts = line.split()
                if len(parts) >= 3 and "master" in parts[2] and "fail" not in parts[2]:
                    hp = parts[1].split("@")[0]
                    host, _, port_s = hp.rpartition(":")
                    out.append((host, int(port_s)))
            if out:
                return out
        return list(self._addrs)

    @staticmethod
    def _key_of(args: tuple) -> str | None:
        if len(args) < 2 or str(args[0]).upper() in _KEYLESS:
            return None
        return str(args[1])

    def _addr_for(self, args: tuple) -> tuple[str, int]:
        key = self._key_of(args)
        if key is None:
            return self._addrs[0]
        return self._slot_owner.get(keyslot(key), self._addrs[0])

    @staticmethod
    def _parse_redirect(msg: str) -> tuple[int, tuple[str, int]]:
        # "MOVED 3999 127.0.0.1:6381" / "ASK 3999 127.0.0.1:6381"
        _, slot_s, hp = msg.split(" ", 2)
        host, _, port_s = hp.rpartition(":")
        return int(slot_s), (host, int(port_s))

    # --- public API (RespClient-compatible)
    def call(self, *args):
        addr = self._addr_for(args)
        asking = False
        for _ in range(self._MAX_REDIRECTS):
            conn = self._conn(addr)
            try:
                if asking:
                    conn.call("ASKING")
                    asking = False
                return conn.call(*args)
            except RespError as e:
                msg = str(e)
                if msg.startswith("MOVED "):
                    slot, addr = self._parse_redirect(msg)
                    with self._lock:
                        self._slot_owner[slot] = addr
                    continue
                if msg.startswith("ASK "):
                    _, addr = self._parse_redirect(msg)
                    asking = True
                    continue
                raise
        raise RespError(f"too many cluster redirects for {args[:2]}")

    def call_all(self, *args) -> list:
        """Run a keyless command on every master; returns per-master replies."""
        return [self._conn(a).call(*args) for a in self.masters()]

    def pipeline(self, commands: list[tuple]) -> list:
        if not commands:
            return []
        by_addr: dict[tuple[str, int], list[int]] = {}
        for i, cmd in enumerate(commands):
            by_addr.setdefault(self._addr_for(cmd), []).append(i)
        results: list = [None] * len(commands)
        for addr, idxs in by_addr.items():
            conn = self._conn(addr)
            batch = [commands[i] for i in idxs]
            with conn._lock:
                conn._sock.sendall(b"".join(conn._encode(c) for c in batch))
                for i in idxs:
                    try:
                        results[i] = conn._read_reply()
                    except RespError as e:
                        if str(e).startswith(("MOVED ", "ASK ")):
                            results[i] = e  # retry below, outside the batch
                        else:
                            raise
        for i, r in enumerate(results):
            if isinstance(r, RespError):
                results[i] = self.call(*commands[i])
        return results

    def close(self) -> None:
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()


class MiniRedisCluster:
    """In-process N-node Redis Cluster fixture: each node owns a contiguous
    slot range and bounces keys it does not own with ``-MOVED``, serves
    CLUSTER NODES, and restricts KEYS to its local keyspace — the behaviors
    RespClusterClient routes around (the redis-cluster compat-test analog,
    reference build_test.yml redis+cluster:// job)."""

    def __init__(self, n_nodes: int = 3, host: str = "127.0.0.1") -> None:
        bounds = [i * 16384 // n_nodes for i in range(n_nodes)] + [16384]
        self.nodes: list[MiniRedis] = []
        ranges: list[tuple[int, int]] = []
        for i in range(n_nodes):
            rng = (bounds[i], bounds[i + 1] - 1)
            node = MiniRedis(host=host, cluster_slots=rng)
            self.nodes.append(node)
            ranges.append(rng)
        peers = [
            (n.host, n.port, r[0], r[1]) for n, r in zip(self.nodes, ranges)
        ]
        for node in self.nodes:
            node.cluster_peers = peers

    @property
    def url(self) -> str:
        first = self.nodes[0]
        extra = "&".join(f"addr={n.host}:{n.port}" for n in self.nodes[1:])
        return f"redis+cluster://{first.host}:{first.port}" + (f"?{extra}" if extra else "")

    def close(self) -> None:
        for n in self.nodes:
            n.close()
