"""Meta store: node registry with TTL heartbeats and a small KV space for
the active model ids (copy of gorse_tpu/storage/meta.py, sqlite3). Key
names are the reference's."""

from __future__ import annotations

import dataclasses
import sqlite3
import threading
import time

COLLABORATIVE_FILTERING_MODEL = "COLLABORATIVE_FILTERING_MODEL"
CLICK_THROUGH_RATE_MODEL = "CLICK_THROUGH_RATE_MODEL"
RECOMMEND_CONFIG = "RECOMMEND_CONFIG"

MASTER_NODE = "master"
SERVER_NODE = "server"
WORKER_NODE = "worker"


@dataclasses.dataclass
class Node:
    uuid: str
    hostname: str
    node_type: str  # master | server | worker
    version: str = ""
    update_time: float = 0.0


class MetaStore:
    """SQLite-backed meta store."""

    def __init__(self, path: str = ":memory:", ttl_seconds: float = 60.0) -> None:
        if path.startswith("sqlite://"):
            path = path[len("sqlite://"):] or ":memory:"
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        self.ttl = ttl_seconds
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS nodes (uuid TEXT PRIMARY KEY, hostname TEXT, "
                "node_type TEXT, version TEXT, update_time REAL)"
            )
            self._conn.execute("CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT)")
            self._conn.commit()

    def update_node(self, node: Node) -> None:
        """Register or heartbeat a node."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO nodes VALUES (?, ?, ?, ?, ?)",
                (node.uuid, node.hostname, node.node_type, node.version, time.time()),
            )
            self._conn.commit()

    def list_nodes(self, node_type: str | None = None) -> list[Node]:
        """Live nodes only: entries older than the TTL are dropped."""
        cutoff = time.time() - self.ttl
        with self._lock:
            self._conn.execute("DELETE FROM nodes WHERE update_time < ?", (cutoff,))
            where, args = "update_time >= ?", [cutoff]
            if node_type:
                where += " AND node_type = ?"
                args.append(node_type)
            rows = self._conn.execute(
                "SELECT uuid, hostname, node_type, version, update_time FROM nodes "
                f"WHERE {where} ORDER BY uuid",
                tuple(args),
            ).fetchall()
            self._conn.commit()
        return [Node(*r) for r in rows]

    def put(self, k: str, v: str) -> None:
        with self._lock:
            self._conn.execute("INSERT OR REPLACE INTO kv VALUES (?, ?)", (k, v))
            self._conn.commit()

    def get(self, k: str) -> str | None:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (k,)).fetchone()
        return row[0] if row else None

    def delete(self, k: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (k,))
            self._conn.commit()

    def close(self) -> None:
        self._conn.close()
