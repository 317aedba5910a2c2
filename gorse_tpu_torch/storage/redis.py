"""Redis cache store (copy of gorse_tpu/storage/redis.py).

KV, dedup queues, scored document collections and time series over plain
Redis structures (a sorted set per (collection, subset) for score order, a
hash per document), so any Redis-compatible server works, the embedded
``MiniRedis`` of storage/resp.py included.

URL format: ``redis://[:password@]host:port[/db]`` or
``redis+cluster://[:password@]host:port[?addr=host2:port2&addr=...]``;
cluster mode routes per key slot, follows MOVED/ASK and runs scans and
purges on every master (storage/resp.RespClusterClient)."""

from __future__ import annotations

import json
import uuid

from .cache import CacheStore, _match_categories
from .resp import RespClient, RespClusterClient
from .types import Score, TimeSeriesPoint


def _parse_cluster_url(url: str) -> tuple[list[tuple[str, int]], str | None]:
    """redis+cluster://[:pass@]host:port[?addr=h2:p2&addr=...] -> nodes."""
    import urllib.parse

    parsed = urllib.parse.urlparse(url)
    password = parsed.password or None
    nodes = [(parsed.hostname or "127.0.0.1", parsed.port or 6379)]
    for a in urllib.parse.parse_qs(parsed.query).get("addr", []):
        host, _, port_s = a.rpartition(":")
        nodes.append((host, int(port_s)))
    return nodes, password


def _parse_url(url: str) -> tuple[str, int, int, str | None]:
    rest = url[len("redis://"):]
    password = None
    if "@" in rest:
        auth, rest = rest.rsplit("@", 1)
        password = auth.split(":", 1)[-1] or None
    db = 0
    if "/" in rest:
        rest, db_s = rest.split("/", 1)
        db = int(db_s or 0)
    host, _, port_s = rest.partition(":")
    return host or "127.0.0.1", int(port_s or 6379), db, password


class RedisCacheStore(CacheStore):
    """CacheStore over RESP (reference: storage/cache/redis.go).

    ``key_prefix`` mirrors the reference's cache_table_prefix applied to
    redis keys; ``client_name`` is CLIENT SETNAME (config cache_client_name,
    config/config.go:83 + StorageOptions); ``max_search_results`` caps
    search_scores result sets (config database.redis.max_search_results)."""

    def __init__(
        self,
        url: str,
        key_prefix: str = "",
        client_name: str = "",
        max_search_results: int = 0,
    ) -> None:
        if url.startswith("redis+cluster://"):
            nodes, password = _parse_cluster_url(url)
            self._c = RespClusterClient(nodes, password=password)
        else:
            host, port, db, password = _parse_url(url)
            self._c = RespClient(host, port, db=db, password=password)
        self._p = key_prefix
        self._max_search = max_search_results
        if client_name:
            try:
                self._c.call("CLIENT", "SETNAME", client_name)
            except Exception:  # noqa: BLE001 — optional on minimal servers
                pass

    # --- key layout
    def _zs(self, collection: str, subset: str) -> str:
        return f"{self._p}zs:{collection}/{subset}"

    def _doc(self, collection: str, subset: str, doc_id: str) -> str:
        return f"{self._p}doc:{collection}/{subset}/{doc_id}"

    # --- KV
    def set(self, k, v) -> None:
        self._c.call("SET", f"{self._p}kv:{k}", v)

    def get(self, k):
        return self._c.call("GET", f"{self._p}kv:{k}")

    def delete(self, k) -> None:
        self._c.call("DEL", f"{self._p}kv:{k}")

    # --- queues (dedup via companion set, matching the SQL backend's
    # insert-if-absent semantics)
    def push(self, name, value) -> None:
        if self._c.call("SADD", f"{self._p}qm:{name}", value):
            self._c.call("RPUSH", f"{self._p}q:{name}", value)

    def pop(self, name):
        v = self._c.call("LPOP", f"{self._p}q:{name}")
        if v is not None:
            self._c.call("SREM", f"{self._p}qm:{name}", v)
        return v

    def remain(self, name) -> int:
        return self._c.call("LLEN", f"{self._p}q:{name}")

    # --- scored collections
    def add_scores(self, collection, subset, scores) -> None:
        cmds: list[tuple] = [("SADD", f"{self._p}subs:{collection}", subset)]
        for s in scores:
            cmds.append(("ZADD", self._zs(collection, subset), s.score, s.id))
            cmds.append((
                "HSET", self._doc(collection, subset, s.id),
                "categories", json.dumps(s.categories),
                "timestamp", repr(s.timestamp),
                "is_hidden", "0",
            ))
        self._c.pipeline(cmds)

    def _subset_rows(self, collection: str, subset: str) -> list[Score]:
        """All docs of a subset in descending score order, hidden included."""
        flat = self._c.call("ZRANGE", self._zs(collection, subset), "0", "-1", "REV", "WITHSCORES") or []
        ids = flat[0::2]
        zscores = [float(x) for x in flat[1::2]]
        docs = self._c.pipeline([("HGETALL", self._doc(collection, subset, i)) for i in ids])
        out = []
        for doc_id, zscore, fields in zip(ids, zscores, docs):
            d = dict(zip(fields[0::2], fields[1::2])) if fields else {}
            s = Score(
                id=doc_id,
                score=zscore,
                categories=json.loads(d.get("categories") or "[]"),
                timestamp=float(d.get("timestamp") or 0.0),
            )
            s._hidden = d.get("is_hidden") == "1"  # transient, backend-internal
            out.append(s)
        return out

    def search_scores(self, collection, subset, categories=None, begin=0, end=-1):
        matched = [
            s
            for s in self._subset_rows(collection, subset)
            if not s._hidden and _match_categories(s.categories, categories)
        ]
        if end < 0:
            end = len(matched)
        if self._max_search > 0:
            end = min(end, begin + self._max_search)
        return matched[begin:end]

    def _subsets(self, collection: str) -> list[str]:
        return self._c.call("SMEMBERS", f"{self._p}subs:{collection}") or []

    def _drop_doc(self, collection: str, subset: str, doc_id: str) -> list[tuple]:
        return [
            ("ZREM", self._zs(collection, subset), doc_id),
            ("DEL", self._doc(collection, subset, doc_id)),
        ]

    def delete_scores(self, collection, subsets=None, before=None) -> None:
        targets = self._subsets(collection) if subsets is None else subsets
        cmds: list[tuple] = []
        for subset in targets:
            rows = self._subset_rows(collection, subset)
            for s in rows:
                if before is None or s.timestamp < before:
                    cmds.extend(self._drop_doc(collection, subset, s.id))
            if before is None:
                cmds.append(("SREM", f"{self._p}subs:{collection}", subset))
        self._c.pipeline(cmds)

    def update_scores(self, collections, subset, item_id, categories=None, is_hidden=None) -> None:
        cmds: list[tuple] = []
        for collection in collections:
            targets = [subset] if subset is not None else self._subsets(collection)
            for ss in targets:
                doc = self._doc(collection, ss, item_id)
                if not self._c.call("EXISTS", doc):
                    continue
                if is_hidden is not None:
                    cmds.append(("HSET", doc, "is_hidden", "1" if is_hidden else "0"))
                if categories is not None:
                    cmds.append(("HSET", doc, "categories", json.dumps(categories)))
        self._c.pipeline(cmds)

    def scan_scores(self, collection):
        for subset in self._subsets(collection):
            for s in self._subset_rows(collection, subset):
                yield subset, s

    def scan_score_subsets(self, collection):
        return self._subsets(collection)

    # --- time series (sorted set keyed by timestamp; unique member suffix
    # allows equal-valued points)
    def add_time_series_points(self, points) -> None:
        cmds: list[tuple] = []
        for p in points:
            member = json.dumps([p.name, p.timestamp, p.value, uuid.uuid4().hex[:8]])
            cmds.append(("ZADD", f"{self._p}ts:{p.name}", p.timestamp, member))
            cmds.append(("SADD", f"{self._p}tsn", p.name))
        self._c.pipeline(cmds)

    def get_time_series_points(self, name, begin, end):
        members = self._c.call("ZRANGE", f"{self._p}ts:{name}", "0", "-1") or []
        out = []
        for m in members:
            n, ts, value, _ = json.loads(m)
            if begin <= ts <= end:
                out.append(TimeSeriesPoint(n, ts, value))
        out.sort(key=lambda p: p.timestamp)
        return out

    def ping(self) -> bool:
        try:
            return self._c.call("PING") == "PONG"
        except Exception:  # noqa: BLE001 — ping answers reachability
            return False

    def purge(self) -> None:
        cluster = getattr(self._c, "is_cluster", False)
        for prefix in ("kv", "q", "qm", "zs", "doc", "subs", "ts"):
            pattern = f"{self._p}{prefix}:*"
            if cluster:
                # per-master scan + slot-safe single-key deletes (the
                # reference's ForEachMaster purge, redis.go:451-463)
                keys = [k for node in self._c.call_all("KEYS", pattern) for k in (node or [])]
                if keys:
                    self._c.pipeline([("DEL", k) for k in keys])
            else:
                keys = self._c.call("KEYS", pattern) or []
                if keys:
                    self._c.call("DEL", *keys)
        self._c.call("DEL", f"{self._p}tsn")

    def close(self) -> None:
        self._c.close()
