"""In-process mock vector databases: MiniQdrant, MiniWeaviate, MiniMilvus
(copy of gorse_tpu/storage/minivector.py).

They stand in for the Qdrant, Weaviate and Milvus services that gorse's
vector-store tests run against in its CI. Each mock
implements its engine's REST surface **with the engine's native distance
semantics** (Qdrant Euclid returns raw distances ascending, Weaviate returns
dot/cosine/l2-squared *distances*, Milvus L2 returns squared distances) so the
score conversions in vectordb.py are genuinely exercised, and checks the
engine's auth header.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["MiniMilvus", "MiniQdrant", "MiniWeaviate"]


class _Backend:
    """name -> {dim, distance(one of Dot/Cosine/Euclid-style engine names is
    kept by each mock), rows: {key -> (vector, meta)}}"""

    def __init__(self) -> None:
        self.collections: dict[str, dict] = {}
        self.lock = threading.Lock()


def _scores(rows: dict, vector: np.ndarray, mode: str) -> list[tuple[str, float, dict]]:
    """mode: 'dot' | 'cosine' | 'l2' (raw distance) | 'l2sq'."""
    out = []
    q = np.asarray(vector, dtype=np.float32)
    for key, (vec, meta) in rows.items():
        if mode == "dot":
            s = float(q @ vec)
        elif mode == "cosine":
            denom = float(np.linalg.norm(q) * np.linalg.norm(vec)) or 1.0
            s = float(q @ vec) / denom
        elif mode == "l2":
            s = float(np.linalg.norm(q - vec))
        else:
            s = float(np.sum((q - vec) ** 2))
        out.append((key, s, meta))
    reverse = mode in ("dot", "cosine")
    out.sort(key=lambda t: -t[1] if reverse else t[1])
    return out


class _JSONHandler(BaseHTTPRequestHandler):
    mini: "object"

    def log_message(self, fmt, *args):
        pass

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw) if raw.strip() else {}

    def _reply(self, status: int, doc) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _MiniHTTP:
    def __init__(self, handler_cls) -> None:
        mini = self

        class Handler(handler_cls):
            pass

        Handler.mini = mini
        self.backend = _Backend()
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# MiniQdrant
# ---------------------------------------------------------------------------

_QDRANT_MODE = {"Dot": "dot", "Cosine": "cosine", "Euclid": "l2"}


class _QdrantHandler(_JSONHandler):
    def _auth(self) -> bool:
        want = self.mini.api_key  # type: ignore[attr-defined]
        return not want or self.headers.get("api-key") == want

    def _dispatch(self):
        if not self._auth():
            return self._reply(401, {"status": {"error": "invalid api key"}})
        be: _Backend = self.mini.backend  # type: ignore[attr-defined]
        path = urllib.parse.unquote(self.path.partition("?")[0])
        parts = [p for p in path.split("/") if p]
        with be.lock:
            if parts == ["collections"] and self.command == "GET":
                return self._reply(
                    200,
                    {"result": {"collections": [{"name": n} for n in be.collections]}},
                )
            if len(parts) == 2 and parts[0] == "collections":
                name = parts[1]
                if self.command == "PUT":
                    body = self._body()
                    be.collections[name] = {
                        "vectors": body["vectors"],
                        "quantization_config": body.get("quantization_config"),
                        "rows": {},
                    }
                    return self._reply(200, {"result": True, "status": "ok"})
                if self.command == "GET":
                    coll = be.collections.get(name)
                    if coll is None:
                        return self._reply(404, {"status": {"error": "not found"}})
                    return self._reply(
                        200,
                        {
                            "result": {
                                "config": {
                                    "params": {"vectors": coll["vectors"]},
                                    "quantization_config": coll["quantization_config"],
                                }
                            }
                        },
                    )
                if self.command == "DELETE":
                    be.collections.pop(name, None)
                    return self._reply(200, {"result": True})
            if len(parts) >= 3 and parts[0] == "collections":
                name, action = parts[1], "/".join(parts[2:])
                coll = be.collections.get(name)
                if coll is None:
                    return self._reply(404, {"status": {"error": "not found"}})
                if action == "points" and self.command == "PUT":
                    for p in self._body()["points"]:
                        coll["rows"][p["id"]] = (
                            np.asarray(p["vector"], dtype=np.float32),
                            p.get("payload") or {},
                        )
                    return self._reply(200, {"result": {"status": "acknowledged"}})
                if action == "points/delete":
                    for pid in self._body()["points"]:
                        coll["rows"].pop(pid, None)
                    return self._reply(200, {"result": {"status": "acknowledged"}})
                if action == "points/search/batch":
                    mode = _QDRANT_MODE[coll["vectors"]["distance"]]
                    results = []
                    for search in self._body()["searches"]:
                        hits = _scores(coll["rows"], search["vector"], mode)
                        results.append(
                            [
                                {"id": key, "score": s, "payload": meta}
                                for key, s, meta in hits[: search["limit"]]
                            ]
                        )
                    return self._reply(200, {"result": results})
        return self._reply(404, {"status": {"error": f"no route {path}"}})

    do_GET = do_PUT = do_POST = do_DELETE = _dispatch


class MiniQdrant(_MiniHTTP):
    def __init__(self, api_key: str = "qdrant_key") -> None:
        super().__init__(_QdrantHandler)
        self.api_key = api_key


# ---------------------------------------------------------------------------
# MiniWeaviate
# ---------------------------------------------------------------------------

_WEAVIATE_MODE = {"dot": "dot", "cosine": "cosine", "l2-squared": "l2sq"}
_GQL = re.compile(
    r"\{ Get \{ (\w+)\(nearVector: \{vector: (\[[^]]*\])\}, limit: (\d+)\)"
)


class _WeaviateHandler(_JSONHandler):
    def _auth(self) -> bool:
        want = self.mini.api_key  # type: ignore[attr-defined]
        return not want or self.headers.get("Authorization") == f"Bearer {want}"

    def _dispatch(self):
        if not self._auth():
            return self._reply(401, {"error": [{"message": "unauthorized"}]})
        be: _Backend = self.mini.backend  # type: ignore[attr-defined]
        path = urllib.parse.unquote(self.path.partition("?")[0])
        parts = [p for p in path.split("/") if p]
        with be.lock:
            if parts[:2] == ["v1", "schema"]:
                if len(parts) == 2 and self.command == "GET":
                    return self._reply(
                        200,
                        {"classes": [c["class_obj"] for c in be.collections.values()]},
                    )
                if len(parts) == 2 and self.command == "POST":
                    body = self._body()
                    be.collections[body["class"]] = {"class_obj": body, "rows": {}}
                    return self._reply(200, body)
                if len(parts) == 3:
                    cls = parts[2]
                    if self.command == "GET":
                        c = be.collections.get(cls)
                        if c is None:
                            return self._reply(404, {"error": "not found"})
                        return self._reply(200, c["class_obj"])
                    if self.command == "DELETE":
                        be.collections.pop(cls, None)
                        return self._reply(200, {})
            if parts == ["v1", "batch", "objects"] and self.command == "POST":
                for obj in self._body()["objects"]:
                    c = be.collections.get(obj["class"])
                    if c is None:
                        return self._reply(422, {"error": "no such class"})
                    c["rows"][obj["id"]] = (
                        np.asarray(obj["vector"], dtype=np.float32),
                        obj.get("properties") or {},
                    )
                return self._reply(200, [])
            if parts[:2] == ["v1", "objects"] and self.command == "DELETE":
                cls, oid = parts[2], parts[3]
                c = be.collections.get(cls)
                if c is not None:
                    c["rows"].pop(oid, None)
                return self._reply(204, {})
            if parts == ["v1", "graphql"] and self.command == "POST":
                m = _GQL.search(self._body()["query"])
                if not m:
                    return self._reply(400, {"errors": [{"message": "bad query"}]})
                cls, vec, limit = m.group(1), json.loads(m.group(2)), int(m.group(3))
                c = be.collections.get(cls)
                if c is None:
                    return self._reply(200, {"data": {"Get": {cls: []}}})
                mode = _WEAVIATE_MODE[
                    c["class_obj"]["vectorIndexConfig"]["distance"]
                ]
                hits = _scores(c["rows"], vec, mode)
                # weaviate always returns *distances*, ascending
                dists = []
                for key, s, meta in hits:
                    if mode == "dot":
                        dists.append((-s, meta))
                    elif mode == "cosine":
                        dists.append((1.0 - s, meta))
                    else:
                        dists.append((s, meta))
                dists.sort(key=lambda t: t[0])
                return self._reply(
                    200,
                    {
                        "data": {
                            "Get": {
                                cls: [
                                    {
                                        "docId": meta.get("docId", ""),
                                        "_additional": {"distance": d},
                                    }
                                    for d, meta in dists[:limit]
                                ]
                            }
                        }
                    },
                )
        return self._reply(404, {"error": f"no route {path}"})

    do_GET = do_PUT = do_POST = do_DELETE = _dispatch


class MiniWeaviate(_MiniHTTP):
    def __init__(self, api_key: str = "weaviate_key") -> None:
        super().__init__(_WeaviateHandler)
        self.api_key = api_key


# ---------------------------------------------------------------------------
# MiniMilvus
# ---------------------------------------------------------------------------

_MILVUS_MODE = {"IP": "dot", "COSINE": "cosine", "L2": "l2sq"}


class _MilvusHandler(_JSONHandler):
    def _auth(self) -> bool:
        want = self.mini.token  # type: ignore[attr-defined]
        return not want or self.headers.get("Authorization") == f"Bearer {want}"

    def do_POST(self):
        if not self._auth():
            return self._reply(401, {"code": 1800, "message": "auth check failure"})
        be: _Backend = self.mini.backend  # type: ignore[attr-defined]
        path = self.path.partition("?")[0]
        body = self._body()
        with be.lock:
            if path == "/v2/vectordb/collections/create":
                be.collections[body["collectionName"]] = {
                    "dim": int(body["dimension"]),
                    "metric": body.get("metricType", "IP"),
                    "indexes": body.get("indexParams") or [],
                    "rows": {},
                }
                return self._reply(200, {"code": 0, "data": {}})
            if path == "/v2/vectordb/collections/list":
                return self._reply(200, {"code": 0, "data": sorted(be.collections)})
            if path == "/v2/vectordb/collections/describe":
                c = be.collections.get(body["collectionName"])
                if c is None:
                    return self._reply(
                        200, {"code": 100, "message": "collection not found"}
                    )
                return self._reply(
                    200,
                    {
                        "code": 0,
                        "data": {
                            "collectionName": body["collectionName"],
                            "fields": [
                                {"name": "id", "type": "VarChar"},
                                {
                                    "name": "vector",
                                    "type": "FloatVector",
                                    "params": {"dim": c["dim"]},
                                },
                            ],
                            "indexes": c.get("indexes")
                            or [{"fieldName": "vector", "metricType": c["metric"]}],
                        },
                    },
                )
            if path == "/v2/vectordb/collections/drop":
                be.collections.pop(body["collectionName"], None)
                return self._reply(200, {"code": 0, "data": {}})
            c = be.collections.get(body.get("collectionName", ""))
            if c is None:
                return self._reply(200, {"code": 100, "message": "collection not found"})
            if path == "/v2/vectordb/entities/upsert":
                for row in body["data"]:
                    c["rows"][row["id"]] = (
                        np.asarray(row["vector"], dtype=np.float32),
                        {"id": row["id"]},
                    )
                return self._reply(200, {"code": 0, "data": {"upsertCount": len(body["data"])}})
            if path == "/v2/vectordb/entities/delete":
                m = re.search(r"id in \[(.*)\]", body.get("filter", ""))
                ids = json.loads(f"[{m.group(1)}]") if m else []
                for i in ids:
                    c["rows"].pop(i, None)
                return self._reply(200, {"code": 0, "data": {}})
            if path == "/v2/vectordb/entities/search":
                mode = _MILVUS_MODE[c["metric"]]
                hits = _scores(c["rows"], body["data"][0], mode)
                return self._reply(
                    200,
                    {
                        "code": 0,
                        "data": [
                            {"id": key, "distance": s}
                            for key, s, _ in hits[: body.get("limit", 10)]
                        ],
                    },
                )
        return self._reply(404, {"code": 404, "message": f"no route {path}"})


class MiniMilvus(_MiniHTTP):
    def __init__(self, token: str = "root:Milvus") -> None:
        super().__init__(_MilvusHandler)
        self.token = token
