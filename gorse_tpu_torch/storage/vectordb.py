"""External vector-database stores: Qdrant, Weaviate, Milvus (copy of
gorse_tpu/storage/vectordb.py), as stdlib REST clients:

- **Qdrant**: collections API, points upsert/delete/search-batch; string
  document ids ride in the payload (a point id is the UUID5 of the
  document id); ``sq`` quantization maps to Qdrant's scalar int8.
- **Weaviate**: schema, batch objects and GraphQL ``nearVector`` queries;
  the collection's metadata sits in the class description (classes are
  named ``C<hex>``).
- **Milvus**: the RESTful v2 API (collections and entities endpoints).

Scores follow the native stores (vectors.py): dot and cosine scores are
similarities, euclidean scores negative squared distances."""

from __future__ import annotations

import json
import urllib.parse
import uuid

import numpy as np

from .object import _http_request
from .types import Score
from .vectors import DISTANCES, VectorStore

__all__ = [
    "MilvusVectorStore",
    "QdrantVectorStore",
    "WeaviateVectorStore",
]


def _doc_uuid(doc_id: str) -> str:
    return str(uuid.uuid5(uuid.NAMESPACE_URL, doc_id))


class _RESTClient:
    def __init__(self, host: str, port: int, headers: dict[str, str], secure: bool = False):
        self.host, self.port, self.secure = host, port, secure
        self.headers = headers

    def call(self, method: str, path: str, body: dict | None = None,
             ok: tuple = (200,)) -> dict:
        payload = json.dumps(body).encode() if body is not None else b""
        headers = dict(self.headers)
        headers["Host"] = f"{self.host}:{self.port}"
        if payload:
            headers["Content-Type"] = "application/json"
        status, _, data = _http_request(
            self.host, self.port, self.secure, method, path, headers, payload
        )
        if status not in ok:
            raise IOError(f"{method} {path}: HTTP {status} {data[:300]!r}")
        return json.loads(data) if data.strip() else {}


# ---------------------------------------------------------------------------
# Qdrant
# ---------------------------------------------------------------------------

_QDRANT_DIST = {"dot": "Dot", "cosine": "Cosine", "euclidean": "Euclid"}
_QDRANT_DIST_INV = {v: k for k, v in _QDRANT_DIST.items()}
# pq bits/dimension -> Qdrant product-quantization compression ratio
# (reference: storage/vectors/qdrant.go:179-195)
_QDRANT_PQ_COMPRESSION = {8: "x4", 4: "x8", 2: "x16", 1: "x32"}
_QDRANT_PQ_COMPRESSION_INV = {v: k for k, v in _QDRANT_PQ_COMPRESSION.items()}


def _qdrant_quantization_config(quantization: str, bits: int) -> dict | None:
    """Reference: qdrantQuantizationConfig (storage/vectors/qdrant.go:153-199);
    rq maps to Qdrant's binary/TurboQuant family with 1/2/4-bit codes."""
    if not quantization:
        return None
    if quantization == "sq":
        if bits not in (0, 8):
            raise ValueError(f"sq quantization bits {bits} for Qdrant")
        return {"scalar": {"type": "int8"}}
    if quantization == "pq":
        cfg: dict = {}
        if bits:
            if bits not in _QDRANT_PQ_COMPRESSION:
                raise ValueError(f"pq quantization bits {bits} for Qdrant")
            cfg["compression"] = _QDRANT_PQ_COMPRESSION[bits]
        return {"product": cfg}
    if quantization == "rq":
        cfg = {}
        if bits:
            if bits not in (1, 2, 4):
                raise ValueError(f"rq quantization bits {bits} for Qdrant")
            cfg["bits"] = bits
        return {"binary": cfg}
    raise ValueError(f"quantization type {quantization!r} for Qdrant")


def _qdrant_parse_quantization(quant: dict | None) -> tuple[str, int]:
    """Inverse of :func:`_qdrant_quantization_config` (qdrant.go:202-250)."""
    if not quant:
        return "", 0
    if "scalar" in quant:
        return "sq", 8
    if "product" in quant:
        comp = (quant["product"] or {}).get("compression")
        return "pq", _QDRANT_PQ_COMPRESSION_INV.get(comp, 0)
    if "binary" in quant:
        return "rq", int((quant["binary"] or {}).get("bits") or 0)
    return "", 0


class QdrantVectorStore(VectorStore):
    def __init__(self, host: str, port: int = 6333, api_key: str = "",
                 secure: bool = False) -> None:
        headers = {"api-key": api_key} if api_key else {}
        self.c = _RESTClient(host, port, headers, secure)
        self._dist: dict[str, str] = {}  # collection -> distance (immutable)

    def create_collection(self, name, dimensions, distance="dot",
                          quantization="", bits=0) -> None:
        if distance not in DISTANCES:
            raise ValueError(f"unknown distance {distance!r}")
        body: dict = {
            "vectors": {"size": int(dimensions), "distance": _QDRANT_DIST[distance]}
        }
        qc = _qdrant_quantization_config(quantization, bits)
        if qc is not None:
            body["quantization_config"] = qc
        self.c.call("PUT", f"/collections/{urllib.parse.quote(name)}", body)
        self._dist[name] = distance

    def describe_collection(self, name):
        try:
            r = self.c.call("GET", f"/collections/{urllib.parse.quote(name)}")
        except IOError:
            return None
        cfg = r["result"]["config"]["params"]["vectors"]
        quant, bits = _qdrant_parse_quantization(
            r["result"]["config"].get("quantization_config")
        )
        return {
            "name": name,
            "dimension": int(cfg["size"]),
            "distance": _QDRANT_DIST_INV.get(cfg["distance"], "dot"),
            "quantization": quant,
            "bits": bits,
        }

    def list_collections(self) -> list[str]:
        r = self.c.call("GET", "/collections")
        return sorted(c["name"] for c in r["result"]["collections"])

    def drop_collection(self, name) -> None:
        self.c.call("DELETE", f"/collections/{urllib.parse.quote(name)}", ok=(200, 404))
        self._dist.pop(name, None)

    def add(self, collection, ids, vectors) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        points = [
            {"id": _doc_uuid(i), "vector": v.tolist(), "payload": {"_id": i}}
            for i, v in zip(ids, vectors)
        ]
        self.c.call(
            "PUT",
            f"/collections/{urllib.parse.quote(collection)}/points?wait=true",
            {"points": points},
        )

    def delete(self, collection, ids) -> None:
        self.c.call(
            "POST",
            f"/collections/{urllib.parse.quote(collection)}/points/delete?wait=true",
            {"points": [_doc_uuid(i) for i in ids]},
        )

    def _distance(self, collection: str) -> str:
        if collection not in self._dist:
            info = self.describe_collection(collection) or {}
            self._dist[collection] = info.get("distance", "dot")
        return self._dist[collection]

    def query(self, collection, vectors, k):
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        euclid = self._distance(collection) == "euclidean"
        r = self.c.call(
            "POST",
            f"/collections/{urllib.parse.quote(collection)}/points/search/batch",
            {
                "searches": [
                    {"vector": v.tolist(), "limit": int(k), "with_payload": True}
                    for v in vectors
                ]
            },
        )
        out = []
        for batch in r["result"]:
            hits = batch["result"] if isinstance(batch, dict) else batch
            out.append(
                [
                    # qdrant Euclid returns plain distances; the framework
                    # convention (vectors.py) is negative SQUARED distance
                    Score(
                        h["payload"]["_id"],
                        -(h["score"] ** 2) if euclid else h["score"],
                    )
                    for h in hits
                ]
            )
        return out

    def ping(self) -> bool:
        try:
            self.c.call("GET", "/collections")
            return True
        except Exception:
            return False


# ---------------------------------------------------------------------------
# Weaviate
# ---------------------------------------------------------------------------

_WEAVIATE_DIST = {"dot": "dot", "cosine": "cosine", "euclidean": "l2-squared"}


def _class_name(collection: str) -> str:
    return "C" + collection.encode().hex()


class WeaviateVectorStore(VectorStore):
    def __init__(self, host: str, port: int = 8080, api_key: str = "",
                 secure: bool = False) -> None:
        headers = {"Authorization": f"Bearer {api_key}"} if api_key else {}
        self.c = _RESTClient(host, port, headers, secure)
        self._dist: dict[str, str] = {}

    def create_collection(self, name, dimensions, distance="dot",
                          quantization="", bits=0) -> None:
        if distance not in DISTANCES:
            raise ValueError(f"unknown distance {distance!r}")
        index_config: dict = {"distance": _WEAVIATE_DIST[distance]}
        # reference: weaviateApplyQuantization (storage/vectors/weaviate.go:172-199)
        if quantization in ("sq", "pq"):
            if bits:
                raise ValueError(f"quantization bits for {quantization} on Weaviate")
            index_config[quantization] = {"enabled": True}
        elif quantization == "rq":
            rq: dict = {"enabled": True}
            if bits:
                rq["bits"] = int(bits)
            index_config["rq"] = rq
        elif quantization:
            raise ValueError(f"quantization type {quantization!r} for Weaviate")
        meta = {
            "name": name, "dimension": int(dimensions), "distance": distance,
            "quantization": quantization, "bits": int(bits),
        }
        self.c.call(
            "POST",
            "/v1/schema",
            {
                "class": _class_name(name),
                "description": json.dumps(meta),
                "vectorizer": "none",
                "vectorIndexConfig": index_config,
                "properties": [{"name": "docId", "dataType": ["text"]}],
            },
        )
        self._dist[name] = distance

    def describe_collection(self, name):
        try:
            r = self.c.call("GET", f"/v1/schema/{_class_name(name)}")
        except IOError:
            return None
        return json.loads(r["description"])

    def list_collections(self) -> list[str]:
        r = self.c.call("GET", "/v1/schema")
        names = []
        for cls in r.get("classes", []):
            try:
                names.append(json.loads(cls.get("description", ""))["name"])
            except (ValueError, KeyError):
                continue
        return sorted(names)

    def drop_collection(self, name) -> None:
        self.c.call("DELETE", f"/v1/schema/{_class_name(name)}", ok=(200, 404))
        self._dist.pop(name, None)

    def add(self, collection, ids, vectors) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        cls = _class_name(collection)
        objects = [
            {
                "class": cls,
                "id": _doc_uuid(i),
                "properties": {"docId": i},
                "vector": v.tolist(),
            }
            for i, v in zip(ids, vectors)
        ]
        self.c.call("POST", "/v1/batch/objects", {"objects": objects})

    def delete(self, collection, ids) -> None:
        cls = _class_name(collection)
        for i in ids:
            self.c.call("DELETE", f"/v1/objects/{cls}/{_doc_uuid(i)}", ok=(204, 404))

    def query(self, collection, vectors, k):
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if collection not in self._dist:
            info = self.describe_collection(collection) or {}
            self._dist[collection] = info.get("distance", "dot")
        distance = self._dist[collection]
        cls = _class_name(collection)
        out = []
        for v in vectors:
            gql = (
                f"{{ Get {{ {cls}(nearVector: {{vector: {json.dumps(v.tolist())}}},"
                f" limit: {int(k)}) {{ docId _additional {{ distance }} }} }} }}"
            )
            r = self.c.call("POST", "/v1/graphql", {"query": gql})
            hits = r.get("data", {}).get("Get", {}).get(cls) or []
            scores = []
            for h in hits:
                d = float(h["_additional"]["distance"])
                if distance == "dot":
                    score = -d  # weaviate dot distance = -dot product
                elif distance == "cosine":
                    score = 1.0 - d
                else:
                    # l2-squared distance already matches the framework's
                    # negative-squared-distance convention (vectors.py)
                    score = -d
                scores.append(Score(h["docId"], score))
            out.append(scores)
        return out

    def ping(self) -> bool:
        try:
            self.c.call("GET", "/v1/schema")
            return True
        except Exception:
            return False


# ---------------------------------------------------------------------------
# Milvus (RESTful v2)
# ---------------------------------------------------------------------------

_MILVUS_METRIC = {"dot": "IP", "cosine": "COSINE", "euclidean": "L2"}
_MILVUS_METRIC_INV = {v: k for k, v in _MILVUS_METRIC.items()}


class MilvusVectorStore(VectorStore):
    def __init__(self, host: str, port: int = 19530, token: str = "",
                 secure: bool = False) -> None:
        headers = {"Authorization": f"Bearer {token}"} if token else {}
        self.c = _RESTClient(host, port, headers, secure)
        self._dist: dict[str, str] = {}

    def _call(self, path: str, body: dict) -> dict:
        r = self.c.call("POST", f"/v2/vectordb{path}", body)
        if r.get("code") not in (0, 200):
            raise IOError(f"milvus {path}: {r}")
        return r

    def create_collection(self, name, dimensions, distance="dot",
                          quantization="", bits=0) -> None:
        if distance not in DISTANCES:
            raise ValueError(f"unknown distance {distance!r}")
        # index type per quantization (reference: milvusIndex,
        # storage/vectors/milvus.go:327-356)
        metric = _MILVUS_METRIC[distance]
        if not quantization:
            index = {"indexType": "HNSW", "params": {"M": 16, "efConstruction": 200}}
        elif quantization == "rq":
            if bits:
                raise ValueError(f"rq quantization bits {bits} for Milvus")
            index = {"indexType": "IVF_RABITQ", "params": {"nlist": 128}}
        elif quantization == "pq":
            b = bits or 8
            m = dimensions * b // 8
            if dimensions * b % 8 or m < 1 or m > dimensions or dimensions % m:
                raise ValueError(f"pq quantization bits {bits} for Milvus")
            index = {"indexType": "IVF_PQ", "params": {"nlist": 128, "m": m, "nbits": 8}}
        elif quantization == "sq":
            if bits not in (0, 8):
                raise ValueError(f"sq quantization bits {bits} for Milvus")
            index = {"indexType": "IVF_SQ8", "params": {"nlist": 128}}
        else:
            raise ValueError(f"quantization type {quantization!r} for Milvus")
        index.update({"fieldName": "vector", "indexName": "vector",
                      "metricType": metric})
        self._call(
            "/collections/create",
            {
                "collectionName": name,
                "dimension": int(dimensions),
                "metricType": metric,
                "idType": "VarChar",
                "primaryFieldName": "id",
                "vectorFieldName": "vector",
                "params": {"max_length": "256"},
                "indexParams": [index],
            },
        )
        self._dist[name] = distance

    def describe_collection(self, name):
        try:
            r = self._call("/collections/describe", {"collectionName": name})
        except IOError:
            return None
        d = r["data"]
        dim = 0
        for f in d.get("fields", []):
            if f.get("name") == "vector":
                dim = int((f.get("params") or {}).get("dim") or f.get("dimension", 0))
        metric = "IP"
        quant, bits = "", 0
        for idx in d.get("indexes", []):
            metric = idx.get("metricType", metric)
            # inverse of milvusIndex (reference milvus.go:117-136)
            itype = idx.get("indexType", "")
            params = idx.get("params") or {}
            if itype == "IVF_RABITQ":
                quant, bits = "rq", 0
            elif itype == "IVF_SQ8":
                quant, bits = "sq", 8
            elif itype == "IVF_PQ" and dim:
                quant = "pq"
                bits = int(params.get("m", 0)) * int(params.get("nbits", 8)) // dim
        return {
            "name": name,
            "dimension": dim,
            "distance": _MILVUS_METRIC_INV.get(metric, "dot"),
            "quantization": quant,
            "bits": bits,
        }

    def list_collections(self) -> list[str]:
        r = self._call("/collections/list", {})
        return sorted(r.get("data") or [])

    def drop_collection(self, name) -> None:
        try:
            self._call("/collections/drop", {"collectionName": name})
        except IOError:
            pass
        self._dist.pop(name, None)

    def add(self, collection, ids, vectors) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        self._call(
            "/entities/upsert",
            {
                "collectionName": collection,
                "data": [
                    {"id": i, "vector": v.tolist()} for i, v in zip(ids, vectors)
                ],
            },
        )

    def delete(self, collection, ids) -> None:
        id_list = ", ".join(json.dumps(i) for i in ids)
        self._call(
            "/entities/delete",
            {"collectionName": collection, "filter": f"id in [{id_list}]"},
        )

    def query(self, collection, vectors, k):
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if collection not in self._dist:
            info = self.describe_collection(collection) or {}
            self._dist[collection] = info.get("distance", "dot")
        euclid = self._dist[collection] == "euclidean"
        out = []
        for v in vectors:
            r = self._call(
                "/entities/search",
                {
                    "collectionName": collection,
                    "data": [v.tolist()],
                    "annsField": "vector",
                    "limit": int(k),
                    "outputFields": ["id"],
                },
            )
            hits = r.get("data") or []
            out.append(
                [
                    Score(h["id"], -h["distance"] if euclid else h["distance"])
                    for h in hits
                ]
            )
        return out

    def ping(self) -> bool:
        try:
            self._call("/collections/list", {})
            return True
        except Exception:
            return False
