"""The storage proxy: the master's own stores for nodes over gRPC (port of
gorse_tpu/storage/proxy.py).

As gorse's storage proxy services (registered on the master's gRPC server,
master/master.go:391-393, chosen by the worker and the server for the
master's local engines, worker/worker.go:164-223, server/server.go:177-226):
when the master's data and cache stores are node-local (``memory://``,
``sqlite://``), the other nodes reach them through the master's gRPC port
instead of a database of their own. One generic ``StorageProxy`` service
has two methods, unary ``Call`` and server-streaming ``CallStream`` (row
streams, 512 rows a message), carrying JSON-encoded method calls with
entities and numpy arrays tagged; the client classes implement the
``DataStore``, ``CacheStore`` and ``VectorStore`` interfaces, so
``proxy://host:port`` is a store URL like any other. The service runs on
protocol/grpcwire.py, the wire the reference's grpcio speaks.
"""

from __future__ import annotations

import base64
import json
import logging
from typing import Iterator

import numpy as np

from .cache import CacheStore
from .data import DataStore
from .types import Feedback, Item, Score, TimeSeriesPoint, User
from .vectors import VectorStore

logger = logging.getLogger(__name__)

_SERVICE = "gorse_tpu.StorageProxy"
_STREAM_CHUNK = 512  # rows per streamed message

_TAGGED = {
    "User": User,
    "Item": Item,
    "Feedback": Feedback,
    "Score": Score,
}


def _enc(v):
    """A value in the JSON wire format (entities and arrays tagged)."""
    if isinstance(v, (User, Item, Feedback, Score)):
        return {"__t__": type(v).__name__, "d": v.to_dict()}
    if isinstance(v, TimeSeriesPoint):
        return {"__t__": "TimeSeriesPoint", "d": [v.name, v.timestamp, v.value]}
    if isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        return {
            "__t__": "ndarray",
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "b64": base64.b64encode(arr.tobytes()).decode(),
        }
    if isinstance(v, (list, tuple)):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    return v


def _dec(v):
    if isinstance(v, list):
        return [_dec(x) for x in v]
    if isinstance(v, dict):
        tag = v.get("__t__")
        if tag is None:
            return {k: _dec(x) for k, x in v.items()}
        if tag == "ndarray":
            arr = np.frombuffer(base64.b64decode(v["b64"]), dtype=np.dtype(v["dtype"]))
            return arr.reshape(v["shape"]).copy()
        if tag == "TimeSeriesPoint":
            return TimeSeriesPoint(*v["d"])
        return _TAGGED[tag].from_dict(v["d"])
    return v


# Methods whose results are row streams (reference: the *Stream RPCs).
_STREAM_METHODS = {
    ("data", "get_users"),
    ("data", "get_items"),
    ("data", "get_feedback"),
    ("cache", "scan_scores"),
}


def add_storage_proxy(server, data=None, cache=None, vectors=None) -> None:
    """Register the StorageProxy service on a grpcwire.Server (gorse's
    master registers CacheStoreServer, DataStoreServer and
    VectorStoreServer, master/master.go:391-393)."""
    from ..protocol import grpcwire

    stores = {"data": data, "cache": cache, "vectors": vectors}

    def _target(req_bytes: bytes, context):
        req = json.loads(req_bytes.decode())
        store = stores.get(req["store"])
        if store is None:
            context.abort(
                grpcwire.StatusCode.UNIMPLEMENTED, f"no {req['store']} store proxied"
            )
        method = req["method"]
        if method.startswith("_") or not hasattr(store, method):
            context.abort(grpcwire.StatusCode.UNIMPLEMENTED, f"unknown method {method}")
        args = _dec(req.get("args") or [])
        kwargs = _dec(req.get("kwargs") or {})
        return store, method, args, kwargs

    def call(req_bytes: bytes, context) -> bytes:
        store, method, args, kwargs = _target(req_bytes, context)
        try:
            result = getattr(store, method)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — surfaced to the remote caller
            context.abort(grpcwire.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        return json.dumps({"result": _enc(result)}).encode()

    def call_stream(req_bytes: bytes, context) -> Iterator[bytes]:
        store, method, args, kwargs = _target(req_bytes, context)
        try:
            rows: list = []
            for row in getattr(store, method)(*args, **kwargs):
                rows.append(_enc(row))
                if len(rows) >= _STREAM_CHUNK:
                    yield json.dumps({"rows": rows}).encode()
                    rows = []
            yield json.dumps({"rows": rows, "eof": True}).encode()
        except Exception as e:  # noqa: BLE001
            context.abort(grpcwire.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

    handlers = grpcwire.method_handlers_generic_handler(
        _SERVICE,
        {
            "Call": grpcwire.unary_unary_rpc_method_handler(call),
            "CallStream": grpcwire.unary_stream_rpc_method_handler(call_stream),
        },
    )
    server.add_generic_rpc_handlers((handlers,))


class _ProxyBase:
    """Shared channel + invocation plumbing for the proxy store clients."""

    _store: str

    def __init__(self, target: str, channel=None, tls=None) -> None:
        """A store over the proxy at ``target`` (host:port), through
        ``channel`` when given (shared by the stores of one node), else its
        own channel, over TLS with ``tls`` (utils.tls.TLSConfig)."""
        from ..utils.tls import make_channel

        self._own_channel = channel is None
        self._channel = channel if channel is not None else make_channel(target, tls)
        self._call_rpc = self._channel.unary_unary(f"/{_SERVICE}/Call")
        self._stream_rpc = self._channel.unary_stream(f"/{_SERVICE}/CallStream")

    def _request(self, method: str, *args, **kwargs) -> bytes:
        return json.dumps(
            {
                "store": self._store,
                "method": method,
                "args": _enc(list(args)),
                "kwargs": _enc(kwargs),
            }
        ).encode()

    def _call(self, method: str, *args, **kwargs):
        resp = self._call_rpc(self._request(method, *args, **kwargs))
        return _dec(json.loads(resp.decode())["result"])

    def _stream(self, method: str, *args, **kwargs) -> Iterator:
        for msg in self._stream_rpc(self._request(method, *args, **kwargs)):
            for row in json.loads(msg.decode())["rows"]:
                yield _dec(row)

    def ping(self) -> bool:
        try:
            return bool(self._call("ping"))
        except Exception:  # noqa: BLE001 — ping answers reachability
            return False

    def close(self) -> None:
        if self._own_channel:
            self._channel.close()


class ProxyDataStore(_ProxyBase, DataStore):
    """DataStore over the master's gRPC proxy (data_store.proto analog)."""

    _store = "data"

    def insert_users(self, users) -> None:
        self._call("insert_users", list(users))

    def get_user(self, user_id):
        return self._call("get_user", user_id)

    def delete_user(self, user_id) -> None:
        self._call("delete_user", user_id)

    def get_users(self, begin_id: str = "", limit=None):
        return self._stream("get_users", begin_id, limit)

    def insert_items(self, items) -> None:
        self._call("insert_items", list(items))

    def get_item(self, item_id):
        return self._call("get_item", item_id)

    def delete_item(self, item_id) -> None:
        self._call("delete_item", item_id)

    def get_items(self, begin_id: str = "", limit=None):
        return self._stream("get_items", begin_id, limit)

    def batch_get_items(self, item_ids, skip_hidden=False, after=None):
        return self._call("batch_get_items", item_ids, skip_hidden, after)

    def reconcile(self, search_columns) -> None:
        self._call("reconcile", list(search_columns))

    def search_items(self, query: str, n: int, columns=None):
        return self._call("search_items", query, n, columns)

    def get_latest_items(self, limit, categories=None, after=None):
        return self._call("get_latest_items", limit, categories, after)

    def insert_feedback(self, feedback, insert_user=True, insert_item=True, overwrite=True) -> None:
        self._call("insert_feedback", list(feedback), insert_user, insert_item, overwrite)

    def get_user_feedback(self, user_id, end_time=None, feedback_types=None):
        return self._call("get_user_feedback", user_id, end_time, feedback_types)

    def get_item_feedback(self, item_id, feedback_types=None):
        return self._call("get_item_feedback", item_id, feedback_types)

    def get_feedback(self, begin_time=None, end_time=None, feedback_types=None):
        return self._stream("get_feedback", begin_time, end_time, feedback_types)

    def delete_user_item_feedback(self, user_id, item_id, feedback_types=None) -> int:
        return self._call("delete_user_item_feedback", user_id, item_id, feedback_types)

    def count_users(self) -> int:
        return self._call("count_users")

    def count_items(self) -> int:
        return self._call("count_items")

    def count_feedback(self) -> int:
        return self._call("count_feedback")

    def purge(self) -> None:
        self._call("purge")


class ProxyCacheStore(_ProxyBase, CacheStore):
    """CacheStore over the master's gRPC proxy (cache_store.proto analog)."""

    _store = "cache"

    def set(self, k, v) -> None:
        self._call("set", k, v)

    def get(self, k):
        return self._call("get", k)

    def delete(self, k) -> None:
        self._call("delete", k)

    def push(self, name, value) -> None:
        self._call("push", name, value)

    def pop(self, name):
        return self._call("pop", name)

    def remain(self, name) -> int:
        return self._call("remain", name)

    def add_scores(self, collection, subset, scores) -> None:
        self._call("add_scores", collection, subset, list(scores))

    def search_scores(self, collection, subset, categories=None, begin=0, end=-1):
        return self._call("search_scores", collection, subset, categories, begin, end)

    def delete_scores(self, collection, subsets=None, before=None) -> None:
        self._call("delete_scores", collection, subsets, before)

    def update_scores(self, collections, subset, item_id, categories=None, is_hidden=None) -> None:
        self._call("update_scores", collections, subset, item_id, categories, is_hidden)

    def scan_scores(self, collection):
        # rows stream as [subset, Score] pairs
        for row in self._stream("scan_scores", collection):
            yield row[0], row[1]

    def scan_score_subsets(self, collection):
        return self._call("scan_score_subsets", collection)

    def add_time_series_points(self, points) -> None:
        self._call("add_time_series_points", list(points))

    def get_time_series_points(self, name, begin, end):
        return self._call("get_time_series_points", name, begin, end)

    def purge(self) -> None:
        self._call("purge")


class ProxyVectorStore(_ProxyBase, VectorStore):
    """VectorStore over the master's gRPC proxy (vector_store.proto analog);
    queries execute on the master's device top-k kernel."""

    _store = "vectors"

    def create_collection(self, name, dimensions, distance="dot", quantization="", bits=0) -> None:
        self._call("create_collection", name, dimensions, distance, quantization, bits)

    def describe_collection(self, name):
        return self._call("describe_collection", name)

    def list_collections(self) -> list[str]:
        return self._call("list_collections")

    def has_collection(self, name) -> bool:
        return self._call("has_collection", name)

    def drop_collection(self, name) -> None:
        self._call("drop_collection", name)

    def add(self, collection, ids, vectors) -> None:
        self._call("add", collection, list(ids), np.asarray(vectors, dtype=np.float32))

    def delete(self, collection, ids) -> None:
        self._call("delete", collection, list(ids))

    def query(self, collection, vectors, k):
        return self._call("query", collection, np.asarray(vectors, dtype=np.float32), k)
