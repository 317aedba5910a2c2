"""The port's storage proxy and the slice as a whole
(gorse_tpu_torch/storage/proxy.py, the ``proxy://`` openers,
``Master.get_meta``'s rewrite, cmd/nodes_main.py's gRPC plane, the nodes).

- tests/test_proxy_tls.py's cases on the port's classes;
- the port's ``Proxy*Store`` against the reference's ``add_storage_proxy``
  and the reference's against the port's, on one script of calls over the
  data, cache and vector stores: the results equal those of the
  reference's clients on its own server, the error codes and messages too;
- ``Master.get_meta``'s JSON equal to the reference's for the same config;
- the slice: the port's master on ``memory://`` stores with its gRPC plane
  started by ``master_main``'s code (plain and over mutual TLS), a port
  ``WorkerNode`` and ``ServerNode`` on the ``proxy://`` URLs it hands out;
  their cache lists, and the served lists, exactly those of an in-process
  master and worker over the same rows and seed.

Every test runs under ``stall_guard`` (tests/_stall.py): the stores'
calls take no timeout, as the reference's do, so a stalled stream fails
its test at the guard's bound instead of holding the suite.
"""

import json
import urllib.request

import grpc
import numpy as np
import pytest

import gorse_tpu.storage as ref_storage
from gorse_tpu.serve.master import Master as RefMaster
from gorse_tpu.storage import BlobStore as RefBlobStore
from gorse_tpu.storage import MetaStore as RefMetaStore
from gorse_tpu.storage import types as ref_types
from gorse_tpu.storage.vectors import MemoryVectorStore as RefMemoryVectorStore
from gorse_tpu.utils.config import Config as RefConfig
from gorse_tpu_torch import storage as port_storage
from gorse_tpu_torch.cmd.nodes_main import serve_grpc_plane
from gorse_tpu_torch.protocol import grpcwire
from gorse_tpu_torch.protocol.rpc import MasterGrpcClient, serve_master_grpc
from gorse_tpu_torch.serve.dashboard import MasterRestServer
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.serve.nodes import ServerNode, WorkerNode
from gorse_tpu_torch.serve.worker import Worker
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types as port_types
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore, open_cache_store
from gorse_tpu_torch.storage.data import MemoryDataStore, open_data_store
from gorse_tpu_torch.storage.meta import MetaStore
from gorse_tpu_torch.storage.types import Feedback, Item, Score, User
from gorse_tpu_torch.storage.vectors import MemoryVectorStore, open_vector_store
from gorse_tpu_torch.utils.config import Config
from gorse_tpu_torch.utils.tls import generate_test_certs
from _stall import stall_guard  # noqa: F401 - autouse: a stalled stream fails its test

RPC_ERRORS = (grpc.RpcError, grpcwire.RpcError)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU fits on one intra-op thread: the same bits on every run, and
    no oversubscribed cores when the suite runs in parallel."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _proxy_server(side: str, **stores):
    if side == "port":
        server = grpcwire.Server(max_workers=4)
        port_storage.add_storage_proxy(server, **stores)
    else:
        from concurrent.futures import ThreadPoolExecutor

        server = grpc.server(ThreadPoolExecutor(max_workers=4))
        ref_storage.add_storage_proxy(server, **stores)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, f"127.0.0.1:{port}"


# ------------------------------------------------- tests/test_proxy_tls.py


def test_vector_proxy_round_trip():
    backing = MemoryVectorStore("cpu")
    server, target = _proxy_server("port", vectors=backing)
    try:
        store = port_storage.ProxyVectorStore(target)
        store.create_collection("cf", 4)
        assert store.has_collection("cf")
        assert not store.has_collection("nope")
        store.add("cf", ["a", "b", "c", "d"], np.eye(4, dtype=np.float32))
        hits = store.query("cf", np.asarray([[1.0, 0, 0, 0]], dtype=np.float32), 2)
        assert hits[0][0].id == "a"
        store.delete("cf", ["a"])
        hits = store.query("cf", np.asarray([[1.0, 0, 0, 0]], dtype=np.float32), 1)
        assert hits[0][0].id != "a"
        store.drop_collection("cf")
        assert not backing.has_collection("cf")
        store.close()
    finally:
        server.stop(None)


def test_open_stores_by_proxy_url():
    data, cache, vectors = MemoryDataStore(), MemoryCacheStore(), MemoryVectorStore("cpu")
    server, target = _proxy_server("port", data=data, cache=cache, vectors=vectors)
    try:
        d = open_data_store(f"proxy://{target}")
        d.insert_users([User("u1")])
        assert data.get_user("u1") is not None
        assert d.ping()
        c = open_cache_store(f"proxy://{target}")
        c.add_scores("recommend", "u1", [Score("i1", 0.9)])
        assert [s.id for s in cache.search_scores("recommend", "u1")] == ["i1"]
        v = open_vector_store(f"proxy://{target}", device="cpu")
        v.create_collection("x", 2)
        assert vectors.has_collection("x")
        for s in (d, c, v):
            s.close()
    finally:
        server.stop(None)


def test_proxy_streaming_chunks():
    """Row streams cross the 512-row message boundary."""
    data = MemoryDataStore()
    data.insert_feedback(
        [Feedback("like", f"u{i}", f"i{i % 50}", timestamp=float(i)) for i in range(1300)])
    server, target = _proxy_server("port", data=data)
    try:
        d = open_data_store(f"proxy://{target}")
        assert len(list(d.get_users())) == 1300
        assert len(list(d.get_feedback(begin_time=100.0))) == 1200
        d.close()
    finally:
        server.stop(None)


def test_proxy_error_surfacing():
    server, target = _proxy_server("port", data=MemoryDataStore())
    try:
        c = open_cache_store(f"proxy://{target}")  # the cache is not proxied
        with pytest.raises(grpcwire.RpcError) as caught:
            c.set("k", "v")
        assert (caught.value.code(), caught.value.details()) == \
            (grpcwire.StatusCode.UNIMPLEMENTED, "no cache store proxied")
        assert not c.ping()
        c.close()
    finally:
        server.stop(None)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return generate_test_certs(tmp_path_factory.mktemp("certs"))


def test_mtls_control_plane(tmp_path, certs):
    server_tls, client_tls = certs
    data = MemoryDataStore()
    data.insert_items([Item("i1", timestamp=1.0)])
    master = Master(Config(), data, MemoryCacheStore(), BlobStore(tmp_path / "b"), MetaStore(),
                    device="cpu")
    server, port = serve_master_grpc(master, master.blob, port=0, tls=server_tls)
    try:
        client = MasterGrpcClient(f"localhost:{port}", "worker", node_id="tls-w1",
                                  tls=client_tls)
        assert "tls-w1" in client.get_meta()["workers"]
        client.close()
        bare = MasterGrpcClient(f"localhost:{port}", "worker", node_id="intruder")
        with pytest.raises(grpcwire.RpcError):
            bare.get_meta()
        bare.close()
    finally:
        server.stop(None)


def test_meta_rewrites_local_store_urls(tmp_path):
    """A master proxying node-local stores hands out proxy:// URLs, and the
    JSON is the reference's for the same config."""
    docs = {}
    for side in ("port", "ref"):
        config = Config() if side == "port" else RefConfig()
        config.database.data_store = f"sqlite://{tmp_path}/{side}.db"
        config.database.vector_store = "memory://"
        if side == "port":
            data = open_data_store(config.database.data_store)
            data.insert_users([User("u-remote")])
            master = Master(config, data, MemoryCacheStore(), BlobStore(tmp_path / side),
                            MetaStore(), device="cpu")
            server, port = serve_master_grpc(master, master.blob, port=0, data_store=data,
                                             cache_store=master.cache)
        else:
            data = ref_storage.open_data_store(config.database.data_store)
            master = RefMaster(config, data, ref_storage.MemoryCacheStore(),
                               RefBlobStore(tmp_path / side), RefMetaStore())
            from gorse_tpu.protocol import serve_master_grpc as ref_serve

            server, port = ref_serve(master, master.blob, port=0, data_store=data,
                                     cache_store=master.cache)
        try:
            doc = json.loads(master.get_meta()["config"])
            db = doc["database"]
            assert db["data_store"] == db["cache_store"] == f"proxy://127.0.0.1:{port}"
            assert db["vector_store"] == "memory://"  # the reference rewrites data and cache
            if side == "port":
                remote = open_data_store(db["data_store"])
                assert remote.get_user("u-remote") is not None
                remote.close()
            db["data_store"] = db["cache_store"] = "proxy://"
            docs[side] = doc
        finally:
            server.stop(None)
    assert docs["port"] == docs["ref"]


# ------------------------------------------------------- across packages


def _norm(v):
    """Either package's result in comparable form."""
    if hasattr(v, "to_dict"):
        return (type(v).__name__, v.to_dict())
    if type(v).__name__ == "TimeSeriesPoint":
        return ("TimeSeriesPoint", v.name, v.timestamp, v.value)
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def _script(types, data, cache, vectors) -> list:
    """One run of calls over the three proxy stores; each result or error."""
    User, Item, Feedback, Score = types.User, types.Item, types.Feedback, types.Score
    steps = [
        lambda: data.insert_users([User("u1", labels={"a": 1}, comment="c"), User("u2")]),
        lambda: data.get_user("u1"),
        lambda: data.get_user("nope"),
        lambda: data.insert_items([Item("i1", categories=["c1"], timestamp=1.0),
                                   Item("i2", is_hidden=True, timestamp=2.0, labels=[1, 2])]),
        lambda: data.insert_feedback([Feedback("like", "u1", "i1", 1.0, 5.0),
                                      Feedback("read", "u2", "i2", 2.0, 6.0),
                                      Feedback("like", "u3", "i1", 1.0, 7.0)]),
        lambda: list(data.get_users()),
        lambda: list(data.get_items(limit=1)),
        lambda: list(data.get_feedback(begin_time=5.5)),
        lambda: data.get_user_feedback("u1"),
        lambda: data.get_item_feedback("i1", feedback_types=["like"]),
        lambda: (data.count_users(), data.count_items(), data.count_feedback()),
        lambda: data.batch_get_items(["i1", "i2", "i9"]),
        lambda: data.get_latest_items(5),
        lambda: data.delete_user_item_feedback("u1", "i1"),
        lambda: data.delete_item("i2"),
        lambda: data.get_item("i2"),
        lambda: cache.set("k", "v"),
        lambda: cache.get("k"),
        lambda: cache.push("q", "a"),
        lambda: (cache.remain("q"), cache.pop("q"), cache.pop("q")),
        lambda: cache.add_scores("c", "s", [Score("i1", 1.0), Score("i2", 0.5, categories=["x"]),
                                           Score("i3", 0.75, timestamp=3.0)]),
        lambda: cache.search_scores("c", "s"),
        lambda: cache.search_scores("c", "s", categories=["x"]),
        lambda: sorted((s, x.id) for s, x in cache.scan_scores("c")),
        lambda: cache.update_scores(["c"], "s", "i1", is_hidden=True),
        lambda: cache.search_scores("c", "s", begin=0, end=1),
        lambda: cache.delete_scores("c", ["s"]),
        lambda: cache.add_time_series_points([types.TimeSeriesPoint("n", 1.0, 2.0)]),
        lambda: cache.get_time_series_points("n", 0.0, 10.0),
        lambda: vectors.create_collection("v", 4),
        lambda: vectors.add("v", ["a", "b", "c"], np.eye(3, 4, dtype=np.float32)),
        lambda: vectors.query("v", np.ones((2, 4), np.float32), 2),
        lambda: (vectors.list_collections(), vectors.has_collection("v")),
        lambda: vectors.query("missing", np.ones((1, 4), np.float32), 1),
        lambda: vectors.drop_collection("v"),
    ]
    out = []
    for step in steps:
        try:
            out.append(("ok", _norm(step())))
        except RPC_ERRORS as e:
            out.append((e.code().name, e.details()))
    return out


def _clients(side: str, target: str):
    lib = port_storage if side == "port" else ref_storage
    return (lib.ProxyDataStore(target), lib.ProxyCacheStore(target),
            lib.ProxyVectorStore(target))


def _server_stores(side: str):
    if side == "port":
        return MemoryDataStore(), MemoryCacheStore(), MemoryVectorStore("cpu")
    return ref_storage.MemoryDataStore(), ref_storage.MemoryCacheStore(), RefMemoryVectorStore()


def _run(server_side: str, client_side: str) -> list:
    data, cache, vectors = _server_stores(server_side)
    server, target = _proxy_server(server_side, data=data, cache=cache, vectors=vectors)
    clients = _clients(client_side, target)
    try:
        return _script(port_types if client_side == "port" else ref_types, *clients)
    finally:
        for c in clients:
            c.close()
        server.stop(None)


@pytest.mark.parametrize("server_side,client_side", [("ref", "port"), ("port", "ref"),
                                                     ("port", "port")])
def test_proxy_stores_across_packages(server_side, client_side):
    got, want = _run(server_side, client_side), _run("ref", "ref")
    assert [o[0] for o in want].count("ok") == len(want) - 1  # the missing collection
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, n
    assert len(got) == len(want)


@pytest.mark.parametrize("server_side,client_side", [("ref", "port"), ("port", "ref")])
def test_proxy_unproxied_store_and_unknown_method(server_side, client_side):
    stores = _server_stores(server_side)
    server, target = _proxy_server(server_side, data=stores[0])
    data, cache, vectors = _clients(client_side, target)
    try:
        outcomes = []
        for call in (lambda: cache.get("k"), lambda: vectors.list_collections(),
                     lambda: data._call("_private"), lambda: data._call("no_such_method")):
            with pytest.raises(RPC_ERRORS) as caught:
                call()
            outcomes.append((caught.value.code().name, caught.value.details()))
        assert outcomes == [("UNIMPLEMENTED", "no cache store proxied"),
                            ("UNIMPLEMENTED", "no vectors store proxied"),
                            ("UNIMPLEMENTED", "unknown method _private"),
                            ("UNIMPLEMENTED", "unknown method no_such_method")]
        assert data.ping() and not cache.ping()
    finally:
        for c in (data, cache, vectors):
            c.close()
        server.stop(None)


# ------------------------------------------------------- the slice


def _configure(config, tmp_path):
    config.recommend.collaborative.type = "mf"
    config.database.data_store = "memory://"
    config.database.cache_store = "memory://"
    config.database.blob_store = str(tmp_path / "blobs")
    config.recommend.ranker.type = "none"
    config.recommend.ranker.recommenders = ["collaborative"]
    config.master.host, config.master.port = "127.0.0.1", 0
    return config


def _fill(data):
    rng = np.random.default_rng(0)
    data.insert_items([Item(f"i{k}", timestamp=float(k)) for k in range(30)])
    data.insert_feedback([Feedback("like", f"u{u}", f"i{i}", timestamp=float(rng.integers(1, 99)))
                          for u in range(12) for i in rng.choice(30, size=5, replace=False)])


def _lists(cache, users):
    return {c: {u: [(s.id, s.score) for s in cache.search_scores(c, u)] for u in users}
            for c in (ck.COLLABORATIVE, ck.RECOMMEND)}


@pytest.mark.parametrize("secure", [False, True], ids=["plain", "mtls"])
def test_nodes_over_the_masters_proxy(secure, certs, tmp_path):
    users = [f"u{u}" for u in range(12)]
    # the in-process master and worker over their own stores
    config = _configure(Config(), tmp_path / "inproc")
    data, cache = MemoryDataStore(), MemoryCacheStore()
    _fill(data)
    master = Master(config, data, cache, BlobStore(config.database.blob_store), MetaStore(),
                    device="cpu")
    master.run_tasks_once()
    worker = Worker(config, data, cache, master.blob, node_id="w-a", device="cpu")
    worker.pull_models(master.meta.get("COLLABORATIVE_FILTERING_MODEL"), "")
    assert worker.recommend(worker.pull_users(["w-a"])) == 12
    want = _lists(cache, users)

    # the master process's code: the gRPC plane over its memory:// stores
    config = _configure(Config(), tmp_path / "proxied")
    if secure:
        server_tls, client_tls = certs
        config.master.ssl_mode = True
        config.master.ssl_ca, config.master.ssl_cert, config.master.ssl_key = \
            server_tls.ssl_ca, server_tls.ssl_cert, server_tls.ssl_key
    else:
        client_tls = None
    data, cache = MemoryDataStore(), MemoryCacheStore()
    _fill(data)
    master = Master(config, data, cache, BlobStore(config.database.blob_store), MetaStore(),
                    device="cpu")
    grpc_server, grpc_port = serve_grpc_plane(master, config)
    rest = MasterRestServer(master)
    httpd = rest.serve("127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = None
    try:
        master.run_tasks_once()
        node = WorkerNode(url, meta_timeout=0.1, node_id="w-a", device="cpu", tls=client_tls)
        assert node.sync_once() == 12
        proxy = f"proxy://127.0.0.1:{grpc_port}"
        assert node.config.database.data_store == node.config.database.cache_store == proxy
        assert type(node.worker.data).__name__ == "ProxyDataStore"
        assert _lists(cache, users) == want  # written through the proxy, exactly
        server = ServerNode(url, meta_timeout=0.1, tls=client_tls)
        front = server.serve("127.0.0.1", 0)
        assert server.config.database.cache_store == proxy
        for u in ("u0", "u5", "u11"):
            with urllib.request.urlopen(f"http://127.0.0.1:{front.server_address[1]}"
                                        f"/api/recommend/{u}?n=5", timeout=30) as resp:
                assert json.loads(resp.read()) == [i for i, _ in want[ck.RECOMMEND][u][:5]]
        # a feedback row written through the server lands in the master's store
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.server_address[1]}/api/feedback", method="PUT",
            data=json.dumps([{"FeedbackType": "like", "UserId": "u99", "ItemId": "i1",
                              "Timestamp": "2020-01-01T00:00:00Z"}]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read()) == {"RowAffected": 1}
        assert [f.item_id for f in data.get_user_feedback("u99")] == ["i1"]
    finally:
        if server is not None:
            server.shutdown()
        rest.shutdown()
        grpc_server.stop(None)
