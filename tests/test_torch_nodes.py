"""The port's server and worker nodes (gorse_tpu_torch/serve/nodes.py) on the
CPU:

- tests/test_nodes.py's five cases against the port: a master HTTP endpoint
  (the port's ``MasterRestServer``) with server and worker nodes syncing
  from it in this process over shared SQLite files;
- across packages, on one set of SQLite files and one blob directory: the
  port's ``WorkerNode`` and ``ServerNode`` against the reference's
  ``MasterRestServer``, and the reference's nodes against the port's. The
  port's worker writes the caches the reference's ``WorkerNode`` wrote for
  the same shard: ids equal, scores within rtol 1e-6 and atol 1e-6
  (tests/test_torch_master.py's tolerance), the reference on its kernel
  route (``use_pallas=True, interpret=True``), which the port's plain
  versions follow on the CPU. Each package's master lists the other's
  worker and its progress spans, and each package's nodes run on the
  other's meta.
"""

import functools
import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

from gorse_tpu.logics.cf import MatrixFactorizationIndex as RefIndex
from gorse_tpu.serve.dashboard import MasterRestServer as RefMasterRestServer
from gorse_tpu.serve.master import Master as RefMaster
from gorse_tpu.serve.nodes import ServerNode as RefServerNode
from gorse_tpu.serve.nodes import WorkerNode as RefWorkerNode
from gorse_tpu.storage.blob import BlobStore as RefBlobStore
from gorse_tpu.storage.cache import open_cache_store as ref_open_cache_store
from gorse_tpu.storage.data import open_data_store as ref_open_data_store
from gorse_tpu.storage.meta import MetaStore as RefMetaStore
from gorse_tpu.utils.config import Config as RefConfig
from gorse_tpu_torch.serve.dashboard import MasterRestServer
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.serve.nodes import MasterClient, ServerNode, UnsharedStoreError, WorkerNode
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import open_cache_store
from gorse_tpu_torch.storage.data import open_data_store
from gorse_tpu_torch.storage.meta import MetaStore
from gorse_tpu_torch.storage.types import Feedback, Item
from gorse_tpu_torch.utils.config import Config

RTOL = ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU work on one intra-op thread: a thread per core in
    every test worker oversubscribes the cores when the suite runs in
    parallel, and a cycle then takes minutes instead of seconds."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _configure(config, tmp_path):
    config.recommend.collaborative.type = "mf"
    config.database.data_store = f"sqlite://{tmp_path}/data.db"
    config.database.cache_store = f"sqlite://{tmp_path}/cache.db"
    config.database.blob_store = str(tmp_path / "blobs")
    config.recommend.ranker.type = "none"
    config.recommend.ranker.recommenders = ["collaborative"]
    return config


def _fill(data, item_cls, feedback_cls):
    rng = np.random.default_rng(0)
    data.insert_items([item_cls(f"i{k}", timestamp=float(k)) for k in range(30)])
    fbs = []
    for u in range(12):
        for i in rng.choice(30, size=5, replace=False):
            fbs.append(feedback_cls("like", f"u{u}", f"i{i}",
                                    timestamp=float(rng.integers(1, 100))))
    data.insert_feedback(fbs)


@pytest.fixture
def master_env(tmp_path):
    config = _configure(Config(), tmp_path)
    data = open_data_store(config.database.data_store)
    cache = open_cache_store(config.database.cache_store)
    blob = BlobStore(config.database.blob_store)
    _fill(data, Item, Feedback)
    master = Master(config, data, cache, blob, MetaStore(), device="cpu")
    master.run_tasks_once()
    rest = MasterRestServer(master)
    port = _free_port()
    rest.serve("127.0.0.1", port)
    yield master, f"http://127.0.0.1:{port}", cache
    rest.shutdown()


def test_worker_node_syncs_over_http(master_env):
    master, url, cache = master_env
    w1 = WorkerNode(url, meta_timeout=0.1, device="cpu")
    assert w1.sync_once() == 12
    assert cache.search_scores(ck.RECOMMEND, "u3", None, 0, 5)
    assert any(t.get("Node") == w1.client.node_id for t in master.progress.list())


def test_two_workers_split_users(master_env):
    master, url, cache = master_env
    w1 = WorkerNode(url, meta_timeout=0.1, node_id="worker-a", device="cpu")
    w2 = WorkerNode(url, meta_timeout=0.1, node_id="worker-b", device="cpu")
    w1.client.get_meta()
    w2.client.get_meta()
    n1 = w1.sync_once()
    n2 = w2.sync_once()
    assert n1 + n2 == 12 and n1 > 0 and n2 > 0


def test_server_node_serves_recommendations(master_env):
    master, url, cache = master_env
    WorkerNode(url, meta_timeout=0.1, device="cpu").sync_once()
    server = ServerNode(url, meta_timeout=0.1)
    port = _free_port()
    server.serve("127.0.0.1", port)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/recommend/u3?n=5") as resp:
            recs = json.loads(resp.read().decode())
        assert len(recs) == 5
    finally:
        server.shutdown()


def test_master_client_registration(master_env):
    master, url, _ = master_env
    meta = MasterClient(url, "worker", node_id="w-test").get_meta()
    assert "w-test" in meta["workers"]
    assert meta["cf_model_id"]


def test_worker_http_health_and_metrics(master_env):
    master, url, cache = master_env
    w = WorkerNode(url, meta_timeout=0.1, device="cpu")
    w.sync_once()
    httpd = w.serve_http()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        with urllib.request.urlopen(base + "/api/health/live") as r:
            assert json.loads(r.read())["status"] == "live"
        with urllib.request.urlopen(base + "/api/health/ready") as r:
            assert json.loads(r.read())["status"] == "ready"
        with urllib.request.urlopen(base + "/metrics") as r:
            body = r.read()
            assert b"gorse_worker_tasks_complete" in body
            assert b"gorse_worker_update_user_recommend_total" in body
            assert b"gorse_worker_offline_recommend_total_seconds" in body
    finally:
        w.shutdown()


@pytest.mark.parametrize("store", ["data_store", "cache_store"])
def test_nodes_refuse_a_master_on_memory_stores(store, tmp_path):
    """A master on a ``memory://`` store holds it in its own process; a node
    would open a private, empty one. A master that runs its gRPC plane
    hands out ``proxy://`` in its place (tests/test_torch_proxy.py); one
    without it hands out the URL as it is, so the server's first sync and
    the worker's cycle raise, naming ``proxy://``, instead of dropping
    acknowledged writes."""
    config = _configure(Config(), tmp_path)
    setattr(config.database, store, "memory://")
    master = Master(config, open_data_store(config.database.data_store),
                    open_cache_store(config.database.cache_store),
                    BlobStore(config.database.blob_store), MetaStore(), device="cpu")
    rest = MasterRestServer(master)
    port = _free_port()
    rest.serve("127.0.0.1", port)
    url = f"http://127.0.0.1:{port}"
    try:
        server = ServerNode(url)
        with pytest.raises(UnsharedStoreError, match=f"{store}.*proxy://"):
            server.serve("127.0.0.1", _free_port())
        assert server.rest is None
        worker = WorkerNode(url, meta_timeout=0.1, device="cpu")
        with pytest.raises(UnsharedStoreError, match=f"{store}.*proxy://"):
            worker.sync_once()
        with pytest.raises(UnsharedStoreError, match="proxy://"):
            worker.serve()  # the cycle's loop does not swallow it
        assert worker.worker is None
    finally:
        rest.shutdown()


# -------------------------------------------------------- across packages


def _lists(cache, collection, users):
    return {u: [(s.id, s.score) for s in cache.search_scores(collection, u)] for u in users}


def _hold(got, want):
    assert got.keys() == want.keys()
    filled = 0
    for u in want:
        assert [i for i, _ in got[u]] == [i for i, _ in want[u]], u
        np.testing.assert_allclose([s for _, s in got[u]], [s for _, s in want[u]],
                                   rtol=RTOL, atol=ATOL, err_msg=u)
        filled += bool(want[u])
    assert filled == len(want)


def _recommend(port: int, user: str) -> list:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/recommend/{user}?n=5") as resp:
        return json.loads(resp.read().decode())


def test_nodes_across_packages(tmp_path, monkeypatch):
    from gorse_tpu.storage.types import Feedback as RefFeedback
    from gorse_tpu.storage.types import Item as RefItem

    monkeypatch.setattr(RefIndex, "search_users", functools.partialmethod(
        RefIndex.search_users, use_pallas=True, interpret=True))
    ref_cfg = _configure(RefConfig(), tmp_path)
    data = ref_open_data_store(ref_cfg.database.data_store)
    _fill(data, RefItem, RefFeedback)
    ref_cache = ref_open_cache_store(ref_cfg.database.cache_store)
    meta_path = str(tmp_path / "meta.sqlite")
    ref_master = RefMaster(ref_cfg, data, ref_cache, RefBlobStore(ref_cfg.database.blob_store),
                           RefMetaStore(meta_path))
    ref_master.run_tasks_once()
    ref_rest = RefMasterRestServer(ref_master)
    ref_port = _free_port()
    ref_rest.serve("127.0.0.1", ref_port)
    ref_url = f"http://127.0.0.1:{ref_port}"
    users = [f"u{u}" for u in range(12)]
    servers = []
    try:
        # the reference's worker fills the shard; then the port's, with the
        # same node id (the same shard), over the lists made stale
        assert RefWorkerNode(ref_url, meta_timeout=0.1, node_id="w-a").sync_once() == 12
        want = {c: _lists(ref_cache, c, users) for c in (ck.COLLABORATIVE, ck.RECOMMEND)}
        for u in users:
            ref_cache.delete(ck.key(ck.RECOMMEND_DIGEST, u))
        port_worker = WorkerNode(ref_url, meta_timeout=0.1, node_id="w-a", device="cpu")
        assert port_worker.sync_once() == 12
        assert port_worker.worker.cf_model_id == ref_master.meta.get(
            "COLLABORATIVE_FILTERING_MODEL")
        cache = open_cache_store(ref_cfg.database.cache_store)
        for c in (ck.COLLABORATIVE, ck.RECOMMEND):
            _hold(_lists(cache, c, users), want[c])
        spans = [s for s in ref_master.progress.list() if s.get("Node") == "w-a"]
        assert [s["Name"] for s in spans] == ["recommend"] and spans[0]["Count"] == 12
        # the port's server on the reference master's meta serves the cache
        server = ServerNode(ref_url, meta_timeout=0.1)
        port = _free_port()
        server.serve("127.0.0.1", port)
        servers.append(server)
        for u in ("u0", "u3", "u11"):
            assert _recommend(port, u) == [i for i, _ in want[ck.RECOMMEND][u][:5]]
        _, cluster = ref_rest.dispatch("GET", "/api/dashboard/cluster", {}, None, {})
        assert {(n["UUID"], n["Type"]) for n in cluster} >= {("w-a", "worker")}
        assert any(n["Type"] == "server" for n in cluster)

        # the port's master on the same files resumes the reference's model;
        # the reference's nodes sync from it
        master = Master(_configure(Config(), tmp_path), open_data_store(
            ref_cfg.database.data_store), cache, BlobStore(ref_cfg.database.blob_store),
            MetaStore(meta_path), device="cpu")
        assert master.cf_index is not None
        rest = MasterRestServer(master)
        port_master = _free_port()
        rest.serve("127.0.0.1", port_master)
        url = f"http://127.0.0.1:{port_master}"
        try:
            ref_worker = RefWorkerNode(url, meta_timeout=0.1, node_id="w-b")
            ref_worker.client.get_meta()
            for u in users:
                cache.delete(ck.key(ck.RECOMMEND_DIGEST, u))
            # w-a and w-b now split the users: the reference's worker fills
            # its shard from the port master's meta
            n = ref_worker.sync_once()
            assert 0 < n < 12
            _, tasks = rest.dispatch("GET", "/api/dashboard/tasks", {}, None, {})
            pushed = [t for t in tasks if t.get("Node") == "w-b"]
            assert [t["Name"] for t in pushed] == ["recommend"] and pushed[0]["Count"] == n
            ref_server = RefServerNode(url, meta_timeout=0.1)
            port2 = _free_port()
            ref_server.serve("127.0.0.1", port2)
            servers.append(ref_server)
            for u in ("u0", "u3", "u11"):
                assert _recommend(port2, u) == _recommend(port, u)
            assert {n.uuid for n in master.meta.list_nodes("worker")} == {"w-a", "w-b"}
        finally:
            rest.shutdown()
    finally:
        for s in servers:
            s.shutdown()
        ref_rest.shutdown()


@pytest.mark.parametrize("section,name", [("tracing", "enable"), ("master", "ssl_mode")])
def test_master_process_raises_for_m21(section, name, tmp_path):
    """The master process's tracing and its gRPC TLS no longer raise: the
    master that ``master_main`` builds accepts either, and its gRPC plane
    is mutually authenticated with ``master.ssl_mode``."""
    from gorse_tpu_torch.cmd.nodes_main import build_master, grpc_tls
    from gorse_tpu_torch.utils.tls import TLSConfig

    config = Config()
    config.database.blob_store = str(tmp_path / "blobs")
    config.master.ssl_ca, config.master.ssl_cert, config.master.ssl_key = "ca", "cert", "key"
    setattr(getattr(config, section), name, True)
    master = build_master(config, device="cpu")
    assert master.device == torch.device("cpu")
    want = TLSConfig("ca", "cert", "key") if section == "master" else None
    assert grpc_tls(config) == want


HELD_NODE = """
import os, sys, time, torch
import gorse_tpu_torch as g
g.resolve_device = lambda d=None: torch.device('cpu' if d is None else d)
from gorse_tpu_torch.serve import dashboard, nodes


def wait_for_the_signal():
    # hold the entry point after its servers have started and before its
    # handlers are in place, until the test has sent the signal
    open(os.environ["REACHED"], "w").close()
    deadline = time.time() + 60
    while not os.path.exists(os.environ["SIGNALLED"]) and time.time() < deadline:
        time.sleep(0.05)


def then_wait(serve):
    def wrapped(self, *args, **kwargs):
        out = serve(self, *args, **kwargs)
        wait_for_the_signal()
        return out
    return wrapped


dashboard.MasterRestServer.serve = then_wait(dashboard.MasterRestServer.serve)
# the server node syncs from a master before it serves: none runs here
nodes.ServerNode.serve = lambda self, *args, **kwargs: wait_for_the_signal()
nodes.WorkerNode.serve_http = then_wait(nodes.WorkerNode.serve_http)
from gorse_tpu_torch.cmd._spawn import main
main()
"""


@pytest.mark.parametrize("role", ["master", "server", "worker"])
@pytest.mark.parametrize("sig", ["SIGTERM", "SIGINT"])
def test_a_signal_before_the_handlers_are_in_place_is_held(sig, role, tmp_path):
    """Each node process reaches the point between starting its servers and
    installing its handlers (the master and the worker after their HTTP
    servers answer). Held there until the signal has been sent, the process
    still stops as a signal stops it, with exit code 0 and its kernel
    launches logged: the signal waits for the handlers. (Unheld, SIGTERM's
    default action ended the process with -15 and SIGINT's
    ``KeyboardInterrupt`` with 1.)"""
    import os
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    http_port, grpc_port, master_port = _free_port(), _free_port(), _free_port()
    cfg = tmp_path / "config.toml"
    cfg.write_text(f"""
[database]
data_store = "sqlite://{tmp_path}/data.db"
cache_store = "sqlite://{tmp_path}/cache.db"
blob_store = "{tmp_path}/blobs"
meta_store = "sqlite://{tmp_path}/meta.db"

[master]
host = "127.0.0.1"
port = {grpc_port}
http_host = "127.0.0.1"
http_port = {http_port}
""")
    args = {"master": ["--config", str(cfg)],
            # no master listens on master_port: the worker's cycles fail and retry
            "server": ["--master-port", str(master_port), "--http-port", str(http_port)],
            "worker": ["--master-port", str(master_port), "--http-port", str(http_port)]}[role]
    reached, signalled, log = tmp_path / "reached", tmp_path / "signalled", tmp_path / "node.log"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]),
               OMP_NUM_THREADS="1", REACHED=str(reached), SIGNALLED=str(signalled))
    with open(log, "wb") as out:
        proc = subprocess.Popen([sys.executable, "-c", HELD_NODE, role, *args],
                                cwd=str(tmp_path), env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 90
        while time.time() < deadline and proc.poll() is None and not reached.exists():
            time.sleep(0.1)
        if not reached.exists():
            raise AssertionError(f"the {role} never reached its handlers:\n" + log.read_text())
        if role != "server":
            with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/api/health/live",
                                        timeout=10) as resp:
                assert resp.status == 200
        proc.send_signal(getattr(signal, sig))
        signalled.touch()
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise AssertionError("no exit 60 s after the signal:\n" + log.read_text()) from None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, log.read_text()
    assert "kernel launches" in log.read_text()
