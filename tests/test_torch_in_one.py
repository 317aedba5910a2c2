"""The port's in-one node (gorse_tpu_torch/serve/in_one.py) on the CPU, from
a copy of the repo's config.toml.example with its four stores in SQLite
files under ``tmp_path`` (and small depths, below), held three ways:

- against gorse_tpu's in-one node run on its own copy of the same rows: the
  non-personalized caches equal exactly, the item-to-item and user-to-user
  caches id for id with scores within rtol 1e-6 (the neighbour tests'
  standard, tests/test_torch_neighbors.py);
- resuming the models a reference in-one saved into the shared
  ``meta.sqlite`` and blob directory: the port's worker ranks with them,
  and each user's list equals the reference worker's, tie-aware (scores
  within ``RANK_TOL`` (1 + |s|), ids equal where neighbours are farther
  apart). The catalog is smaller than ``cache_size``, so every candidate
  list is the whole catalog less the user's feedback and only the AFM's
  rounding can differ;
- its whole cycle on SQLite equal, exactly, to the port's own master and
  worker on memory stores from the same rows (each list's ids and scores;
  equal scores read back from SQLite in the store's own order).

The example's searches come due on the first cycle (``optimize_period =
"360m"``); the cuts keep them small: BPR ``fit_epoch`` 4, the AFM's 2,
``optimize_trials`` 2, ``model_search_epoch`` 2."""

import json
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import gorse_tpu.serve.in_one as ref_in_one
import gorse_tpu.storage.data as ref_data
import gorse_tpu.storage.types as ref_types
from gorse_tpu.utils.config import load_config as ref_load_config
from gorse_tpu_torch.serve.in_one import InOneNode
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.serve.worker import Worker
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore, SQLiteDataStore
from gorse_tpu_torch.storage.meta import (
    CLICK_THROUGH_RATE_MODEL,
    COLLABORATIVE_FILTERING_MODEL,
    MetaStore,
)
from gorse_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 40, 30
RANK_TOL = 2.0**-14
CUTS = (("recommend.collaborative", "fit_epoch", "4"),
        ("recommend.collaborative", "optimize_trials", "2"),
        ("recommend.collaborative", "model_search_epoch", "2"),
        ("recommend.ranker", "fit_epoch", "2"),
        ("recommend.ranker", "optimize_trials", "2"))


def _set(text: str, section: str, key: str, value: str) -> str:
    lines = text.split("\n")
    start = lines.index(f"[{section}]")
    end = next((n for n in range(start + 1, len(lines)) if lines[n].startswith("[")), len(lines))
    for n in range(start + 1, end):
        if re.match(rf"{key}\s*=", lines[n]):
            lines[n] = f"{key} = {value}"
            return "\n".join(lines)
    lines.insert(start + 1, f"{key} = {value}")
    return "\n".join(lines)


def _config(tmp: Path) -> Path:
    """config.toml.example with its stores and blobs under ``tmp``."""
    text = (ROOT / "config.toml.example").read_text()
    for section, key, value in (
        ("database", "data_store", f'"sqlite://{tmp}/data.sqlite"'),
        ("database", "cache_store", f'"sqlite://{tmp}/cache.sqlite"'),
        ("database", "vector_store", f'"sqlite://{tmp}/vector.sqlite"'),
        ("database", "meta_store", f'"{tmp}/meta.sqlite"'),
        ("blob", "uri", f'"{tmp}/blob"'),
    ) + CUTS:
        text = _set(text, section, key, f"{value}")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "config.toml").write_text(text)
    return tmp / "config.toml"


def _fill(store, t):
    """Labelled items and users; star, like and read feedback of the
    example's positive types, and reads below 3 that are not positive."""
    rng = np.random.default_rng(7)
    store.insert_items(t.Item(f"i{i}", categories=[f"c{i % 3}"], timestamp=float(100 + i),
                              labels={"genre": [f"g{g}" for g in rng.choice(5, 2, replace=False)]})
                       for i in range(N_ITEMS))
    store.insert_users(t.User(f"u{u}", labels={"age": str(u % 4)}) for u in range(N_USERS))
    rows = []
    for u in range(N_USERS):
        for i in sorted(rng.choice(N_ITEMS, int(rng.integers(3, 9)), replace=False)):
            kind = ("star", "like", "read", "read")[int(rng.integers(4))]
            value = float(rng.integers(1, 6)) if kind == "read" else 1.0
            rows.append(t.Feedback(kind, f"u{u}", f"i{i}", value, float(rng.integers(1, 10**6))))
    store.insert_feedback(rows)


def _caches(cache, collection: str) -> dict:
    return {subset: [(s.id, s.score) for s in cache.search_scores(collection, subset)]
            for subset in sorted(cache.scan_score_subsets(collection))}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """The reference in-one and the port's, each on its own files, one
    cycle each."""
    tmp = tmp_path_factory.mktemp("in_one")
    out = {}
    for name, opener, t, node_cls, loader, kw in (
        ("ref", ref_data.SQLiteDataStore, ref_types, ref_in_one.InOneNode, ref_load_config, {}),
        ("port", SQLiteDataStore, types, InOneNode, load_config, {"device": "cpu"}),
    ):
        path = _config(tmp / name)
        store = opener(str(tmp / name / "data.sqlite"))
        _fill(store, t)
        store.close()
        node = node_cls(loader(path), workdir=str(tmp / name), **kw)
        summary = node.run_once()
        out[name] = (node, summary, path)
    return out


def test_the_port_node_runs_the_example_cycle(nodes):
    node, summary, _ = nodes["port"]
    assert summary["users_refreshed"] == N_USERS
    assert summary["cf_model_id"] == node.meta.get(COLLABORATIVE_FILTERING_MODEL)
    assert summary["ctr_model_id"] == node.meta.get(CLICK_THROUGH_RATE_MODEL)
    for name in ("BEST_PARAMS_CF", "CF_SEARCH_TARGET", "BEST_PARAMS_CTR"):
        assert node.meta.get(name), name
    assert sorted(node.blob.list()) == sorted([summary["cf_model_id"], summary["ctr_model_id"]])
    assert node.vectors.describe_collection(Master.CF_COLLECTION)["dimension"] > 0
    text = node.master.metrics.render()
    for gauge in ("master_collaborative_filtering_search_seconds",
                  "master_ranking_search_seconds"):
        assert float(re.search(rf"^\w+_{gauge} (\S+)$", text, re.M).group(1)) > 0
    pushed = [s for s in node.master.progress.list() if s.get("Node") == node.worker.node_id]
    assert pushed, "the worker pushed its progress to the master"


@pytest.mark.parametrize("collection", [ck.NON_PERSONALIZED, ck.ITEM_TO_ITEM, ck.USER_TO_USER])
def test_caches_equal_the_reference_node(nodes, collection):
    port, ref = nodes["port"][0], nodes["ref"][0]
    got, want = _caches(port.cache, collection), _caches(ref.cache, collection)
    assert got.keys() == want.keys() and got
    for subset in want:
        assert [i for i, _ in got[subset]] == [i for i, _ in want[subset]], subset
        if collection == ck.NON_PERSONALIZED:
            assert got[subset] == want[subset], subset
        else:
            np.testing.assert_allclose([s for _, s in got[subset]], [s for _, s in want[subset]],
                                       rtol=1e-6, err_msg=subset)


def test_search_keys_have_the_reference_form(nodes):
    """Both nodes searched and wrote their keys in one form: the target's
    type and parameters from that type's space, the CTR best from the
    AFM's. (Their fits start from other initial factors, so the winners
    may differ; tests/test_torch_master.py holds the same winner with the
    objectives injected.)"""
    from gorse_tpu_torch.models.optimize import AFM_SPACE, ALS_SPACE, BPR_SPACE

    spaces = {"bpr": BPR_SPACE, "als": ALS_SPACE}
    for name in ("port", "ref"):
        meta = nodes[name][0].meta
        target = json.loads(meta.get("CF_SEARCH_TARGET"))
        assert set(target) == {"type", "params", "score"} and target["type"] in spaces
        assert set(target["params"]) == set(spaces[target["type"]])
        assert json.loads(meta.get("BEST_PARAMS_CF")) == target["params"]
        assert set(json.loads(meta.get("BEST_PARAMS_CTR"))) == set(AFM_SPACE)


def _same_ranking(got, want):
    """Tie-aware: scores within RANK_TOL (1 + |s|) at each slot; ids equal
    at each slot whose reference score is farther than twice that from its
    neighbours'."""
    assert len(got) == len(want) and {i for i, _ in got} == {i for i, _ in want}
    s, s_w = np.array([x for _, x in got]), np.array([x for _, x in want])
    tol = RANK_TOL * (1.0 + np.maximum(np.abs(s), np.abs(s_w)))
    assert np.all(np.abs(s - s_w) <= tol)
    gap = np.diff(s_w) if len(s_w) > 1 else np.array([])
    for n in range(len(want)):
        above = n == 0 or -gap[n - 1] > 2 * tol.max()
        below = n == len(want) - 1 or -gap[n] > 2 * tol.max()
        if above and below:
            assert got[n][0] == want[n][0], n


def test_port_resumes_the_reference_models(nodes):
    """The port's node on the reference node's files: both models resumed
    from meta.sqlite and the blob directory, and its worker's lists equal
    the reference worker's, tie-aware."""
    ref, _, path = nodes["ref"]
    want = _caches(ref.cache, ck.RECOMMEND)
    assert len(want) == N_USERS
    port = InOneNode(load_config(path), workdir=str(path.parent), device="cpu")
    assert port.master.cf_index is not None and port.master.ctr_model is not None
    meta = port.master.get_meta()
    assert (meta["cf_model_id"], meta["ctr_model_id"]) == (
        ref.meta.get(COLLABORATIVE_FILTERING_MODEL), ref.meta.get(CLICK_THROUGH_RATE_MODEL))
    port.worker.pull_models(meta["cf_model_id"], meta["ctr_model_id"])
    users = sorted(want)
    assert port.worker.recommend(users, force=True) == N_USERS
    got = _caches(port.cache, ck.RECOMMEND)
    for uid in users:
        feedback = {fb.item_id for fb in port.data.get_user_feedback(uid)}
        assert {i for i, _ in want[uid]} == {f"i{i}" for i in range(N_ITEMS)} - feedback
        _same_ranking(got[uid], want[uid])


def test_sqlite_cycle_equals_the_memory_cycle(tmp_path):
    """The port's cycle on SQLite (a node) against its master and worker on
    memory stores: every cache and search key equal, exactly. Both run on
    one CPU thread: torch's multi-threaded CPU backward sums in a varying
    order, so two AFM fits on several threads differ in the last bits."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = _config(tmp_path / "sqlite")
        store = SQLiteDataStore(str(tmp_path / "sqlite" / "data.sqlite"))
        _fill(store, types)
        store.close()
        node = InOneNode(load_config(path), workdir=str(tmp_path / "sqlite"), device="cpu")
        summary = node.run_once()
        cfg = load_config(path)
        data = MemoryDataStore()
        _fill(data, types)
        master = Master(cfg, data, MemoryCacheStore(), BlobStore(tmp_path / "blobs"), MetaStore(),
                        device="cpu")
        master.run_tasks_once()
        worker = Worker(cfg, data, master.cache, master.blob, node_id="in-one", device="cpu")
        assert worker.sync_and_recommend(master) == summary["users_refreshed"] == N_USERS
    finally:
        torch.set_num_threads(threads)

    def content(cache, collection):
        # SQLite's ORDER BY score leaves equal scores in its own order, the
        # memory store in insertion order: the content must be equal
        return {k: sorted(v, key=lambda x: (-x[1], x[0]))
                for k, v in _caches(cache, collection).items()}

    for collection in (ck.NON_PERSONALIZED, ck.ITEM_TO_ITEM, ck.USER_TO_USER, ck.COLLABORATIVE,
                       ck.RECOMMEND):
        got, want = content(node.cache, collection), content(master.cache, collection)
        assert got == want and got, collection
    for name in ("BEST_PARAMS_CF", "CF_SEARCH_TARGET", "BEST_PARAMS_CTR", "CF_MODEL_META"):
        assert node.meta.get(name) == master.meta.get(name), name


def test_serves_the_sqlite_cache(nodes):
    import http.client

    node = nodes["port"][0]
    httpd = node.serve("127.0.0.1", 0, background_loop=False)
    try:
        for uid in ("u0", "u7", "u39"):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=10)
            conn.request("GET", f"/api/recommend/{uid}")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            want = [s.id for s in node.cache.search_scores(ck.RECOMMEND, uid)]
            assert resp.status == 200 and body == want[: node.config.server.default_n] and body
    finally:
        assert node.shutdown()


def test_serves_the_master_routes(nodes):
    """The node serves ``MasterRestServer``, as the reference's in-one does:
    the node-sync and dashboard routes answer from its master, equal to the
    reference node's on the same rows."""
    from gorse_tpu.serve.dashboard import MasterRestServer as RefMasterRestServer
    from gorse_tpu_torch.serve.dashboard import MasterRestServer

    node, ref = nodes["port"][0], nodes["ref"][0]
    assert isinstance(node.rest, MasterRestServer)
    assert isinstance(ref.rest, RefMasterRestServer)
    status, meta = node.rest.dispatch("POST", "/api/admin/meta", {}, {}, {})
    assert status == 200 and meta["cf_model_id"] == node.meta.get(COLLABORATIVE_FILTERING_MODEL)
    assert meta["config"] == node.config.to_json()
    status, stats = node.rest.dispatch("GET", "/api/dashboard/stats", {}, None, {})
    _, want = ref.rest.dispatch("GET", "/api/dashboard/stats", {}, None, {})
    assert status == 200 and stats["CFModel"] == meta["cf_model_id"]
    for name in ("NumUsers", "NumItems", "NumTotalPosFeedback", "NumValidPosFeedback",
                 "NumValidNegFeedback", "NumUserLabels", "NumItemLabels", "NumTotalPos"):
        assert stats[name] == want[name], name


def test_reconcile_builds_the_search_index(tmp_path):
    """``[recommend.search] columns`` reaches the data store through the
    master's reconcile thread: the SQLite store's FTS5 index answers."""
    path = _config(tmp_path)
    text = path.read_text().replace("columns = []", 'columns = ["item.Comment"]')
    path.write_text(text)
    store = SQLiteDataStore(str(tmp_path / "data.sqlite"))
    store.insert_items([types.Item("m1", comment="space opera"), types.Item("m2", comment="drama")])
    store.close()
    node = InOneNode(load_config(path), workdir=str(tmp_path), device="cpu")
    node.master.load_dataset()
    deadline = time.time() + 30
    while node.master._reconciling and time.time() < deadline:
        time.sleep(0.05)
    assert node.data._fts_ready and node.data._search_columns == ["item.Comment"]
    assert [i.item_id for i in node.data.search_items("space", 5)] == ["m1"]


def test_tracing_and_the_card(tmp_path):
    """``tracing.enable`` installs the config's tracer (the in-memory buffer
    without a collector endpoint); a request through the node's REST
    server is a span."""
    from gorse_tpu_torch.utils import tracing
    from gorse_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.tracing.enable = True
    cfg.tracing.sampler = "ratio"
    cfg.tracing.ratio = 0.5
    try:
        node = InOneNode(cfg, workdir=str(tmp_path), device="cpu")
        t = tracing.tracer()
        assert t.enabled and t.sample_ratio == 0.5 and t.exporter is None
        parent = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
        status, _ = node.rest.dispatch("GET", "/api/latest", {}, None, {"traceparent": parent})
        assert status == 200
        span = t.export()[-1]
        assert (span["name"], span["trace_id"], span["parent_id"]) == \
            ("GET /api/latest", "a" * 32, "b" * 16)
        assert span["attrs"]["status_code"] == 200
        node.shutdown()
    finally:
        tracing.configure(enabled=False)


# the entry point with its device mapped to the CPU, as the tests run it
ENTRY = """
import os, sys, time, torch
import gorse_tpu_torch.serve.in_one as m
m.resolve_device = lambda d=None: torch.device("cpu")
if os.environ.get("SIGNALLED"):
    serve = m.InOneNode.serve

    def serve_then_wait(self, *args, **kwargs):
        # hold main() between the server's first answer and its handler
        # until the test has sent SIGINT
        httpd = serve(self, *args, **kwargs)
        deadline = time.time() + 60
        while not os.path.exists(os.environ["SIGNALLED"]) and time.time() < deadline:
            time.sleep(0.05)
        return httpd

    m.InOneNode.serve = serve_then_wait
sys.argv = ["gorse-tpu-torch-in-one"] + sys.argv[1:]
m.main()
"""


def _serve_then_sigint(config: Path, workdir: Path, signalled: Path | None = None) -> int:
    """Start the entry point, wait up to 120 s for its answer to ``GET
    /api/recommend/u1`` (ids of the catalog), send SIGINT (then create
    ``signalled``, when given) and return its exit code, waiting up to 60
    s. Its output goes to a file, shown when an assertion fails."""
    import http.client
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, SIGNALLED=str(signalled)) if signalled else None
    log = workdir / "entry.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", ENTRY, "--config", str(config), "--port", str(port),
             "--workdir", str(workdir)], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            env=env)
    try:
        body = None
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/api/recommend/u1")
                resp = conn.getresponse()
                body = json.loads(resp.read())
                conn.close()
                break
            except OSError:
                time.sleep(0.2)
        assert body and set(body) <= {f"i{i}" for i in range(N_ITEMS)}, log.read_text()
        proc.send_signal(signal.SIGINT)
        if signalled:
            signalled.touch()
        try:
            return proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise AssertionError("no exit 60 s after SIGINT:\n" + log.read_text()) from None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_the_entry_point_serves_and_stops_on_sigint(nodes, tmp_path):
    """``python -m gorse_tpu_torch.serve.in_one`` (its device mapped to the
    CPU, as the tests run it) answers from the node's files and ends on
    SIGINT with exit code 0, its first cycle running or not."""
    _, _, path = nodes["port"]
    assert _serve_then_sigint(path, tmp_path) == 0, (tmp_path / "entry.log").read_text()


def test_a_sigint_before_the_handler_is_in_place_is_held(nodes, tmp_path):
    """The server answers before ``main()`` has reached its SIGINT handler.
    Held in that window until the signal has been sent, the entry point
    still ends with exit code 0: the signal waits for the handler. (Raised
    in the window, ``KeyboardInterrupt`` left ``main()`` with exit code 1 or
    -2, -6 where a running cycle's threads were torn down at exit.)"""
    _, _, path = nodes["port"]
    rc = _serve_then_sigint(path, tmp_path, signalled=tmp_path / "signalled")
    assert rc == 0, (tmp_path / "entry.log").read_text()
