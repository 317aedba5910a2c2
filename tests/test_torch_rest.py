"""The port's REST API (gorse_tpu_torch/serve/rest.py and the master's
routes of serve/dashboard.py) held against gorse_tpu's on the CPU:

- the reference's REST cases (tests/test_serve.py and
  tests/test_rest_surface.py), each run over both packages, the port's
  in-one node on ``device="cpu"``;
- route by route: both packages' ``MasterRestServer`` on memory stores
  seeded alike take one script of requests through ``dispatch``, covering
  every route the port registers with its 400, 401 and 404 cases, and
  answer with equal status and body. Normalised, and nothing else: numbers
  (or numeric strings) that fall inside the script's own run window, which
  are ``time.time()`` stamps (auto-inserted rows, modify times, node and
  span times), also inside a dump's records and the CSV and JSONL rows;
  the session cookie's token (signed with a key drawn per process); and
  ``/metrics``, compared by its series (their values are durations and the
  process's memory);
- both front ends (the event loop and the threaded server) of each package
  over sockets: the same status, content type and body for every method.
"""

import csv
import http.client
import importlib
import io
import json
import re
import socket
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("ref", "port")


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


def _pkg(name: str) -> SimpleNamespace:
    root = {"ref": "gorse_tpu", "port": "gorse_tpu_torch"}[name]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    return SimpleNamespace(
        name=name, config=m("utils.config"), rest=m("serve.rest"), in_one=m("serve.in_one"),
        types=m("storage.types"), cache=m("storage.cache"), data=m("storage.data"),
        dashboard=m("serve.dashboard"), master=m("serve.master"), meta=m("storage.meta"),
        blob=m("storage.blob"), kw={"device": "cpu"} if name == "port" else {},
    )


def _node(p, config, workdir):
    return p.in_one.InOneNode(config, workdir=str(workdir), **p.kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _populate(p, data, n_users=30, n_items=40, seed=0):
    t = p.types
    rng = np.random.default_rng(seed)
    data.insert_items(
        [
            t.Item(f"i{k}", timestamp=float(k), categories=["even"] if k % 2 == 0 else [],
                   labels=["tag_a"] if k < 20 else ["tag_b"])
            for k in range(n_items)
        ]
    )
    data.insert_users([t.User(f"u{u}", labels=["young"] if u % 2 else ["old"])
                       for u in range(n_users)])
    fbs = []
    for u in range(n_users):
        liked = rng.choice(n_items, size=6, replace=False)
        for i in liked:
            fbs.append(t.Feedback("like", f"u{u}", f"i{i}", timestamp=float(rng.integers(1, 1000))))
    data.insert_feedback(fbs)


def _get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read().decode())


def _send(base, method, path, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers or {})
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read().decode())


# --------------------------------------------- tests/test_serve.py's cases


@pytest.fixture(scope="module", params=PACKAGES)
def http_node(request, tmp_path_factory):
    p = _pkg(request.param)
    config = p.config.Config()
    config.recommend.collaborative.type = "mf"
    config.recommend.ranker.type = "none"
    config.recommend.ranker.recommenders = ["collaborative"]
    config.recommend.fallback.recommenders = ["latest"]
    config.recommend.item_to_item = [p.config.ItemToItemConfigEntry(name="similar", type="users")]
    node = _node(p, config, tmp_path_factory.mktemp(f"http_{p.name}"))
    _populate(p, node.data)
    node.run_once()
    port = _free_port()
    node.serve("127.0.0.1", port, background_loop=False)
    yield node, f"http://127.0.0.1:{port}", p
    node.shutdown()


def test_rest_end_to_end(http_node):
    node, base, _ = http_node
    assert _get(base, "/api/health/live")[1]["status"] == "live"
    assert _get(base, "/api/health/ready")[1]["status"] == "ready"
    _send(base, "POST", "/api/user", {"UserId": "newuser", "Labels": ["x"]})
    assert _get(base, "/api/user/newuser")[1]["Labels"] == ["x"]
    _send(base, "PATCH", "/api/user/newuser", {"Comment": "hi"})
    assert _get(base, "/api/user/newuser")[1]["Comment"] == "hi"
    status, users = _get(base, "/api/users?n=5")
    assert len(users["Users"]) == 5 and users["Cursor"]
    _send(base, "POST", "/api/item", {"ItemId": "newitem", "Categories": ["c"],
                                      "Timestamp": "2023-01-01T00:00:00Z"})
    assert _get(base, "/api/item/newitem")[1]["Categories"] == ["c"]
    _send(base, "PUT", "/api/item/newitem/category/d")
    assert set(_get(base, "/api/item/newitem")[1]["Categories"]) == {"c", "d"}
    _send(base, "POST", "/api/feedback", [
        {"FeedbackType": "like", "UserId": "newuser", "ItemId": "newitem"}
    ])
    fb = _get(base, "/api/user/newuser/feedback/like")[1]
    assert fb and fb[0]["ItemId"] == "newitem"
    status, recs = _get(base, "/api/recommend/u1?n=5")
    assert status == 200 and len(recs) == 5
    consumed = {f.item_id for f in node.data.get_user_feedback("u1")}
    assert not (set(recs) & consumed)
    status, recs2 = _get(base, "/api/recommend/u1?n=3", headers={"X-API-Version": "2"})
    assert "Score" in recs2[0]
    assert len(_get(base, "/api/latest?n=3")[1]) == 3
    assert len(_get(base, "/api/popular?n=3")[1]) == 3
    assert _get(base, "/api/collaborative-filtering/u1?n=3")[1]
    i2i = _get(base, "/api/item-to-item/similar/i1?n=3")[1]
    assert i2i == _get(base, "/api/item/i1/neighbors?n=3")[1]
    status, sess = _send(base, "POST", "/api/session/recommend?n=5", [
        {"FeedbackType": "like", "UserId": "anon", "ItemId": "i1", "Timestamp": 100.0}
    ])
    assert status == 200 and sess
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/api/user/ghost")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/api/nonexistent")
    assert e.value.code == 404


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rest_api_key(pkg, tmp_path):
    p = _pkg(pkg)
    config = p.config.Config()
    config.recommend.collaborative.type = "mf"
    config.server.api_key = "secret"
    node = _node(p, config, tmp_path)
    port = _free_port()
    node.serve("127.0.0.1", port, background_loop=False)
    base = f"http://127.0.0.1:{port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/api/users")
        assert e.value.code == 401
        status, _ = _get(base, "/api/users", headers={"X-API-Key": "secret"})
        assert status == 200
        assert _get(base, "/api/health/live")[1]["status"] == "live"
    finally:
        node.shutdown()


def test_in_one_write_back(http_node):
    node, base, _ = http_node
    status, recs = _get(base, "/api/recommend/u2?n=2&write-back-type=read")
    assert status == 200
    fb = node.data.get_user_feedback("u2", feedback_types=["read"])
    assert {f.item_id for f in fb} == set(recs)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_openapi_spec(pkg):
    p = _pkg(pkg)
    server = p.rest.RestServer(p.config.Config(), p.data.MemoryDataStore(),
                               p.cache.MemoryCacheStore(), api_key="sekret")
    status, spec = server.dispatch("GET", "/apidocs.json", {}, None, {})
    assert status == 200
    assert spec["openapi"].startswith("3.")
    n_ops = sum(len(ops) for ops in spec["paths"].values())
    assert n_ops >= 42
    assert "/api/recommend/{user-id}" in spec["paths"]
    params = spec["paths"]["/api/recommend/{user-id}"]["get"]["parameters"]
    assert params[0]["name"] == "user-id"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_openapi_model_schemas(pkg):
    p = _pkg(pkg)
    server = p.rest.RestServer(p.config.Config(), p.data.MemoryDataStore(),
                               p.cache.MemoryCacheStore())
    registered = {(m, pat) for m, pat, _ in server._route_templates}
    for k in server._route_models():
        assert k in registered, f"model mapped to unregistered route {k}"
    _, spec = server.dispatch("GET", "/apidocs.json", {}, None, {})
    schemas = spec["components"]["schemas"]
    for name in ("User", "Item", "Feedback", "Score", "Success"):
        assert name in schemas

    def refs(node):
        if isinstance(node, dict):
            if "$ref" in node:
                yield node["$ref"]
            for v in node.values():
                yield from refs(v)
        elif isinstance(node, list):
            for v in node:
                yield from refs(v)

    for r in refs(spec):
        assert r.startswith("#/components/schemas/")
        assert r.rsplit("/", 1)[1] in schemas, r
    paths = spec["paths"]
    body = "requestBody"
    assert paths["/api/user"]["post"][body]["content"]["application/json"]["schema"] == {
        "$ref": "#/components/schemas/User"}
    assert paths["/api/users"]["post"][body]["content"]["application/json"]["schema"][
        "items"] == {"$ref": "#/components/schemas/User"}
    assert paths["/api/item/{item-id}"]["get"]["responses"]["200"]["content"][
        "application/json"]["schema"] == {"$ref": "#/components/schemas/Item"}
    assert paths["/api/feedback"]["post"][body]["content"]["application/json"]["schema"][
        "items"] == {"$ref": "#/components/schemas/Feedback"}
    assert paths["/api/session/recommend"]["post"]["responses"]["200"]["content"][
        "application/json"]["schema"]["items"] == {"$ref": "#/components/schemas/Score"}
    json.dumps(spec)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_items_search_endpoint(pkg):
    p = _pkg(pkg)
    config = p.config.Config()
    config.recommend.collaborative.type = "mf"
    data = p.data.MemoryDataStore()
    data.insert_items([p.types.Item("m1", comment="a space opera"),
                       p.types.Item("m2", comment="courtroom drama")])
    server = p.rest.RestServer(config, data, p.cache.MemoryCacheStore())
    status, body = server.dispatch("GET", "/api/items", {"q": "space"}, None, {})
    assert status == 400
    config.recommend.search.columns = ["comment"]
    data.reconcile(config.recommend.search.columns)
    status, body = server.dispatch("GET", "/api/items", {"q": "space"}, None, {})
    assert status == 200
    assert [i["ItemId"] for i in body["Items"]] == ["m1"]


def test_search_documents_semantics(http_node):
    node, base, _ = http_node
    status, latest = _get(base, "/api/latest?n=3")
    assert {"Id", "Score"} <= set(latest[0])
    status, pop = _get(base, "/api/popular?n=3")
    assert {"Id", "Score"} <= set(pop[0])
    status, cf = _get(base, "/api/collaborative-filtering/u1?n=3")
    assert {"Id", "Score"} <= set(cf[0])
    read = {f.item_id for f in node.data.get_user_feedback("u1")}
    status, pruned = _get(base, "/api/latest?n=100&user-id=u1")
    assert not ({d["Id"] for d in pruned} & read)
    status, pruned = _get(base, "/api/popular?n=100&user-id=u1")
    assert not ({d["Id"] for d in pruned} & read)
    req = urllib.request.Request(base + "/api/popular?n=3")
    with urllib.request.urlopen(req) as resp:
        assert resp.headers.get("Last-Modified", "").endswith("GMT")
    status, sess = _send(base, "POST", "/api/session/recommend?n=5", [
        {"FeedbackType": "like", "UserId": "anon", "ItemId": "i1", "Timestamp": 100.0}
    ])
    assert sess and {"Id", "Score"} <= set(sess[0])


def test_collaborative_disabled_404(http_node):
    node, base, _ = http_node
    node.master.config.recommend.collaborative.type = "none"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/api/collaborative-filtering/u1?n=3")
        assert e.value.code == 404
    finally:
        node.master.config.recommend.collaborative.type = "mf"


def test_auto_insert_flags_and_modify_times(http_node):
    node, base, p = http_node
    ck, key = p.cache, p.cache.key
    _send(base, "POST", "/api/feedback", [
        {"FeedbackType": "like", "UserId": "autou", "ItemId": "autoi"}
    ])
    assert node.data.get_user("autou") is not None
    assert node.data.get_item("autoi") is not None
    assert node.master.cache.get(key(ck.LAST_MODIFY_USER_TIME, "autou"))
    assert node.master.cache.get(key(ck.LAST_MODIFY_ITEM_TIME, "autoi"))
    node.master.config.server.auto_insert_user = False
    node.master.config.server.auto_insert_item = False
    try:
        _send(base, "POST", "/api/feedback", [
            {"FeedbackType": "like", "UserId": "ghostu", "ItemId": "ghosti"}
        ])
        assert node.data.get_user("ghostu") is None
        assert node.data.get_item("ghosti") is None
    finally:
        node.master.config.server.auto_insert_user = True
        node.master.config.server.auto_insert_item = True
    _send(base, "POST", "/api/item", {"ItemId": "stamped"})
    assert node.master.cache.get(key(ck.LAST_MODIFY_ITEM_TIME, "stamped"))


# --------------------------------------- tests/test_rest_surface.py's cases


@pytest.fixture(scope="module", params=PACKAGES)
def surface(request, tmp_path_factory):
    p = _pkg(request.param)
    c = p.config
    config = c.Config()
    config.recommend.ranker.type = "none"
    config.recommend.item_to_item = [c.ItemToItemConfigEntry(name="similar", type="users")]
    config.recommend.user_to_user = [c.UserToUserConfigEntry(name="peers", type="items")]
    config.recommend.non_personalized = [
        c.NonPersonalizedConfigEntry(name="trending", score="len(feedback)")
    ]
    node = _node(p, config, tmp_path_factory.mktemp(f"surface_{p.name}"))
    t = p.types
    node.data.insert_users([t.User(f"u{u}") for u in range(8)])
    node.data.insert_items(
        [t.Item(f"i{k}", timestamp=float(k), categories=["even"] if k % 2 == 0 else [])
         for k in range(16)]
    )
    rng = np.random.default_rng(3)
    fbs = []
    for u in range(8):
        for i in rng.choice(16, size=6, replace=False):
            fbs.append(t.Feedback("like", f"u{u}", f"i{i}", timestamp=float(u * 16 + i)))
    fbs.append(t.Feedback("read", "u0", "i1", timestamp=1.0))
    node.data.insert_feedback(fbs)
    node.run_once()
    port = _free_port()
    node.serve("127.0.0.1", port, background_loop=False)
    yield node, f"http://127.0.0.1:{port}"
    node.shutdown()


def _req(base, path, method="GET", data=None, content_type="application/json"):
    if isinstance(data, (dict, list)):
        data = json.dumps(data).encode()
    r = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": content_type} if data else {},
    )
    with urllib.request.urlopen(r) as resp:
        body = resp.read()
        ctype = resp.headers.get("Content-Type", "")
        return resp.status, json.loads(body) if "json" in ctype else body


def test_entity_feedback_reads(surface):
    _, base = surface
    _, rows = _req(base, "/api/user/u0/feedback")
    assert rows and all(r["UserId"] == "u0" for r in rows)
    _, typed = _req(base, "/api/user/u0/feedback/read")
    assert [r["ItemId"] for r in typed] == ["i1"]
    _, irows = _req(base, "/api/item/i1/feedback")
    assert irows and all(r["ItemId"] == "i1" for r in irows)
    _, ityped = _req(base, "/api/item/i1/feedback/read")
    assert [r["UserId"] for r in ityped] == ["u0"]
    _, none = _req(base, "/api/item/i1/feedback/ghost-type")
    assert none == []


def test_neighbors_aliases(surface):
    _, base = surface
    _, via_name = _req(base, "/api/item-to-item/similar/i1")
    _, via_alias = _req(base, "/api/item/i1/neighbors")
    assert via_alias == via_name and via_alias
    _, by_cat = _req(base, "/api/item/i1/neighbors/even")
    assert by_cat
    assert {r["Id"] for r in by_cat} <= {f"i{k}" for k in range(0, 16, 2)}
    _, u_via_name = _req(base, "/api/user-to-user/peers/u0")
    _, u_via_alias = _req(base, "/api/user/u0/neighbors")
    assert u_via_alias == u_via_name and u_via_alias


def test_non_personalized_and_measurements(surface):
    _, base = surface
    _, rows = _req(base, "/api/non-personalized/trending")
    assert rows and rows[0]["Score"] >= rows[-1]["Score"]
    _, points = _req(base, "/api/measurements/num_users")
    assert points and points[-1]["Value"] == 8.0
    _, empty = _req(base, "/api/measurements/no_such_series")
    assert empty == []


def test_item_category_add_remove(surface):
    n, base = surface
    _, out = _req(base, "/api/item/i3/category/featured", method="PUT")
    assert out["RowAffected"] == 1
    assert "featured" in n.data.get_item("i3").categories
    _req(base, "/api/item/i3/category/featured", method="PUT")
    assert n.data.get_item("i3").categories.count("featured") == 1
    _, out = _req(base, "/api/item/i3/category/featured", method="DELETE")
    assert out["RowAffected"] == 1
    assert "featured" not in n.data.get_item("i3").categories
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, "/api/item/ghost/category/x", method="PUT")
    assert e.value.code == 404


def test_http_csv_export_import(surface):
    n, base = surface
    _, csv_users = _req(base, "/api/export/users")
    assert csv_users.decode().count("\n") >= 8
    _, csv_items = _req(base, "/api/export/items")
    assert b"i1" in csv_items
    # import new users through the HTTP surface
    extra = "user_id,labels\nnew-user-a,\nnew-user-b,\n"
    _, out = _req(base, "/api/import/users", method="POST",
                  data=extra.encode(), content_type="text/csv")
    assert out == {"RowAffected": 2} and n.data.get_user("new-user-a") is not None


def test_dashboard_previews(surface):
    _, base = surface
    _, i2i = _req(base, "/api/dashboard/item-to-item/similar/i1")
    assert i2i and "Score" in i2i[0] and "ItemId" in i2i[0]
    _, u2u = _req(base, "/api/dashboard/user-to-user/peers/u0")
    assert u2u and "Score" in u2u[0]
    _, np_rows = _req(base, "/api/dashboard/non-personalized/trending")
    assert np_rows and "ItemId" in np_rows[0]
    _, fb = _req(base, "/api/dashboard/user/u0/feedback")
    assert fb
    _, fb_read = _req(base, "/api/dashboard/user/u0/feedback/read")
    assert len(fb_read) == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_visibility_end_to_end(pkg, tmp_path):
    p = _pkg(pkg)
    ck, t = p.cache, p.types
    config = p.config.Config()
    config.recommend.item_to_item = [p.config.ItemToItemConfigEntry(name="similar", type="users")]
    config.recommend.ranker.type = "fm"
    n = _node(p, config, tmp_path)
    port = _free_port()
    n.serve("127.0.0.1", port, background_loop=False)
    base = f"http://127.0.0.1:{port}"
    try:
        items = [{"ItemId": str(i), "Categories": ["a"], "Timestamp": float(i + 1)}
                 for i in range(5)]
        _req(base, "/api/items", method="POST", data=items)
        docs = [t.Score(id=str(i), score=float(i + 1), categories=["", "a"]) for i in range(5)]
        docs.reverse()
        n.cache.add_scores(ck.ITEM_TO_ITEM, ck.key("similar", "100"), docs)
        n.cache.add_scores(ck.RECOMMEND, "100", docs)
        _req(base, "/api/item/0", method="DELETE")
        _req(base, "/api/item/1", method="PATCH", data={"IsHidden": True})
        _req(base, "/api/item", method="POST", data={"ItemId": "2", "IsHidden": True})
        _, latest = _req(base, "/api/latest?n=10")
        assert [d["Id"] for d in latest] == ["4", "3"]
        _, nb = _req(base, "/api/item/100/neighbors?n=10")
        assert [d["Id"] for d in nb] == ["4", "3"]
        _, recs = _req(base, "/api/recommend/100?n=10")
        assert recs == ["4", "3"]
        _req(base, "/api/item", method="POST",
             data={"ItemId": "0", "Categories": ["a"], "Timestamp": 1.0})
        _req(base, "/api/item/1", method="PATCH", data={"IsHidden": False})
        _req(base, "/api/item", method="POST",
             data={"ItemId": "2", "Categories": ["a"], "Timestamp": 3.0})
        _, latest = _req(base, "/api/latest?n=10")
        assert [d["Id"] for d in latest] == ["4", "3", "2", "1", "0"]
        _, nb = _req(base, "/api/item/100/neighbors?n=10")
        assert [d["Id"] for d in nb] == ["4", "3", "2", "1", "0"]
        _, recs = _req(base, "/api/recommend/100?n=10")
        assert recs == ["4", "3", "2", "1", "0"]
    finally:
        n.shutdown()


# ------------------------------------------------------- route by route

def _restore_stream() -> bytes:
    """A dump of fixed rows (the port's ``dump``), restored by both."""
    from gorse_tpu_torch.serve import dump
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.types import Feedback, Item, User

    store = MemoryDataStore()
    store.insert_users([User("r1", labels={"a": [1, 2.5]}, comment="c"), User("r2")])
    store.insert_items([Item("ri", categories=["even"], timestamp=3.0, labels=["x"])])
    store.insert_feedback([Feedback("like", "r1", "ri", timestamp=4.0)])
    buf = io.BytesIO()
    dump.dump(store, buf)
    return buf.getvalue()


_MULTIPART = (b"--XyZ\r\nContent-Disposition: form-data; name=\"file\"; filename=\"u.jsonl\"\r\n"
              b"Content-Type: application/octet-stream\r\n\r\n"
              b'{"UserId": "mp1"}\n{"UserId": "mp2", "Labels": {"k": "v"}}\n\r\n--XyZ--\r\n')


def seed_master(p, tmp):
    """A master over memory stores holding the same rows, caches, meta keys
    and time series in either package, its REST server with the public
    routes keyed by "pub"."""
    c, t, ck = p.config, p.types, p.cache
    config = c.Config()
    config.recommend.collaborative.type = "mf"
    config.recommend.ranker.type = "none"
    config.recommend.ranker.recommenders = ["collaborative"]
    config.recommend.fallback.recommenders = ["latest"]
    config.recommend.item_to_item = [c.ItemToItemConfigEntry(name="similar", type="users")]
    config.recommend.user_to_user = [c.UserToUserConfigEntry(name="peers", type="items")]
    data, cache = p.data.MemoryDataStore(), ck.MemoryCacheStore()
    rng = np.random.default_rng(11)
    data.insert_items([t.Item(f"i{k}", is_hidden=k == 7, categories=["even"] if k % 2 == 0
                              else ["odd"], timestamp=float(100 + k), labels={"tag": k % 3},
                              comment=f"item {k}") for k in range(12)])
    data.insert_users([t.User(f"u{u}", labels=["a"] if u % 2 else {"age": u}, comment=f"c{u}",
                              subscribe=["x"] if u == 1 else None) for u in range(6)])
    rows = []
    for u in range(6):
        for k in sorted(rng.choice(12, 4, replace=False)):
            rows.append(t.Feedback(("like", "read")[int(rng.integers(2))], f"u{u}", f"i{k}",
                                   float(rng.integers(1, 5)), float(10 * u + k), "n"))
    data.insert_feedback(rows)

    def scores(ids, base):
        return [t.Score(f"i{k}", base - n, ["", "even" if k % 2 == 0 else "odd"], 50.0)
                for n, k in enumerate(ids)]

    for name, ids in (("popular", (3, 1, 4, 8, 5, 9, 2, 6)), ("latest", (11, 10, 9, 8, 6))):
        cache.add_scores(ck.NON_PERSONALIZED, name, scores(ids, 10.0))
    for k in range(12):
        cache.add_scores(ck.ITEM_TO_ITEM, ck.key("similar", f"i{k}"),
                         scores([(k + d) % 12 for d in (1, 3, 5, 2)], 5.0))
    for u in range(6):
        cache.add_scores(ck.USER_TO_USER, ck.key("peers", f"u{u}"),
                         [t.Score(f"u{(u + d) % 6}", 3.0 - d, [""], 50.0) for d in (1, 2)])
        for coll in (ck.COLLABORATIVE, ck.RECOMMEND):
            cache.add_scores(coll, f"u{u}", scores([(u + d) % 12 for d in range(7)], 9.0))
        cache.set(ck.key(ck.LAST_UPDATE_USER_RECOMMEND_TIME, f"u{u}"), "1000.5")
    for key_, v in ((ck.key(ck.NON_PERSONALIZED_UPDATE_TIME, "popular"), "2000.0"),
                    (ck.key(ck.ITEM_TO_ITEM_UPDATE_TIME, "similar"), "3000.0"),
                    (ck.key(ck.USER_TO_USER_UPDATE_TIME, "peers"), "4000.0"),
                    (ck.key(ck.GLOBAL_META, ck.NUM_USERS), "6"),
                    (ck.key(ck.GLOBAL_META, ck.NUM_VALID_POS_FEEDBACKS), "9"),
                    (ck.key(ck.GLOBAL_META, ck.LAST_UPDATE_POPULAR_ITEMS_TIME), "77.0"),
                    (ck.LAST_FIT_MATCHING_MODEL_TIME, "88.0")):
        cache.set(key_, v)
    cache.add_time_series_points([t.TimeSeriesPoint("num_users", float(s), float(s) / 2)
                                  for s in range(1, 6)])
    meta = p.meta.MetaStore()
    meta.put("COLLABORATIVE_FILTERING_MODEL", "cf-model-1")
    meta.put("CF_MODEL_META", json.dumps({"score": 0.25, "type": "bpr"}))
    master = p.master.Master(config, data, cache, p.blob.BlobStore(tmp / p.name), meta, **p.kw)
    return master, p.dashboard.MasterRestServer(master)


def _ts_window(t0, t1):
    def norm(x):
        if isinstance(x, bool):
            return x
        if isinstance(x, (int, float)) and t0 <= x <= t1:
            return "<now>"
        if isinstance(x, str):
            try:
                v = float(x)
            except ValueError:
                return x
            return "<now>" if t0 <= v <= t1 else x
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return x
    return norm


def _comparable(rest, status, payload, norm):
    data, ctype, extra, status = rest.render_payload(status, payload)
    headers = dict(extra)
    if "Set-Cookie" in headers:
        headers["Set-Cookie"] = re.sub(r"gorse_session=[^;]+", "gorse_session=<token>",
                                       headers["Set-Cookie"])
    if ctype.startswith("text/plain; version"):
        body = sorted({line.rsplit(" ", 1)[0] for line in data.decode().splitlines()
                       if line and not line.startswith("#")})
    elif ctype == "application/json":
        body = norm(json.loads(data))
    elif data.startswith(b"GTPU1"):
        from gorse_tpu_torch.utils.msgpack import Unpacker

        body = norm(list(Unpacker(data[5:])))
    elif ctype == "text/csv":
        body = [norm(row) for row in csv.reader(io.StringIO(data.decode()))]
    elif ctype == "application/jsonl":
        body = [norm(json.loads(line)) for line in data.decode().splitlines()]
    else:
        body = data
    return status, ctype, headers, body


def _b64(text: str) -> str:
    import base64

    return base64.b64encode(text.encode()).decode()


def _script():
    """(method, path, query, body, headers) requests and ("do", fn) steps
    that change both servers alike."""
    key = {"X-API-Key": "k"}
    admin = {"X-API-Key": "admin"}
    fb = [{"FeedbackType": "like", "UserId": "u1", "ItemId": "i11", "Timestamp": 5.0},
          {"FeedbackType": "star", "UserId": "nu", "ItemId": "ni"}]
    return [
        ("GET", "/api/health/live", {}, None, {}),
        ("GET", "/api/health/ready", {}, None, {}),
        ("GET", "/apidocs.json", {}, None, {}),
        ("GET", "/api/user/u1", {}, None, {}),
        ("GET", "/api/user/ghost", {}, None, {}),
        ("GET", "/api/user/u1/", {}, None, {}),
        ("POST", "/api/user", {}, {"UserId": "new", "Labels": {"k": 1}}, {}),
        ("POST", "/api/user", {}, {"Labels": []}, {}),
        ("PATCH", "/api/user/new", {}, {"Comment": "hi", "Subscribe": ["s"], "Labels": [1]}, {}),
        ("PATCH", "/api/user/ghost", {}, {"Comment": "x"}, {}),
        ("POST", "/api/users", {}, [{"UserId": "m1"}, {"UserId": "m2"}], {}),
        ("POST", "/api/users", {}, [{"UserId": "m3"}, {"Comment": "no id"}], {}),
        ("GET", "/api/users", {"n": "3"}, None, {}),
        ("GET", "/api/users", {"n": "3", "cursor": "u1"}, None, {}),
        ("GET", "/api/users", {"n": "abc"}, None, {}),
        ("DELETE", "/api/user/m2", {}, None, {}),
        ("GET", "/api/item/i2", {}, None, {}),
        ("GET", "/api/item/ghost", {}, None, {}),
        ("POST", "/api/item", {}, {"ItemId": "n1", "Categories": ["even"],
                                   "Timestamp": "2023-01-01T00:00:00Z"}, {}),
        ("POST", "/api/item", {}, {"Categories": ["x"]}, {}),
        ("PATCH", "/api/item/i3", {}, {"IsHidden": True, "Categories": ["odd", "z"],
                                       "Labels": ["l"], "Comment": "p", "Timestamp": 7.5}, {}),
        ("PATCH", "/api/item/i5", {}, {"Timestamp": "2024-02-03T04:05:06+00:00"}, {}),
        ("PATCH", "/api/item/ghost", {}, {"IsHidden": True}, {}),
        ("POST", "/api/items", {}, [{"ItemId": "n2", "Timestamp": 9.0}, {"ItemId": "n3"}], {}),
        ("POST", "/api/items", {}, [{"ItemId": "n4"}, {}], {}),
        ("GET", "/api/items", {"n": "4"}, None, {}),
        ("GET", "/api/items", {"n": "4", "cursor": "i3"}, None, {}),
        ("GET", "/api/items", {"q": "item"}, None, {}),
        ("PUT", "/api/item/i4/category/featured", {}, None, {}),
        ("PUT", "/api/item/ghost/category/featured", {}, None, {}),
        ("DELETE", "/api/item/i4/category/featured", {}, None, {}),
        ("DELETE", "/api/item/ghost/category/featured", {}, None, {}),
        ("DELETE", "/api/item/i9", {}, None, {}),
        ("POST", "/api/feedback", {}, fb, {}),
        ("PUT", "/api/feedback", {}, [{"FeedbackType": "like", "UserId": "u2", "ItemId": "i1",
                                       "Value": 3.0, "Timestamp": "2020-01-01T00:00:00Z"}], {}),
        ("POST", "/api/feedback", {}, [{"FeedbackType": "like", "UserId": "u2"}], {}),
        ("PUT", "/api/feedback", {}, {"FeedbackType": "read", "UserId": "u3", "ItemId": "i2",
                                      "Timestamp": 6.0}, {}),
        ("GET", "/api/feedback", {"n": "5"}, None, {}),
        ("GET", "/api/feedback/like", {"n": "4"}, None, {}),
        ("GET", "/api/feedback/nosuch", {}, None, {}),
        ("GET", "/api/feedback/u1/i11", {}, None, {}),
        ("GET", "/api/feedback/like/u1/i11", {}, None, {}),
        ("GET", "/api/feedback/star/u1/i11", {}, None, {}),
        ("GET", "/api/user/u0/feedback", {}, None, {}),
        ("GET", "/api/user/u0/feedback/like", {}, None, {}),
        ("GET", "/api/item/i11/feedback", {}, None, {}),
        ("GET", "/api/item/i11/feedback/like", {}, None, {}),
        ("DELETE", "/api/feedback/like/u1/i11", {}, None, {}),
        ("DELETE", "/api/feedback/u3/i2", {}, None, {}),
        ("GET", "/api/collaborative-filtering/u2", {"n": "3"}, None, {}),
        ("GET", "/api/collaborative-filtering/u2/even", {}, None, {}),
        ("GET", "/api/collaborative-filtering/u2", {"user-id": "u2", "offset": "1"}, None, {}),
        ("GET", "/api/latest", {"n": "4"}, None, {}),
        ("GET", "/api/latest/even", {"user-id": "u1"}, None, {}),
        ("GET", "/api/latest", {"category": "odd", "__multi__": {"category": ["odd"]}},
         None, {}),
        ("GET", "/api/popular", {"n": "3", "offset": "1"}, None, {}),
        ("GET", "/api/popular/even", {}, None, {}),
        ("GET", "/api/popular", {"user-id": "u0"}, None, {}),
        ("GET", "/api/non-personalized/popular", {"n": "2"}, None, {}),
        ("GET", "/api/non-personalized/nosuch", {}, None, {}),
        ("GET", "/api/item-to-item/similar/i1", {"n": "3"}, None, {}),
        ("GET", "/api/item/i1/neighbors", {}, None, {}),
        ("GET", "/api/item/i1/neighbors/even", {}, None, {}),
        ("GET", "/api/user-to-user/peers/u1", {}, None, {}),
        ("GET", "/api/user/u1/neighbors", {}, None, {}),
        ("GET", "/api/recommend/u1", {"n": "4"}, None, {}),
        ("GET", "/api/recommend/u1", {"n": "3"}, None, {"X-API-Version": "2"}),
        ("GET", "/api/recommend/u1/even", {}, None, {}),
        ("GET", "/api/recommend/cold", {"n": "3"}, None, {}),
        ("GET", "/api/recommend/u4", {"n": "2", "write-back-type": "read",
                                      "write-back-delay": "0s"}, None, {}),
        ("GET", "/api/recommend/u4", {"write-back-type": "read", "write-back-delay": "x"},
         None, {}),
        ("POST", "/api/session/recommend", {"n": "5"},
         [{"FeedbackType": "like", "UserId": "a", "ItemId": "i1", "Timestamp": 3.0},
          {"FeedbackType": "like", "UserId": "a", "ItemId": "i2", "Timestamp": 4.0}], {}),
        ("POST", "/api/session/recommend/even", {}, [{"FeedbackType": "like", "UserId": "a",
                                                      "ItemId": "i1"}], {}),
        ("GET", "/api/measurements/num_users", {"n": "3"}, None, {}),
        ("GET", "/api/measurements/none", {}, None, {}),
        ("GET", "/api/nonexistent", {}, None, {}),
        ("POST", "/api/health/live", {}, None, {}),
        # dashboard
        ("GET", "/api/dashboard/cluster", {}, None, {}),
        ("POST", "/api/admin/meta", {}, {"uuid": "w1", "hostname": "h", "type": "worker",
                                         "version": "v"}, {}),
        ("POST", "/api/admin/meta", {}, {"uuid": "s1", "type": "server"}, {}),
        ("POST", "/api/admin/meta", {}, {}, {}),
        ("POST", "/api/admin/progress", {}, {"uuid": "w1", "spans": [
            {"Name": "recommend", "Status": "running", "Count": 5, "Total": 10}]}, {}),
        ("GET", "/api/dashboard/cluster", {}, None, {}),
        ("GET", "/api/dashboard/tasks", {}, None, {}),
        ("GET", "/api/dashboard/stats", {}, None, {}),
        ("GET", "/api/dashboard/timeseries/num_users", {}, None, {}),
        ("GET", "/api/dashboard/config", {}, None, {}),
        ("GET", "/api/dashboard/config/schema", {}, None, {}),
        ("POST", "/api/dashboard/config", {}, {"recommend": {"cache_size": 55}}, {}),
        ("POST", "/api/dashboard/config", {}, {"collaborative": {"type": "bogus"}}, {}),
        ("GET", "/api/dashboard/config", {}, None, {}),
        ("DELETE", "/api/dashboard/config", {}, None, {}),
        ("GET", "/api/dashboard/categories", {}, None, {}),
        ("POST", "/api/dashboard/schedule", {}, {}, {}),
        ("GET", "/api/dashboard/feedback", {"n": "3"}, None, {}),
        ("GET", "/api/dashboard/feedback", {"n": "3", "cursor": "3"}, None, {}),
        ("GET", "/api/dashboard/feedback", {"cursor": "x"}, None, {}),
        ("GET", "/api/dashboard/feedback/read", {}, None, {}),
        ("GET", "/api/dashboard/users", {"n": "2"}, None, {}),
        ("GET", "/api/dashboard/user/u1", {}, None, {}),
        ("GET", "/api/dashboard/user/ghost", {}, None, {}),
        ("GET", "/api/dashboard/user/u0/feedback", {}, None, {}),
        ("GET", "/api/dashboard/user/u0/feedback/like", {}, None, {}),
        ("GET", "/api/dashboard/recommend/u1", {"n": "4"}, None, {}),
        ("GET", "/api/dashboard/recommend/u1/collaborative", {"n": "3"}, None, {}),
        ("GET", "/api/dashboard/recommend/u1/item-to-item/similar", {}, None, {}),
        ("GET", "/api/dashboard/latest", {"n": "3"}, None, {}),
        ("GET", "/api/dashboard/non-personalized/popular", {}, None, {}),
        ("GET", "/api/dashboard/item-to-item/similar/i2", {}, None, {}),
        ("GET", "/api/dashboard/user-to-user/peers/u2", {}, None, {}),
        ("GET", "/api/dashboard/external", {}, None, {}),
        ("GET", "/api/dashboard/external", {"script": "a"}, None, {}),
        ("GET", "/api/dashboard/external",
         {"script": _b64("JSON.stringify([user_id, 'x'].concat([1, 2].map(String)))"),
          "user-id": "u1"}, None, {}),
        ("GET", "/api/dashboard/external", {"script": _b64("[user_id]")}, None, {}),
        ("GET", "/api/dashboard/external", {"script": _b64("throw new Error('boom')")},
         None, {}),
        ("GET", "/api/dashboard/external", {"script": _b64("42")}, None, {}),
        ("GET", "/login", {}, None, {}),
        ("POST", "/login", {}, {"user_name": "a", "password": "b"}, {}),
        ("GET", "/callback/oauth2", {"state": "s"}, None, {}),
        ("GET", "/logout", {}, None, {}),
        ("GET", "/api/dashboard/userinfo", {}, None, {}),
        ("GET", "/metrics", {}, None, {}),
        # the dashboard's page, the prompt preview and the chat proxy
        # without an endpoint
        ("GET", "/", {}, None, {}),
        ("GET", "/api/dashboard/ranker/prompt",
         {"query-template": _b64("{{ user.user_id }}: {% for t, item in feedback %}"
                                 "{{ t }}/{{ item.item_id }} {% endfor %}"),
          "document-template": _b64("doc {{ item.item_id }} {{ item.categories|join(',') }}"),
          "user-id": "u1"}, None, {}),
        ("GET", "/api/dashboard/ranker/prompt", {"query-template": _b64("q"),
                                                 "document-template": _b64("d")}, None, {}),
        ("GET", "/api/dashboard/ranker/prompt", {"query-template": _b64("q"),
                                                 "document-template": _b64("d"),
                                                 "user-id": "ghost"}, None, {}),
        ("GET", "/api/dashboard/ranker/prompt", {}, None, {}),
        ("POST", "/api/chat/completions", {}, {"messages": [{"role": "user", "content": "x"}]},
         {}),
        # bulk data: dump, restore, CSV and JSONL both ways, purge refused
        ("GET", "/api/dump", {}, None, {}),
        ("POST", "/api/restore", {}, _restore_stream(), {}),
        ("POST", "/api/restore", {}, {"not": "a stream"}, {}),
        ("GET", "/api/export/users", {}, None, {}),
        ("GET", "/api/export/items", {}, None, {}),
        ("GET", "/api/export/feedback", {}, None, {}),
        ("POST", "/api/import/users", {}, b"user_id,labels\ncu1,\ncu2,\"{\"\"k\"\": 1}\"\n", {}),
        ("POST", "/api/import/items", {},
         b"item_id,is_hidden,categories,timestamp,labels,description\n"
         b"ci1,true,a|b,5.5,[],hello\nci2,false,,,,\n", {}),
        ("POST", "/api/import/feedback", {},
         b"feedback_type,user_id,item_id,timestamp\nlike,cu1,ci1,7\n", {}),
        ("POST", "/api/import/users", {}, None, {}),
        ("GET", "/api/bulk/users", {}, None, {}),
        ("GET", "/api/bulk/items", {}, None, {}),
        ("GET", "/api/bulk/feedback", {}, None, {}),
        ("POST", "/api/bulk/users", {}, _MULTIPART,
         {"Content-Type": "multipart/form-data; boundary=XyZ"}),
        ("POST", "/api/bulk/items", {}, b'{"ItemId": "bi1", "Categories": ["c"]}\n\n'
         b'{"ItemId": "bi2"}\n', {}),
        ("POST", "/api/bulk/feedback", {},
         b'{"FeedbackType": "like", "UserId": "cu2", "ItemId": "bi1", "Timestamp": 8}\n', {}),
        ("POST", "/api/bulk/items", {}, b'{"ItemId": "ok"}\n{not json\n', {}),
        ("POST", "/api/bulk/users", {}, b'{"UserId": "a/b"}\n', {}),
        ("POST", "/api/bulk/feedback", {}, b'{"FeedbackType": "x", "UserId": " ", '
         b'"ItemId": "i1"}\n', {}),
        ("POST", "/api/bulk/users", {}, b"--XyZ--\r\n",
         {"Content-Type": "multipart/form-data; boundary=XyZ"}),
        ("POST", "/api/bulk/users", {}, {"json": "body"}, {}),
        ("POST", "/api/purge", {}, {"check_list": "delete_users,delete_items,"
                                                  "delete_feedback,delete_cache"}, {}),
        ("GET", "/api/dump", {}, None, {}),
        # the neighbour aliases and CF without their configuration: 404
        ("do", lambda m: setattr(m.config.recommend, "item_to_item", [])),
        ("do", lambda m: setattr(m.config.recommend, "user_to_user", [])),
        ("do", lambda m: setattr(m.config.recommend.collaborative, "type", "none")),
        ("GET", "/api/item/i1/neighbors", {}, None, {}),
        ("GET", "/api/user/u1/neighbors", {}, None, {}),
        ("POST", "/api/session/recommend", {}, [], {}),
        ("GET", "/api/collaborative-filtering/u2", {}, None, {}),
        # the public API key: 401 on a route, 404 off the table, health free
        ("do", lambda m: setattr(m.rest, "api_key", "k")),
        ("GET", "/api/user/u1", {}, None, {}),
        ("GET", "/api/user/u1", {}, None, key),
        ("GET", "/api/no/such/route", {}, None, {}),
        ("GET", "/api/health/live", {}, None, {}),
        ("GET", "/apidocs.json", {}, None, {}),
        ("GET", "/metrics", {}, None, {}),
        ("GET", "/api/dashboard/stats", {}, None, key),
        # the admin key and the dashboard login: the protected prefixes
        ("do", lambda m: setattr(m.config.master, "admin_api_key", "admin")),
        ("do", lambda m: setattr(m.config.master, "dashboard_user_name", "root")),
        ("do", lambda m: setattr(m.config.master, "dashboard_password", "pw")),
        ("POST", "/api/admin/meta", {}, {}, key),
        ("GET", "/api/dashboard/stats", {}, None, {}),
        ("GET", "/api/dashboard/cluster", {}, None, admin),
        ("GET", "/api/dump", {}, None, {}),
        ("POST", "/login", {}, {"user_name": "root", "password": "nope"}, {}),
        ("POST", "/login", {}, {"user_name": "root", "password": "pw"}, {}),
        ("GET", "/api/dashboard/userinfo", {}, None, {"Cookie": "<session>"}),
        ("GET", "/api/dashboard/stats", {}, None, {"Cookie": "<session>"}),
        ("GET", "/login", {"msg": "<b>x</b>"}, None, {}),
        # purge with the password set: the checklist, then everything gone
        ("POST", "/api/purge", {}, {"check_list": "delete_users"}, {"Cookie": "<session>"}),
        ("POST", "/api/purge", {}, {}, {"Cookie": "<session>"}),
        ("POST", "/api/purge", {}, {"check_list": "delete_users,delete_items,delete_feedback,"
                                                  "delete_cache"}, {"Cookie": "<session>"}),
        ("GET", "/api/dump", {}, None, {"Cookie": "<session>"}),
        ("GET", "/api/users", {}, None, key),
    ]


def test_every_route_equals_the_reference(tmp_path):
    """One script through both packages' ``MasterRestServer.dispatch``:
    every status and body equal (normalised as the module says), every
    route the port registers reached, and the port's route table the
    reference's."""
    servers = {}
    for name in PACKAGES:
        p = _pkg(name)
        master, rest = seed_master(p, tmp_path)
        servers[name] = SimpleNamespace(master=master, rest=rest, config=master.config)
    want_routes = {(m, pat) for m, pat, _ in servers["ref"].rest._route_templates}
    got_routes = {(m, pat) for m, pat, _ in servers["port"].rest._route_templates}
    assert got_routes == want_routes
    t0 = time.time()
    script = _script()
    reached = set()
    answers = {name: [] for name in PACKAGES}
    session = {}
    for step in script:
        if step[0] == "do":
            for s in servers.values():
                step[1](s)
            continue
        method, path, query, body, headers = step
        for name, s in servers.items():
            h = dict(headers)
            if h.get("Cookie") == "<session>":
                h["Cookie"] = session[name]
            status, payload = s.rest.dispatch(method, path, dict(query), body, h)
            cookie = getattr(payload, "headers", {}).get("Set-Cookie", "")
            if cookie.startswith("gorse_session=") and "Max-Age" not in cookie:
                session[name] = cookie.split(";")[0]
            answers[name].append((method, path, status, payload))
        for m, pattern, _, template in servers["port"].rest._routes:
            if m == method and pattern.match(path.rstrip("/") or "/"):
                reached.add((m, template))
                break
    norm = _ts_window(t0, time.time())
    statuses = set()
    for (method, path, s_want, p_want), (_, _, s_got, p_got) in zip(answers["ref"],
                                                                     answers["port"]):
        want = _comparable(servers["ref"].rest, s_want, p_want, norm)
        got = _comparable(servers["port"].rest, s_got, p_got, norm)
        assert got == want, (method, path)
        statuses.add(got[0])
    assert {200, 302, 400, 401, 404, 500} <= statuses
    assert reached == got_routes, sorted(got_routes - reached)


# -------------------------------------------------- both front ends


def _raw(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_front_ends_answer_alike():
    """The same requests to each package's event-loop and threaded servers
    (each over its own memory stores): the port's front end equal to the
    reference's in status, content type and body (time stamps normalised),
    and both front ends with the same statuses. (The reference's two front
    ends differ in one header of their own: the threaded server's OPTIONS
    answer carries no content type.)"""
    requests = [
        ("GET", "/api/health/live", None, {}),
        ("POST", "/api/items", json.dumps([{"ItemId": f"x{i}", "Timestamp": float(i)}
                                           for i in range(4)]), {"Content-Type": "application/json"}),
        ("PUT", "/api/feedback", json.dumps([{"FeedbackType": "like", "UserId": "a",
                                              "ItemId": "x1", "Timestamp": 2.0}]),
         {"Content-Type": "application/json"}),
        ("PATCH", "/api/item/x2", json.dumps({"Comment": "c"}),
         {"Content-Type": "application/json"}),
        ("GET", "/api/item/x2", None, {}),
        ("HEAD", "/api/item/x2", None, {}),
        ("GET", "/api/latest?n=2&user-id=a", None, {}),
        ("GET", "/api/user/a/feedback", None, {}),
        ("DELETE", "/api/item/x3", None, {}),
        ("GET", "/api/items?n=abc", None, {}),
        ("POST", "/api/users", b"{not json", {"Content-Type": "application/json"}),
        ("GET", "/api/nope", None, {}),
        ("OPTIONS", "/api/items", None, {"Origin": "https://evil.example.com"}),
        ("OPTIONS", "/api/items", None, {"Origin": "https://app.example.com"}),
        ("GET", "/metrics", None, {}),
    ]
    t0 = time.time()
    answers = {}
    servers = []
    try:
        for name in PACKAGES:
            p = _pkg(name)
            for backend in ("async", "threaded"):
                config = p.config.default_config()
                config.master.http_cors_domains = [r"https://app\.example\.com"]
                rest = p.rest.RestServer(config, p.data.MemoryDataStore(),
                                         p.cache.MemoryCacheStore())
                httpd = rest.serve("127.0.0.1", 0, backend=backend)
                servers.append(rest)
                port = httpd.server_address[1]
                answers[name, backend] = [_raw(port, m, path, body, h)
                                          for m, path, body, h in requests]
    finally:
        for rest in servers:
            rest.shutdown()
    norm = _ts_window(t0, time.time())

    def comparable(answer):
        status, ctype, body = answer
        if ctype == "application/json" and body:
            body = norm(json.loads(body))
        elif ctype and ctype.startswith("text/plain; version"):
            body = sorted({ln.rsplit(" ", 1)[0] for ln in body.decode().splitlines()
                           if ln and not ln.startswith("#")})
        return status, ctype, body

    statuses = [a[0] for a in answers["ref", "async"]]
    assert statuses == [200, 200, 200, 200, 200, 200, 200, 200, 200, 400, 400, 404, 405, 204,
                        200]
    for backend in ("async", "threaded"):
        want = [comparable(a) for a in answers["ref", backend]]
        assert [comparable(a) for a in answers["port", backend]] == want, backend
        assert [a[0] for a in want] == statuses, backend
