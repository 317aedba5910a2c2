"""The master's dashboard and admin routes (gorse_tpu_torch/serve/dashboard.py,
``MasterRestServer``) and the login sessions (serve/oidc.py), held on the
CPU: tests/test_dashboard.py's and tests/test_oidc.py's cases, each run
over both packages (the port's in-one node on ``device="cpu"``); every
route that the reference registers is routed in the port and answers alike
on an empty master; ``oidc.enable`` builds the OIDC client as the
reference's does (the sign-on itself: tests/test_torch_oidc.py).
Assertions are the reference tests' own: exact values, no tolerance."""

import importlib
import json
import socket
import urllib.error
import urllib.parse
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
        name=name, config=m("utils.config"), in_one=m("serve.in_one"), types=m("storage.types"),
        cache=m("storage.cache"), data=m("storage.data"), dashboard=m("serve.dashboard"),
        master=m("serve.master"), meta=m("storage.meta"), blob=m("storage.blob"),
        metrics=m("serve.metrics"), oidc=m("serve.oidc"),
        kw={"device": "cpu"} if name == "port" else {},
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metrics_registry(pkg):
    reg = _pkg(pkg).metrics.MetricsRegistry(namespace="gorse")
    reg.gauge_set("master_users_total", 5, help="number of users")
    reg.counter_inc("requests", labels={"path": "/api/recommend"})
    reg.counter_inc("requests", labels={"path": "/api/recommend"})
    reg.observe_seconds("master_load_dataset", 1.5)
    text = reg.render()
    assert "# TYPE gorse_master_users_total gauge" in text
    assert "gorse_master_users_total 5.0" in text
    assert 'gorse_requests{path="/api/recommend"} 2.0' in text
    assert "gorse_master_load_dataset_seconds 1.5" in text


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metrics_histogram(pkg):
    reg = _pkg(pkg).metrics.MetricsRegistry(namespace="gorse")
    for v in (0.003, 0.02, 0.02, 7.0, 99.0):
        reg.histogram_observe(
            "server_rest_api_request_seconds", v, labels={"api": "/api/recommend/{user-id}"}
        )
    text = reg.render()
    assert "# TYPE gorse_server_rest_api_request_seconds histogram" in text
    assert 'le="0.005"} 1' in text
    assert 'le="0.025"} 3' in text
    assert 'le="10.0"} 4' in text
    assert 'le="+Inf"} 5' in text
    assert ('gorse_server_rest_api_request_seconds_count{api="/api/recommend/{user-id}"} 5'
            in text)
    total = 0.003 + 0.02 + 0.02 + 7.0 + 99.0
    assert (f'gorse_server_rest_api_request_seconds_sum{{api="/api/recommend/{{user-id}}"}} '
            f'{total}' in text)


@pytest.fixture(scope="module", params=PACKAGES)
def node(request, tmp_path_factory):
    p = _pkg(request.param)
    config = p.config.Config()
    config.recommend.collaborative.type = "mf"
    config.recommend.ranker.type = "none"
    node = p.in_one.InOneNode(config, workdir=str(tmp_path_factory.mktemp(f"dash_{p.name}")),
                              **p.kw)
    rng = np.random.default_rng(0)
    t = p.types
    node.data.insert_items([t.Item(f"i{k}", timestamp=float(k), categories=["c"])
                            for k in range(15)])
    pairs = [(u, i) for u in range(8) for i in range(15)]
    rng.shuffle(pairs)
    node.data.insert_feedback([
        t.Feedback("like", f"u{u}", f"i{i}", timestamp=float(n))
        for n, (u, i) in enumerate(pairs[:60])
    ])
    node.run_once()
    port = _free_port()
    node.serve("127.0.0.1", port, background_loop=False)
    yield node, f"http://127.0.0.1:{port}"
    node.shutdown()


def _get_raw(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    with urllib.request.urlopen(req) as resp:
        return resp.status, resp.read(), resp.headers.get("Content-Type", "")


def _get(base, path):
    status, body, _ = _get_raw(base, path)
    return status, json.loads(body.decode())


def _post(base, path, data, content_type="application/json"):
    if isinstance(data, (dict, list)):
        data = json.dumps(data).encode()
    req = urllib.request.Request(
        base + path, data=data, method="POST", headers={"Content-Type": content_type}
    )
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_dashboard_endpoints(node):
    n, base = node
    status, stats = _get(base, "/api/dashboard/stats")
    assert stats["NumUsers"] == 8 and stats["NumItems"] == 15
    assert stats["CFModel"]
    _, tasks = _get(base, "/api/dashboard/tasks")
    assert any(t["Name"] == "fit_cf_model" for t in tasks)
    _, cats = _get(base, "/api/dashboard/categories")
    assert cats == ["c"]
    _, cfg = _get(base, "/api/dashboard/config")
    assert cfg["recommend"]["cache_size"] == 100
    _post(base, "/api/dashboard/config", {"recommend": {"cache_size": 55}})
    _, cfg2 = _get(base, "/api/dashboard/config")
    assert cfg2["recommend"]["cache_size"] == 55
    assert n.master.meta.get("RECOMMEND_CONFIG")
    _, schema = _get(base, "/api/dashboard/config/schema")
    assert "recommend" in schema["properties"]
    _, ts = _get(base, "/api/dashboard/timeseries/cf_ndcg")
    assert ts and "Value" in ts[0]
    _post(base, "/api/dashboard/schedule", {})
    assert n.master._trigger.is_set()


def test_stats_reference_fields(node):
    _, base = node
    _, stats = _get(base, "/api/dashboard/stats")
    assert stats["BinaryVersion"]
    assert stats["NumUsers"] == 8 and stats["NumItems"] == 15
    assert stats["NumValidPosFeedback"] > 0
    assert stats["NumTotalPosFeedback"] >= stats["NumValidPosFeedback"]
    assert stats["PopularItemsUpdateTime"] > 0
    assert stats["LatestItemsUpdateTime"] > 0
    assert stats["MatchingModelFitTime"] > 0
    assert "NDCG" in stats["MatchingModelScore"]
    assert stats["NumServers"] == 0 and stats["NumWorkers"] == 0


def test_metrics_endpoint(node):
    _, base = node
    status, body, ctype = _get_raw(base, "/metrics")
    text = body.decode()
    assert "gorse_master_users_total 8.0" in text
    _get_raw(base, "/api/users")
    _, body, _ = _get_raw(base, "/metrics")
    text = body.decode()
    assert "gorse_server_rest_api_request_seconds_bucket" in text
    assert 'api="/api/users"' in text
    assert ctype.startswith("text/plain")


def test_admin_meta_sync(node):
    n, base = node
    status, meta = _post(base, "/api/admin/meta", {
        "uuid": "w-remote", "hostname": "h1", "type": "worker", "version": "0.1",
    })
    assert "w-remote" in meta["workers"]
    assert json.loads(meta["config"])["recommend"]
    _, cluster = _get(base, "/api/dashboard/cluster")
    assert any(c["UUID"] == "w-remote" for c in cluster)
    _post(base, "/api/admin/progress", {"uuid": "w-remote", "spans": [
        {"Name": "recommend", "Status": "running", "Count": 5, "Total": 10}
    ]})
    _, tasks = _get(base, "/api/dashboard/tasks")
    assert any(t.get("Node") == "w-remote" for t in tasks)


def test_dashboard_previews(node):
    """tests/test_dashboard.py's previews (the external preview is held in
    tests/test_torch_external.py)."""
    n, base = node
    status, users = _get(base, "/api/dashboard/users?n=3")
    assert status == 200 and len(users["Users"]) == 3 and users["Cursor"]
    status, user = _get(base, "/api/dashboard/user/u1")
    assert status == 200 and user["UserId"] == "u1"
    assert "LastActiveTime" in user and "LastUpdateTime" in user
    status, fb = _get(base, "/api/dashboard/user/u1/feedback/like")
    assert status == 200 and fb and fb[0]["Item"]["ItemId"].startswith("i")
    status, page1 = _get(base, "/api/dashboard/feedback?n=10")
    assert status == 200 and len(page1["Feedback"]) == 10 and page1["Cursor"] == "10"
    assert page1["Feedback"][0]["Item"]["ItemId"].startswith("i")
    status, page2 = _get(base, f"/api/dashboard/feedback?n=10&cursor={page1['Cursor']}")
    assert status == 200 and page2["Feedback"]
    k1 = {(f["UserId"], f["Item"]["ItemId"]) for f in page1["Feedback"]}
    k2 = {(f["UserId"], f["Item"]["ItemId"]) for f in page2["Feedback"]}
    assert not (k1 & k2), "pages overlap"
    status, typed = _get(base, "/api/dashboard/feedback/like?n=5")
    assert status == 200 and all(f["FeedbackType"] == "like" for f in typed["Feedback"])
    status, recs = _get(base, "/api/dashboard/recommend/u1?n=5")
    assert status == 200 and len(recs) == 5
    assert all("ItemId" in r and "Score" in r for r in recs)
    status, recs = _get(base, "/api/dashboard/recommend/u1/collaborative?n=5")
    assert status == 200 and len(recs) == 5
    status, latest = _get(base, "/api/dashboard/latest?n=4")
    assert status == 200 and len(latest) == 4
    assert latest[0]["Score"] >= latest[-1]["Score"]
    import base64

    q = base64.b64encode(b"history: {% for t, item in feedback %}{{ item.item_id }} {% endfor %}").decode()
    d = base64.b64encode(b"doc {{ item.item_id }}").decode()
    status, prompt = _get(
        base, f"/api/dashboard/ranker/prompt?query-template={q}&document-template={d}&user-id=u1"
    )
    assert status == 200 and prompt["query"].startswith("history: i")
    assert prompt["documents"] and prompt["documents"][0].startswith("doc i")


def test_typed_feedback_route(node):
    n, base = node
    status, out = _get(base, "/api/feedback/like?n=5")
    assert status == 200 and len(out["Feedback"]) == 5
    assert all(f["FeedbackType"] == "like" for f in out["Feedback"])
    status, out = _get(base, "/api/feedback/nosuch?n=5")
    assert status == 200 and out["Feedback"] == []


def test_dashboard_redacted_config(node):
    n, base = node
    status, cfg = _get(base, "/api/dashboard/config")
    assert status == 200 and "database" in cfg
    n.config.master.dashboard_redacted = True
    status, cfg = _get(base, "/api/dashboard/config")
    assert status == 200 and "database" not in cfg
    n.config.master.dashboard_redacted = False


def test_login_msg_escaped(node):
    n, base = node
    n.config.master.dashboard_user_name = "admin"
    n.config.master.dashboard_password = "pw"
    try:
        status, body, _ = _get_raw(base, "/login?msg=%3Cscript%3Ealert(1)%3C/script%3E")
        assert status == 200
        assert b"<script>" not in body
        assert b"&lt;script&gt;" in body
    finally:
        n.config.master.dashboard_user_name = ""
        n.config.master.dashboard_password = ""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_admin_meta_requires_auth_when_login_configured(pkg, tmp_path):
    p = _pkg(pkg)
    config = p.config.Config()
    config.recommend.collaborative.type = "mf"
    config.master.dashboard_user_name = "admin"
    config.master.dashboard_password = "hunter2"
    config.master.admin_api_key = "adminkey"
    node = p.in_one.InOneNode(config, workdir=str(tmp_path), **p.kw)
    port = _free_port()
    node.serve("127.0.0.1", port, background_loop=False)
    base = f"http://127.0.0.1:{port}"
    try:
        req = urllib.request.Request(base + "/api/admin/meta", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 401
        req = urllib.request.Request(
            base + "/api/admin/meta", data=b"{}", headers={"X-API-Key": "adminkey"}
        )
        with urllib.request.urlopen(req) as resp:
            meta = json.loads(resp.read().decode())
        assert "config" in meta
    finally:
        node.shutdown()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_recommend_config_override_survives_restart(pkg, tmp_path):
    p = _pkg(pkg)
    config = p.config.Config()
    config.recommend.collaborative.type = "mf"
    meta = p.meta.MetaStore()
    meta.put(p.meta.RECOMMEND_CONFIG, json.dumps({"recommend": {"cache_size": 42}}))
    master = p.master.Master(config, p.data.MemoryDataStore(), p.cache.MemoryCacheStore(),
                             p.blob.BlobStore(tmp_path / "b"), meta, **p.kw)
    assert master.config.recommend.cache_size == 42


# ----------------------------------------------- tests/test_oidc.py's cases


@pytest.mark.parametrize("pkg", PACKAGES)
def test_session_manager_round_trip(pkg):
    SessionManager = _pkg(pkg).oidc.SessionManager
    sm = SessionManager(ttl=60)
    token = sm.issue({"Name": "alice"})
    assert sm.verify(token) == {"Name": "alice"}
    assert sm.verify(token[:-4] + "AAAA") is None
    assert sm.verify("garbage") is None
    sm2 = SessionManager(ttl=-1)
    assert sm2.verify(sm2.issue({"Name": "x"})) is None
    assert sm.from_cookie_header(f"a=b; {SessionManager.COOKIE}={token}") == {"Name": "alice"}
    assert sm.from_cookie_header(None) is None


class NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def _open(req):
    try:
        resp = urllib.request.build_opener(NoRedirect()).open(req, timeout=10)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _master_server(p, config, tmp_path):
    master = p.master.Master(config, p.data.MemoryDataStore(), p.cache.MemoryCacheStore(),
                             p.blob.BlobStore(tmp_path / "blobs"), p.meta.MetaStore(), **p.kw)
    rest = p.dashboard.MasterRestServer(master)
    httpd = rest.serve("127.0.0.1", 0)
    return rest, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_password_login_flow(pkg, tmp_path):
    p = _pkg(pkg)
    config = p.config.Config()
    config.master.dashboard_user_name = "admin"
    config.master.dashboard_password = "hunter2"
    rest, base = _master_server(p, config, tmp_path)

    def get(path, cookie=None):
        req = urllib.request.Request(base + path)
        if cookie:
            req.add_header("Cookie", cookie)
        return _open(req)

    def post_form(path, form):
        return _open(urllib.request.Request(
            base + path, data=urllib.parse.urlencode(form).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"}))

    try:
        assert get("/api/dashboard/stats")[0] == 401
        status, _, body = get("/login")
        assert status == 200 and b"<form" in body
        status, headers, _ = post_form("/login", {"user_name": "admin", "password": "nope"})
        assert status == 302 and "msg=incorrect" in headers["Location"]
        status, headers, _ = post_form("/login", {"user_name": "admin", "password": "hunter2"})
        assert status == 302
        cookie = headers["Set-Cookie"].split(";")[0]
        assert get("/api/dashboard/stats", cookie=cookie)[0] == 200
        status, _, body = get("/api/dashboard/userinfo", cookie=cookie)
        assert status == 200 and b"admin" in body
        status, headers, _ = get("/logout")
        assert status == 302 and "Max-Age=0" in headers["Set-Cookie"]
    finally:
        rest.shutdown()


# ---------------------------------------------------- what the port leaves out

M21_PATHS = (
    ("GET", "/"), ("GET", "/api/dump"), ("POST", "/api/restore"),
    ("GET", "/api/export/users"), ("GET", "/api/export/items"), ("GET", "/api/export/feedback"),
    ("POST", "/api/import/users"), ("POST", "/api/import/items"),
    ("POST", "/api/import/feedback"), ("GET", "/api/bulk/users"), ("POST", "/api/bulk/items"),
    ("GET", "/api/bulk/feedback"), ("POST", "/api/purge"), ("POST", "/api/chat/completions"),
    ("GET", "/api/dashboard/external"), ("GET", "/api/dashboard/ranker/prompt"),
)


# listed above before their port; now routed in both packages alike
PORTED_SINCE = set(M21_PATHS)


@pytest.mark.parametrize("method,path", M21_PATHS)
def test_m21_routes_are_not_found(method, path, tmp_path):
    """Routes once left to ROADMAP.md M21 (404 in the port): those of
    ``PORTED_SINCE``, now all of them, are routed in both packages and
    answer alike."""
    answers = {}
    for name in PACKAGES:
        p = _pkg(name)
        master = p.master.Master(p.config.Config(), p.data.MemoryDataStore(),
                                 p.cache.MemoryCacheStore(), p.blob.BlobStore(tmp_path / name),
                                 p.meta.MetaStore(), **p.kw)
        rest = p.dashboard.MasterRestServer(master)
        routed = any(m == method and pattern.match(path) for m, pattern, _, _ in rest._routes)
        # rendered (status, body bytes, content type, headers): a raw
        # response compares by what goes on the wire
        data, ctype, extra, status = rest.render_payload(*rest.dispatch(method, path, {},
                                                                        None, {}))
        answers[name] = routed, (status, data, ctype, extra)
    if (method, path) in PORTED_SINCE:
        assert answers["ref"][0] and answers["port"][0]
        assert answers["port"][1] == answers["ref"][1]
        return
    assert answers["ref"][0] and (answers["port"][0], answers["port"][1][0]) == (False, 404)


def test_oidc_enable_raises(tmp_path):
    """``oidc.enable`` no longer raises: both packages build the same OIDC
    client from the config, and only a login session passes the protected
    prefixes."""
    clients = {}
    for name in PACKAGES:
        p = _pkg(name)
        config = p.config.Config()
        config.oidc.enable = True
        config.oidc.issuer = "http://127.0.0.1:1/"
        config.oidc.client_id, config.oidc.client_secret = "gorse", "s3cret"
        config.oidc.redirect_url = "http://127.0.0.1:2/callback/oauth2"
        master = p.master.Master(config, p.data.MemoryDataStore(), p.cache.MemoryCacheStore(),
                                 p.blob.BlobStore(tmp_path / name), p.meta.MetaStore(), **p.kw)
        rest = p.dashboard.MasterRestServer(master)
        o = rest.oidc
        clients[name] = (o.issuer, o.client_id, o.client_secret, o.redirect_url,
                         rest.dispatch("GET", "/api/dashboard/stats", {}, None, {}),
                         rest.dispatch("GET", "/callback/oauth2", {"state": "forged"}, None, {}))
    assert clients["port"] == clients["ref"]
    assert clients["port"][4][0] == 401 and clients["port"][5][0] == 401
