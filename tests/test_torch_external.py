"""The port's external recommender sources (gorse_tpu_torch/logics/
external.py, ``Recommender._recommend_external``, the worker's chain and
``GET /api/dashboard/external``) held against gorse_tpu's: the cases of
tests/test_external.py run over both packages against one in-process HTTP
server, and each package must give the same answer (equal values, or the
same exception type) as well as the reference test's expected one.
"""

import base64
import importlib
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("ref", "port")


def _pkg(name: str) -> SimpleNamespace:
    root = {"ref": "gorse_tpu", "port": "gorse_tpu_torch"}[name]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    return SimpleNamespace(
        name=name, external=m("logics.external"), minijs=m("utils.minijs"),
        recommend=m("logics.recommend"), config=m("utils.config"), types=m("storage.types"),
        data=m("storage.data"), cache=m("storage.cache"), worker=m("serve.worker"),
        blob=m("storage.blob"), master=m("serve.master"), meta=m("storage.meta"),
        dashboard=m("serve.dashboard"), kw={"device": "cpu"} if name == "port" else {},
    )


@pytest.fixture(scope="module")
def http_server():
    """tests/test_external.py's server: records requests, answers /recs with
    an object of scored items, /ids with a bare array of ids, anything else
    with a greeting."""
    state = {"requests": []}

    class Handler(BaseHTTPRequestHandler):
        def _handle(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length).decode() if length else ""
            state["requests"].append({"method": self.command, "path": self.path,
                                      "headers": dict(self.headers), "body": body})
            if self.path.startswith("/recs"):
                payload = json.dumps({"items": [
                    {"id": "i2", "score": 1.0}, {"id": "i7", "score": 9.0},
                    {"id": "i5", "score": 4.0},
                ]}).encode()
            elif self.path.startswith("/ids"):
                payload = json.dumps(["i3", "i1", "i4", "i0"]).encode()
            else:
                payload = b"Hello, client\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_PUT = _handle

        def log_message(self, *args):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    thread.join(timeout=5)


def _both(fn):
    """``fn(pkg)`` over both packages: (value or None, exception type name or
    None) each, which must agree; the port's value is returned."""
    out = {}
    for name in PACKAGES:
        try:
            out[name] = (fn(_pkg(name)), None)
        except Exception as e:  # compared across packages
            out[name] = (None, type(e).__name__)
    assert out["port"] == out["ref"]
    return out["port"]


def _interp(p, timeout=5.0):
    i = p.minijs.Interpreter()
    i.register("fetch", p.external._js_fetch(timeout))
    return i


def test_fetch_url(http_server):
    url, state = http_server

    def fetch(p):
        resp = _interp(p).eval(f'fetch("{url}")')
        resp["headers"].pop("Date")  # the clock, not the package
        return resp

    resp, _ = _both(fetch)
    assert state["requests"][-1]["method"] == "GET"
    assert resp["ok"] is True and resp["status"] == 200.0
    assert resp["statusText"] == "200 OK" and resp["body"] == "Hello, client\n"
    assert "Content-Type" in resp["headers"]


def _last(state):
    req = dict(state["requests"][-1])
    req["headers"] = {k: v for k, v in req["headers"].items() if k != "User-Agent"}
    return req


@pytest.mark.parametrize("src,method", [
    ('fetch({{method: "POST", url: "{url}"}})', "POST"),
    ('''fetch("{url}", {{method: "PUT", headers: {{"Content-Type": "application/json"}},
        body: JSON.stringify({{message: "Hello, server"}})}})''', "PUT"),
])
def test_fetch_request_forms(http_server, src, method):
    url, state = http_server
    seen = {}
    for name in PACKAGES:
        _interp(_pkg(name)).eval(src.format(url=url))
        seen[name] = _last(state)
    assert seen["port"] == seen["ref"] and seen["port"]["method"] == method
    if method == "PUT":
        assert json.loads(seen["port"]["body"]) == {"message": "Hello, server"}


@pytest.mark.parametrize("src", ["fetch(42)", 'fetch("ftp://nope")', "fetch()",
                                 'fetch("http://x", 1)',
                                 'try { fetch("http://127.0.0.1:1/unreachable") } '
                                 'catch (e) { "caught" }'])
def test_fetch_bad_args(src):
    value, err = _both(lambda p: _interp(p).eval(src))
    assert (value, err) in (("caught", None), (None, "JSThrow"))


PULL_CASES = {
    "js": lambda url: dict(type="js", script="""
        var resp = fetch('%s/recs?user_id=' + encodeURIComponent(user_id));
        var items = JSON.parse(resp.body).items;
        items.sort((a, b) => b.score - a.score);
        JSON.stringify(items.map(it => it.id))""" % url),
    "array": lambda url: dict(type="js", script="['a', 'b'].map(x => x + user_id)"),
    "non_array": lambda url: dict(type="js", script="42"),
    "object": lambda url: dict(type="js", script="JSON.stringify({a: 1})"),
    "default_js": lambda url: dict(type="", script="JSON.stringify(['only'])"),
    "numbers": lambda url: dict(type="js", script="[1, 2.5, 'x']"),
    "http_object": lambda url: dict(type="http", url=f"{url}/recs"),
    "http_ids": lambda url: dict(type="http", url=f"{url}/ids?src=1"),
    "http_down": lambda url: dict(type="http", url="http://127.0.0.1:1/ids", timeout=1.0),
    "spin": lambda url: dict(type="js", script="while (true) {}"),
    "python": lambda url: dict(type="python"),
    "python_missing": lambda url: dict(type="python"),
    "unknown": lambda url: dict(type="grpc"),
}
PULL_WANT = {
    "js": (["i7", "i5", "i2"], None), "array": (["au 1", "bu 1"], None),
    "non_array": (None, "TypeError"), "object": (None, "TypeError"),
    "default_js": (["only"], None), "numbers": (["1", "2.5", "x"], None),
    "http_object": ([], None), "http_ids": (["i3", "i1", "i4", "i0"], None),
    "http_down": ([], None), "spin": (None, "JSError"), "python": (["u 1-x"], None),
    "python_missing": ([], None), "unknown": (None, "ValueError"),
}


@pytest.mark.parametrize("case", sorted(PULL_CASES))
def test_pull(http_server, case):
    """TestPull (tests/test_external.py:99) over both packages: js scripts,
    http endpoints, registered callables and their errors."""
    url, state = http_server
    spec = PULL_CASES[case](url)
    name = "py-ext" if case == "python" else f"ext-{case}"

    def pull(p):
        p.external.register_external("py-ext", lambda uid: [f"{uid}-x"])
        cfg = p.external.ExternalConfig(name=name, **spec)
        return p.external.External(cfg).pull("u 1")

    assert _both(pull) == PULL_WANT[case]
    if case == "js":
        assert "user_id=u%201" in state["requests"][-1]["path"]


def test_config_entry_and_digest():
    def entries(p):
        e = p.config.ExternalConfigEntry
        return (e(name="n", script="1").type, e(name="n").type,
                e(name="n", script="1").digest(), e(name="n", script="2").digest(),
                p.external.ExternalConfig(name="n", type="js", script="1").digest())

    js_type, py_type, d1, d2, d3 = _both(entries)[0]
    assert (js_type, py_type) == ("js", "python") and d1 != d2 and d1 == d3


def _chain(p, url, categories=None, user_id="u1", exclude=("i5",)):
    data, cache = p.data.MemoryDataStore(), p.cache.MemoryCacheStore()
    data.insert_items([p.types.Item(i) for i in ("i2", "i5", "i7")])
    data.insert_feedback([p.types.Feedback("read", user_id, i, timestamp=1.0) for i in exclude])
    cfg = p.config.Config()
    cfg.recommend.external = [p.config.ExternalConfigEntry(name="up", script=f"""
        var resp = fetch('{url}/recs?user_id=' + user_id);
        JSON.stringify(JSON.parse(resp.body).items
            .sort((a, b) => b.score - a.score)
            .map(it => it.id))
        """)]
    rec = p.recommend.Recommender(cfg.recommend, cache, data, online=True, user_id=user_id,
                                  categories=categories)
    return rec


@pytest.mark.parametrize("variant", ["plain", "category", "unknown"])
def test_recommender_chain_external_js(http_server, variant):
    """external/<name> in the chain (tests/test_external.py:167): the
    source's ids less the user's read items, score 0; nothing under a
    category filter or for a name not configured."""
    url, _ = http_server

    def run(p):
        rec = _chain(p, url, categories=["c"] if variant == "category" else None)
        name = "up" if variant != "unknown" else "nope"
        scores, digest = rec.parse(f"external/{name}")()
        return [(s.id, s.score) for s in scores], digest

    (scores, digest), _ = _both(run)
    if variant == "plain":
        assert scores == [("i7", 0.0), ("i2", 0.0)] and digest
    else:
        assert scores == [] and (digest == "") == (variant == "unknown")


def test_worker_chain_with_external_sources(http_server, tmp_path):
    """A worker whose chain holds a js source (with fetch) and an http
    source: its recommend lists equal the reference worker's, the source's
    ids less each user's items."""
    url, _ = http_server
    lists = {}
    for name in PACKAGES:
        p = _pkg(name)
        data, cache = p.data.MemoryDataStore(), p.cache.MemoryCacheStore()
        data.insert_items([p.types.Item(f"i{k}", timestamp=float(k)) for k in range(8)])
        data.insert_users([p.types.User(f"u{u}") for u in range(3)])
        data.insert_feedback([p.types.Feedback("like", f"u{u}", f"i{u + 1}", timestamp=1.0)
                              for u in range(3)])
        cfg = p.config.Config()
        cfg.recommend.cache_size = 10
        cfg.recommend.collaborative.type = "none"
        cfg.recommend.ranker.type = "none"
        cfg.recommend.external = [
            p.config.ExternalConfigEntry(name="js", script=(
                f"var r = fetch('{url}/recs?user_id=' + user_id);"
                "JSON.stringify(JSON.parse(r.body).items.map(it => it.id))")),
            p.config.ExternalConfigEntry(name="ids", type="http", url=f"{url}/ids"),
        ]
        cfg.recommend.ranker.recommenders = ["external/js", "external/ids"]
        worker = p.worker.Worker(cfg, data, cache, p.blob.BlobStore(tmp_path / name), **p.kw)
        users = [f"u{u}" for u in range(3)]
        assert worker.recommend(users, force=True) == 3
        lists[name] = {u: [s.id for s in cache.search_scores("recommend", u)] for u in users}
    assert lists["port"] == lists["ref"]
    for u in range(3):
        got = lists["port"][f"u{u}"]
        assert f"i{u + 1}" not in got
        assert set(got) <= {"i2", "i7", "i5", "i3", "i1", "i4", "i0"} and got


def _b64(text: str) -> str:
    return base64.b64encode(text.encode()).decode()


@pytest.mark.parametrize("query", [
    {}, {"script": "a"}, {"script": _b64("[user_id, 'x']"), "user-id": "u1"},
    {"script": _b64("JSON.stringify(['a'])")}, {"script": _b64("throw new Error('boom')")},
    {"script": _b64("42")}, {"script": _b64("py-ext")}, {"script": "<url>"},
])
def test_dashboard_external_preview(http_server, query, tmp_path):
    """GET /api/dashboard/external answers as the reference's: its status
    codes and error texts, a bare URL as an http source, a registered name
    as a Python source."""
    url, _ = http_server
    if query.get("script") == "<url>":
        query = {"script": _b64(f"{url}/ids"), "user-id": "u2"}
    answers = {}
    for name in PACKAGES:
        p = _pkg(name)
        p.external.register_external("py-ext", lambda uid: [f"{uid}-x"])
        master = p.master.Master(p.config.Config(), p.data.MemoryDataStore(),
                                 p.cache.MemoryCacheStore(), p.blob.BlobStore(tmp_path / name),
                                 p.meta.MetaStore(), **p.kw)
        rest = p.dashboard.MasterRestServer(master)
        answers[name] = rest.dispatch("GET", "/api/dashboard/external", dict(query), None, {})
    assert answers["port"] == answers["ref"]
    assert answers["port"][0] in (200, 400)


def test_minijs_is_the_ports_own():
    from gorse_tpu_torch.logics import external
    from gorse_tpu_torch.utils import minijs

    assert external.minijs is minijs
    assert np.isclose(minijs.Interpreter().eval("Math.sqrt(2)"), 2 ** 0.5)
