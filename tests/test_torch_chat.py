"""The port's LLM features (gorse_tpu_torch/logics/chat.py, the worker's
``ranker.type = "llm"``, the chat proxy and the ranker-prompt preview of
serve/dashboard.py, ``bench reranker``) against gorse_tpu's, on the CPU,
on the same mock servers: the port's MockOpenAIServer (echoing the prompt,
hash embeddings; held equal to the reference's mock in
tests/test_torch_llm.py) and a reranker API of a few lines here.

- ``ChatItemToItem`` with a client, over items whose embeddings are drawn
  from a seed with numpy: each item's neighbour ids equal the reference's
  except where two distances lie within ``D_TIE`` of each other (f32
  products summed in another order), scores within ``SCORE_RTOL``
  (relative); without a client it equals the embedding type.
- ``ChatReranker`` and ``LLMReranker``: the same scores, exactly.
- The worker with ``ranker.type = "llm"``, on the chat-completion route
  and on the reranker-API route: every user's recommend list equal to the
  reference worker's, exactly, both serving the reference master's CF
  model (the reference's recall on the CPU; the port loads its blob).
- The master's ``chat`` item-to-item cache equals its ``embedding`` cache,
  in both packages (the master passes no client, gorse_tpu/serve/
  master.py:443-447).
- The chat proxy, streaming and not, and the ranker-prompt preview's bad
  template: the reference's status and body.
- ``bench reranker`` with a reversing prompt: the reference's result.
"""

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import gorse_tpu.logics.chat as RCHAT
import gorse_tpu.llm.client as RLLM
import gorse_tpu.storage.types as RT
import gorse_tpu_torch.logics.chat as PCHAT
import gorse_tpu_torch.llm.client as PLLM
import gorse_tpu_torch.storage.types as PT
from gorse_tpu.logics.item_to_item import ItemToItemConfig as RefI2IConfig
from gorse_tpu_torch.llm.mock import MockOpenAIServer
from gorse_tpu_torch.logics.item_to_item import ItemToItemConfig

D_TIE = 1e-5  # distances closer than this may swap between the packages
SCORE_RTOL = 1e-5
DIM = 16
REVERSED = ('[{% for item in items|reverse %}"{{ item.item_id }}"{% if not loop.last %},'
            '{% endif %}{% endfor %}]')


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mock():
    server = MockOpenAIServer(dimensions=DIM).start()
    yield server
    server.close()


def _clients(mock, **kw):
    return {name: mod.OpenAIClient(mock.base_url, mock.auth_token, chat_model="m",
                                   embedding_dimensions=DIM, **kw)
            for name, mod in (("ref", RLLM), ("port", PLLM))}


class _Reranker:
    """A reranker API: the documents' indices in reverse order, scores
    descending; it records the queries it was sent."""

    def __init__(self) -> None:
        owner = self
        self.queries: list[str] = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                owner.queries.append(body["query"])
                n = len(body["documents"])
                out = json.dumps({"results": [{"index": i, "relevance_score": float(i) + 0.5}
                                              for i in range(n - 1, -1, -1)]}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/rerank"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def reranker():
    server = _Reranker()
    yield server
    server.close()


# ---------------------------------------------------------------- engines


def _chat_items(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(f"i{k}", rng.normal(size=DIM).astype(np.float32).tolist(),
             ["a", "b", "c"][k % 3]) for k in range(n)]


def _hold_neighbors(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (item, g), (_, w) in zip(got, want):
        assert len(g) == len(w), item
        d_want = [1.0 / s.score - 1.0 for s in w]
        for r, (a, b) in enumerate(zip(g, w)):
            assert abs(a.score - b.score) <= SCORE_RTOL * abs(b.score), (item, r)
            near = [abs(d_want[r] - d_want[j]) <= D_TIE for j in (r - 1, r + 1)
                    if 0 <= j < len(w)]
            if a.id != b.id:
                assert any(near), (item, r, a.id, b.id)
            assert a.categories == b.categories or a.id != b.id


@pytest.mark.parametrize("prompt", ["queries for {{ item.item_id }}",
                                    '["{{ item.item_id }}", "{{ item.comment|upper }}"]'])
def test_chat_item_to_item_matches(mock, prompt):
    clients = _clients(mock)
    rows = _chat_items(0, 40)
    engines = {
        "ref": RCHAT.ChatItemToItem(RefI2IConfig(name="c", type="chat", column="e",
                                                 prompt=prompt), 6, timestamp=1.0,
                                    openai_client=clients["ref"]),
        "port": PCHAT.ChatItemToItem(ItemToItemConfig(name="c", type="chat", column="e",
                                                      prompt=prompt), 6, timestamp=1.0,
                                     openai_client=clients["port"], device="cpu"),
    }
    for name, T in (("ref", RT), ("port", PT)):
        for item_id, vec, comment in rows:
            engines[name].push(T.Item(item_id, labels={"e": vec}, comment=comment,
                                      categories=[comment]), [])
    got, want = engines["port"].pop_all(), engines["ref"].pop_all()
    assert all(len(n) >= 5 for _, n in want)  # k = 6 fetched, self dropped
    _hold_neighbors(got, want)


def test_chat_item_to_item_degrades_per_item():
    """A dead endpoint: every item gets no neighbours, in both."""
    outs = []
    for name, mod, T, cfg_cls in (("ref", RCHAT, RT, RefI2IConfig),
                                  ("port", PCHAT, PT, ItemToItemConfig)):
        client = (RLLM if name == "ref" else PLLM).OpenAIClient(
            "http://127.0.0.1:1/v1", max_retries=1, timeout=0.2)
        kw = {"device": "cpu"} if name == "port" else {}
        eng = mod.ChatItemToItem(cfg_cls(name="c", type="chat", column="e"), 3, timestamp=1.0,
                                 openai_client=client, **kw)
        for item_id, vec, _ in _chat_items(1, 4):
            eng.push(T.Item(item_id, labels={"e": vec}), [])
        outs.append([(i, [s.id for s in n]) for i, n in eng.pop_all()])
    assert outs[0] == outs[1] == [(f"i{k}", []) for k in range(4)]


def _scores(scores):
    return [(s.id, s.score, s.categories, s.timestamp) for s in scores]


def test_rerankers_match(mock, reranker):
    clients = _clients(mock)
    rng = np.random.default_rng(2)
    for case in range(5):
        n = int(rng.integers(1, 12))
        ids = [f"i{int(k)}" for k in rng.choice(50, n, replace=False)]
        outs = {}
        for name, mod, T in (("ref", RCHAT, RT), ("port", PCHAT, PT)):
            items = {i: T.Item(i, comment=f"c{i}", categories=["x"]) for i in ids}
            cands = [T.Score(i, float(rng.normal()) if name == "ref" else 0.0, ["x"], 5.0)
                     for i in ids]
            user = T.User("u1", labels={"age": 3})
            fb = [("like", items[ids[0]])]
            llm = mod.LLMReranker(clients[name], prompt=REVERSED if case % 2 else "")
            api = mod.ChatReranker(mod.RerankerClient(reranker.url, "tok"),
                                   "{{ user.user_id }}|{% for t, it in feedback %}{{ it.item_id }}"
                                   "{% endfor %}", "{{ item.item_id }} {{ item.comment }}")
            outs[name] = (_scores(llm.rank(user, fb, [T.Score(c.id, 0.0, c.categories,
                                                              c.timestamp) for c in cands],
                                           items)),
                          _scores(api.rank(user, fb, list(items.values()))))
        assert outs["port"] == outs["ref"], case
        if case % 2:
            assert [s[0] for s in outs["port"][0]] == ids[::-1]
    assert reranker.queries[-1].startswith("u1|")


# ---------------------------------------------------------------- workers


def _rows(T, seed: int = 1):
    rng = np.random.default_rng(seed)
    items = [T.Item(f"i{k}", timestamp=float(k), comment=f"item {k}") for k in range(24)]
    feedback = [T.Feedback("like", f"u{u}", f"i{int(i)}", timestamp=float(rng.integers(1, 100)))
                for u in range(12) for i in rng.choice(24, size=6, replace=False)]
    return items, feedback


def _llm_config(Config, route: str, reranker_url: str, base_url: str):
    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.ranker.type = "llm"
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.ranker.prompt = REVERSED
    cfg.openai.base_url, cfg.openai.auth_token = base_url, "ollama"
    cfg.openai.chat_completion_model = "m"
    if route == "api":
        cfg.recommend.ranker.reranker_api.url = reranker_url
        cfg.recommend.ranker.query_template = "user={{ user.user_id }}"
        cfg.recommend.ranker.document_template = "doc={{ item.item_id }}"
    return cfg


@pytest.mark.parametrize("route", ["chat", "api"])
def test_worker_llm_lists_equal_the_reference(route, mock, reranker, tmp_path):
    from gorse_tpu.serve import Master as RefMaster
    from gorse_tpu.serve import Worker as RefWorker
    from gorse_tpu.storage import BlobStore as RefBlob
    from gorse_tpu.storage import MemoryCacheStore as RefCache
    from gorse_tpu.storage import MemoryDataStore as RefData
    from gorse_tpu.storage import MetaStore as RefMeta
    from gorse_tpu.storage import cache as rck
    from gorse_tpu.utils.config import Config as RefConfig
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as pck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.utils.config import Config

    ref_data, ref_cache = RefData(), RefCache()
    items, feedback = _rows(RT)
    ref_data.insert_items(items)
    ref_data.insert_feedback(feedback)
    ref_cfg = _llm_config(RefConfig, route, reranker.url, mock.base_url)
    master = RefMaster(ref_cfg, ref_data, ref_cache, RefBlob(tmp_path / "blobs"), RefMeta())
    master.run_tasks_once()
    ref_worker = RefWorker(ref_cfg, ref_data, ref_cache, RefBlob(tmp_path / "blobs"))
    assert (ref_worker.openai_client is not None) and ref_worker.sync_and_recommend(master) == 12

    data, cache = MemoryDataStore(), MemoryCacheStore()
    items, feedback = _rows(PT)
    data.insert_items(items)
    data.insert_feedback(feedback)
    cfg = _llm_config(Config, route, reranker.url, mock.base_url)
    worker = Worker(cfg, data, cache, BlobStore(tmp_path / "blobs"), device="cpu")
    assert worker.openai_client is not None
    worker.pull_models(master.get_meta()["cf_model_id"])
    users = [f"u{u}" for u in range(12)]
    mock.requests.clear()
    assert worker.recommend(users) == 12
    if route == "chat":
        assert len([r for r in mock.requests if r["path"].endswith("/chat/completions")]) == 12
    for user in users:
        got = _scores(cache.search_scores(pck.RECOMMEND, user))
        want = _scores(ref_cache.search_scores(rck.RECOMMEND, user))
        assert [s[:2] for s in got] == [s[:2] for s in want] and got, user
        recall = [s.id for s in ref_cache.search_scores(rck.COLLABORATIVE, user)]
        assert [s[0] for s in got] == recall[::-1], user


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_master_chat_cache_equals_embedding_cache(pkg, mock, tmp_path):
    import importlib

    root = {"ref": "gorse_tpu", "port": "gorse_tpu_torch"}[pkg]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    c, T = m("utils.config"), m("storage.types")
    cfg = c.Config()
    cfg.openai.base_url, cfg.openai.auth_token = mock.base_url, "ollama"
    cfg.recommend.item_to_item = [
        c.ItemToItemConfigEntry(name="emb", type="embedding", column="e"),
        c.ItemToItemConfigEntry(name="chat", type="chat", column="e",
                                prompt="queries for {{ item.item_id }}"),
    ]
    data = m("storage.data").MemoryDataStore()
    data.insert_items([T.Item(i, labels={"e": v}) for i, v, _ in _chat_items(3, 30)])
    rng = np.random.default_rng(4)
    data.insert_feedback([T.Feedback("like", f"u{int(u)}", f"i{int(i)}")
                          for u, i in zip(rng.integers(10, size=60), rng.integers(30, size=60))])
    ck = m("storage.cache")
    master = m("serve.master").Master(cfg, data, ck.MemoryCacheStore(),
                                      m("storage.blob").BlobStore(tmp_path / pkg),
                                      m("storage.meta").MetaStore(),
                                      **({"device": "cpu"} if pkg == "port" else {}))
    mock.requests.clear()
    master.update_item_to_item(master.load_dataset())
    assert mock.requests == []  # the master asks no LLM
    for k in range(30):
        emb = master.cache.search_scores(ck.ITEM_TO_ITEM, ck.key("emb", f"i{k}"))
        chat = master.cache.search_scores(ck.ITEM_TO_ITEM, ck.key("chat", f"i{k}"))
        # each engine stamps its own build time: all else equal
        assert [x[:3] for x in _scores(chat)] == [x[:3] for x in _scores(emb)] and emb


# ---------------------------------------------------------------- routes


def _rest(pkg: str, tmp_path, base_url: str):
    import importlib

    root = {"ref": "gorse_tpu", "port": "gorse_tpu_torch"}[pkg]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    cfg = m("utils.config").Config()
    cfg.openai.base_url, cfg.openai.auth_token = base_url, "ollama"
    cfg.openai.chat_completion_model = "deepseek-r1"
    data = m("storage.data").MemoryDataStore()
    T = m("storage.types")
    data.insert_users([T.User("u1")])
    master = m("serve.master").Master(cfg, data, m("storage.cache").MemoryCacheStore(),
                                      m("storage.blob").BlobStore(tmp_path / pkg),
                                      m("storage.meta").MetaStore(),
                                      **({"device": "cpu"} if pkg == "port" else {}))
    return m("serve.dashboard").MasterRestServer(master)


CHAT_CALLS = [
    ("POST", "/api/chat/completions", {}, {"messages": [{"role": "user", "content": "hi"}]}),
    ("POST", "/api/chat/completions", {}, {"messages": [{"role": "user", "content": "s"}],
                                           "stream": True}),
    ("POST", "/api/chat/completions", {}, {"model": "other", "stream": False,
                                           "messages": [{"role": "user", "content": "x"}]}),
    ("POST", "/api/chat/completions", {}, "not json"),
    ("GET", "/api/dashboard/ranker/prompt", {"query-template": base64.b64encode(
        b"{% for %}").decode(), "document-template": base64.b64encode(b"d").decode(),
        "user-id": "u1"}, None),
]


def test_chat_proxy_and_prompt_preview(mock, tmp_path):
    """The proxy's answers (the mock echoes; deepseek-r1 adds a think
    block), SSE framing for ``stream``, and a bad template's 400."""
    answers = {}
    for pkg in ("ref", "port"):
        rest = _rest(pkg, tmp_path, mock.base_url)
        out = []
        for method, path, query, body in CHAT_CALLS:
            status, payload = rest.dispatch(method, path, dict(query), body, {})
            data, ctype, extra, status = rest.render_payload(status, payload)
            out.append((status, ctype, extra, data if status == 200 else None))
        answers[pkg] = out
    assert answers["port"] == answers["ref"]
    statuses = [a[0] for a in answers["port"]]
    assert statuses == [200, 200, 200, 500, 400]  # no messages: the mock fails, as upstream
    sse = answers["port"][1][3].decode()
    assert answers["port"][1][1] == "text/event-stream" and sse.endswith("data: [DONE]\n\n")
    chunk = json.loads(sse.split("\n\n")[0][len("data: "):])
    assert chunk["object"] == "chat.completion.chunk"
    assert chunk["choices"][0]["delta"]["content"].endswith("s")


def test_bench_reranker_matches(tmp_path):
    import contextlib
    import io

    from gorse_tpu.cmd import bench as ref_bench
    from gorse_tpu_torch.cmd import bench as port_bench

    outs = []
    for mod in (ref_bench, port_bench):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(["reranker", "--users", "10", "--candidates", "8",
                             "--prompt", REVERSED]) == 0
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[1]["users"] == 10
