"""The port's copies of the stdlib LLM client, its in-process mock server and
the token buckets (gorse_tpu_torch/llm/, parallel/ratelimit.py) held
against gorse_tpu's: tests/test_llm.py's client cases with each package's
client against each package's mock (the same answers and the same recorded
requests, exactly), the completion parsers on the same strings, and the
buckets' delays within 0.05 s of the reference's (each reads the clock)."""

import importlib
import itertools
from types import SimpleNamespace

import pytest

PACKAGES = ("ref", "port")


def _pkg(name: str) -> SimpleNamespace:
    root = {"ref": "gorse_tpu", "port": "gorse_tpu_torch"}[name]
    return SimpleNamespace(
        llm=importlib.import_module(f"{root}.llm"),
        client=importlib.import_module(f"{root}.llm.client"),
        ratelimit=importlib.import_module(f"{root}.parallel.ratelimit"),
    )


@pytest.fixture(scope="module")
def mocks():
    servers = {name: _pkg(name).llm.MockOpenAIServer(dimensions=16).start() for name in PACKAGES}
    yield servers
    for s in servers.values():
        s.close()


def _client(p, server, **kw):
    server.completions.clear()
    server.requests.clear()
    return p.llm.OpenAIClient(base_url=server.base_url, auth_token=server.auth_token,
                              chat_model="test-model", embedding_model="test-embed",
                              embedding_dimensions=16, **kw)


CALLS = {
    "echo": lambda c, s: c.chat_completion("hello world"),
    "think": lambda c, s: c.chat_completion("the prompt", model="deepseek-r1"),
    "queued": lambda c, s: (s.queue_completion('["i1", "i2"]'), c.chat_completion("x"))[1],
    "embedding": lambda c, s: c.embedding("movie about space"),
    "embedding_model": lambda c, s: c.embedding("cooking show", model="other"),
    "raw": lambda c, s: c.chat_completion_raw(
        {"messages": [{"role": "user", "content": "hi"}], "stream": True}),
}


@pytest.mark.parametrize("call", sorted(CALLS))
@pytest.mark.parametrize("client_pkg,server_pkg", list(itertools.product(PACKAGES, PACKAGES)))
def test_client_against_mock(mocks, call, client_pkg, server_pkg):
    """Every pairing of client and mock answers as the reference's client
    against the reference's mock, and the mock records the same requests."""
    want_client = _client(_pkg("ref"), mocks["ref"])
    want = CALLS[call](want_client, mocks["ref"])
    want_requests = list(mocks["ref"].requests)
    server = mocks[server_pkg]
    got = CALLS[call](_client(_pkg(client_pkg), server), server)
    assert got == want
    assert server.requests == want_requests
    if call == "echo":
        assert got == "hello world"
    if call == "think":
        assert "<think>" in got and _pkg("port").llm.strip_think(got) == "the prompt"


def test_hash_embedding_matches():
    for text, dims in [("movie about space", 16), ("", 8), ("ünïcode", 128)]:
        assert _pkg("port").llm.hash_embedding(text, dims) == \
            _pkg("ref").llm.hash_embedding(text, dims)


@pytest.mark.parametrize("text", [
    '["a", "b"]', 'Here you go:\n```json\n["x"]\n```', '<think>hmm</think>["y"]',
    "plain text", '[{"id": 1}]', "", "first\nsecond\n\nthird", "```\nnot json\n```",
    '<think>a</think><think>b</think>["z", 2]', "[1, 2.5, null]",
])
def test_completion_parsers_match(text):
    port, ref = _pkg("port"), _pkg("ref")
    assert port.llm.parse_array_from_completion(text) == \
        ref.llm.parse_array_from_completion(text)
    assert port.llm.strip_think(text) == ref.llm.strip_think(text)
    assert port.client.estimate_tokens(text) == ref.client.estimate_tokens(text)


def test_token_bucket_matches():
    delays = {}
    for name in PACKAGES:
        tb = _pkg(name).ratelimit.TokenBucket(60, period=60.0)  # 1/s
        first = tb.take(1)
        tb.tokens = 0
        delays[name] = (first, tb.take(2))
    assert delays["port"][0] == delays["ref"][0] == 0.0
    assert abs(delays["port"][1] - delays["ref"][1]) < 0.05
    assert 1.9 < delays["port"][1] < 2.1


def test_rate_limiters_and_from_config():
    """The four limiters' defaults, and ``from_config`` on each package's
    OpenAI config section."""
    import gorse_tpu.utils.config as ref_config
    import gorse_tpu_torch.utils.config as port_config

    def state(p, config):
        lim = p.ratelimit.RateLimiters()
        cfg = config.Config().openai
        cfg.base_url, cfg.embedding_dimensions = "http://x/v1", 7
        client = p.llm.OpenAIClient.from_config(cfg)
        return ([(b.capacity, b.period) for b in (lim.chat_requests, lim.chat_tokens,
                                                   lim.embedding_requests, lim.embedding_tokens)],
                (client.base_url, client.embedding_dimensions, client.enabled(),
                 client.limiters.chat_requests.capacity))

    assert state(_pkg("port"), port_config) == state(_pkg("ref"), ref_config)


def test_retry_then_raise_on_http_error(mocks):
    """A 404 is not retried: both clients raise the same HTTPError."""
    import urllib.error

    errs = {}
    for name in PACKAGES:
        client = _client(_pkg(name), mocks["port"], max_retries=2)
        with pytest.raises(urllib.error.HTTPError) as e:
            client._post("/nowhere", {})
        errs[name] = e.value.code
    assert errs["port"] == errs["ref"] == 404
