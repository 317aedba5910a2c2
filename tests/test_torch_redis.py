"""The port's Redis layer (gorse_tpu_torch/storage/resp.py: ``RespClient``,
``RespClusterClient``, ``crc16_xmodem``, ``keyslot``, the servers
``MiniRedis`` and ``MiniRedisCluster``; storage/redis.py
``RedisCacheStore``) against gorse_tpu's. The store's contract cases run
in tests/test_torch_sql_stores.py; here the slot hash, the raw protocol
both ways between the packages' clients and servers, cluster routing, and
the opener's ``key_prefix``, ``client_name`` and ``max_search_results``."""

import numpy as np
import pytest

import gorse_tpu.storage.cache as RC
import gorse_tpu.storage.resp as RR
import gorse_tpu.storage.types as RT
import gorse_tpu_torch.storage.cache as PC
import gorse_tpu_torch.storage.resp as PR
import gorse_tpu_torch.storage.types as PT

PACKAGES = {"port": PR, "ref": RR}


def test_keyslot_is_the_reference():
    rng = np.random.default_rng(0)
    keys = ["", "foo", "bar", "{user1000}.following", "{user1000}.followers", "{}x", "a{}b{c}",
            "{a", "a}", "ünï", "recommend/u1"]
    keys += [rng.bytes(int(rng.integers(1, 40))).hex() for _ in range(200)]
    keys += [f"pre{{{rng.integers(1000)}}}post{n}" for n in range(100)]
    assert [PR.keyslot(k) for k in keys] == [RR.keyslot(k) for k in keys]
    assert [PR.crc16_xmodem(k.encode()) for k in keys] == [RR.crc16_xmodem(k.encode())
                                                           for k in keys]
    assert (PR.keyslot("foo"), PR.keyslot("bar")) == (12182, 5061)


COMMANDS = [("PING",), ("SET", "k", "v"), ("GET", "k"), ("EXISTS", "k", "nope"),
            ("RPUSH", "q", "a", "b", "c"), ("LPOP", "q"), ("LLEN", "q"),
            ("SADD", "s", "x", "y", "x"), ("SISMEMBER", "s", "y"), ("SREM", "s", "y"),
            ("SMEMBERS", "s"), ("ZADD", "z", "1.5", "a", "-2", "b", "3", "c"),
            ("ZRANGE", "z", "0", "-1", "WITHSCORES"), ("ZRANGE", "z", "0", "1", "REV"),
            ("ZREM", "z", "b"), ("ZCARD", "z"), ("HSET", "h", "f1", "1", "f2", "ü"),
            ("HGET", "h", "f2"), ("HGETALL", "h"), ("HDEL", "h", "f1"), ("KEYS", "*"),
            ("DEL", "k", "q"), ("GET", "k"), ("FLUSHDB",), ("KEYS", "*")]


def _replies(client_mod, server) -> list:
    c = client_mod.RespClient(server.host, server.port)
    try:
        out = []
        for cmd in COMMANDS:
            r = c.call(*cmd)
            out.append(sorted(r) if cmd[0] in ("KEYS", "SMEMBERS") and r else r)
        out.append(c.pipeline([("SET", f"p{n}", str(n)) for n in range(5)]
                              + [("GET", f"p{n}") for n in range(5)]))
        return out
    finally:
        c.close()


def test_protocol_both_ways():
    """Each client against each server gives the reference client's replies
    on the reference server."""
    results = {}
    for client in PACKAGES:
        for server_pkg, mod in PACKAGES.items():
            server = mod.MiniRedis()
            try:
                results[client, server_pkg] = _replies(PACKAGES[client], server)
            finally:
                server.close()
    want = results["ref", "ref"]
    assert all(r == want for r in results.values())


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_cluster_routing_both_ways(client, server):
    """Slot routing: MOVED redirects teach the slot map, pipelines split per
    node, each key on the node owning its slot, per-master scans see the
    union keyspace."""
    cluster = PACKAGES[server].MiniRedisCluster(3)
    try:
        first = cluster.nodes[0]
        c = PACKAGES[client].RespClusterClient([(first.host, first.port)])
        for i in range(40):
            assert c.call("SET", f"k{i}", f"v{i}") == "OK"
        assert c.pipeline([("GET", f"k{i}") for i in range(40)]) == [f"v{i}" for i in range(40)]
        for node in cluster.nodes:
            lo, hi = node.cluster_slots
            assert all(lo <= PR.keyslot(k) <= hi for k in node.state.keys())
        assert sum(len(n.state.keys()) for n in cluster.nodes) == 40
        keys = sorted(k for node in c.call_all("KEYS", "k*") for k in (node or []))
        assert keys == sorted(f"k{i}" for i in range(40)) and len(c.masters()) == 3
        c.close()
    finally:
        cluster.close()


def _store_keys(pkg: str, url: str) -> tuple:
    cache, types = (PC, PT) if pkg == "port" else (RC, RT)
    store = cache.open_cache_store(url, table_prefix="gorse_", client_name="node-7",
                                   max_search_results=3)
    try:
        store.set("k", "v")
        store.push("q", "x")
        store.add_scores("recommend", "u1", [types.Score(f"i{n}", float(n), [], 1.0)
                                             for n in range(6)])
        store.add_time_series_points([types.TimeSeriesPoint("m", 1.0, 2.0)])
        capped = [s.id for s in store.search_scores("recommend", "u1")]
        window = [s.id for s in store.search_scores("recommend", "u1", begin=1, end=10)]
        return capped, window
    finally:
        store.close()


@pytest.mark.parametrize("kind", ["redis", "redis+cluster"])
def test_opener_knobs_are_the_reference(kind):
    """``key_prefix`` names every key, ``max_search_results`` caps a
    search, as the reference's store does on the same server."""
    results, keyspaces = {}, {}
    for pkg in PACKAGES:
        server = PR.MiniRedis() if kind == "redis" else PR.MiniRedisCluster(3)
        try:
            results[pkg] = _store_keys(pkg, server.url)
            nodes = [server] if kind == "redis" else server.nodes
            keyspaces[pkg] = sorted(k for n in nodes for k in n.state.keys())
        finally:
            server.close()
    assert results["port"] == results["ref"] and len(results["port"][0]) == 3
    assert keyspaces["port"] == keyspaces["ref"]
    assert keyspaces["port"] and all(k.startswith("gorse_") for k in keyspaces["port"])


def test_url_grammar_is_the_reference():
    import gorse_tpu.storage.redis as rred
    import gorse_tpu_torch.storage.redis as pred

    for url in ("redis://h", "redis://h:6380", "redis://:pw@h:1/3", "redis://user:pw@h/",
                "redis://127.0.0.1:6379/0"):
        assert pred._parse_url(url) == rred._parse_url(url)
    for url in ("redis+cluster://h:7000", "redis+cluster://:pw@h:7000?addr=a:1&addr=b:2"):
        assert pred._parse_cluster_url(url) == rred._parse_cluster_url(url)
