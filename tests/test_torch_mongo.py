"""The port's MongoDB layer (gorse_tpu_torch/storage/bson.py, mongowire.py,
mongo.py) against gorse_tpu's, on the port's ``MiniMongo``
(storage/minimongo.py) and, each case again, on gorse_tpu's, so that the
port's client stays held against the reference's server semantics. The
stores' contract cases run in
tests/test_torch_sql_stores.py; here the BSON codec byte for byte, the wire
client's SCRAM refusal and cursor batching, the URL grammar and the
collection prefix."""

import numpy as np
import pytest

import gorse_tpu.storage.bson as RB
import gorse_tpu.storage.mongowire as RW
import gorse_tpu_torch.storage.bson as PB
import gorse_tpu_torch.storage.mongowire as PW
import gorse_tpu.storage.minimongo as RMM
import gorse_tpu_torch.storage.minimongo as PMM


@pytest.fixture(scope="module", params=["port", "ref"])
def mini(request):
    """The port's MiniMongo, and the reference's copy."""
    server = {"port": PMM, "ref": RMM}[request.param].MiniMongo().start()
    yield server
    server.stop()


def _docs(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = [{"str": "héllo", "int32": 42, "int64": 1 << 40, "neg": -7, "float": 3.25,
            "bool_t": True, "bool_f": False, "null": None, "bin": b"\x00\x01\xff",
            "doc": {"nested": ["a", 1, 2.0, None]}, "arr": [1, "two", {"three": 3}],
            "edge": [2**31 - 1, -(2**31), 2**31, -(2**31) - 1, 2**63 - 1, 0.0, -0.0]}]
    for _ in range(20):
        out.append({f"k{n}": (float(rng.normal()) if n % 3 == 0 else int(rng.integers(-2**40, 2**40))
                              if n % 3 == 1 else rng.bytes(int(rng.integers(0, 9))).hex())
                    for n in range(int(rng.integers(1, 12)))})
    return out


def test_bson_is_the_reference_byte_for_byte():
    for doc in _docs(0):
        encoded = PB.encode(doc)
        assert encoded == RB.encode(doc)
        assert PB.decode(encoded) == RB.decode(encoded) == doc
    stream = b"".join(RB.encode(d) for d in _docs(1))
    assert PB.decode_all(stream) == RB.decode_all(stream)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_scram_refusal_and_cursor_batches(mini, pkg):
    wire = PW if pkg == "port" else RW
    with pytest.raises(wire.MongoError):
        wire.MongoConnection("127.0.0.1", mini.port, user=mini.state.user, password="wrong")
    conn = wire.MongoConnection("127.0.0.1", mini.port, user=mini.state.user,
                                password=mini.state.password)
    try:
        conn.command("db", {"insert": f"c_{pkg}",
                            "documents": [{"_id": i, "v": i} for i in range(10)]})
        # 10 documents at the server's batch size of 3: three getMore trips
        docs = conn.find_all("db", f"c_{pkg}", sort={"_id": 1})
        assert [d["v"] for d in docs] == list(range(10))
    finally:
        conn.close()


def test_url_grammar_is_the_reference(monkeypatch):
    """``from_url`` passes the reference's host, port, credentials, auth
    database and database name (caught before it dials)."""
    dialled = {}
    for name, mod in (("port", PW), ("ref", RW)):
        def init(self, *args, _name=name, **kwargs):
            dialled.setdefault(_name, []).append((args, kwargs))

        monkeypatch.setattr(mod.MongoConnection, "__init__", init)
    for url in ("mongodb://h/db", "mongodb://u:p%40ss@h:27018/gorse?authSource=admin",
                "mongodb://h:1", "mongodb://u:@127.0.0.1/x"):
        assert PW.MongoConnection.from_url(url)[1] == RW.MongoConnection.from_url(url)[1]
    assert dialled["port"] == dialled["ref"] and len(dialled["port"]) == 4


def test_collection_prefix_is_the_reference(mini):
    """``mongodb://`` with a table prefix opens the stores with the
    reference's collection names."""
    import gorse_tpu.storage.cache as RC
    import gorse_tpu.storage.data as RD
    import gorse_tpu.storage.types as RT
    import gorse_tpu_torch.storage.cache as PC
    import gorse_tpu_torch.storage.data as PD
    import gorse_tpu_torch.storage.types as PT

    names = {}
    for pkg, (data, cache, types) in (("port", (PD, PC, PT)), ("ref", (RD, RC, RT))):
        url = mini.url(database=f"prefix_{pkg}")
        d, c = data.open_data_store(url, table_prefix="g_"), cache.open_cache_store(
            url, table_prefix="g_")
        try:
            assert (type(d).__name__, type(c).__name__) == ("MongoDataStore", "MongoCacheStore")
            d.insert_feedback([types.Feedback("like", "u1", "i1", 1.0, 5.0)])
            c.set("k", "v")
            c.add_scores("recommend", "u1", [types.Score("i1", 1.0, [], 1.0)])
            c.add_time_series_points([types.TimeSeriesPoint("m", 1.0, 2.0)])
            names[pkg] = sorted(n for n in mini.state.dbs.get(f"prefix_{pkg}", {}))
        finally:
            d.close()
            c.close()
    assert names["port"] == names["ref"] and all(n.startswith("g_") for n in names["port"])
