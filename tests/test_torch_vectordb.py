"""The port's vector-database stores (gorse_tpu_torch/storage/vectordb.py:
Qdrant, Weaviate, Milvus over one stdlib REST client) against gorse_tpu's,
each on the port's engine-semantics server (storage/minivector.py); one
case per engine also on gorse_tpu's copy of the servers, so that the
port's clients stay held against the reference's engine semantics.

The same calls on the same rows, made from a seed with numpy, give the same
records from both packages' stores, per engine and distance, quantization
included; the openers ``qdrant://``, ``weaviate://`` and ``milvus://`` give
the reference's clients; a bad key is refused; ``_doc_uuid`` gives the
reference's UUIDs; Qdrant's quantization configuration round-trips both
ways and equals the reference's."""

import numpy as np
import pytest

import gorse_tpu.storage.vectordb as RDB
import gorse_tpu.storage.vectors as RV
import gorse_tpu_torch.storage.vectordb as PDB
import gorse_tpu.storage.minivector as RMV
import gorse_tpu_torch.storage.minivector as PMV
from gorse_tpu_torch.storage import vectors as PV

ENGINES = ("qdrant", "weaviate", "milvus")


def _start(mv) -> dict:
    return {"qdrant": mv.MiniQdrant().start(), "weaviate": mv.MiniWeaviate().start(),
            "milvus": mv.MiniMilvus().start()}


@pytest.fixture(scope="module")
def servers():
    minis = _start(PMV)
    yield minis
    for mini in minis.values():
        mini.stop()


@pytest.fixture(scope="module")
def ref_servers():
    minis = _start(RMV)
    yield minis
    for mini in minis.values():
        mini.stop()


def _url(engine: str, mini, key: str | None = None) -> str:
    if engine == "milvus":
        return f"milvus://{key or mini.token}@127.0.0.1:{mini.port}"
    return f"{engine}://:{key or mini.api_key}@127.0.0.1:{mini.port}"


def _calls(store, name: str, distance: str, quantization: str, bits: int) -> list:
    """Create, add in two batches, upsert, delete, query (several k), the
    collection's description, drop: what each call returned."""
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(60, 8)).astype(np.float32)
    queries = rng.normal(size=(3, 8)).astype(np.float32)
    ids = [f"doc-{n}" for n in range(60)]

    def hits(results):
        return [[(s.id, round(s.score, 4)) for s in row] for row in results]

    store.create_collection(name, 8, distance=distance, quantization=quantization, bits=bits)
    out = [store.has_collection(name)]
    store.add(name, ids[:40], vecs[:40])
    out.append(hits(store.query(name, queries, 5)))
    store.add(name, ids[40:], vecs[40:])
    store.add(name, ids[:3], vecs[3:6])
    store.delete(name, ids[10:20])
    out.append(hits(store.query(name, queries, 10)))
    out.append(hits(store.query(name, queries[:1], 1)))
    info = store.describe_collection(name)
    out.append(info)
    out.append(name in store.list_collections())
    store.drop_collection(name)
    out.append(store.has_collection(name))
    return out


CASES = [("dot", "", 0), ("cosine", "", 0), ("euclidean", "", 0), ("dot", "sq", 0),
         ("dot", "pq", 0), ("dot", "rq", 0)]


@pytest.mark.parametrize("distance,quantization,bits", CASES)
@pytest.mark.parametrize("engine", ENGINES)
def test_store_is_the_reference(servers, engine, distance, quantization, bits):
    mini = servers[engine]
    name = f"c_{distance}_{quantization or 'none'}"
    got = _calls(PV.open_vector_store(_url(engine, mini), device="cpu"), name, distance,
                 quantization, bits)
    want = _calls(RV.open_vector_store(_url(engine, mini)), name, distance, quantization, bits)
    assert got == want


@pytest.mark.parametrize("engine", ENGINES)
def test_store_on_the_reference_server(servers, ref_servers, engine):
    """The reference's copy of each server: the port's store gives there
    what the reference's store gives there, and what it gives on the
    port's server."""
    args = ("c_ref", "euclidean", "sq", 0)
    got = _calls(PV.open_vector_store(_url(engine, ref_servers[engine]), device="cpu"), *args)
    want = _calls(RV.open_vector_store(_url(engine, ref_servers[engine])), *args)
    own = _calls(PV.open_vector_store(_url(engine, servers[engine]), device="cpu"), *args)
    assert got == want == own
    assert got[0] and got[-1] is False and got[1] and len(got[2][0]) == 10


@pytest.mark.parametrize("engine", ENGINES)
def test_openers_give_the_reference_clients(servers, engine):
    mini = servers[engine]
    for url in (_url(engine, mini), _url(engine, mini).replace("127.0.0.1", "localhost")
                + "?secure=true"):
        got, want = PV.open_vector_store(url, device="cpu"), RV.open_vector_store(url)
        assert type(got).__name__ == type(want).__name__ and type(got).__module__ == PDB.__name__
        assert vars(got.c) == vars(want.c)


@pytest.mark.parametrize("engine", ENGINES)
def test_bad_credentials_are_refused(servers, engine):
    mini = servers[engine]
    for opener in (lambda u: PV.open_vector_store(u, device="cpu"), RV.open_vector_store):
        store = opener(_url(engine, mini, key="root:wrong" if engine == "milvus" else "wrong"))
        with pytest.raises(IOError):
            store.create_collection("refused", 4)


def test_doc_uuids_are_the_reference():
    rng = np.random.default_rng(0)
    ids = ["", "0", "item/1", "ünï", "a" * 300] + [f"u{n}" for n in rng.integers(0, 10**9, 50)]
    assert [PDB._doc_uuid(i) for i in ids] == [RDB._doc_uuid(i) for i in ids]


@pytest.mark.parametrize("quantization,bits", [("", 0), ("sq", 0), ("sq", 8), ("pq", 0),
                                               ("pq", 1), ("pq", 2), ("pq", 4), ("pq", 8),
                                               ("rq", 0), ("rq", 1), ("rq", 2), ("rq", 4)])
def test_qdrant_quantization_round_trips(quantization, bits):
    cfg = PDB._qdrant_quantization_config(quantization, bits)
    assert cfg == RDB._qdrant_quantization_config(quantization, bits)
    parsed = PDB._qdrant_parse_quantization(cfg)
    assert parsed == RDB._qdrant_parse_quantization(cfg)
    assert parsed == ((quantization, 8 if quantization == "sq" else bits) if quantization
                      else ("", 0))
    assert PDB._qdrant_quantization_config(*parsed) == cfg or (quantization, bits) == ("sq", 0)


@pytest.mark.parametrize("quantization,bits", [("sq", 4), ("pq", 3), ("rq", 8), ("xq", 0)])
def test_qdrant_refuses_what_the_reference_refuses(quantization, bits):
    for mod in (PDB, RDB):
        with pytest.raises(ValueError):
            mod._qdrant_quantization_config(quantization, bits)
