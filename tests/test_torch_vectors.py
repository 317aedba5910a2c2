"""The port's vector store (gorse_tpu_torch.storage.vectors) held against
gorse_tpu.storage.vectors on the same rows and queries.

The helpers must be exact: quantization, recompression, k-means codebooks,
codes, rotation, packing, and the store's vectorised ``add`` against the
reference's row-by-row one. Queries take the reference's XLA formulations
under 1,024 rows and the kernel routes (sq, and pq/rq through the 8-bit
decode cache) at 1,024 rows or more; there the reference's Pallas route runs
in interpret mode, its gate patched to the port's rule. Scores are held to
1e-5 of the magnitude of the terms they sum plus 1e-6 (the reference's
scores for the magnitudes, twice the dot part plus |norms2| + |q2| for
euclidean), and ids must be equal wherever the reference's neighbours in
its list are farther apart than both tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gorse_tpu.storage.vectors as RV
from gorse_tpu.storage.none import NoDatabaseError as RefNoDatabaseError
from gorse_tpu.utils.config import DatabaseConfig as RefDatabaseConfig
from gorse_tpu_torch.storage import vectors as V
from gorse_tpu_torch.storage.none import NoCacheStore, NoDatabaseError, NoDataStore, NoVectorStore
from gorse_tpu_torch.utils.config import Config, DatabaseConfig

KERNEL_ROWS = 1100  # above the 1,024 rows from which both serve through the kernels


@pytest.fixture
def kernel_gate(monkeypatch):
    """The reference serves through its Pallas route only on a TPU: give it
    the port's rule (1,024 rows or more) for the test."""
    monkeypatch.setattr(RV, "_device_serving_enabled", lambda n: n >= 1024)


def _rows(rng, n, d):
    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows[3] = rows[1]  # a duplicate row
    rows[5] = 0.25  # a constant row: scale 1.0
    return rows


# ---------------------------------------------------------------- helpers


def test_quantize_sq_is_the_reference():
    rng = np.random.default_rng(0)
    for vec in [rng.normal(size=64).astype(np.float32), np.full(8, 3.0, np.float32),
                (rng.normal(size=13) * 1e3).astype(np.float32), np.zeros(5, np.float32)]:
        codes, scale, lo = V._quantize_sq(vec)
        r_codes, r_scale, r_lo = RV._quantize_sq(vec)
        np.testing.assert_array_equal(codes, r_codes)
        assert (scale, lo) == (r_scale, r_lo) and type(scale) is float


@pytest.mark.parametrize("d", [13, 64])
def test_vectorised_quantization_is_row_by_row(d):
    """_quantize_sq_rows equals _quantize_sq on every row, bit for bit."""
    rng = np.random.default_rng(d)
    m = _rows(rng, 500, d) * rng.uniform(0.01, 100, size=(500, 1)).astype(np.float32)
    codes, scale, lo = V._quantize_sq_rows(m)
    for i in range(len(m)):
        c, s, low = RV._quantize_sq(m[i])
        np.testing.assert_array_equal(codes[i], c)
        assert float(scale[i]) == s and float(lo[i]) == low


def test_recompress_and_codecs_are_the_reference():
    rng = np.random.default_rng(1)
    m = _rows(rng, 600, 16)
    for a, b in zip(V._sq_recompress(m), RV._sq_recompress(m)):
        np.testing.assert_array_equal(a, b)
    books = V._train_pq(m, 8, seed=5)
    np.testing.assert_array_equal(books, RV._train_pq(m, 8, seed=5))
    np.testing.assert_array_equal(V._encode_pq(m, books), RV._encode_pq(m, books))
    rot = V._rotation(16, seed=2)
    np.testing.assert_array_equal(rot, RV._rotation(16, seed=2))
    for bits in (1, 2, 4):
        for a, b in zip(V._encode_rq(m, rot, bits), RV._encode_rq(m, rot, bits)):
            np.testing.assert_array_equal(a, b)
    for bits in (1, 2, 4, 8):
        for d in (4, 16, 24):
            try:
                want = RV._pq_subspaces(d, bits)
            except ValueError:
                with pytest.raises(ValueError):
                    V._pq_subspaces(d, bits)
            else:
                assert V._pq_subspaces(d, bits) == want


@pytest.mark.parametrize("distance", ["dot", "cosine", "euclidean"])
@pytest.mark.parametrize("quantization", ["", "sq"])
def test_add_stores_what_the_reference_stores(distance, quantization):
    """The batch add keeps exactly the reference's rows, codes, scales,
    mins and norms2 (zero, constant and duplicate rows included), and an
    upsert replaces in place."""
    rng = np.random.default_rng(2)
    rows = _rows(rng, 300, 13)
    rows[7] = 0.0
    ids = [f"v{i}" for i in range(300)]
    port, ref = V.MemoryVectorStore(device="cpu"), RV.MemoryVectorStore()
    for s in (port, ref):
        s.create_collection("c", 13, distance=distance, quantization=quantization)
        s.add("c", ids, rows)
        s.add("c", ["v9", "new"], rows[:2] * 2)
    a, b = port._collections["c"], ref._collections["c"]
    assert list(a.rows) == list(b.rows) and a.version == b.version == 2
    for vid in b.rows:
        np.testing.assert_array_equal(a.rows[vid], b.rows[vid])
        assert a.rows[vid].dtype == b.rows[vid].dtype
        assert a.norms2[vid] == b.norms2[vid]
        if quantization == "sq":
            assert a.scales[vid] == b.scales[vid] and a.mins[vid] == b.mins[vid]


@pytest.fixture(params=["memory", "sqlite"])
def store(request, tmp_path):
    if request.param == "memory":
        return V.MemoryVectorStore(device="cpu")
    return V.SQLiteVectorStore(str(tmp_path / "v.db"), device="cpu")


def test_metadata_and_validation(store):
    ref = RV.MemoryVectorStore()
    for s in (store, ref):
        s.create_collection("a", 8, distance="cosine", quantization="sq", bits=8)
        s.create_collection("b", 4)
        s.create_collection("p", 16, quantization="pq")
        s.create_collection("r", 16, quantization="rq")
    assert store.list_collections() == ref.list_collections() == ["a", "b", "p", "r"]
    for name in ("a", "b", "p", "r", "missing"):
        assert store.describe_collection(name) == ref.describe_collection(name)
        assert store.has_collection(name) == ref.has_collection(name)
    assert store.describe_collection("p")["bits"] == 8 and store.describe_collection("r")["bits"] == 1
    assert store.dimensions("a") == 8 and store.ping()
    bad = [dict(distance="hamming"), dict(quantization="vq"), dict(quantization="pq", bits=1),
           dict(quantization="rq", bits=8), dict(quantization="sq", bits=4)]
    for kwargs in bad:
        with pytest.raises(ValueError) as got:
            store.create_collection("bad", 4, **kwargs)
        with pytest.raises(ValueError) as want:
            ref.create_collection("bad", 4, **kwargs)
        assert str(got.value) == str(want.value)
    assert store.query("b", np.ones((2, 4), np.float32), 3) == [[], []]
    with pytest.raises(AssertionError):
        store.add("b", ["x"], np.ones((1, 5), np.float32))
    store.drop_collection("a")
    assert not store.has_collection("a")


# ------------------------------------------------------------------ queries


def _dense_mag(qabs, vabs):
    return qabs.astype(np.float64) @ vabs.astype(np.float64).T


def _sq_mag(q_dot, q, codes, scale, minv):
    qsum = q.astype(np.float64).sum(1, keepdims=True)
    return (_dense_mag(np.abs(q_dot), codes) * np.abs(scale)[None, :]
            + np.abs(qsum * minv[None, :]))


def _magnitudes(ref, name, q, kernel):
    """[B, n] magnitudes of the terms of each score, columns in the
    reference's row order, from the reference's stored collection."""
    c = ref._collections[name]
    info, ids = c.info, list(c.rows)
    norms2 = np.asarray([c.norms2[i] for i in ids], np.float64)
    if info.quantization == "sq":
        codes = np.stack([c.rows[i] for i in ids])
        scale = np.asarray([c.scales[i] for i in ids], np.float32)
        minv = np.asarray([c.mins[i] for i in ids], np.float32)
        q_dot = torch.as_tensor(q).bfloat16().float().numpy() if kernel else q
        mag = _sq_mag(q_dot, q, codes, scale, minv)
    elif info.quantization:
        enc = c.encoded
        ids = enc["ids"]
        norms2 = enc["norms2"].astype(np.float64)
        decoded = V._decode(info, enc, len(ids))
        if kernel:
            codes, scale, minv = V._sq_recompress(decoded)
            q_dot = torch.as_tensor(q).bfloat16().float().numpy()
            mag = _sq_mag(q_dot, q, codes, scale, minv)
        elif info.quantization == "pq":
            mag = _dense_mag(np.abs(q), torch.as_tensor(decoded).bfloat16().float().abs().numpy())
        else:  # the rotated basis: |q| |rot|^T against |minv| + |scale| codes
            bits = info.bits
            shifts = (np.arange(8 // bits, dtype=np.uint8) * bits)[None, None, :]
            codes = ((enc["packed"][:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(
                len(ids), -1)[:, : info.dimension]
            vabs = np.abs(enc["minv"])[:, None] + np.abs(enc["scale"])[:, None] * codes
            mag = _dense_mag(_dense_mag(np.abs(q), np.abs(enc["rot"])), vabs)
    else:
        mag = _dense_mag(np.abs(q), np.abs(np.stack([c.rows[i] for i in ids])))
    if info.distance == "euclidean":
        q2 = (q.astype(np.float64) ** 2).sum(1, keepdims=True)
        mag = 2.0 * mag + np.abs(norms2)[None, :] + q2
    return mag, ids


def _assert_lists(got, want, k, mag, ids):
    """``want`` holds the reference's top k + 1 (the neighbour below)."""
    col = {vid: j for j, vid in enumerate(ids)}
    checked = total = 0
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == min(k, len(w)) and len(w) == min(k + 1, len(ids))
        tol = [1e-5 * mag[b, col[s.id]] + 1e-6 for s in w]
        for r, s in enumerate(g):
            t_got = 1e-5 * mag[b, col[s.id]] + 1e-6
            assert abs(s.score - w[r].score) <= tol[r] + t_got, (b, r, s, w[r])
            above = r == 0 or w[r - 1].score - w[r].score > tol[r - 1] + tol[r]
            below = r + 1 == len(w) or w[r].score - w[r + 1].score > tol[r] + tol[r + 1]
            total += 1
            if above and below:
                checked += 1
                assert s.id == w[r].id, (b, r, s, w[r])
    assert checked > total / 2, "the inputs leave too few ranks to check"


def _both(quantization, bits, distance, n, d, seed=4, tmp_path=None):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, n, d)
    ids = [f"v{i}" for i in range(n)]
    if tmp_path is None:
        port, ref = V.MemoryVectorStore(device="cpu"), RV.MemoryVectorStore()
    else:
        port = V.SQLiteVectorStore(str(tmp_path / "p.db"), device="cpu")
        ref = RV.SQLiteVectorStore(str(tmp_path / "r.db"))
    for s in (port, ref):
        s.create_collection("c", d, distance=distance, quantization=quantization, bits=bits)
        s.add("c", ids, rows)
    q = rng.normal(size=(5, d)).astype(np.float32)
    q[4] = rows[8] * 2.0
    return port, ref, rows, q


def _hold(port, ref, q, k, kernel):
    got = port.query("c", q, k)
    want = ref.query("c", q, k + 1)
    qn = q
    if port._collections["c"].info.distance == "cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    mag, ids = _magnitudes(ref, "c", qn, kernel)
    _assert_lists(got, want, k, mag, ids)
    return got


ROUTES = [("", 0), ("sq", 8), ("pq", 8), ("pq", 4), ("rq", 4), ("rq", 1)]


@pytest.mark.parametrize("distance", ["dot", "cosine", "euclidean"])
@pytest.mark.parametrize("quantization,bits", ROUTES)
def test_xla_routes_match_reference(quantization, bits, distance):
    """Under 1,024 rows: the XLA formulations on both sides."""
    port, ref, _, q = _both(quantization, bits, distance, 300, 16)
    _hold(port, ref, q, 10, kernel=False)
    assert port._collections["c"].encoded is None or quantization in ("pq", "rq")


@pytest.mark.parametrize("distance", ["dot", "cosine", "euclidean"])
@pytest.mark.parametrize("quantization,bits", [("sq", 8), ("pq", 8), ("rq", 4)])
def test_kernel_routes_match_reference(kernel_gate, quantization, bits, distance):
    """At 1,024 rows or more: the SQ kernels (plain versions here) against
    the reference's Pallas route in interpret mode, sq directly and pq/rq
    through the 8-bit decode cache; the caches are built once."""
    from gorse_tpu_torch.ops import topk

    port, ref, _, q = _both(quantization, bits, distance, KERNEL_ROWS, 16)
    _hold(port, ref, q, 10, kernel=True)
    enc = port._collections["c"].encoded
    prep = enc["prepared"] if quantization == "sq" else enc["sq_prepared"]
    assert isinstance(prep, topk.PreparedSQ) and prep.n_items == KERNEL_ROWS
    assert prep.has_norms2
    _hold(port, ref, q, 10, kernel=True)
    enc2 = port._collections["c"].encoded
    assert (enc2["prepared"] if quantization == "sq" else enc2["sq_prepared"]) is prep


@pytest.mark.parametrize("n", [300, KERNEL_ROWS])
@pytest.mark.parametrize("quantization,bits", [("sq", 8), ("pq", 8), ("rq", 4)])
def test_mutations_invalidate_the_cache(kernel_gate, quantization, bits, n):
    """Adds and deletes after a query are seen by the next one, on both
    routes, as in the reference."""
    port, ref, rows, q = _both(quantization, bits, "dot", n, 16)
    big = (q[0] / np.linalg.norm(q[0]) * 20).astype(np.float32)
    for s in (port, ref):
        s.query("c", q[:1], 3)
        s.add("c", ["big"], big[None, :])
    got, want = port.query("c", q[:1], 3), ref.query("c", q[:1], 3)
    assert got[0][0].id == want[0][0].id == "big"
    for s in (port, ref):
        s.delete("c", ["big", "v1"])
    got, want = port.query("c", q[:1], 5), ref.query("c", q[:1], 5)
    assert {x.id for x in got[0]}.isdisjoint({"big", "v1"})
    assert [x.id for x in got[0]][:3] == [x.id for x in want[0]][:3]


def test_k_beyond_the_collection():
    """k_eff = min(k, n): every row, best first."""
    port, ref, _, q = _both("sq", 8, "dot", 12, 8)
    got, want = port.query("c", q, 50), ref.query("c", q, 50)
    assert [len(x) for x in got] == [12] * 5
    assert [[s.id for s in x] for x in got] == [[s.id for s in x] for x in want]


def test_concurrent_mutation_during_cache_build_not_masked(monkeypatch):
    """An add() landing while another thread builds the sq serving cache
    (outside the lock) must not be masked by the cache publish: the build
    is version-stamped and discarded if stale."""
    from gorse_tpu_torch.ops import topk as T

    rng = np.random.default_rng(11)
    n, dim, k = 64, 16, 5
    store = V.MemoryVectorStore(device="cpu")
    store.create_collection("c", dim, quantization="sq")
    store.add("c", [f"v{i}" for i in range(n)], rng.normal(size=(n, dim)).astype(np.float32))
    monkeypatch.setattr(V, "_device_serving_enabled", lambda n_rows: True)

    q = rng.normal(size=(1, dim)).astype(np.float32)
    big = (q[0] / np.linalg.norm(q[0]) * 10).astype(np.float32)
    real_prepare = T.prepare_sq_items
    fired = {"done": False}

    def racing_prepare(*args, **kwargs):
        # a concurrent writer landing mid-build (the build runs without the
        # store lock, so a real thread could do exactly this)
        if not fired["done"]:
            fired["done"] = True
            store.add("c", ["vbig"], big[None, :])
        return real_prepare(*args, **kwargs)

    monkeypatch.setattr(T, "prepare_sq_items", racing_prepare)
    first = store.query("c", q, k)  # builds from the pre-add snapshot
    after = store.query("c", q, k)
    assert after[0][0].id == "vbig", [s.id for s in after[0]]
    assert fired["done"] and first is not None


def test_sqlite_persistence(tmp_path, kernel_gate):
    """Rows survive a reopen and re-quantize to the same collection; the
    reopened store answers as the reference's reopened store does."""
    port, ref, rows, q = _both("sq", 8, "euclidean", KERNEL_ROWS, 8, tmp_path=tmp_path)
    for s in (port, ref):
        s.delete("c", ["v2"])
    before = port.query("c", q, 10)
    port.close()
    ref.close()
    port = V.SQLiteVectorStore(str(tmp_path / "p.db"), device="cpu")
    ref = RV.SQLiteVectorStore(str(tmp_path / "r.db"))
    assert port.describe_collection("c") == ref.describe_collection("c")
    a, b = port._collections["c"], ref._collections["c"]
    assert list(a.rows) == list(b.rows) and "v2" not in a.rows
    for vid in b.rows:
        np.testing.assert_array_equal(a.rows[vid], b.rows[vid])
        assert (a.scales[vid], a.mins[vid], a.norms2[vid]) == (b.scales[vid], b.mins[vid],
                                                               b.norms2[vid])
    assert port.query("c", q, 10) == before
    _hold(port, ref, q, 10, kernel=True)
    port.drop_collection("c")
    port.close()
    assert V.SQLiteVectorStore(str(tmp_path / "p.db"), device="cpu").list_collections() == []


# ------------------------------------------------------- URLs, none, config


@pytest.mark.parametrize("url,kind", [
    ("memory://", V.MemoryVectorStore), ("memory", V.MemoryVectorStore),
    ("sqlite://", V.SQLiteVectorStore), ("none://", NoVectorStore), ("", NoVectorStore),
])
def test_open_vector_store(url, kind):
    assert type(V.open_vector_store(url, device="cpu")) is kind


@pytest.mark.parametrize("url", ["hnsw://", "proxy://h:1", "qdrant://h:6333",
                                 "weaviate://h:8080", "milvus://u:p@h:19530"])
def test_backends_not_ported_name_their_roadmap_item(url):
    with pytest.raises(NotImplementedError, match="ROADMAP.md M19"):
        V.open_vector_store(url, device="cpu")
    with pytest.raises(ValueError):
        V.open_vector_store("redis://h", device="cpu")


def test_no_database_stores_raise():
    for store, call in ((NoVectorStore(), lambda s: s.query("c", np.ones((1, 2)), 1)),
                        (NoDataStore(), lambda s: s.get_user("u")),
                        (NoCacheStore(), lambda s: s.get("k"))):
        assert store.ping() is False
        store.close()
        with pytest.raises(NoDatabaseError, match="store configured") as got:
            call(store)
        assert str(got.value) == str(RefNoDatabaseError(str(got.value).split()[1]))


def test_database_config_is_the_reference():
    assert dataclasses.asdict(DatabaseConfig()) == dataclasses.asdict(RefDatabaseConfig())
    cfg = Config()
    cfg.validate()
    for url in ("memory://", "sqlite:///tmp/v.db", "none", "qdrant://h:6333"):
        cfg.database.vector_store = url
        cfg.validate()
    cfg.database.vector_store = "redis://h"
    with pytest.raises(ValueError, match="unsupported store URL"):
        cfg.validate()
    cfg.database.vector_store = ""
    cfg.database.vector_quantization_type = "vq"
    with pytest.raises(ValueError, match="unsupported vector quantization"):
        cfg.validate()
