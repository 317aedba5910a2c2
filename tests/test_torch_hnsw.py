"""The port's native HNSW index (gorse_tpu_torch/native/hnsw.py over
hnsw.cpp) and the ``hnsw://`` store (storage/vectors.py
``HNSWVectorStore``) against gorse_tpu's.

hnsw.cpp draws its levels from a seeded ``std::mt19937_64`` in one thread,
so with the same source, flags and insertion order the port's graph is the
reference's: labels and distances are held exactly, not by recall, on the
same rows made from a seed with numpy, through batched adds, deletes,
upserts and several ``ef``. An index saved by either package loads in the
other. The exact fallback (no ``g++``) is held the same way; a worker
that lost the reference's build race loads its library again first
(``reference_native``, tests/test_torch_native.py). The store:
the same calls give the same lists, quantization is refused with the
reference's text, cosine rows are normalised, scores are ``-distance``.
Needs ``g++``."""

import numpy as np
import pytest
from test_torch_native import reference_native  # noqa: F401 - autouse

import gorse_tpu.native.hnsw as RH
import gorse_tpu.storage.vectors as RV
import gorse_tpu_torch.native.hnsw as PH
from gorse_tpu_torch.storage import vectors as PV

DIM = 16
PACKAGES = {"port": PH, "ref": RH}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    return (rng.normal(size=(3000, DIM)).astype(np.float32),
            rng.normal(size=(64, DIM)).astype(np.float32))


def test_both_build_natively():
    assert PH.native_available() and RH.native_available()


def _run(mod, space, vecs, queries, m=16, efc=200, seed=0):
    """Adds in three batches, deletes, an upsert, then searches at several
    k and ef: everything the index returned."""
    ix = mod.HNSWIndex(DIM, space=space, m=m, ef_construction=efc, seed=seed)
    out = []
    for lo, hi in ((0, 1000), (1000, 1100), (1100, len(vecs))):
        ix.add(np.arange(lo, hi, dtype=np.int64), vecs[lo:hi])
        out.append(ix.search(queries, 10, ef=50))
    for lab in range(0, 300, 7):
        out.append(ix.mark_deleted(lab))
    out.append(ix.mark_deleted(10**6))
    ix.add(np.asarray([14, 21], dtype=np.int64), vecs[[5, 6]])  # undelete, new vectors
    for k, ef in ((1, 0), (10, 0), (10, 100), (50, 60)):
        out.append(ix.search(queries, k, ef=ef))
    out.append(len(ix))
    return ix, out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert np.array_equal(g[0], w[0]), "labels"
            assert g[1].dtype == w[1].dtype and np.array_equal(g[1], w[1]), "distances"
        else:
            assert g == w


@pytest.mark.parametrize("space,m,efc,seed", [("ip", 16, 200, 0), ("l2", 8, 64, 3),
                                              ("cosine", 12, 100, 7)])
def test_index_is_the_reference_exactly(corpus, space, m, efc, seed):
    vecs, queries = corpus
    _, got = _run(PH, space, vecs, queries, m, efc, seed)
    _, want = _run(RH, space, vecs, queries, m, efc, seed)
    _same(got, want)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_saved_index_loads_in_the_other_package(tmp_path, corpus, writer, reader):
    vecs, queries = corpus
    ix, _ = _run(PACKAGES[writer], "ip", vecs, queries)
    path = tmp_path / "ix.bin"
    ix.save(path)
    loaded = PACKAGES[reader].HNSWIndex.load(path, DIM, "ip")
    assert len(loaded) == len(ix)
    _same([loaded.search(queries, 10, ef=80)], [ix.search(queries, 10, ef=80)])
    # both go on growing the same graph from the file
    more = np.random.default_rng(1).normal(size=(200, DIM)).astype(np.float32)
    again = PACKAGES[writer].HNSWIndex.load(path, DIM, "ip")
    for index in (loaded, again):
        index.add(np.arange(5000, 5200, dtype=np.int64), more)
    _same([loaded.search(queries, 20)], [again.search(queries, 20)])


def test_saved_files_are_the_reference_bytes(tmp_path, corpus):
    vecs, queries = corpus
    for name, mod in PACKAGES.items():
        ix, _ = _run(mod, "l2", vecs, queries)
        ix.save(tmp_path / f"{name}.bin")
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()


@pytest.mark.parametrize("space", ["ip", "l2", "cosine"])
def test_fallback_is_the_reference(monkeypatch, corpus, space):
    """Without g++ both packages search exactly, by numpy brute force."""
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    vecs, queries = corpus
    _, got = _run(PH, space, vecs[:1500], queries)
    _, want = _run(RH, space, vecs[:1500], queries)
    _same(got, want)


def test_recall_against_brute_force(corpus):
    """tests/test_hnsw.py's floor: recall@10 at least 0.9."""
    vecs, queries = corpus
    ix = PH.HNSWIndex(DIM, space="ip")
    ix.add(np.arange(len(vecs), dtype=np.int64), vecs)
    got, _ = ix.search(queries, 10, ef=100)
    ref = np.argsort(-(queries @ vecs.T), axis=1)[:, :10]
    assert np.mean([len(set(got[i]) & set(ref[i])) / 10 for i in range(len(queries))]) >= 0.9


# ------------------------------------------------------------------ the store


def _store_calls(store, vecs, queries, distance):
    out = []
    store.create_collection("c", DIM, distance=distance)
    store.create_collection("c", DIM, distance=distance)  # idempotent
    ids = [f"item{n}" for n in range(len(vecs))]
    store.add("c", ids[:800], vecs[:800])
    out.append(store.query("c", queries, 10))
    store.add("c", ids[800:], vecs[800:])
    store.add("c", ids[:5], vecs[5:10])  # upsert: labels kept, vectors new
    store.delete("c", ids[10:40])
    out.append(store.query("c", queries, 10))
    out.append(store.query("c", queries[0], 3))
    out.append(store.describe_collection("c"))
    out.append(sorted(store.list_collections()))
    store.drop_collection("c")
    out.append(store.has_collection("c"))
    return [[[(s.id, s.score) for s in hits] for hits in o] if isinstance(o, list) and o
            and isinstance(o[0], list) else o for o in out]


@pytest.mark.parametrize("distance", ["dot", "cosine", "euclidean"])
def test_store_is_the_reference(corpus, distance):
    vecs, queries = corpus
    got = _store_calls(PV.open_vector_store("hnsw://", device="cpu"), vecs[:1500], queries,
                       distance)
    want = _store_calls(RV.open_vector_store("hnsw://"), vecs[:1500], queries, distance)
    assert got == want


def test_store_scores_and_refusals():
    """Cosine rows are normalised before they are added, scores are
    ``-distance``, and quantization is refused with the reference's text."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(50, DIM)).astype(np.float32) * 10
    q = rng.normal(size=(2, DIM)).astype(np.float32)
    store = PV.HNSWVectorStore(device="cpu")
    store.create_collection("cos", DIM, distance="cosine")
    store.add("cos", [str(n) for n in range(50)], rows)
    hits = store.query("cos", q, 5)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    for b in range(2):
        for s in hits[b]:
            assert abs(s.score - float(qn[b] @ unit[int(s.id)])) < 1e-5
    messages = []
    for cls in (PV.HNSWVectorStore, RV.HNSWVectorStore):
        with pytest.raises(ValueError) as caught:
            (cls(device="cpu") if cls is PV.HNSWVectorStore else cls()).create_collection(
                "q", 8, quantization="sq", bits=8)
        messages.append(str(caught.value))
    assert messages[0] == messages[1] == "HNSW store does not support quantization"
