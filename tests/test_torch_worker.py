"""The serving slice as a whole: one index saved by gorse_tpu, the same
memory-store contents, then gorse_tpu's Worker.recommend and RestServer
against the port's.

On the CPU the reference takes its f32 route (gorse_tpu/logics/cf.py:120)
and the port its kernel route (bf16, plain versions). The factors are small
integers, exact in bf16, so both routes give the same scores and ids, ties
included: cache entries must be equal (ids exact, scores to tolerance 0),
digests equal, and /api/recommend answers equal.
"""

import numpy as np
import pytest

from gorse_tpu.data.dict import FreqDict as RefFreqDict
from gorse_tpu.logics.cf import MatrixFactorizationIndex as RefIndex
from gorse_tpu.serve.rest import RestServer as RefRestServer
from gorse_tpu.serve.worker import Worker as RefWorker
from gorse_tpu.storage import cache as ref_ck
from gorse_tpu.storage.blob import BlobStore as RefBlobStore
from gorse_tpu.storage.cache import MemoryCacheStore as RefCache
from gorse_tpu.storage.data import MemoryDataStore as RefData
from gorse_tpu.storage import types as ref_types
from gorse_tpu.utils.config import Config as RefConfig
from gorse_tpu_torch.ops import topk as port_topk
from gorse_tpu_torch.serve.rest import RestServer
from gorse_tpu_torch.serve.worker import Worker
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore
from gorse_tpu_torch.utils.config import Config

N_USERS, N_ITEMS, DIM = 60, 400, 8
MODEL_ID = "1000"


def _configure(cfg):
    cfg.recommend.cache_size = 30
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.collaborative.type = "mf"
    return cfg


def _fill(data, t):
    """The same users, items and feedback, through either package's types."""
    rng = np.random.default_rng(0)
    data.insert_items(
        t.Item(f"i{i}", categories=[f"c{i % 3}"], timestamp=1000.0 + i) for i in range(N_ITEMS)
    )
    data.insert_users(t.User(f"u{u}") for u in range(N_USERS + 2))  # two unknown to the index
    feedback = []
    for u in range(N_USERS):
        for j in rng.choice(N_ITEMS, size=int(rng.integers(0, 40)), replace=False):
            kind = "like" if j % 2 else "read"
            feedback.append(t.Feedback(kind, f"u{u}", f"i{j}", 1.0, 500.0 + j))
    data.insert_feedback(feedback)


@pytest.fixture
def stacks(tmp_path):
    rng = np.random.default_rng(1)
    uf = rng.integers(-3, 4, size=(N_USERS, DIM)).astype(np.float32)
    itf = rng.integers(-3, 4, size=(N_ITEMS, DIM)).astype(np.float32)
    users, items = RefFreqDict(), RefFreqDict()
    for u in range(N_USERS):
        users.add(f"u{u}")
    for i in range(N_ITEMS):
        items.add(f"i{i}")
    item_pred = np.ones(N_ITEMS, bool)
    item_pred[::17] = False
    RefIndex(uf, itf, users, items, [[f"c{i % 3}"] for i in range(N_ITEMS)], 5.0,
             item_predictable=item_pred).save(RefBlobStore(tmp_path / "blobs").create(MODEL_ID))

    ref_data, ref_cache = RefData(), RefCache()
    _fill(ref_data, ref_types)
    ref_cfg = _configure(RefConfig())
    ref_worker = RefWorker(ref_cfg, ref_data, ref_cache, RefBlobStore(tmp_path / "blobs"))

    data, cache = MemoryDataStore(), MemoryCacheStore()
    _fill(data, types)
    cfg = _configure(Config())
    worker = Worker(cfg, data, cache, BlobStore(tmp_path / "blobs"), device="cpu")

    for w in (ref_worker, worker):
        w.pull_models(MODEL_ID, "")
    users = [f"u{u}" for u in range(N_USERS + 2)]
    uses = port_topk.dot_topk_xla.uses
    assert ref_worker.recommend(users) == worker.recommend(users) == len(users)
    assert port_topk.dot_topk_xla.uses == uses  # the port stayed on the kernel route
    return (
        (ref_cfg, ref_data, ref_cache, ref_worker),
        (cfg, data, cache, worker),
        users,
    )


def _entries(cache, collection, user):
    return [(s.id, s.score, s.categories) for s in cache.search_scores(collection, user)]


@pytest.mark.parametrize("collection", ["collaborative", "recommend"])
def test_worker_cache_matches_reference(stacks, collection):
    (_, _, ref_cache, _), (_, _, cache, _), users = stacks
    name = {"collaborative": ck.COLLABORATIVE, "recommend": ck.RECOMMEND}[collection]
    assert name == {"collaborative": ref_ck.COLLABORATIVE, "recommend": ref_ck.RECOMMEND}[collection]
    filled = 0
    for u in users:
        want = _entries(ref_cache, name, u)
        assert _entries(cache, name, u) == want
        filled += bool(want)
    assert filled >= N_USERS - 2  # most users got a list


def test_worker_digests_match_reference(stacks):
    (ref_cfg, _, ref_cache, _), (cfg, _, cache, _), users = stacks
    assert cfg.recommend.hash() == ref_cfg.recommend.hash()
    for u in users:
        for k in (ck.RECOMMEND_DIGEST, ck.COLLABORATIVE_DIGEST):
            assert cache.get(ck.key(k, u)) == ref_cache.get(ref_ck.key(k, u))
    # a second pass refreshes, in both packages, only the users whose list
    # came out empty (the two users the index does not know)
    (_, _, _, ref_worker), (_, _, _, worker), _ = stacks
    stale = sum(not cache.search_scores(ck.RECOMMEND, u) for u in users)
    assert stale == 2
    assert worker.recommend(users) == ref_worker.recommend(users) == stale


@pytest.mark.parametrize("path, query", [
    ("/api/recommend/u3", {}),
    ("/api/recommend/u11", {"n": "25", "offset": "3"}),
    ("/api/recommend/u7/c1", {}),
    ("/api/recommend/u61", {}),  # no CF list: the fallback chain
    ("/api/recommend/nobody", {}),
    ("/api/health/ready", {}),
])
def test_rest_recommend_matches_reference(stacks, path, query):
    (ref_cfg, ref_data, ref_cache, _), (cfg, data, cache, _), _ = stacks
    want = RefRestServer(ref_cfg, ref_data, ref_cache).dispatch("GET", path, dict(query), None, {})
    got = RestServer(cfg, data, cache).dispatch("GET", path, dict(query), None, {})
    assert got == want
    assert got[0] == 200


def test_rest_recommend_over_http(stacks):
    """The threaded front-end answers with the cache's order."""
    import json
    import urllib.request

    _, (cfg, data, cache, _), _ = stacks
    server = RestServer(cfg, data, cache)
    httpd = server.serve("127.0.0.1", 0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/recommend/u3?n=5", timeout=10) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
    assert body == [s.id for s in cache.search_scores(ck.COLLABORATIVE, "u3")][:5]


def _fields(obj):
    """Dataclass fields as plain values, recursively."""
    import dataclasses

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("variant", ["default", "collaborative", "sources"])
def test_config_defaults_and_digest_match_reference(variant):
    """Every field the port keeps has the reference's default, and
    RecommendConfig.hash() (the digest the worker writes to the cache) is
    equal for the same settings."""
    import dataclasses

    from gorse_tpu.utils import config as ref_config
    from gorse_tpu_torch.utils import config as port_config

    def check(port_obj, ref_obj):
        if dataclasses.is_dataclass(port_obj):
            for name, value in _fields(port_obj).items():
                check(value, getattr(ref_obj, name))
        elif isinstance(port_obj, list):
            assert len(port_obj) == len(ref_obj)
            for p, r in zip(port_obj, ref_obj):
                check(p, r)
        else:
            assert port_obj == ref_obj

    cfgs = []
    for mod in (port_config, ref_config):
        cfg = mod.Config()
        if variant == "collaborative":
            _configure(cfg)
        elif variant == "sources":
            rc = cfg.recommend
            rc.non_personalized = [mod.NonPersonalizedConfigEntry("popular")]
            rc.item_to_item = [mod.ItemToItemConfigEntry("similar", type="users")]
            rc.user_to_user = [mod.UserToUserConfigEntry("neighbors", type="items")]
            rc.data_source.negative_feedback_types = ["dislike"]
            rc.ranker.recommenders = [
                "collaborative", "non-personalized/popular", "item-to-item/similar",
                "user-to-user/neighbors",
            ]
        cfgs.append(cfg)
    port_cfg, ref_cfg = cfgs
    check(port_cfg.server, ref_cfg.server)
    check(port_cfg.recommend, ref_cfg.recommend)
    assert port_cfg.recommend.hash() == ref_cfg.recommend.hash()


@pytest.mark.parametrize("part", ["llm_ranker", "external_source"])
def test_unported_parts_raise(part, tmp_path):
    """What the slice does not port yet raises NotImplementedError naming its
    ROADMAP item, instead of serving something else."""
    from gorse_tpu_torch.logics.recommend import Recommender

    cfg = _configure(Config())
    data, cache = MemoryDataStore(), MemoryCacheStore()
    worker = Worker(cfg, data, cache, BlobStore(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if part == "external_source":
            Recommender(cfg.recommend, cache, data, online=True, user_id="u0").parse("external/x")
        else:
            cfg.recommend.ranker.type = part.split("_")[0]
            worker._rank({"u0": []})


# ------------------------------------------------------------ the fm ranker

FM_MODEL_ID = "2000"
FM_TOL = 1e-5  # logits of |x| < 10 summed in another order


def _save_ref_afm(blob_root, users, items, user_labels, item_labels, num_dimension, seed=0):
    """A reference AFM over these ids (random parameters, wide enough to
    spread the logits), saved as blob FM_MODEL_ID."""
    from gorse_tpu.data.dict import Index as RefIndex_
    from gorse_tpu.data.unified_index import UnifiedIndex as RefUnified
    from gorse_tpu.models.fm import AFM as RefAFM

    dicts = []
    for names in (users, items, user_labels, item_labels):
        d = RefIndex_()
        for name in names:
            d.add(name)
        dicts.append(d)
    model = RefAFM({"n_factors": 4, "init_stddev": 0.7})
    model.index = RefUnified(*dicts)
    model.num_dimension = num_dimension
    model.model_params = model._init_params(len(model.index), [], seed)
    model.save(RefBlobStore(blob_root).create(FM_MODEL_ID))


def _assert_ranked(got: list, want: list, what: str):
    """Tie-aware: the same candidates and scores within FM_TOL; ids equal
    wherever the reference's neighbouring scores are more than 2 FM_TOL
    apart."""
    assert sorted(s.id for s in got) == sorted(s.id for s in want), what
    ws = np.array([s.score for s in want])
    by_id = {s.id: s.score for s in got}
    np.testing.assert_allclose([by_id[s.id] for s in want], ws, rtol=0, atol=FM_TOL)
    assert all(a.score >= b.score for a, b in zip(got, got[1:])), what
    gap = np.full(len(ws), np.inf)
    if len(ws) > 1:
        d = np.abs(np.diff(ws))
        gap[:-1] = d
        gap[1:] = np.minimum(gap[1:], d)
    for pos in np.flatnonzero(gap > 2 * FM_TOL):
        assert got[pos].id == want[pos].id, (what, pos)


def _labelled_stores(t):
    """Users with 0-2 labels (one unknown to the model), items with 1-3
    labels in two fields, from a seed; either package's types."""
    rng = np.random.default_rng(5)
    data = RefData() if t is ref_types else MemoryDataStore()
    data.insert_users(t.User(f"u{u}", labels=[f"g{g}" for g in range(u % 3)] + (["new"] if u == 4
                                                                                 else []))
                      for u in range(40))
    data.insert_items(t.Item(f"i{i}", categories=[f"c{i % 3}"],
                             labels={"tag": [f"t{x}" for x in rng.choice(6, 1 + i % 2, False)],
                                     "genre": [f"x{i % 4}"] if i % 3 == 0 else []})
                      for i in range(120))
    return data


def test_fm_ranking_is_the_reference(tmp_path):
    """``_rank`` with ``ranker.type = "fm"`` on the same saved model and
    candidates: every user's ranking, tie-aware. Some users, items and
    labels are unknown to the model, and some rows exceed its
    ``num_dimension`` (6 features against 5): they are cut as the
    reference cuts them."""
    from gorse_tpu_torch.logics.item_to_item import _flatten_labels

    blobs = tmp_path / "blobs"
    stores = {}
    for t in (types, ref_types):
        stores[t] = _labelled_stores(t)
    port_data = stores[types]
    item_labels = sorted({label for item in port_data.get_items()
                          for label in _flatten_labels(item.labels)})
    _save_ref_afm(blobs, [f"u{u}" for u in range(36)], [f"i{i}" for i in range(110)],
                  ["g0", "g1"], item_labels, num_dimension=5)
    rng = np.random.default_rng(9)
    picks = {f"u{u}": rng.choice(130, size=int(rng.integers(0, 50)), replace=False)
             for u in list(range(40)) + [77]}
    ranked = []
    for t, worker_cls, cache_cls, blob_cls, cfg in (
        (types, Worker, MemoryCacheStore, BlobStore, Config()),
        (ref_types, RefWorker, RefCache, RefBlobStore, RefConfig()),
    ):
        cfg.recommend.ranker.type = "fm"
        kw = {"device": "cpu"} if t is types else {}
        worker = worker_cls(cfg, stores[t], cache_cls(), blob_cls(blobs), **kw)
        worker.pull_models("", FM_MODEL_ID)
        assert worker.ctr_model_id == FM_MODEL_ID and worker.ctr_model.is_fitted()
        candidates = {u: [t.Score(f"i{j}", float(j % 7), [f"c{j % 3}"], 5.0) for j in js]
                      for u, js in picks.items()}
        ranked.append(worker._rank(candidates))
    got, want = ranked
    assert list(got) == list(want)
    for user in want:
        _assert_ranked(got[user], want[user], user)
        assert all(s.timestamp == 5.0 and s.categories == [f"c{int(s.id[1:]) % 3}"]
                   for s in got[user])
    assert sum(len(v) for v in got.values()) > 500


def test_fm_without_a_model_sorts_the_candidates(tmp_path):
    cfg = _configure(Config())
    cfg.recommend.ranker.type = "fm"
    worker = Worker(cfg, MemoryDataStore(), MemoryCacheStore(), BlobStore(tmp_path), device="cpu")
    worker.pull_models("", "missing")  # no such blob: nothing pulled
    assert worker.ctr_model is None
    scores = [types.Score(f"i{j}", s) for j, s in enumerate([0.5, 2.0, -1.0, 2.0])]
    assert [s.id for s in worker._rank({"u0": scores})["u0"]] == ["i1", "i3", "i0", "i2"]


def test_fm_recommend_caches_match_reference(stacks, tmp_path):
    """The whole worker pass with the fm ranker over the CF candidates (the
    slice as a whole): every user's ``recommend`` cache, tie-aware."""
    (ref_cfg, ref_data, ref_cache, ref_worker), (cfg, data, cache, worker), users = stacks
    _save_ref_afm(tmp_path / "blobs", [f"u{u}" for u in range(N_USERS)],
                  [f"i{i}" for i in range(N_ITEMS)], [], [], num_dimension=2, seed=3)
    for c, w in ((ref_cfg, ref_worker), (cfg, worker)):
        c.recommend.ranker.type = "fm"
        w.blob = (RefBlobStore if w is ref_worker else BlobStore)(tmp_path / "blobs")
        w.pull_models("", FM_MODEL_ID)
        assert w.recommend(users, force=True) == len(users)
    for uid in users:
        got, want = (c.search_scores(ck.RECOMMEND, uid) for c in (cache, ref_cache))
        _assert_ranked(got, want, uid)
    assert worker.ctr_model.device.type == "cpu"


def test_gc_paused_restores_the_collector():
    import gc

    from gorse_tpu_torch.utils.gcpause import gc_paused

    assert gc.isenabled()
    with pytest.raises(RuntimeError):
        with gc_paused():
            assert not gc.isenabled()
            with gc_paused():
                assert not gc.isenabled()
            assert not gc.isenabled()  # the inner block leaves it paused
            raise RuntimeError
    assert gc.isenabled()
