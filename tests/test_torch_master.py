"""The training half of the main path as a whole: the same feedback rows in
both packages' memory stores, gorse_tpu's Master against the port's
(``load_dataset`` + ``train_collaborative_filtering``), then the port's
Worker serving the port master's index.

Under tests/conftest.py the reference Master trains on the 8-device CPU
mesh, so its BPR is the user-sharded XLA epoch with the same counter sampler
and key stream as the port's; the port's BPR is given the reference's init
factors. Datasets, gauges, global-meta keys and time series must be equal;
factors agree to rtol 1e-4 / atol 1e-6 and the score to 1e-3 (summation
order only, as in tests/test_torch_bpr.py). The worker's lists must equal
the reference index's bf16 kernel route (``search_users(use_pallas=True,
interpret=True)``) on the port's saved index: ids exact, scores to 1e-6
(the two sum the same bf16 products in another order).

The vector-store sync: both masters' indexes built from the same numpy
factors, then ``_sync_cf_vectors`` into each package's memory store. The
collections must hold the same ids, codes, scales and mins; queries agree
within tests/test_torch_vectors.py's tolerance (the kernel route: above
1,024 predictable items); a quantization or bits change recreates the
collection and an unchanged config does not.
"""

import json
import re

import numpy as np
import pytest
from test_torch_vectors import _assert_lists, _magnitudes

import gorse_tpu.storage.vectors as RV
from gorse_tpu.data.dict import FreqDict as RefFreqDict
from gorse_tpu.logics.cf import MatrixFactorizationIndex as RefIndex
from gorse_tpu.models.bpr import BPR as RefBPR
from gorse_tpu.serve.master import Master as RefMaster
from gorse_tpu.storage import cache as ref_ck
from gorse_tpu.storage import types as ref_types
from gorse_tpu.storage.blob import BlobStore as RefBlobStore
from gorse_tpu.storage.cache import MemoryCacheStore as RefCache
from gorse_tpu.storage.data import MemoryDataStore as RefData
from gorse_tpu.storage.meta import MetaStore as RefMeta
from gorse_tpu.utils.config import Config as RefConfig
from gorse_tpu_torch.data.loaders import synthetic_cf
from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex
from gorse_tpu_torch.models import bpr as port_bpr
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.serve.worker import Worker
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore
from gorse_tpu_torch.storage.meta import (
    CLICK_THROUGH_RATE_MODEL,
    COLLABORATIVE_FILTERING_MODEL,
    MetaStore,
)
from gorse_tpu_torch.storage.vectors import MemoryVectorStore
from gorse_tpu_torch.utils.config import Config

N_USERS, N_ITEMS, EPOCHS = 90, 70, 5
GAUGES = (
    "master_users_total", "master_items_total", "master_user_labels_total",
    "master_item_labels_total", "master_feedbacks_total", "master_positive_feedbacks_total",
    "master_negative_feedbacks_total", "master_implicit_feedbacks_total",
    "master_active_users_total", "master_inactive_users_total", "master_active_items_total",
    "master_inactive_items_total",
)
META_KEYS = ("num_users", "num_items", "num_user_labels", "num_item_labels",
             "num_total_pos_feedbacks", "num_valid_pos_feedbacks", "num_valid_neg_feedbacks")
SERIES = ("num_users", "num_items", "num_feedback", "num_pos_feedbacks", "num_neg_feedbacks")


def _configure(cfg):
    cfg.recommend.cache_size = 20
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.collaborative.fit_epoch = EPOCHS
    cfg.recommend.ranker.recommenders = ["collaborative"]
    return cfg


def _fill(data, t):
    """Likes from a low-rank synthetic set, some reads and a duplicate
    like, labelled items and users, two users and an item without
    feedback; the same rows through either package's types."""
    ds = synthetic_cf(N_USERS, N_ITEMS, 4, 0.15, seed=4)
    data.insert_items(t.Item(f"i{i}", categories=[f"c{i % 3}"], labels={"tag": [f"t{i % 5}"]})
                      for i in range(N_ITEMS + 1))
    data.insert_users(t.User(f"u{u}", labels=[f"g{u % 2}"]) for u in range(N_USERS + 2))
    rows = []
    for u, (fb, stamps) in enumerate(zip(ds.user_feedback, ds.timestamps)):
        for i, ts in zip(fb, stamps):
            rows.append(t.Feedback("like", f"u{u}", f"i{i}", 1.0, ts))
        rows.append(t.Feedback("read", f"u{u}", f"i{(u * 7) % N_ITEMS}", 1.0, 5.0))
    data.insert_feedback(rows)


def _gauges(registry) -> dict:
    text = registry.render()
    return {name: float(re.search(rf"^\w+_{name} (\S+)$", text, re.M).group(1))
            for name in GAUGES}


@pytest.fixture(scope="module")
def masters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("masters")
    ref_data, ref_cache = RefData(), RefCache()
    _fill(ref_data, ref_types)
    ref = RefMaster(_configure(RefConfig()), ref_data, ref_cache,
                    RefBlobStore(tmp / "ref_blobs"), RefMeta(), vector_store=RV.MemoryVectorStore())
    ref_loaded = ref.load_dataset()
    ref.train_collaborative_filtering(ref_loaded)
    ref_init = RefBPR({})
    ref_init.init(ref_loaded.train, seed=0)
    factors = (np.asarray(ref_init.user_factors), np.asarray(ref_init.item_factors))

    data, cache = MemoryDataStore(), MemoryCacheStore()
    _fill(data, types)
    port = Master(_configure(Config()), data, cache, BlobStore(tmp / "blobs"), MetaStore(),
                  device="cpu", vector_store=MemoryVectorStore(device="cpu"))
    mp = pytest.MonkeyPatch()
    init = port_bpr.BPR.init
    mp.setattr(port_bpr.BPR, "init",
               lambda self, train, seed=0, factors_=None: init(self, train, seed, factors))
    loaded = port.load_dataset()
    port.train_collaborative_filtering(loaded)
    mp.undo()
    return ref, ref_loaded, port, loaded


def test_load_dataset_is_the_reference(masters):
    ref, ref_loaded, port, loaded = masters
    for a, b in ((loaded.dataset, ref_loaded.dataset), (loaded.train, ref_loaded.train),
                 (loaded.test, ref_loaded.test)):
        assert a.user_dict.to_dict() == b.user_dict.to_dict()
        assert a.item_dict.to_dict() == b.item_dict.to_dict()
        assert a.user_label_dict.to_dict() == b.user_label_dict.to_dict()
        assert a.item_label_dict.to_dict() == b.item_label_dict.to_dict()
        assert a.user_feedback == b.user_feedback and a.timestamps == b.timestamps
    assert loaded.item_categories == ref_loaded.item_categories
    # the CTR rows (the positive edges' set order, then the sampled
    # negatives): equal in one process from the same insertion order
    assert loaded.ctr.index.to_dict() == ref_loaded.ctr.index.to_dict()
    assert loaded.ctr.features == ref_loaded.ctr.features
    assert loaded.ctr.targets == ref_loaded.ctr.targets
    assert loaded.ctr.users == ref_loaded.ctr.users
    assert 0 < loaded.ctr.count_negative() <= loaded.ctr.count_positive()
    assert max(len(f[0]) for f in loaded.ctr.features) == 4  # user, item, a label each
    step = re.search(r'^\w+_master_load_dataset_step_seconds\{step="create_ranking_dataset"\} (\S+)$',
                     port.metrics.render(), re.M)
    assert step and float(step.group(1)) > 0
    assert _gauges(port.metrics) == _gauges(ref.metrics)
    for name in META_KEYS:
        k = ck.key(ck.GLOBAL_META, name)
        assert port.cache.get(k) == ref.cache.get(ref_ck.key(ref_ck.GLOBAL_META, name)), name
    for name in SERIES:
        got = [p.value for p in port.cache.get_time_series_points(name, 0, 1e12)]
        want = [p.value for p in ref.cache.get_time_series_points(name, 0, 1e12)]
        assert got == want, name


def test_trained_model_is_the_reference(masters):
    ref, _, port, _ = masters
    assert port.meta.get(COLLABORATIVE_FILTERING_MODEL) and ref.meta.get(COLLABORATIVE_FILTERING_MODEL)
    assert port.blob.exists(port.meta.get(COLLABORATIVE_FILTERING_MODEL))
    meta, ref_meta = (json.loads(m.meta.get("CF_MODEL_META")) for m in (port, ref))
    assert (meta["type"], meta["params"]) == (ref_meta["type"], ref_meta["params"]) == ("bpr", {})
    assert abs(meta["score"] - ref_meta["score"]) <= 1e-3
    for name in ("cf_ndcg", "cf_precision", "cf_recall"):
        (got,), (want,) = (c.get_time_series_points(name, 0, 1e12) for c in (port.cache, ref.cache))
        assert abs(got.value - want.value) <= 1e-3, name
    np.testing.assert_allclose(port.cf_index.user_factors.numpy(),
                               np.asarray(ref.cf_index.user_factors), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.cf_index.item_factors.numpy(),
                               np.asarray(ref.cf_index.item_factors), rtol=1e-4, atol=1e-6)
    assert np.array_equal(port.cf_index.user_predictable, ref.cf_index.user_predictable)
    assert np.array_equal(port.cf_index.item_predictable, ref.cf_index.item_predictable)
    assert port.cf_index.item_categories == ref.cf_index.item_categories
    assert port.cache.get(ck.LAST_FIT_MATCHING_MODEL_TIME)
    fit_s = re.search(r"^\w+_master_collaborative_filtering_fit_seconds (\S+)$",
                      port.metrics.render(), re.M)
    assert float(fit_s.group(1)) > 0


def test_worker_serves_the_trained_index(masters):
    """get_meta -> Worker.sync_and_recommend: every user's collaborative
    list, equal to the reference's bf16 kernel route on the same index."""
    _, _, port, _ = masters
    meta = port.get_meta()
    assert set(meta) == {"config", "cf_model_id", "ctr_model_id", "servers", "workers"}
    assert json.loads(meta["config"])["recommend"]["collaborative"]["fit_epoch"] == EPOCHS
    worker = Worker(port.config, port.data, port.cache, port.blob, device="cpu")
    assert worker.sync_and_recommend(meta) == N_USERS + 2
    assert worker.cf_model_id == meta["cf_model_id"]

    ref_index = RefIndex.load(port.blob.open(meta["cf_model_id"]))
    users = [f"u{u}" for u in range(N_USERS + 2)]
    exclude = [[fb.item_id for fb in port.data.get_user_feedback(u)] for u in users]
    want = ref_index.search_users(users, port.config.recommend.cache_size, exclude,
                                  use_pallas=True, interpret=True)
    served = 0
    for uid, ref_scores in zip(users, want):
        got = port.cache.search_scores(ck.COLLABORATIVE, uid)
        assert [s.id for s in got] == [s.id for s in ref_scores], uid
        np.testing.assert_allclose([s.score for s in got], [s.score for s in ref_scores],
                                   rtol=1e-6, atol=1e-6)
        served += bool(got)
    assert served == N_USERS  # the two users without feedback get no list


def test_master_resumes_the_index_from_meta(masters):
    _, _, port, _ = masters
    again = Master(port.config, port.data, port.cache, port.blob, port.meta, device="cpu")
    assert again.cf_index is not None
    assert np.array_equal(again.cf_index.item_factors.numpy(), port.cf_index.item_factors.numpy())
    assert again.training_mesh() is None


def test_fit_syncs_the_vector_store(masters):
    """train_collaborative_filtering keeps the model and upserts the
    predictable items into the CF collection, as the reference does."""
    ref, _, port, _ = masters
    assert np.array_equal(port.cf_model.item_factors.numpy(), port.cf_index.item_factors.numpy())
    name = Master.CF_COLLECTION
    assert name == RefMaster.CF_COLLECTION
    assert port.vectors.describe_collection(name) == ref.vectors.describe_collection(name)
    ids, _ = port.cf_index.serving_items()
    assert list(port.vectors._collections[name].rows) == ids
    assert list(ref.vectors._collections[name].rows) == ids
    assert json.loads(port.meta.get("cf_vector_config")) == {"quantization": "", "bits": 0}


N_VEC_ITEMS, VEC_DIM = 1200, 8


def _vector_masters(tmp, quantization, bits):
    """Both masters with an index from the same numpy factors (every 7th
    item unpredictable: 1,028 serving rows) and an empty memory store."""
    rng = np.random.default_rng(21)
    uf = rng.normal(size=(6, VEC_DIM)).astype(np.float32)
    itf = rng.normal(size=(N_VEC_ITEMS, VEC_DIM)).astype(np.float32)
    itf[10] = itf[3]  # a duplicate item
    pred = np.ones(N_VEC_ITEMS, bool)
    pred[::7] = False
    users = {"names": [f"u{u}" for u in range(6)], "freqs": [1] * 6}
    items = {"names": [f"i{i}" for i in range(N_VEC_ITEMS)], "freqs": [1] * N_VEC_ITEMS}
    ref_cfg, cfg = RefConfig(), Config()
    for c in (ref_cfg, cfg):
        c.database.vector_quantization_type = quantization
        c.database.vector_quantization_bits = bits
    ref = RefMaster(ref_cfg, RefData(), RefCache(), RefBlobStore(tmp / "rb"), RefMeta(),
                    vector_store=RV.MemoryVectorStore())
    ref.cf_index = RefIndex(uf, itf, RefFreqDict.from_dict(users), RefFreqDict.from_dict(items),
                            item_predictable=pred)
    port = Master(cfg, MemoryDataStore(), MemoryCacheStore(), BlobStore(tmp / "pb"), MetaStore(),
                  device="cpu", vector_store=MemoryVectorStore(device="cpu"))
    port.cf_index = MatrixFactorizationIndex.from_numpy(uf, itf, users, items,
                                                        item_predictable=pred, device="cpu")
    return ref, port, itf


@pytest.mark.parametrize("quantization,bits", [("sq", 0), ("", 0), ("pq", 4), ("rq", 2)])
def test_sync_cf_vectors_is_the_reference(tmp_path, monkeypatch, quantization, bits):
    monkeypatch.setattr(RV, "_device_serving_enabled", lambda n: n >= 1024)
    ref, port, itf = _vector_masters(tmp_path, quantization, bits)
    ref._sync_cf_vectors()
    port._sync_cf_vectors()
    name = Master.CF_COLLECTION
    assert port.vectors.describe_collection(name) == ref.vectors.describe_collection(name)
    a, b = port.vectors._collections[name], ref.vectors._collections[name]
    assert list(a.rows) == list(b.rows) and len(a.rows) == 1028
    for vid in b.rows:
        np.testing.assert_array_equal(a.rows[vid], b.rows[vid])
        assert (a.scales.get(vid), a.mins.get(vid), a.norms2[vid]) == (
            b.scales.get(vid), b.mins.get(vid), b.norms2[vid])
    q = itf[1:17] * 1.5  # 16 items' factors
    got = port.vectors.query(name, q, 10)
    want = ref.vectors.query(name, q, 11)
    mag, ids = _magnitudes(ref.vectors, name, q, kernel=quantization != "")
    _assert_lists(got, want, 10, mag, ids)
    if quantization == "sq":
        assert a.encoded["kind"] == "sq" and a.encoded["prepared"].n_items == 1028


def test_sync_cf_vectors_recreates_on_config_changes(tmp_path):
    """A quantization or bits-only change recreates the collection (the
    meta record of what it was created with), an unchanged config keeps it,
    and a dimension change recreates it."""
    ref, port, _ = _vector_masters(tmp_path, "sq", 0)
    name = Master.CF_COLLECTION
    for m in (ref, port):
        m.vectors.create_collection(name, 3)  # stale: the wrong dimension
        m._sync_cf_vectors()
    seen = [port.vectors._collections[name]]
    for q, bits in (("sq", 0), ("rq", 2), ("rq", 4), ("rq", 4), ("", 0)):
        for m in (ref, port):
            m.config.database.vector_quantization_type = q
            m.config.database.vector_quantization_bits = bits
            m._sync_cf_vectors()
        assert port.vectors.describe_collection(name) == ref.vectors.describe_collection(name)
        assert port.meta.get("cf_vector_config") == ref.meta.get("cf_vector_config")
        seen.append(port.vectors._collections[name])
    info = port.vectors.describe_collection(name)
    assert (info["dimension"], info["quantization"]) == (VEC_DIM, "")
    # the same collection (upserted) when unchanged, recreated at each change
    assert [a is b for a, b in zip(seen, seen[1:])] == [True, False, False, True, False]


# ------------------------------------------------ the CTR ranker and the cycle

CTR_EPOCHS = 3
STALE_BLOB = "1"  # an old model's blob, older than any new model id


def _meta_keys(store) -> set:
    return {k for (k,) in store._conn.execute("SELECT k FROM kv").fetchall()}


def _cycle_config(cfg, mod):
    """The cycle with every task on: CF, an item-to-item and a
    user-to-user entry, and the fm ranker over the CF candidates."""
    _configure(cfg)
    cfg.recommend.ranker.type = "fm"
    cfg.recommend.ranker.fit_epoch = CTR_EPOCHS
    cfg.recommend.item_to_item = [mod.ItemToItemConfigEntry("similar", type="users")]
    cfg.recommend.user_to_user = [mod.UserToUserConfigEntry("neighbors", type="items")]
    return cfg


def _stale_entries(cache, blob, ck_mod, t):
    """What the cycle's garbage collection must remove: a non-personalized
    entry no longer configured, an item-to-item list of a removed entry and
    one of an unknown item, a CF list of an unknown user (each with its
    digest), and an old model blob; and a CF list of a known user, which
    stays."""
    old = [t.Score("i1", 1.0, [], 1.0)]
    cache.add_scores(ck_mod.NON_PERSONALIZED, "retired", old)
    cache.add_scores(ck_mod.ITEM_TO_ITEM, ck_mod.key("gone", "i1"), old)
    cache.add_scores(ck_mod.ITEM_TO_ITEM, ck_mod.key("similar", "nope"), old)
    cache.set(ck_mod.key(ck_mod.ITEM_TO_ITEM_DIGEST, "similar", "nope"), "x")
    cache.add_scores(ck_mod.COLLABORATIVE, "ghost", old)
    cache.set(ck_mod.key(ck_mod.COLLABORATIVE_DIGEST, "ghost"), "x")
    cache.add_scores(ck_mod.COLLABORATIVE, "u3", old)
    (blob.create(STALE_BLOB) / "x").write_text("old")


@pytest.fixture(scope="module")
def cycles(tmp_path_factory):
    """Both masters' ``run_tasks_once`` on the same rows, the port's BPR
    and AFM from the reference's inits."""
    from gorse_tpu.models.fm import AFM as RefAFM
    from gorse_tpu.utils import config as ref_config
    from gorse_tpu_torch.models import fm as port_fm
    from gorse_tpu_torch.utils import config as port_config

    tmp = tmp_path_factory.mktemp("cycles")
    ref_data, ref_cache = RefData(), RefCache()
    _fill(ref_data, ref_types)
    ref_blob = RefBlobStore(tmp / "ref_blobs")
    _stale_entries(ref_cache, ref_blob, ref_ck, ref_types)
    ref = RefMaster(_cycle_config(RefConfig(), ref_config), ref_data, ref_cache, ref_blob,
                    RefMeta())
    ref_loaded = ref.run_tasks_once()
    ref_init = RefBPR({})
    ref_init.init(ref_loaded.train, seed=0)
    factors = (np.asarray(ref_init.user_factors), np.asarray(ref_init.item_factors))

    def afm_init(self, n_features, dims, seed):
        tree = RefAFM(dict(self.params))._init_params(n_features, dims, seed)
        flat = {k: np.asarray(tree[k]) for k in ("b", "v", "w")}
        return port_fm.afm_params_from_numpy(flat, self.device)

    data, cache = MemoryDataStore(), MemoryCacheStore()
    _fill(data, types)
    blob = BlobStore(tmp / "blobs")
    _stale_entries(cache, blob, ck, types)
    port = Master(_cycle_config(Config(), port_config), data, cache, blob, MetaStore(),
                  device="cpu")
    mp = pytest.MonkeyPatch()
    init = port_bpr.BPR.init
    mp.setattr(port_bpr.BPR, "init",
               lambda self, train, seed=0, factors_=None: init(self, train, seed, factors))
    mp.setattr(port_fm.AFM, "_init_params", afm_init)
    loaded = port.run_tasks_once()
    mp.undo()
    return ref, ref_loaded, port, loaded


def test_ctr_model_is_the_reference(cycles):
    """train_click_through_rate from the reference's init (the reference
    on its 8-device mesh, the port on the CPU): the same model within the
    fit tolerance of tests/test_torch_fm.py, its gauges, series and keys."""
    from test_torch_fm import AUC_TOL, FIT_TOL, _table_share

    ref, _, port, loaded = cycles
    assert port.ctr_model.n_epochs == CTR_EPOCHS and port.ctr_model.is_fitted()
    for name in ("v", "w"):
        share = _table_share(getattr(port.ctr_model.model_params, name),
                             ref.ctr_model.model_params[name])
        assert share <= FIT_TOL, (name, share)
    assert port.ctr_model.index.to_dict() == ref.ctr_model.index.to_dict()
    assert port.ctr_model.num_dimension == ref.ctr_model.num_dimension == 4
    text, ref_text = port.metrics.render(), ref.metrics.render()
    for gauge in ("auc", "precision", "recall"):
        got, want = (float(re.search(rf"^\w+_master_ranking_model_{gauge} (\S+)$", t, re.M)
                           .group(1)) for t in (text, ref_text))
        assert abs(got - want) <= AUC_TOL, gauge
        (p,), (r,) = (c.get_time_series_points(f"ctr_{gauge}", 0, 1e12)
                      for c in (port.cache, ref.cache))
        assert p.value == got and abs(p.value - r.value) <= AUC_TOL
    assert float(re.search(r"^\w+_master_ranking_fit_seconds (\S+)$", text, re.M).group(1)) > 0
    ctr_id = port.meta.get(CLICK_THROUGH_RATE_MODEL)
    assert ctr_id and port.blob.exists(ctr_id)
    assert port.cache.get(ck.LAST_FIT_RANKING_MODEL_TIME)


def test_cycle_fills_the_reference_caches_and_keys(cycles):
    ref, _, port, _ = cycles
    assert _meta_keys(port.meta) == _meta_keys(ref.meta)
    assert {k for k in port.cache._kv if "update_time" not in k and "last_" not in k} == \
           {k for k in ref.cache._kv if "update_time" not in k and "last_" not in k}
    for name in ("popular", "latest"):
        got, want = (c.search_scores(ck.NON_PERSONALIZED, name) for c in (port.cache, ref.cache))
        assert [(s.id, s.score) for s in got] == [(s.id, s.score) for s in want] and got
    for collection in (ck.ITEM_TO_ITEM, ck.USER_TO_USER, ck.COLLABORATIVE):
        subsets = sorted(port.cache.scan_score_subsets(collection))
        assert subsets == sorted(ref.cache.scan_score_subsets(collection)), collection
        if collection == ck.COLLABORATIVE:
            continue
        for subset in subsets:
            got, want = (c.search_scores(collection, subset) for c in (port.cache, ref.cache))
            assert [s.id for s in got] == [s.id for s in want], subset
            np.testing.assert_allclose([s.score for s in got], [s.score for s in want],
                                       rtol=1e-6)
    meta, ref_meta = (json.loads(m.meta.get("CF_MODEL_META")) for m in (port, ref))
    assert (meta["type"], meta["params"]) == (ref_meta["type"], ref_meta["params"])


def test_cycle_collects_the_reference_garbage(cycles):
    ref, _, port, _ = cycles
    live = [port.meta.get(COLLABORATIVE_FILTERING_MODEL), port.meta.get(CLICK_THROUGH_RATE_MODEL)]
    assert port.blob.list() == sorted(live) and len(ref.blob.list()) == 2
    assert STALE_BLOB not in port.blob.list() + ref.blob.list()
    for m, mod in ((port, ck), (ref, ref_ck)):
        def listed(collection):  # subsets with scores left (a pruned subset may stay empty)
            return {x for x in m.cache.scan_score_subsets(collection)
                    if m.cache.search_scores(collection, x)}

        assert "retired" not in listed(mod.NON_PERSONALIZED)
        assert not {"gone/i1", "similar/nope"} & listed(mod.ITEM_TO_ITEM)
        assert m.cache.get(mod.key(mod.ITEM_TO_ITEM_DIGEST, "similar", "nope")) is None
        assert listed(mod.COLLABORATIVE) == {"u3"}
        assert m.cache.get(mod.key(mod.COLLABORATIVE_DIGEST, "ghost")) is None
    for gauge in ("master_cache_scanned_total", "master_cache_reclaimed_total"):
        got, want = (float(re.search(rf"^\w+_{gauge} (\S+)$", m.metrics.render(), re.M).group(1))
                     for m in (port, ref))
        assert got == want, gauge


def test_cycle_accounts_memory(cycles):
    import time

    _, _, port, _ = cycles
    deadline = time.time() + 60
    while port._sizeof_busy and time.time() < deadline:
        time.sleep(0.05)
    assert not port._sizeof_busy
    text = port.metrics.render()
    for component in ("dataset", "cf_index", "ctr_model"):
        got = re.search(rf'^\w+_master_memory_inuse_bytes\{{data="{component}"\}} (\S+)$',
                        text, re.M)
        assert got and float(got.group(1)) > 0, component


def test_master_resumes_the_ctr_model_from_meta(cycles):
    _, _, port, _ = cycles
    again = Master(port.config, port.data, port.cache, port.blob, port.meta, device="cpu")
    assert again.ctr_model is not None
    assert torch_equal(again.ctr_model.model_params.v, port.ctr_model.model_params.v)


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.detach(), b.detach()))


def _tiny_master(tmp_path, **ranker):
    data = MemoryDataStore()
    data.insert_items(types.Item(f"i{i}") for i in range(4))
    data.insert_users(types.User(f"u{u}") for u in range(3))
    data.insert_feedback(types.Feedback("like", f"u{u}", f"i{(u + j) % 4}", 1.0, 1.0)
                         for u in range(3) for j in range(2))
    cfg = Config()
    cfg.recommend.ranker.fit_epoch = 1
    for k, v in ranker.items():
        setattr(cfg.recommend.ranker, k, v)
    return Master(cfg, data, MemoryCacheStore(), BlobStore(tmp_path), MetaStore(), device="cpu")


@pytest.mark.parametrize("how", ["search", "cf_period", "ctr_period"])
def test_model_search_raises_m12(tmp_path, how):
    """Hyper-parameter search is not ported: asked for, or come due, it
    raises naming ROADMAP's M12, after the cycle's tasks."""
    master = _tiny_master(tmp_path, type="fm", optimize_period=5.0 if how == "ctr_period" else 0)
    if how == "cf_period":
        master.config.recommend.collaborative.type = "mf"
        master.config.recommend.collaborative.fit_epoch = 1
        master.config.recommend.collaborative.optimize_period = 5.0
    with pytest.raises(NotImplementedError, match="M12"):
        master.run_tasks_once(search=how == "search")
    assert master.meta.get(CLICK_THROUGH_RATE_MODEL)


def test_task_loop_runs_until_shutdown(tmp_path, monkeypatch):
    """serve_background runs a cycle, trigger runs another, a failed
    cycle does not end the loop, shutdown stops the thread."""
    import threading

    master = _tiny_master(tmp_path)
    calls = []
    ran = threading.Semaphore(0)

    def once(search=False):
        calls.append(search)
        ran.release()
        if len(calls) == 2:
            raise RuntimeError("a failed cycle")

    monkeypatch.setattr(master, "run_tasks_once", once)
    master.serve_background()
    assert ran.acquire(timeout=10)
    master.trigger()
    assert ran.acquire(timeout=10)
    master.trigger()
    assert ran.acquire(timeout=10)
    master.shutdown()
    assert not master._thread.is_alive() and len(calls) >= 3
