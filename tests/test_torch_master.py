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
"""

import json
import re

import numpy as np
import pytest

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
from gorse_tpu_torch.models import bpr as port_bpr
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.serve.worker import Worker
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore
from gorse_tpu_torch.storage.meta import COLLABORATIVE_FILTERING_MODEL, MetaStore
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
                    RefBlobStore(tmp / "ref_blobs"), RefMeta())
    ref_loaded = ref.load_dataset()
    ref.train_collaborative_filtering(ref_loaded)
    ref_init = RefBPR({})
    ref_init.init(ref_loaded.train, seed=0)
    factors = (np.asarray(ref_init.user_factors), np.asarray(ref_init.item_factors))

    data, cache = MemoryDataStore(), MemoryCacheStore()
    _fill(data, types)
    port = Master(_configure(Config()), data, cache, BlobStore(tmp / "blobs"), MetaStore(),
                  device="cpu")
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
    assert loaded.ctr is None
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
