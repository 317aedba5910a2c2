"""Master node: the dataset, the recommenders' caches and the CF model
(port of the tasks of gorse_tpu/serve/master.py that precede CTR).

``load_dataset`` streams users, items and feedback from the data store into
the training dataset and its leave-one-out split, and records the catalog
gauges, global-meta keys and time series under the reference's names.
``update_non_personalized`` fills the ``non-personalized`` caches (the
built-in ``popular`` and ``latest`` and the configured entries) on the
host; ``update_item_to_item`` and ``update_user_to_user`` compute every
configured entry's neighbour lists on the card (logics/item_to_item.py,
logics/user_to_user.py), each gated by its config and corpus digests.
``train_collaborative_filtering`` fits the MF model on the card (BPR by
default, eALS with ``model = "als"``), builds the serving index, saves it
to the blob store and records its id in the meta store, where ``get_meta``
hands it to workers, and upserts the serving item factors into the vector
store when one is given (``_sync_cf_vectors``).

Not ported yet: the CTR dataset and ranker (``ctr`` stays ``None``), the
data store's search-column reconcile, ``run_tasks_once`` and the task
loop, hyper-parameter search, and sharded training (``training_mesh`` is
``None``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time

from ..data.dataset import Dataset
from ..logics.cf import MatrixFactorizationIndex
from ..logics.item_to_item import ItemToItemConfig, _flatten_labels, new_item_to_item
from ..logics.non_personalized import NonPersonalized, NonPersonalizedConfig
from ..logics.user_to_user import UserToUser, UserToUserConfig
from ..models import FitConfig, Params, create_mf_model
from ..storage import cache as ck
from ..storage.blob import BlobStore
from ..storage.cache import CacheStore, key
from ..storage.data import DataStore
from ..storage.meta import CLICK_THROUGH_RATE_MODEL, COLLABORATIVE_FILTERING_MODEL, MetaStore
from ..storage.types import TimeSeriesPoint
from ..storage.vectors import VectorStore
from ..utils.config import Config, NonPersonalizedConfigEntry
from ..utils.expression import match_any
from .metrics import MetricsRegistry
from .progress import ProgressTracker

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LoadedData:
    """Result of the load-dataset task."""

    dataset: Dataset
    train: Dataset
    test: Dataset
    ctr: None  # the CTR dataset is not ported yet
    item_categories: list[list[str]]
    items: list
    timestamp: float = 0.0  # load-start snapshot time


class Master:
    def __init__(
        self,
        config: Config,
        data_store: DataStore,
        cache_store: CacheStore,
        blob_store: BlobStore,
        meta_store: MetaStore,
        device=None,
        vector_store: VectorStore | None = None,
    ) -> None:
        self.config = config
        self.data = data_store
        self.cache = cache_store
        self.blob = blob_store
        self.meta = meta_store
        self.device = device  # None: the card
        self.vectors = vector_store
        self.progress = ProgressTracker()
        self.metrics = MetricsRegistry(namespace="gorse")
        self.cf_model = None
        self.cf_index: MatrixFactorizationIndex | None = None
        self._load_models_from_meta()

    def training_mesh(self):
        """Sharded training is not ported yet: always one device."""
        return None

    # ------------------------------------------------------------------ meta

    def get_meta(self) -> dict:
        """Config JSON, active model ids and peer lists, as workers and
        servers poll them."""
        return {
            "config": self.config.to_json(),
            "cf_model_id": self.meta.get(COLLABORATIVE_FILTERING_MODEL) or "",
            "ctr_model_id": self.meta.get(CLICK_THROUGH_RATE_MODEL) or "",
            "servers": [n.uuid for n in self.meta.list_nodes("server")],
            "workers": [n.uuid for n in self.meta.list_nodes("worker")],
        }

    def _load_models_from_meta(self) -> None:
        """Resume the last trained CF index after a restart."""
        cf_id = self.meta.get(COLLABORATIVE_FILTERING_MODEL)
        if cf_id and self.blob.exists(cf_id):
            try:
                self.cf_index = MatrixFactorizationIndex.load(
                    self.blob.open(cf_id), device=self.device
                )
                logger.info("resumed CF index %s", cf_id)
            except Exception as e:  # noqa: BLE001 - a bad artifact must not block startup
                logger.warning("failed to resume CF model %s: %s", cf_id, e)

    # ----------------------------------------------------------------- tasks

    def load_dataset(self) -> LoadedData:
        """Users, items and positive feedback from the data store into the
        training dataset (positive feedback deduplicated per (user, item),
        within the positive TTL), then the leave-one-out split."""
        with self.progress.span("load_dataset"):
            cfg = self.config.recommend
            t_task = time.perf_counter()
            load_time = time.time()
            step_seconds = self.metrics.gauge_set
            dataset = Dataset()
            t0 = time.perf_counter()
            items = list(self.data.get_items())
            item_categories = []
            for item in items:
                dataset.add_item(item.item_id, labels=_flatten_labels(item.labels))
                item_categories.append(item.categories)
            step_seconds("master_load_dataset_step_seconds", time.perf_counter() - t0,
                         labels={"step": "load_items"})
            t0 = time.perf_counter()
            users = list(self.data.get_users())
            for user in users:
                dataset.add_user(user.user_id, labels=_flatten_labels(user.labels))
            step_seconds("master_load_dataset_step_seconds", time.perf_counter() - t0,
                         labels={"step": "load_users"})
            positive_ttl = cfg.data_source.positive_feedback_ttl
            cutoff = time.time() - positive_ttl * 86400 if positive_ttl > 0 else None
            positive_edges: set[tuple[str, str]] = set()
            negative_edges: list[tuple[str, str]] = []
            t0 = time.perf_counter()
            n_feedback_rows = n_implicit = n_total_pos = 0
            active_users: set[str] = set()
            active_items: set[str] = set()
            for fb in self.data.get_feedback(end_time=time.time()):
                n_feedback_rows += 1
                if match_any(cfg.data_source.positive_feedback_types, fb.feedback_type, fb.value):
                    n_total_pos += 1  # before the TTL and the dedup
                    active_users.add(fb.user_id)
                    active_items.add(fb.item_id)
                    if cutoff is not None and fb.timestamp < cutoff:
                        continue
                    if (fb.user_id, fb.item_id) not in positive_edges:
                        positive_edges.add((fb.user_id, fb.item_id))
                        dataset.add_feedback(fb.user_id, fb.item_id, fb.timestamp)
                elif match_any(cfg.data_source.negative_feedback_types, fb.feedback_type, fb.value):
                    negative_edges.append((fb.user_id, fb.item_id))
                else:
                    n_implicit += 1
            step_seconds("master_load_dataset_step_seconds", time.perf_counter() - t0,
                         labels={"step": "load_positive_feedback"})
            t0 = time.perf_counter()
            train, test = dataset.split_cf(seed=0)
            step_seconds("master_load_dataset_step_seconds", time.perf_counter() - t0,
                         labels={"step": "split_ranking_dataset"})
            step_seconds("master_load_dataset_total_seconds", time.perf_counter() - t_task)
            g = self.metrics.gauge_set
            g("master_users_total", dataset.count_users())
            g("master_items_total", dataset.count_items())
            g("master_user_labels_total", len(dataset.user_label_dict))
            g("master_item_labels_total", len(dataset.item_label_dict))
            g("master_feedbacks_total", n_feedback_rows)
            g("master_positive_feedbacks_total", len(positive_edges))
            g("master_negative_feedbacks_total", len(negative_edges))
            g("master_implicit_feedbacks_total", n_implicit)
            g("master_active_users_total", len(active_users))
            g("master_inactive_users_total", max(len(users) - len(active_users), 0))
            g("master_active_items_total", len(active_items))
            g("master_inactive_items_total", max(len(items) - len(active_items), 0))
            for kv, value in (
                (ck.NUM_USERS, dataset.count_users()),
                (ck.NUM_ITEMS, dataset.count_items()),
                (ck.NUM_USER_LABELS, len(dataset.user_label_dict)),
                (ck.NUM_ITEM_LABELS, len(dataset.item_label_dict)),
                (ck.NUM_TOTAL_POS_FEEDBACKS, n_total_pos),
                (ck.NUM_VALID_POS_FEEDBACKS, len(positive_edges)),
                (ck.NUM_VALID_NEG_FEEDBACKS, len(negative_edges)),
            ):
                self.cache.set(key(ck.GLOBAL_META, kv), str(int(value)))
            self._record_ts(ck.NUM_USERS, dataset.count_users())
            self._record_ts(ck.NUM_ITEMS, dataset.count_items())
            self._record_ts(ck.NUM_FEEDBACK, dataset.count_feedback() + len(negative_edges))
            self._record_ts(ck.NUM_POS_FEEDBACKS, dataset.count_feedback())
            self._record_ts(ck.NUM_NEG_FEEDBACKS, len(negative_edges))
            return LoadedData(dataset, train, test, None, item_categories, items,
                              timestamp=load_time)

    def update_non_personalized(self, data: LoadedData) -> None:
        """Refill the ``non-personalized`` cache of each entry, the built-in
        ``popular`` (``len(feedback)``) and ``latest`` (``item.timestamp``)
        included, unless its config digest is unchanged and the data did not
        change; host work only."""
        entries = list(self.config.recommend.non_personalized)
        if not any(e.name == "popular" for e in entries):
            entries.append(NonPersonalizedConfigEntry(name="popular", score="len(feedback)"))
        if not any(e.name == "latest" for e in entries):
            entries.append(NonPersonalizedConfigEntry(name="latest", score="item.timestamp"))
        for entry in entries:
            cfg = NonPersonalizedConfig(name=entry.name, score=entry.score, filter=entry.filter)
            digest_key = key(ck.NON_PERSONALIZED_DIGEST, entry.name)
            if self.cache.get(digest_key) == cfg.digest() and not self._data_changed():
                continue
            with self.progress.span(f"non_personalized/{entry.name}"):
                engine = NonPersonalized(cfg, self.config.recommend.cache_size)
                for item in data.items:
                    engine.push(item, self.data.get_item_feedback(item.item_id))
                self.cache.delete_scores(ck.NON_PERSONALIZED, [entry.name])
                self.cache.add_scores(ck.NON_PERSONALIZED, entry.name, engine.pop_all())
                self.cache.set(digest_key, cfg.digest())
                self.cache.set(key(ck.NON_PERSONALIZED_UPDATE_TIME, entry.name), str(time.time()))
                # the global update-time stamps that getStats reads
                if entry.name == "popular":
                    self.cache.set(
                        key(ck.GLOBAL_META, ck.LAST_UPDATE_POPULAR_ITEMS_TIME), str(time.time())
                    )
                elif entry.name == "latest":
                    self.cache.set(
                        key(ck.GLOBAL_META, ck.LAST_UPDATE_LATEST_ITEMS_TIME), str(time.time())
                    )

    def _data_changed(self) -> bool:
        return True  # as the reference: no data digest yet

    def _needs_refresh(self, digest_key: str, update_key: str, digest: str) -> bool:
        """Recompute when the corpus digest (config, entity and feedback
        counts) changed or the cache's refresh period elapsed: one blocked
        pass computes every entity's neighbours, so the gate is per entry
        and corpus, not per entity."""
        if self.cache.get(digest_key) != digest:
            return True
        last = float(self.cache.get(update_key) or 0)
        period_s = self.config.recommend.cache_expire * 3600.0
        return (time.time() - last) > period_s

    def update_item_to_item(self, data: LoadedData) -> None:
        """Each configured item-to-item entry's neighbour lists, on the
        card, into the ``item-to-item`` cache with per-item digests."""
        entries = list(self.config.recommend.item_to_item)
        if not entries:
            return
        tag_idf = user_idf = None
        for entry in entries:
            cfg = ItemToItemConfig(name=entry.name, type=entry.type, column=entry.column,
                                   prompt=entry.prompt)
            corpus_digest = (f"{cfg.digest()}|{data.dataset.count_items()}|"
                             f"{data.dataset.count_feedback()}")
            if not self._needs_refresh(
                key(ck.ITEM_TO_ITEM_DIGEST, entry.name, "_config"),
                key(ck.ITEM_TO_ITEM_UPDATE_TIME, entry.name),
                corpus_digest,
            ):
                continue
            if tag_idf is None:
                tag_idf = data.dataset.item_label_idf()
                user_idf = data.dataset.user_idf()
            with self.progress.span(f"item_to_item/{entry.name}"):
                t0 = time.perf_counter()
                engine = new_item_to_item(
                    cfg, self.config.recommend.cache_size, tag_idf=tag_idf, user_idf=user_idf,
                    label_index=data.dataset.item_label_dict, device=self.device,
                )
                item_feedback = data.dataset.item_feedback
                for item in data.items:
                    i = data.dataset.item_dict.to_number(item.item_id)
                    engine.push(item, item_feedback[i] if 0 <= i < len(item_feedback) else [])
                n_updated = 0
                for item_id, scores in engine.pop_all():
                    self.cache.add_scores(ck.ITEM_TO_ITEM, key(entry.name, item_id), scores)
                    self.cache.set(key(ck.ITEM_TO_ITEM_DIGEST, entry.name, item_id), cfg.digest())
                    n_updated += 1
                self.cache.set(key(ck.ITEM_TO_ITEM_DIGEST, entry.name, "_config"), corpus_digest)
                self.cache.set(key(ck.ITEM_TO_ITEM_UPDATE_TIME, entry.name), str(time.time()))
                self.metrics.gauge_set(
                    "master_find_item_neighbors_total_seconds", time.perf_counter() - t0
                )
                self.metrics.gauge_set("master_update_item_neighbors_total", n_updated)

    def update_user_to_user(self, data: LoadedData) -> None:
        """Each configured user-to-user entry's neighbour lists, on the
        card, into the ``user-to-user`` cache with per-user digests."""
        entries = list(self.config.recommend.user_to_user)
        if not entries:
            return
        item_idf = tag_idf = users = None
        for entry in entries:
            cfg = UserToUserConfig(name=entry.name, type=entry.type, column=entry.column)
            corpus_digest = (f"{cfg.digest()}|{data.dataset.count_users()}|"
                             f"{data.dataset.count_feedback()}")
            if not self._needs_refresh(
                key(ck.USER_TO_USER_DIGEST, entry.name, "_config"),
                key(ck.USER_TO_USER_UPDATE_TIME, entry.name),
                corpus_digest,
            ):
                continue
            if users is None:
                item_idf = data.dataset.item_idf()
                tag_idf = data.dataset.user_label_idf()
                users = list(self.data.get_users())
            with self.progress.span(f"user_to_user/{entry.name}"):
                t0 = time.perf_counter()
                engine = UserToUser(
                    cfg, self.config.recommend.cache_size, tag_idf=tag_idf, item_idf=item_idf,
                    label_index=data.dataset.user_label_dict, device=self.device,
                )
                user_feedback = data.dataset.user_feedback
                for user in users:
                    u = data.dataset.user_dict.to_number(user.user_id)
                    engine.push(user, user_feedback[u] if 0 <= u < len(user_feedback) else [])
                n_updated = 0
                for user_id, scores in engine.pop_all():
                    self.cache.add_scores(ck.USER_TO_USER, key(entry.name, user_id), scores)
                    self.cache.set(key(ck.USER_TO_USER_DIGEST, entry.name, user_id), cfg.digest())
                    n_updated += 1
                self.cache.set(key(ck.USER_TO_USER_DIGEST, entry.name, "_config"), corpus_digest)
                self.cache.set(key(ck.USER_TO_USER_UPDATE_TIME, entry.name), str(time.time()))
                self.metrics.gauge_set(
                    "master_find_user_neighbors_total_seconds", time.perf_counter() - t0
                )
                self.metrics.gauge_set("master_update_user_neighbors_total", n_updated)

    def train_collaborative_filtering(self, data: LoadedData) -> None:
        """Fit the CF model (the searched one when it scored better), build
        and save its index, and record the model id."""
        cfg = self.config.recommend.collaborative
        if cfg.type.lower() == "none":
            logger.info("skip CF training: collaborative.type = none")
            return
        if data.train.count_feedback() == 0:
            logger.info("skip CF training: no feedback")
            return
        with self.progress.span("fit_cf_model"):
            current = json.loads(self.meta.get("CF_MODEL_META") or "null") or {
                "type": cfg.model, "params": self.meta_model_params("cf"), "score": -1.0,
            }
            target = json.loads(self.meta.get("CF_SEARCH_TARGET") or "null")
            mtype, mparams = current["type"], dict(current["params"])
            if target and target["score"] > current.get("score", -1.0) and (
                target["type"] != mtype or target["params"] != mparams
            ):
                mtype, mparams = target["type"], dict(target["params"])
                logger.info(
                    "find better collaborative filtering model: type=%s score=%.4f params=%s",
                    mtype, target["score"], mparams,
                )
            params = Params(mparams)
            if cfg.fit_epoch > 0:
                params = Params({"n_epochs": cfg.fit_epoch}).merged(params)
            model = create_mf_model(mtype, params, device=self.device)
            t0 = time.perf_counter()
            score = model.fit(
                data.train, data.test,
                FitConfig(verbose=10, patience=cfg.early_stopping.patience, seed=0,
                          mesh=self.training_mesh()),
            )
            g = self.metrics.gauge_set
            g("master_collaborative_filtering_fit_seconds", time.perf_counter() - t0)
            g("master_collaborative_filtering_ndcg_10", score.ndcg)
            g("master_collaborative_filtering_precision_10", score.precision)
            g("master_collaborative_filtering_recall_10", score.recall)
            self._record_ts(ck.CF_NDCG, score.ndcg)
            self._record_ts(ck.CF_PRECISION, score.precision)
            self._record_ts(ck.CF_RECALL, score.recall)
        self.cf_model = model
        self.cf_index = MatrixFactorizationIndex.from_model(
            model, item_categories=data.item_categories, timestamp=time.time()
        )
        model_id = self.blob.new_model_id()
        self.cf_index.save(self.blob.create(model_id))
        self.blob.flush(model_id)
        self.meta.put(COLLABORATIVE_FILTERING_MODEL, model_id)
        self.meta.put(
            "CF_MODEL_META",
            json.dumps({"type": mtype, "params": mparams, "score": score.ndcg}),
        )
        self.cache.set(ck.LAST_FIT_MATCHING_MODEL_TIME, str(time.time()))
        self._sync_cf_vectors()
        logger.info("CF model %s (%s) trained: NDCG@10=%.4f", model_id, mtype, score.ndcg)

    CF_COLLECTION = "collaborative_filtering"

    def _sync_cf_vectors(self) -> None:
        """Keep the CF item-factor collection in the vector store: recreate
        it when the dimension, the quantization or the configured bits
        changed, then upsert the predictable items' factors
        (gorse_tpu/serve/master.py:588-641)."""
        if self.vectors is None or self.cf_index is None:
            return
        dim = int(self.cf_index.item_factors.shape[1])
        db_cfg = self.config.database
        want_q = db_cfg.vector_quantization_type
        want_bits = db_cfg.vector_quantization_bits
        info = self.vectors.describe_collection(self.CF_COLLECTION)
        # the configured bits are compared with the meta record of what this
        # master last created the collection with: backends normalize the
        # bits they describe, so describe_collection alone would miss a
        # bits-only change
        created_with = None
        if self.meta is not None:
            raw = self.meta.get("cf_vector_config")
            if raw:
                try:
                    created_with = json.loads(raw)
                except ValueError:
                    created_with = None
        bits_changed = created_with is not None and (
            created_with.get("quantization") != want_q
            or created_with.get("bits") != want_bits
        )
        if info is not None and (
            info["dimension"] != dim
            or info.get("quantization", "") != want_q
            or bits_changed
        ):
            logger.warning(
                "recreating CF vector collection: dim %s->%s quantization %r->%r bits->%s",
                info["dimension"], dim, info.get("quantization", ""), want_q, want_bits,
            )
            self.vectors.drop_collection(self.CF_COLLECTION)
            info = None
        if info is None:
            self.vectors.create_collection(
                self.CF_COLLECTION, dim, distance="dot",
                quantization=want_q, bits=want_bits,
            )
            if self.meta is not None:
                self.meta.put(
                    "cf_vector_config",
                    json.dumps({"quantization": want_q, "bits": want_bits}),
                )
        ids, serving = self.cf_index.serving_items()
        self.vectors.add(self.CF_COLLECTION, ids, serving)

    def meta_model_params(self, kind: str) -> dict:
        """Best params from a past hyper-parameter search, if recorded."""
        raw = self.meta.get(f"BEST_PARAMS_{kind.upper()}")
        return json.loads(raw) if raw else {}

    def _record_ts(self, name: str, value: float) -> None:
        self.cache.add_time_series_points(
            [TimeSeriesPoint(name=name, timestamp=time.time(), value=float(value))]
        )
