"""Master node: the dataset, the recommenders' caches, the CF model and
the CTR ranker, and the task cycle that runs them (port of
gorse_tpu/serve/master.py).

``load_dataset`` streams users, items and feedback from the data store into
the training dataset and its leave-one-out split, builds the CTR dataset
(positive and negative edges, balancing negatives sampled from
``default_rng(0)``), and records the catalog gauges, global-meta keys and
time series under the reference's names. ``update_non_personalized`` fills
the ``non-personalized`` caches (the built-in ``popular`` and ``latest``
and the configured entries) on the host; ``update_item_to_item`` and
``update_user_to_user`` compute every configured entry's neighbour lists on
the card (logics/item_to_item.py, logics/user_to_user.py), each gated by its
config and corpus digests. ``train_collaborative_filtering`` fits the MF
model on the card (BPR by default, eALS with ``model = "als"``), builds the
serving index, saves it to the blob store and records its id in the meta
store, where ``get_meta`` hands it to workers, and upserts the serving item
factors into the vector store when one is given (``_sync_cf_vectors``).
``train_click_through_rate`` fits the AFM (models/fm.py) on the card with
``ranker.type = "fm"`` and publishes it the same way. ``search_model`` runs
the hyper-parameter search (models/optimize.py): over the model type and
its parameters for CF, over the AFM's parameters for CTR, each trial a fit
on the card; the best parameters go to the meta store for the next fit.
``run_tasks_once`` runs these in the reference's order (a search with
``search=True`` or when its ``optimize_period`` has come due), then
``collect_garbage``; the task loop repeats it every
``collaborative.fit_period`` minutes or on ``trigger``. ``load_dataset``
starts the data store's search-column reconcile on a thread.

With more than one card (or a joined process group) the CF, eALS and CTR
fits shard over ``training_mesh`` (parallel/). When the master's gRPC plane
proxies its stores (protocol/rpc.py sets ``grpc_proxy_target``), ``get_meta``
hands the nodes ``proxy://`` URLs for its local data and cache stores;
``shutdown`` flushes the tracer.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time

import numpy as np
import torch

from ..data.ctr import CTRDataset
from ..data.dataset import Dataset
from ..data.unified_index import UnifiedIndex
from ..logics.cf import MatrixFactorizationIndex
from ..logics.item_to_item import ItemToItemConfig, _flatten_labels, new_item_to_item
from ..logics.non_personalized import NonPersonalized, NonPersonalizedConfig
from ..logics.user_to_user import UserToUser, UserToUserConfig
from ..models import FitConfig, Params, create_mf_model
from ..models.fm import AFM
from ..models.optimize import AFM_SPACE, ALS_SPACE, BPR_SPACE, model_search, model_type_search
from ..storage import cache as ck
from ..storage.blob import BlobStore
from ..storage.cache import CacheStore, key
from ..storage.data import DataStore
from ..storage.meta import (
    CLICK_THROUGH_RATE_MODEL,
    COLLABORATIVE_FILTERING_MODEL,
    RECOMMEND_CONFIG,
    MetaStore,
)
from ..storage.types import TimeSeriesPoint
from ..storage.vectors import VectorStore
from ..utils.config import Config, NonPersonalizedConfigEntry
from ..utils.expression import match_any
from ..utils.gcpause import gc_paused
from ..utils.sizeof import deep_size
from ..utils.tracing import tracer
from .metrics import MetricsRegistry
from .progress import ProgressTracker

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LoadedData:
    """Result of the load-dataset task."""

    dataset: Dataset
    train: Dataset
    test: Dataset
    ctr: CTRDataset | None
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
        self.ctr_model: AFM | None = None
        self._stop = threading.Event()
        self._trigger = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_optimize: dict[str, float] = {}
        self._sizeof_ts = -1e9
        self._sizeof_busy = False
        self._reconciling = False
        self.memory_inuse: dict[str, int] = {}
        self._mesh = None
        self._mesh_built = False
        self._load_models_from_meta()

    def training_mesh(self):
        """The mesh the fits shard over: with a joined process group
        (``parallel.multihost.init_multihost``) every process's cards, else
        every visible card when the master runs on a card and more than one
        is visible; ``None`` (one device) otherwise. Built once."""
        if not self._mesh_built:
            self._mesh_built = True
            import torch.distributed as dist

            on_card = self.device is None or torch.device(self.device).type == "cuda"
            if on_card and dist.is_available() and dist.is_initialized():
                from ..parallel.multihost import global_mesh

                self._mesh = global_mesh()
            elif on_card and torch.cuda.device_count() > 1:
                from ..parallel.mesh import make_mesh

                self._mesh = make_mesh()
        return self._mesh

    # ------------------------------------------------------------------ meta

    def get_meta(self) -> dict:
        """Config JSON, active model ids and peer lists, as workers and
        servers poll them. A master that proxies its node-local stores
        over gRPC names the proxy in place of their URLs, which hold only
        on its own host (gorse: worker/worker.go:164-223,
        server/server.go:177-226)."""
        config_json = self.config.to_json()
        target = getattr(self, "grpc_proxy_target", None)
        if target:
            cfg = json.loads(config_json)
            db = cfg.get("database", {})
            for store_key in ("data_store", "cache_store"):
                url = db.get(store_key, "")
                if url.startswith(("memory://", "sqlite://")) or url in ("memory", "sqlite"):
                    db[store_key] = f"proxy://{target}"
            config_json = json.dumps(cfg)
        return {
            "config": config_json,
            "cf_model_id": self.meta.get(COLLABORATIVE_FILTERING_MODEL) or "",
            "ctr_model_id": self.meta.get(CLICK_THROUGH_RATE_MODEL) or "",
            "servers": [n.uuid for n in self.meta.list_nodes("server")],
            "workers": [n.uuid for n in self.meta.list_nodes("worker")],
        }

    def _load_models_from_meta(self) -> None:
        """Resume the last trained CF index and CTR model after a restart,
        after applying the recommend-config override that the dashboard's
        ``POST /api/dashboard/config`` persisted in the meta store (merged
        into ``recommend`` and validated; an invalid one is logged and
        ignored)."""
        raw_override = self.meta.get(RECOMMEND_CONFIG)
        if raw_override:
            try:
                override = json.loads(raw_override)
                merged = json.loads(self.config.to_json())
                merged["recommend"].update(override.get("recommend", override))
                new_cfg = Config.from_json(json.dumps(merged))
                new_cfg.validate()
                self.config.recommend = new_cfg.recommend
                logger.info("applied persisted recommend-config override")
            except Exception as e:  # noqa: BLE001 - a bad override must not block startup
                logger.warning("ignoring invalid RECOMMEND_CONFIG override: %s", e)
        cf_id = self.meta.get(COLLABORATIVE_FILTERING_MODEL)
        if cf_id and self.blob.exists(cf_id):
            try:
                self.cf_index = MatrixFactorizationIndex.load(
                    self.blob.open(cf_id), device=self.device
                )
                logger.info("resumed CF index %s", cf_id)
            except Exception as e:  # noqa: BLE001 - a bad artifact must not block startup
                logger.warning("failed to resume CF model %s: %s", cf_id, e)
        ctr_id = self.meta.get(CLICK_THROUGH_RATE_MODEL)
        if ctr_id and self.blob.exists(ctr_id):
            try:
                self.ctr_model = AFM.load(self.blob.open(ctr_id), device=self.device)
                logger.info("resumed CTR model %s", ctr_id)
            except Exception as e:  # noqa: BLE001 - a bad artifact must not block startup
                logger.warning("failed to resume CTR model %s: %s", ctr_id, e)

    # ----------------------------------------------------------------- tasks

    def load_dataset(self) -> LoadedData:
        """Users, items and feedback from the data store into the training
        dataset (positive feedback deduplicated per (user, item), within the
        positive TTL), its leave-one-out split and the CTR dataset."""
        with self.progress.span("load_dataset"), gc_paused():
            cfg = self.config.recommend
            # the search-column maintenance runs beside the load, one at a time
            if not self._reconciling:
                self._reconciling = True
                threading.Thread(target=self._reconcile, args=(list(cfg.search.columns),),
                                 name="reconcile", daemon=True).start()
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
            t0 = time.perf_counter()
            ctr = self._build_ctr_dataset(dataset, positive_edges, negative_edges)
            step_seconds("master_load_dataset_step_seconds", time.perf_counter() - t0,
                         labels={"step": "create_ranking_dataset"})
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
            return LoadedData(dataset, train, test, ctr, item_categories, items,
                              timestamp=load_time)

    def _reconcile(self, columns: list[str]) -> None:
        """The data store's full-text search state for ``columns``; a
        failure is logged, as the reference does."""
        try:
            self.data.reconcile(columns)
        except Exception:  # noqa: BLE001 - the load goes on without the index
            logger.exception("failed to reconcile data store")
        finally:
            self._reconciling = False

    def _build_ctr_dataset(self, dataset: Dataset, positive_edges, negative_edges) -> CTRDataset:
        """CTR rows: each positive edge (target 1), each negative edge (0),
        then, while positives outnumber negatives, negatives sampled from
        ``default_rng(0)`` (a user of a positive edge, any item, kept unless
        it is a positive edge). A row is the user, the item, the user's
        labels and the item's labels in the unified index. Rows follow the
        iteration order of ``positive_edges`` (a set), as the reference's."""
        index = UnifiedIndex(
            users=dataset.user_dict,
            items=dataset.item_dict,
            user_labels=dataset.user_label_dict,
            item_labels=dataset.item_label_dict,
        )
        ctr = CTRDataset(index)
        u_num = dataset.user_dict.to_number
        i_num = dataset.item_dict.to_number
        item_off = index.item_offset
        ul_off, il_off = index.user_label_offset, index.item_label_offset
        user_labels, item_labels = dataset.user_labels, dataset.item_labels
        n_ul, n_il = len(user_labels), len(item_labels)

        def add_row(user_id: str, item_id: str, target: float) -> None:
            u = u_num(user_id)
            i = i_num(item_id)
            if u < 0 or i < 0:
                return
            idx = [u, item_off + i]
            if u < n_ul:
                idx += [ul_off + label for label in user_labels[u]]
            if i < n_il:
                idx += [il_off + label for label in item_labels[i]]
            ctr.add(idx, [1.0] * len(idx), target, user=u)

        for user_id, item_id in positive_edges:
            add_row(user_id, item_id, 1.0)
        for user_id, item_id in negative_edges:
            add_row(user_id, item_id, 0.0)
        n_missing = len(positive_edges) - len(negative_edges)
        if n_missing > 0 and dataset.count_items() > 1:
            rng = np.random.default_rng(0)
            users = list({u for u, _ in positive_edges})
            n_items = dataset.count_items()
            for _ in range(n_missing):
                user_id = users[int(rng.integers(len(users)))]
                item_id = dataset.item_dict.to_name(int(rng.integers(n_items)))
                if (user_id, item_id) not in positive_edges:
                    add_row(user_id, item_id, 0.0)
        return ctr

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

    def train_click_through_rate(self, data: LoadedData) -> None:
        """With ``ranker.type = "fm"``: fit the AFM on the card on a 0.2
        split (seed 0) of the CTR dataset, record its gauges and time
        series, save it to the blob store and record its id."""
        if self.config.recommend.ranker.type != "fm" or data.ctr is None or len(data.ctr) == 0:
            return
        if data.ctr.count_positive() == 0 or data.ctr.count_negative() == 0:
            logger.info("skip CTR training: single-class data")
            return
        ranker_cfg = self.config.recommend.ranker
        with self.progress.span("fit_ctr_model"):
            train, test = data.ctr.split(0.2, seed=0)
            params = Params(self.meta_model_params("ctr"))
            if ranker_cfg.fit_epoch > 0:
                params = Params({"n_epochs": ranker_cfg.fit_epoch}).merged(params)
            model = AFM(params, device=self.device)
            t0 = time.perf_counter()
            score = model.fit(
                train, test,
                FitConfig(verbose=10, patience=ranker_cfg.early_stopping.patience,
                          mesh=self.training_mesh()),
            )
            g = self.metrics.gauge_set
            g("master_ranking_fit_seconds", time.perf_counter() - t0)
            g("master_ranking_model_auc", score.auc)
            g("master_ranking_model_precision", score.precision)
            g("master_ranking_model_recall", score.recall)
            self._record_ts(ck.CTR_AUC, score.auc)
            self._record_ts(ck.CTR_PRECISION, score.precision)
            self._record_ts(ck.CTR_RECALL, score.recall)
        self.ctr_model = model
        model_id = self.blob.new_model_id()
        model.save(self.blob.create(model_id))
        self.blob.flush(model_id)
        self.meta.put(CLICK_THROUGH_RATE_MODEL, model_id)
        self.cache.set(ck.LAST_FIT_RANKING_MODEL_TIME, str(time.time()))
        logger.info("CTR model %s trained: AUC=%.4f", model_id, score.auc)

    def meta_model_params(self, kind: str) -> dict:
        """Best params from a past hyper-parameter search, if recorded."""
        raw = self.meta.get(f"BEST_PARAMS_{kind.upper()}")
        return json.loads(raw) if raw else {}

    def _record_ts(self, name: str, value: float) -> None:
        self.cache.add_time_series_points(
            [TimeSeriesPoint(name=name, timestamp=time.time(), value=float(value))]
        )

    def search_model(self, data: LoadedData, kind: str = "cf", n_trials: int | None = None) -> dict:
        """Hyper-parameter search on the card. ``cf``: the model type (BPR or
        eALS) and its parameters by ``model_type_search``, each trial a fit
        of ``model_search_epoch`` epochs scored by NDCG@10, the best into
        ``CF_SEARCH_TARGET``. ``ctr``: the AFM's parameters by
        ``model_search`` on a 0.2 split (seed 0) of the CTR dataset, scored
        by AUC. Both record ``BEST_PARAMS_<KIND>`` and the search gauges."""
        cfg = self.config.recommend.collaborative
        ranker_cfg = self.config.recommend.ranker
        n_trials = n_trials or (
            cfg.optimize_trials if kind == "cf" else ranker_cfg.optimize_trials
        )
        with self.progress.span(f"search_{kind}_model"):
            t0 = time.perf_counter()
            if kind == "cf":
                patience = cfg.early_stopping.patience

                def objective(mtype: str, p: Params) -> float:
                    model = create_mf_model(
                        mtype, Params(n_epochs=cfg.model_search_epoch).merged(p),
                        device=self.device,
                    )
                    return model.fit(
                        data.train, data.test,
                        FitConfig(verbose=cfg.model_search_epoch, patience=patience),
                    ).ndcg

                best_type, best, value, _ = model_type_search(
                    {"bpr": BPR_SPACE, "als": ALS_SPACE}, objective, n_trials=n_trials
                )
                self.meta.put(
                    "CF_SEARCH_TARGET",
                    json.dumps({"type": best_type, "params": dict(best), "score": value}),
                )
            else:
                train, test = data.ctr.split(0.2, seed=0)

                def objective(p: Params) -> float:
                    model = AFM(Params(n_epochs=cfg.model_search_epoch).merged(p),
                                device=self.device)
                    return model.fit(train, test, FitConfig(verbose=cfg.model_search_epoch)).auc

                best, value, _ = model_search(objective, AFM_SPACE, n_trials=n_trials)
            g = self.metrics.gauge_set
            if kind == "cf":
                g("master_collaborative_filtering_search_seconds", time.perf_counter() - t0)
                g("master_collaborative_filtering_search_precision_10", value)
            else:
                g("master_ranking_search_seconds", time.perf_counter() - t0)
                g("master_ranking_search_precision", value)
            self.meta.put(f"BEST_PARAMS_{kind.upper()}", json.dumps(dict(best)))
            logger.info("model search %s: best=%.4f params=%s", kind, value, dict(best))
            return dict(best)

    def collect_garbage(self, data: LoadedData | None = None) -> None:
        """Drop every model blob but the live CF index and CTR model; with
        ``data``, prune score collections whose subset names a removed
        recommender entry or an entity missing from the dataset (their
        digest keys too), keeping rows written after the dataset's snapshot
        time."""
        keep = {
            self.meta.get(COLLABORATIVE_FILTERING_MODEL),
            self.meta.get(CLICK_THROUGH_RATE_MODEL),
        }
        for name in self.blob.list():
            if name not in keep:
                self.blob.remove(name)
        if data is None:
            return
        t0 = time.perf_counter()
        cfg = self.config.recommend
        np_names = {e.name for e in cfg.non_personalized} | {"popular", "latest"}
        i2i_names = {e.name for e in cfg.item_to_item}
        u2u_names = {e.name for e in cfg.user_to_user}
        dataset = data.dataset
        before = data.timestamp or time.time()
        scanned = reclaimed = 0
        for collection in (ck.NON_PERSONALIZED, ck.ITEM_TO_ITEM, ck.USER_TO_USER,
                           ck.COLLABORATIVE):
            subsets = set(self.cache.scan_score_subsets(collection))
            scanned += len(subsets)
            stale: list[str] = []
            stale_digest_keys: list[str] = []
            for subset in subsets:
                if collection == ck.NON_PERSONALIZED:
                    if subset not in np_names:
                        stale.append(subset)
                elif collection == ck.ITEM_TO_ITEM:
                    name, _, item_id = subset.partition("/")
                    if name not in i2i_names or dataset.item_dict.to_number(item_id) < 0:
                        stale.append(subset)
                        stale_digest_keys.append(key(ck.ITEM_TO_ITEM_DIGEST, name, item_id))
                elif collection == ck.USER_TO_USER:
                    name, _, user_id = subset.partition("/")
                    if name not in u2u_names or dataset.user_dict.to_number(user_id) < 0:
                        stale.append(subset)
                        stale_digest_keys.append(key(ck.USER_TO_USER_DIGEST, name, user_id))
                elif dataset.user_dict.to_number(subset) < 0:  # CF: the subset is a user
                    stale.append(subset)
                    stale_digest_keys.append(key(ck.COLLABORATIVE_DIGEST, subset))
            if stale:
                # rows of removed non-personalized entries go whatever their
                # time; entity rows written after the snapshot stay
                self.cache.delete_scores(
                    collection, stale,
                    before=None if collection == ck.NON_PERSONALIZED else before,
                )
                for k in stale_digest_keys:
                    self.cache.delete(k)
                reclaimed += len(stale)
        g = self.metrics.gauge_set
        g("master_cache_scanned_total", scanned)
        g("master_cache_reclaimed_total", reclaimed)
        g("master_cache_scanned_seconds", time.perf_counter() - t0)

    # ------------------------------------------------------------- main loop

    def run_tasks_once(self, search: bool = False) -> LoadedData:
        """One pass of the task sequence, in the reference's order: load,
        non-personalized, item-to-item, user-to-user, CF, CTR, garbage
        collection, then (at most once a minute, on a thread) the memory
        accounting gauges. With ``search``, the CF search runs after the
        fits; each search also runs when its ``optimize_period`` has come
        due (at most once a period; the first cycle finds both due)."""
        data = self.load_dataset()
        self.update_non_personalized(data)
        self.update_item_to_item(data)
        self.update_user_to_user(data)
        self.train_collaborative_filtering(data)
        self.train_click_through_rate(data)
        now = time.time()
        if search:
            self._last_optimize["cf"] = now
            self.search_model(data, "cf")
        cf_cfg = self.config.recommend.collaborative
        if (
            cf_cfg.optimize_period > 0
            and cf_cfg.type != "none"
            and now - self._last_optimize.get("cf", 0.0) >= cf_cfg.optimize_period * 60.0
            and data.train.count_feedback() > 0
        ):
            self._last_optimize["cf"] = now
            self.search_model(data, "cf")
        ranker_cfg = self.config.recommend.ranker
        if (
            ranker_cfg.optimize_period > 0
            and ranker_cfg.type == "fm"
            and now - self._last_optimize.get("ctr", 0.0) >= ranker_cfg.optimize_period * 60.0
            and data.ctr is not None
            and len(data.ctr) > 0
        ):
            self._last_optimize["ctr"] = now
            self.search_model(data, "ctr")
        self.collect_garbage(data)
        # the deep walk is O(rows) in Python: at most once a minute
        now_ts = time.perf_counter()
        if now_ts - self._sizeof_ts > 60.0 and not self._sizeof_busy:
            self._sizeof_ts = now_ts
            self._sizeof_busy = True
            threading.Thread(target=self._account_memory, args=(data,),
                             name="memory-accounting", daemon=True).start()
        return data

    def _account_memory(self, data: LoadedData) -> None:
        """``master_memory_inuse_bytes`` for the dataset, the CF index and
        the CTR model."""
        try:
            sizes = {
                "dataset": deep_size(data),
                "cf_index": deep_size(self.cf_index),
                "ctr_model": deep_size(self.ctr_model),
            }
            self.memory_inuse = sizes
            for component, nbytes in sizes.items():
                self.metrics.gauge_set("master_memory_inuse_bytes", nbytes,
                                       labels={"data": component})
        except Exception:  # noqa: BLE001 - a mutation mid-walk costs this sample only
            logger.debug("memory accounting walk aborted", exc_info=True)
        finally:
            self._sizeof_busy = False

    def trigger(self) -> None:
        """Run the task cycle now (the dashboard's 'train now')."""
        self._trigger.set()

    def run_tasks_loop(self) -> None:
        """Run the task cycle until ``shutdown``, every
        ``collaborative.fit_period`` minutes or on ``trigger``; a failed
        cycle is logged and the loop goes on."""
        period = self.config.recommend.collaborative.fit_period * 60.0
        while not self._stop.is_set():
            try:
                self.run_tasks_once()
            except Exception:  # noqa: BLE001 - keep the loop alive
                logger.exception("task loop iteration failed")
            self._trigger.wait(timeout=period)
            self._trigger.clear()

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self.run_tasks_loop, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self._trigger.set()
        if self._thread:
            self._thread.join(timeout=5.0)
        tracer().flush()  # the trailing spans, fewer than a batch
