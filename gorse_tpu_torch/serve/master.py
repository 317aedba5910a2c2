"""Master node: load the dataset and train the CF model (port of the CF
tasks of gorse_tpu/serve/master.py).

``load_dataset`` streams users, items and feedback from the data store into
the training dataset and its leave-one-out split, and records the catalog
gauges, global-meta keys and time series under the reference's names.
``train_collaborative_filtering`` fits the MF model on the card (BPR by
default), builds the serving index, saves it to the blob store and records
its id in the meta store, where ``get_meta`` hands it to workers.

Not ported yet: the CTR dataset and ranker (``ctr`` stays ``None``), the
data store's search-column reconcile, the other tasks of
``run_tasks_once``, the vector-store sync, hyper-parameter search, and
sharded training (``training_mesh`` is ``None``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time

from ..data.dataset import Dataset
from ..logics.cf import MatrixFactorizationIndex
from ..models import FitConfig, Params, create_mf_model
from ..storage import cache as ck
from ..storage.blob import BlobStore
from ..storage.cache import CacheStore, key
from ..storage.data import DataStore
from ..storage.meta import CLICK_THROUGH_RATE_MODEL, COLLABORATIVE_FILTERING_MODEL, MetaStore
from ..storage.types import TimeSeriesPoint
from ..utils.config import Config
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


def _flatten_labels(labels) -> list[str]:
    """Free-form JSON labels flattened to strings (copy of
    gorse_tpu/logics/item_to_item.py _flatten_labels)."""
    out: list[str] = []
    if labels is None:
        return out
    if isinstance(labels, str):
        return [labels]
    if isinstance(labels, list):
        return [v for v in labels if isinstance(v, str)]
    if isinstance(labels, dict):
        for k, v in labels.items():
            if isinstance(v, str):
                out.append(f"{k}:{v}")
            elif isinstance(v, list):
                out.extend(f"{k}:{x}" for x in v if isinstance(x, str))
            elif isinstance(v, dict):
                out.extend(f"{k}:{x}" for x in _flatten_labels(v))
    return out


class Master:
    def __init__(
        self,
        config: Config,
        data_store: DataStore,
        cache_store: CacheStore,
        blob_store: BlobStore,
        meta_store: MetaStore,
        device=None,
    ) -> None:
        self.config = config
        self.data = data_store
        self.cache = cache_store
        self.blob = blob_store
        self.meta = meta_store
        self.device = device  # None: the card
        self.progress = ProgressTracker()
        self.metrics = MetricsRegistry(namespace="gorse")
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

    def _sync_cf_vectors(self) -> None:
        """The reference upserts the item factors into its vector store
        here; no vector store is ported yet (ROADMAP.md, M11)."""

    def meta_model_params(self, kind: str) -> dict:
        """Best params from a past hyper-parameter search, if recorded."""
        raw = self.meta.get(f"BEST_PARAMS_{kind.upper()}")
        return json.loads(raw) if raw else {}

    def _record_ts(self, name: str, value: float) -> None:
        self.cache.add_time_series_points(
            [TimeSeriesPoint(name=name, timestamp=time.time(), value=float(value))]
        )
