"""Cache store: KV, queues, scored document collections, time series
(the abstract store and the in-memory one of gorse_tpu/storage/cache.py).

Precomputed recommendations live here as scored document collections with
subset/category/time conditions, beside a string KV space (digests, update
times), FIFO queues and time-series points. Key and collection names are
the reference's, so both packages read each other's entries.
"""

from __future__ import annotations

import threading
from typing import Iterator

from .types import Score, TimeSeriesPoint

# collection names
RECOMMEND = "recommend"
COLLABORATIVE = "collaborative_filtering"
ITEM_TO_ITEM = "item-to-item"
USER_TO_USER = "user-to-user"
NON_PERSONALIZED = "non-personalized"
ITEM_CATEGORIES = "item_categories"

# KV key prefixes
RECOMMEND_DIGEST = "recommend_digest"
COLLABORATIVE_DIGEST = "collaborative_filtering_digest"
ITEM_TO_ITEM_DIGEST = "item-to-item_digest"
USER_TO_USER_DIGEST = "user-to-user_digest"
NON_PERSONALIZED_DIGEST = "non-personalized_digest"
ITEM_TO_ITEM_UPDATE_TIME = "item-to-item_update_time"
USER_TO_USER_UPDATE_TIME = "user-to-user_update_time"
NON_PERSONALIZED_UPDATE_TIME = "non-personalized_update_time"
LAST_MODIFY_USER_TIME = "last_modify_user_time"
LAST_MODIFY_ITEM_TIME = "last_modify_item_time"
LAST_UPDATE_USER_RECOMMEND_TIME = "last_update_user_recommend_time"
LAST_FIT_MATCHING_MODEL_TIME = "last_fit_matching_model_time"
LAST_FIT_RANKING_MODEL_TIME = "last_fit_ranking_model_time"
LAST_UPDATE_LATEST_ITEMS_TIME = "last_update_latest_items_time"
LAST_UPDATE_POPULAR_ITEMS_TIME = "last_update_popular_items_time"

# global-meta KV keys and time-series names the master writes
GLOBAL_META = "global_meta"
NUM_USERS = "num_users"
NUM_ITEMS = "num_items"
NUM_FEEDBACK = "num_feedback"
NUM_POS_FEEDBACKS = "num_pos_feedbacks"
NUM_NEG_FEEDBACKS = "num_neg_feedbacks"
NUM_USER_LABELS = "num_user_labels"
NUM_ITEM_LABELS = "num_item_labels"
NUM_TOTAL_POS_FEEDBACKS = "num_total_pos_feedbacks"
NUM_VALID_POS_FEEDBACKS = "num_valid_pos_feedbacks"
NUM_VALID_NEG_FEEDBACKS = "num_valid_neg_feedbacks"
CF_NDCG = "cf_ndcg"
CF_PRECISION = "cf_precision"
CF_RECALL = "cf_recall"
CTR_PRECISION = "ctr_precision"
CTR_RECALL = "ctr_recall"
CTR_AUC = "ctr_auc"


def key(*parts: str) -> str:
    """Compose a cache key."""
    return "/".join(parts)


class CacheStore:
    """Abstract cache store."""

    # --- KV
    def set(self, k: str, v: str) -> None:
        raise NotImplementedError

    def get(self, k: str) -> str | None:
        raise NotImplementedError

    def delete(self, k: str) -> None:
        raise NotImplementedError

    # --- queues
    def push(self, name: str, value: str) -> None:
        raise NotImplementedError

    def pop(self, name: str) -> str | None:
        raise NotImplementedError

    def remain(self, name: str) -> int:
        raise NotImplementedError

    # --- scored collections
    def add_scores(self, collection: str, subset: str, scores: list[Score]) -> None:
        raise NotImplementedError

    def search_scores(
        self,
        collection: str,
        subset: str,
        categories: list[str] | None = None,
        begin: int = 0,
        end: int = -1,
    ) -> list[Score]:
        raise NotImplementedError

    def delete_scores(self, collection: str, subsets: list[str] | None = None, before: float | None = None) -> None:
        raise NotImplementedError

    def update_scores(self, collections: list[str], subset: str | None, item_id: str, categories: list[str] | None = None, is_hidden: bool | None = None) -> None:
        raise NotImplementedError

    def scan_scores(self, collection: str) -> Iterator[tuple[str, Score]]:
        raise NotImplementedError

    def scan_score_subsets(self, collection: str) -> Iterator[str]:
        """Distinct subset names in a collection. Backends override with
        O(subsets) queries; this fallback materializes every row."""
        seen: set[str] = set()
        for subset, _ in self.scan_scores(collection):
            if subset not in seen:
                seen.add(subset)
                yield subset

    # --- time series
    def add_time_series_points(self, points: list[TimeSeriesPoint]) -> None:
        raise NotImplementedError

    def get_time_series_points(self, name: str, begin: float, end: float) -> list[TimeSeriesPoint]:
        raise NotImplementedError

    def ping(self) -> bool:
        return True

    def purge(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _match_categories(score_cats: list[str], want: list[str] | None) -> bool:
    """A document matches if every requested category is on it; an empty
    request matches everything."""
    if not want:
        return True
    return all((c == "" or c in score_cats) for c in want)


class MemoryCacheStore(CacheStore):
    """In-memory cache store."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._kv: dict[str, str] = {}
        self._queues: dict[str, list[str]] = {}
        # collection -> subset -> {id -> Score} (scores sorted at query time)
        self._scores: dict[str, dict[str, dict[str, Score]]] = {}
        # hidden flags scoped per collection: (collection, id)
        self._hidden: set[tuple[str, str]] = set()
        self._ts: list[TimeSeriesPoint] = []

    def set(self, k, v) -> None:
        with self._lock:
            self._kv[k] = v

    def get(self, k):
        return self._kv.get(k)

    def delete(self, k) -> None:
        with self._lock:
            self._kv.pop(k, None)

    def push(self, name, value) -> None:
        with self._lock:
            q = self._queues.setdefault(name, [])
            if value not in q:
                q.append(value)

    def pop(self, name):
        with self._lock:
            q = self._queues.get(name)
            if not q:
                return None
            return q.pop(0)

    def remain(self, name) -> int:
        return len(self._queues.get(name, []))

    def add_scores(self, collection, subset, scores) -> None:
        with self._lock:
            sub = self._scores.setdefault(collection, {}).setdefault(subset, {})
            for s in scores:
                sub[s.id] = s

    def search_scores(self, collection, subset, categories=None, begin=0, end=-1):
        with self._lock:
            sub = self._scores.get(collection, {}).get(subset, {})
            matched = [
                s
                for s in sub.values()
                if (collection, s.id) not in self._hidden
                and _match_categories(s.categories, categories)
            ]
        matched.sort(key=lambda s: -s.score)
        if end < 0:
            end = len(matched)
        return matched[begin:end]

    def delete_scores(self, collection, subsets=None, before=None) -> None:
        with self._lock:
            coll = self._scores.get(collection, {})
            targets = list(coll) if subsets is None else subsets
            for subset in targets:
                if subset not in coll:
                    continue
                if before is None:
                    coll.pop(subset, None)
                else:
                    coll[subset] = {
                        i: s for i, s in coll[subset].items() if s.timestamp >= before
                    }

    def update_scores(self, collections, subset, item_id, categories=None, is_hidden=None) -> None:
        with self._lock:
            # hidden state is scoped to the collections named in the call
            if is_hidden is not None:
                for collection in collections:
                    if is_hidden:
                        self._hidden.add((collection, item_id))
                    else:
                        self._hidden.discard((collection, item_id))
            for collection in collections:
                coll = self._scores.get(collection, {})
                subsets = [subset] if subset is not None else list(coll)
                for ss in subsets:
                    doc = coll.get(ss, {}).get(item_id)
                    if doc is not None and categories is not None:
                        doc.categories = categories

    def scan_scores(self, collection):
        with self._lock:
            snapshot = [
                (subset, s)
                for subset, docs in self._scores.get(collection, {}).items()
                for s in docs.values()
            ]
        yield from snapshot

    def scan_score_subsets(self, collection):
        with self._lock:
            return list(self._scores.get(collection, {}))

    def add_time_series_points(self, points) -> None:
        with self._lock:
            self._ts.extend(points)

    def get_time_series_points(self, name, begin, end):
        with self._lock:
            out = [p for p in self._ts if p.name == name and begin <= p.timestamp <= end]
        out.sort(key=lambda p: p.timestamp)
        return out

    def purge(self) -> None:
        with self._lock:
            self._kv.clear()
            self._queues.clear()
            self._scores.clear()
            self._hidden.clear()
            self._ts.clear()
