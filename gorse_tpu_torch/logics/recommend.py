"""Recommendation composition: the recommender chain (port of
gorse_tpu/logics/recommend.py).

Sources are composed in order with a shared exclusion set until a limit is
reached: ``latest``, ``collaborative``, ``non-personalized/<name>``,
``item-to-item/<name>``, ``user-to-user/<name>``. They read only the cache
and data stores. ``external/<name>`` is not ported yet.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable

from ..storage import cache as cache_keys
from ..storage.cache import CacheStore, key
from ..storage.data import DataStore
from ..storage.types import Score
from ..utils.expression import match_any

LATEST = "latest"
COLLABORATIVE = "collaborative"
NON_PERSONALIZED_PREFIX = "non-personalized/"
ITEM_TO_ITEM_PREFIX = "item-to-item/"
USER_TO_USER_PREFIX = "user-to-user/"
EXTERNAL_PREFIX = "external/"


def step_label(fullname: str) -> str:
    """Map a recommender source name to its offline_recommend step label."""
    if fullname == COLLABORATIVE:
        return "collaborative_recommend"
    if fullname == LATEST:
        return "latest_recommend"
    if fullname == NON_PERSONALIZED_PREFIX + "popular":
        return "popular_recommend"
    if fullname.startswith(NON_PERSONALIZED_PREFIX):
        return "non_personalized_recommend"
    if fullname.startswith(ITEM_TO_ITEM_PREFIX):
        return "item_based_recommend"
    if fullname.startswith(USER_TO_USER_PREFIX):
        return "user_based_recommend"
    if fullname.startswith(EXTERNAL_PREFIX):
        return "external_recommend"
    return "unknown_recommend"


def md5(*parts: str) -> str:
    return hashlib.md5("".join(parts).encode()).hexdigest()


class Recommender:
    """``config`` is a RecommendConfig (utils/config.py). The exclusion set
    starts from the user's feedback: negative feedback always excluded;
    other feedback excluded unless replacement is enabled in online mode.
    """

    def __init__(
        self,
        config,
        cache_client: CacheStore,
        data_client: DataStore,
        online: bool,
        user_id: str,
        categories: list[str] | None = None,
    ) -> None:
        self.config = config
        self.cache = cache_client
        self.data = data_client
        self.online = online
        self.user_id = user_id
        self.categories = categories or []
        self.user_feedback = data_client.get_user_feedback(user_id, end_time=time.time())
        self.exclude_set: set[str] = set()
        self.coldstart = True
        for fb in self.user_feedback:
            if match_any(config.data_source.negative_feedback_types, fb.feedback_type, fb.value):
                self.exclude_set.add(fb.item_id)
            elif not config.replacement.enable_replacement or not online:
                self.exclude_set.add(fb.item_id)
            if match_any(config.data_source.positive_feedback_types, fb.feedback_type, fb.value):
                self.coldstart = False

    def is_cold_start(self) -> bool:
        return self.coldstart

    def recommend(self, limit: int) -> list[Score]:
        """Ranker-backed cache first, then the fallback chain."""
        result: list[Score] = []
        if self.config.ranker.type.lower() != "none":
            scores = self.cache.search_scores(
                cache_keys.RECOMMEND, self.user_id, self.categories, 0, self.config.cache_size
            )
            for s in scores:
                if s.id not in self.exclude_set:
                    self.exclude_set.add(s.id)
                    result.append(s)
        else:
            result, _ = self.recommend_sequential(
                result, self.config.cache_size, self.config.ranker.recommenders
            )
        if limit > 0 and len(result) >= limit:
            return result[:limit]
        result, _ = self.recommend_sequential(result, limit, self.config.fallback.recommenders)
        return result

    def recommend_sequential(
        self,
        result: list[Score],
        limit: int,
        names: list[str],
        timings: dict[str, float] | None = None,
    ) -> tuple[list[Score], str]:
        """Compose ``names`` in order. When ``timings`` is given, per-source
        elapsed seconds accumulate into it under the offline_recommend step
        labels."""
        digests = []
        for name in names:
            fn = self.parse(name)
            if timings is None:
                scores, digest = fn()
            else:
                t0 = time.perf_counter()
                scores, digest = fn()
                label = step_label(name)
                timings[label] = timings.get(label, 0.0) + time.perf_counter() - t0
            for s in scores:
                self.exclude_set.add(s.id)
            result = result + scores
            digests.append(digest)
            if limit > 0 and len(result) >= limit:
                return result[:limit], md5(*digests)
        return result, md5(*digests)

    def parse(self, fullname: str) -> Callable[[], tuple[list[Score], str]]:
        if fullname == COLLABORATIVE:
            return self._recommend_collaborative
        if fullname == LATEST:
            return self._recommend_latest
        if fullname.startswith(NON_PERSONALIZED_PREFIX):
            name = fullname[len(NON_PERSONALIZED_PREFIX):]
            return lambda: self._recommend_non_personalized(name)
        if fullname.startswith(ITEM_TO_ITEM_PREFIX):
            name = fullname[len(ITEM_TO_ITEM_PREFIX):]
            return lambda: self._recommend_item_to_item(name)
        if fullname.startswith(USER_TO_USER_PREFIX):
            name = fullname[len(USER_TO_USER_PREFIX):]
            return lambda: self._recommend_user_to_user(name)
        if fullname.startswith(EXTERNAL_PREFIX):
            raise NotImplementedError(
                f"recommender {fullname!r}: external sources are not ported yet "
                "(ROADMAP.md, M16)"
            )
        raise ValueError(f"unknown recommender: {fullname}")

    def _recommend_latest(self) -> tuple[list[Score], str]:
        after = None
        if self.config.data_source.item_ttl > 0:
            after = time.time() - self.config.data_source.item_ttl * 86400
        items = self.data.get_latest_items(self.config.cache_size, self.categories, after)
        scores = [
            Score(id=i.item_id, score=float(i.timestamp), categories=i.categories)
            for i in items
            if i.item_id not in self.exclude_set
        ]
        return scores, "latest"

    def _recommend_collaborative(self) -> tuple[list[Score], str]:
        items = self.cache.search_scores(
            cache_keys.COLLABORATIVE, self.user_id, self.categories, 0, self.config.cache_size
        )
        digest = self.cache.get(key(cache_keys.COLLABORATIVE_DIGEST, self.user_id)) or ""
        return [s for s in items if s.id not in self.exclude_set], digest

    def _recommend_non_personalized(self, name: str) -> tuple[list[Score], str]:
        categories = self.categories if self.categories else [""]
        items = self.cache.search_scores(
            cache_keys.NON_PERSONALIZED, name, categories, 0, self.config.cache_size
        )
        digest = self.cache.get(key(cache_keys.NON_PERSONALIZED_DIGEST, name)) or ""
        return [s for s in items if s.id not in self.exclude_set], digest

    def _recommend_item_to_item(self, name: str) -> tuple[list[Score], str]:
        """Aggregate neighbors of the user's positive history."""
        feedback = []
        for fb in sorted(self.user_feedback, key=lambda f: -f.timestamp):
            if match_any(
                self.config.data_source.positive_feedback_types, fb.feedback_type, fb.value
            ):
                feedback.append(fb)
                if self.online and len(feedback) >= self.config.context_size:
                    break
        scores: dict[str, float] = {}
        categories: dict[str, list[str]] = {}
        digests = set()
        for fb in feedback:
            similar = self.cache.search_scores(
                cache_keys.ITEM_TO_ITEM, key(name, fb.item_id), self.categories,
                0, self.config.cache_size,
            )
            digest = self.cache.get(key(cache_keys.ITEM_TO_ITEM_DIGEST, name, fb.item_id)) or ""
            for s in similar:
                if s.id not in self.exclude_set:
                    scores[s.id] = scores.get(s.id, 0.0) + s.score
                    categories[s.id] = s.categories
                    digests.add(digest)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])[: self.config.cache_size]
        return (
            [Score(id=i, score=v, categories=categories[i]) for i, v in ranked],
            "".join(sorted(digests)),
        )

    def _recommend_user_to_user(self, name: str) -> tuple[list[Score], str]:
        """Aggregate the positive feedback of similar users."""
        scores: dict[str, float] = {}
        similar_users = self.cache.search_scores(
            cache_keys.USER_TO_USER, key(name, self.user_id), None, 0, self.config.cache_size
        )
        digest = self.cache.get(key(cache_keys.USER_TO_USER_DIGEST, name, self.user_id)) or ""
        for user in similar_users:
            feedbacks = self.data.get_user_feedback(
                user.id, end_time=time.time(),
                feedback_types=None,
            )
            for fb in feedbacks:
                if not match_any(
                    self.config.data_source.positive_feedback_types, fb.feedback_type, fb.value
                ):
                    continue
                if fb.item_id not in self.exclude_set:
                    scores[fb.item_id] = scores.get(fb.item_id, 0.0) + user.score
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])[: self.config.cache_size]
        after = None
        if self.config.data_source.item_ttl > 0:
            after = time.time() - self.config.data_source.item_ttl * 86400
        items = self.data.batch_get_items([i for i, _ in ranked], skip_hidden=True, after=after)
        items_map = {i.item_id: i for i in items}
        results = []
        for item_id, score in ranked:
            item = items_map.get(item_id)
            if item is not None and all(c in item.categories for c in self.categories):
                results.append(Score(id=item_id, score=score, categories=item.categories))
        return results, digest
