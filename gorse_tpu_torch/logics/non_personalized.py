"""Non-personalized recommenders: config-defined score/filter expressions
(copy of gorse_tpu/logics/non_personalized.py).

Each configured recommender evaluates a score expression per item over the
item's feedback, optionally filtered, and keeps the top n per category in a
heap. Host work only: the inputs are catalog metadata, not tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import time

from ..storage.types import Feedback, Item, Score
from ..utils.safe_expr import SafeExpression


@dataclasses.dataclass
class NonPersonalizedConfig:
    """Name + score/filter expressions, with variables ``item`` (Item) and
    ``feedback`` (list[Feedback]): score="len(feedback)" (most popular),
    score="item.timestamp" (latest), filter="not item.is_hidden"."""

    name: str
    score: str = "len(feedback)"
    filter: str = ""

    def digest(self) -> str:
        return hashlib.md5(f"{self.name}|{self.score}|{self.filter}".encode()).hexdigest()


class NonPersonalized:
    """Per-category heaps of (score, push order, item id); "" = overall."""

    def __init__(self, cfg: NonPersonalizedConfig, n: int, timestamp: float | None = None) -> None:
        self.name = cfg.name
        self.cfg = cfg
        self.n = n
        self.timestamp = timestamp if timestamp is not None else time.time()
        self._score_fn = SafeExpression(cfg.score)
        self._filter_fn = SafeExpression(cfg.filter) if cfg.filter else None
        self._heaps: dict[str, list] = {"": []}
        self._seq = 0

    def push(self, item: Item, feedback: list[Feedback]) -> None:
        if item.is_hidden:
            return
        if self._filter_fn is not None:
            if not bool(self._filter_fn(item=item, feedback=feedback)):
                return
        score = float(self._score_fn(item=item, feedback=feedback))
        self._seq += 1
        for category in [""] + list(item.categories):
            h = self._heaps.setdefault(category, [])
            heapq.heappush(h, (score, self._seq, item.item_id))
            if len(h) > self.n:
                heapq.heappop(h)

    def pop_all(self) -> list[Score]:
        """The heaps merged into deduplicated Scores with their category
        lists, by score descending (a stable sort: heap order on ties)."""
        merged: dict[str, Score] = {}
        for category, h in self._heaps.items():
            for score, _, item_id in h:
                if item_id not in merged:
                    merged[item_id] = Score(
                        id=item_id, score=score, categories=[category], timestamp=self.timestamp
                    )
                else:
                    merged[item_id].categories.append(category)
        out = list(merged.values())
        out.sort(key=lambda s: -s.score)
        return out
