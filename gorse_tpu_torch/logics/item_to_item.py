"""Item-to-item similarity recommenders (port of
gorse_tpu/logics/item_to_item.py).

Four similarity types: ``embedding`` (vector distance), ``tags``
(IDF-weighted label sets), ``users`` (IDF-weighted co-consumption) and
``auto`` (tags and users averaged). Items are pushed on the host;
``pop_all`` computes every item's neighbours in one blocked pass on the
engine's device (ops/similarity.py) and emits them as Scores,
``1 / (1 + distance)``. The ``chat`` type (LLM queries -> embedding search)
is not ported: it needs jinja2 and an LLM client.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

from .. import resolve_device
from ..ops.similarity import (
    embedding_neighbors,
    idf_neighbors,
    idf_neighbors_avg,
    incidence_matrix,
)
from ..storage.types import Item, Score


def derive_idf(label_lists: list[list[int]], n_docs: int) -> np.ndarray:
    """IDF weights from a pushed corpus: log(N / doc-frequency)."""
    n_labels = max((max(l) + 1 for l in label_lists if l), default=1)
    counts = np.zeros(n_labels)
    for ls in label_lists:
        for l in ls:
            counts[l] += 1
    return np.log(max(n_docs, 1) / np.maximum(counts, 1)).astype(np.float32)


@dataclasses.dataclass
class ItemToItemConfig:
    """Mirror of config.ItemToItemConfig."""

    name: str
    type: str = "auto"  # embedding | tags | users | auto | chat
    column: str = ""  # embedding source: item.labels key holding a vector
    categories: list[str] = dataclasses.field(default_factory=list)
    prompt: str = ""  # chat type: jinja template rendered per item

    def digest(self) -> str:
        return hashlib.md5(
            f"{self.name}|{self.type}|{self.column}|{','.join(self.categories)}|{self.prompt}".encode()
        ).hexdigest()


class BaseItemToItem:
    """Accumulates items host-side, computes neighbours in one pass on
    ``device`` (``None``: the card)."""

    def __init__(self, cfg: ItemToItemConfig, n: int, timestamp: float | None = None,
                 device=None) -> None:
        self.cfg = cfg
        self.name = cfg.name
        self.n = n
        self.timestamp = timestamp if timestamp is not None else time.time()
        self.device = resolve_device(device)
        self.items: list[Item] = []

    def push(self, item: Item, feedback: list[int]) -> None:
        raise NotImplementedError

    def pop_all(self) -> list[tuple[str, list[Score]]]:
        """Return (item_id, neighbours) for every pushed item."""
        raise NotImplementedError

    def _emit(self, dists, idxs) -> list[tuple[str, list[Score]]]:
        """Each row's neighbours as Scores, the sentinel rows (self and
        padding, distance >= 1e29) skipped; ``score = 1 / (1 + d)``, a
        positive similarity that the recommender chain sums over a user's
        history."""
        dists, idxs = dists.cpu().numpy(), idxs.cpu().numpy()
        out = []
        for row, item in enumerate(self.items):
            scores = []
            for d, j in zip(dists[row], idxs[row]):
                if d >= 1e29:
                    continue
                neighbor = self.items[int(j)]
                scores.append(Score(id=neighbor.item_id, score=1.0 / (1.0 + float(d)),
                                    categories=neighbor.categories, timestamp=self.timestamp))
            out.append((item.item_id, scores))
        return out


class EmbeddingItemToItem(BaseItemToItem):
    """Vector-embedding similarity (squared Euclidean distance)."""

    def __init__(self, cfg: ItemToItemConfig, n: int, timestamp: float | None = None,
                 device=None) -> None:
        super().__init__(cfg, n, timestamp, device)
        self.vectors: list[np.ndarray] = []

    def push(self, item: Item, feedback: list[int]) -> None:
        vec = _extract_embedding(item, self.cfg.column)
        if vec is None:
            return
        self.items.append(item)
        self.vectors.append(vec)

    def pop_all(self):
        if not self.items:
            return []
        k = min(self.n, len(self.items) - 1)
        if k <= 0:
            return [(i.item_id, []) for i in self.items]
        return self._emit(*embedding_neighbors(np.stack(self.vectors), k_top=k,
                                               metric="euclidean", device=self.device))


class TagsItemToItem(BaseItemToItem):
    """IDF-weighted tag-set similarity."""

    def __init__(self, cfg, n, timestamp=None, idf: np.ndarray | None = None, label_index=None,
                 device=None):
        super().__init__(cfg, n, timestamp, device)
        self.idf = idf
        self.label_index = label_index  # FreqDict mapping label -> id
        self.label_lists: list[list[int]] = []
        # without a label index, local ids in push order: Python's
        # per-process str hash would make neighbours differ across restarts
        self._local_ids: dict[str, int] = {}

    def _labels_of(self, item: Item) -> list[int]:
        labels = _flatten_labels(item.labels)
        if self.label_index is not None:
            return sorted({self.label_index.to_number(l) for l in labels} - {-1})
        return sorted({self._local_ids.setdefault(l, len(self._local_ids)) for l in labels})

    def push(self, item: Item, feedback: list[int]) -> None:
        self.items.append(item)
        self.label_lists.append(self._labels_of(item))

    def effective_idf(self) -> np.ndarray:
        """Configured IDF, or one derived from the pushed corpus."""
        if self.idf is not None:
            return self.idf
        return derive_idf(self.label_lists, len(self.items))

    def pop_all(self):
        if len(self.items) < 2:
            return [(i.item_id, []) for i in self.items]
        idf = self.effective_idf()
        inc = incidence_matrix(self.label_lists, len(idf))
        k = min(self.n, len(self.items) - 1)
        return self._emit(*idf_neighbors(inc, idf, k_top=k, device=self.device))


class UsersItemToItem(TagsItemToItem):
    """Co-consumption similarity: an item's "label set" is the set of users
    who consumed it, IDF-weighted by user activity."""

    def __init__(self, cfg, n, timestamp=None, user_idf: np.ndarray | None = None, device=None):
        super().__init__(cfg, n, timestamp, idf=user_idf, device=device)

    def push(self, item: Item, feedback: list[int]) -> None:
        self.items.append(item)
        self.label_lists.append(sorted(set(feedback)))


class AutoItemToItem(BaseItemToItem):
    """Average of the tag distance and the user distance."""

    def __init__(self, cfg, n, timestamp=None, tag_idf=None, user_idf=None, label_index=None,
                 device=None):
        super().__init__(cfg, n, timestamp, device)
        self.tags = TagsItemToItem(cfg, n, timestamp, idf=tag_idf, label_index=label_index,
                                   device=self.device)
        self.users = UsersItemToItem(cfg, n, timestamp, user_idf=user_idf, device=self.device)

    def push(self, item: Item, feedback: list[int]) -> None:
        self.items.append(item)
        self.tags.push(item, feedback)
        self.users.push(item, feedback)

    def pop_all(self):
        if len(self.items) < 2:
            return [(i.item_id, []) for i in self.items]
        # every pair's two distances averaged before the top-k, blockwise
        tag_idf = self.tags.effective_idf()
        user_idf = self.users.effective_idf()
        k = min(self.n, len(self.items) - 1)
        return self._emit(*idf_neighbors_avg(
            incidence_matrix(self.tags.label_lists, len(tag_idf)), tag_idf,
            incidence_matrix(self.users.label_lists, len(user_idf)), user_idf,
            k_top=k, device=self.device,
        ))


def _extract_embedding(item: Item, column: str) -> np.ndarray | None:
    """Pull a float vector out of item.labels by key (the ``column``
    expression, ``item.Labels.<key>``)."""
    labels = item.labels
    if not column:
        return np.asarray(labels, dtype=np.float32) if isinstance(labels, list) else None
    key = column.removeprefix("item.Labels.").removeprefix("labels.")
    if isinstance(labels, dict) and key in labels:
        v = labels[key]
        if isinstance(v, list) and v and isinstance(v[0], (int, float)):
            return np.asarray(v, dtype=np.float32)
    return None


def _flatten_labels(labels) -> list[str]:
    """Flatten free-form JSON labels to strings."""
    out: list[str] = []
    if labels is None:
        return out
    if isinstance(labels, str):
        return [labels]
    if isinstance(labels, list):
        return [v for v in labels if isinstance(v, str)]
    if isinstance(labels, dict):
        for key, v in labels.items():
            if isinstance(v, str):
                out.append(f"{key}:{v}")
            elif isinstance(v, list):
                out.extend(f"{key}:{x}" for x in v if isinstance(x, str))
            elif isinstance(v, dict):
                out.extend(f"{key}:{x}" for x in _flatten_labels(v))
    return out


def new_item_to_item(
    cfg: ItemToItemConfig,
    n: int,
    timestamp: float | None = None,
    tag_idf: np.ndarray | None = None,
    user_idf: np.ndarray | None = None,
    label_index=None,
    device=None,
) -> BaseItemToItem:
    """The engine of ``cfg.type`` on ``device`` (``None``: the card)."""
    if cfg.type == "embedding":
        return EmbeddingItemToItem(cfg, n, timestamp, device)
    if cfg.type == "tags":
        return TagsItemToItem(cfg, n, timestamp, idf=tag_idf, label_index=label_index,
                              device=device)
    if cfg.type == "users":
        return UsersItemToItem(cfg, n, timestamp, user_idf=user_idf, device=device)
    if cfg.type == "auto":
        return AutoItemToItem(cfg, n, timestamp, tag_idf=tag_idf, user_idf=user_idf,
                              label_index=label_index, device=device)
    if cfg.type == "chat":
        raise NotImplementedError(
            "item-to-item type 'chat' is not ported yet: it needs jinja2 and an LLM client "
            "(ROADMAP.md, M21)"
        )
    raise ValueError(f"unknown item-to-item type {cfg.type!r}")
