"""Item full-text search (copy of gorse_tpu/storage/search.py).

Search *columns* are item expressions (``item_id``, ``comment``,
``labels``, ``labels.title``, with or without an ``item.`` prefix).
``DataStore.reconcile`` materializes a search document per item and
``search_items`` ranks items against a query: SQLite through its FTS5 index,
every other store through the tokenized scan here.
"""

from __future__ import annotations

import re
from typing import Iterable

from .types import Item

_TOKEN = re.compile(r"[\w]+", re.UNICODE)


def _flatten(value) -> list[str]:
    if value is None:
        return []
    if isinstance(value, str):
        return [value]
    if isinstance(value, (int, float, bool)):
        return [str(value)]
    if isinstance(value, dict):
        out = []
        for v in value.values():
            out.extend(_flatten(v))
        return out
    if isinstance(value, (list, tuple)):
        out = []
        for v in value:
            out.extend(_flatten(v))
        return out
    return [str(value)]


def _column_value(item: Item, column: str) -> list[str]:
    col = column
    if col.lower().startswith("item."):
        col = col[len("item."):]
    parts = col.split(".")
    head = parts[0].lower()
    if head in ("item_id", "itemid"):
        value: object = item.item_id
    elif head == "comment":
        value = item.comment
    elif head == "categories":
        value = item.categories
    elif head == "labels":
        value = item.labels
        for key in parts[1:]:
            if isinstance(value, dict):
                value = value.get(key)
            else:
                value = None
        return _flatten(value)
    else:
        return []
    return _flatten(value)


def search_document(item: Item, columns: list[str]) -> str:
    """The concatenated text the search index sees for one item."""
    parts: list[str] = []
    for col in columns:
        parts.extend(_column_value(item, col))
    return " ".join(parts)


def tokenize(text: str) -> list[str]:
    return [t.lower() for t in _TOKEN.findall(text)]


def token_search(
    items: Iterable[Item], query: str, n: int, columns: list[str]
) -> list[Item]:
    """Engine-independent ranked scan: score = matched query tokens (term
    frequency breaks ties). Prefix match on the last token supports
    search-as-you-type like FTS5's prefix queries."""
    q_tokens = tokenize(query)
    if not q_tokens:
        return []
    scored: list[tuple[float, Item]] = []
    for item in items:
        doc = tokenize(search_document(item, columns))
        if not doc:
            continue
        score = 0.0
        for i, qt in enumerate(q_tokens):
            exact = doc.count(qt)
            if exact:
                score += 1.0 + 0.01 * exact
            elif i == len(q_tokens) - 1 and any(d.startswith(qt) for d in doc):
                score += 0.5
        if score > 0:
            scored.append((score, item))
    scored.sort(key=lambda t: -t[0])
    return [item for _, item in scored[:n]]
