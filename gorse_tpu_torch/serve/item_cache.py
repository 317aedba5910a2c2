"""Worker-local item metadata cache (port of gorse_tpu/serve/item_cache.py).

Workers hold the item metadata their pipeline touches in memory, with
numeric vectors inside free-form labels compressed to bf16 (a bf16 tensor
here) and repeated strings interned. The cache batches store reads: one
``batch_get_items`` round trip per pipeline run.
"""

from __future__ import annotations

import sys
import threading

import torch

from ..storage.types import Item


def compress_labels(labels):
    """Recursively compress label JSON: numeric vectors -> bf16 tensors,
    strings interned."""
    if labels is None:
        return None
    if isinstance(labels, str):
        return sys.intern(labels)
    if isinstance(labels, dict):
        return {sys.intern(k): compress_labels(v) for k, v in labels.items()}
    if isinstance(labels, torch.Tensor):
        return labels.to(torch.bfloat16) if labels.is_floating_point() else labels
    if isinstance(labels, (list, tuple)):
        if labels and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in labels):
            # an embedding vector
            return torch.tensor(labels, dtype=torch.float32).to(torch.bfloat16)
        return [compress_labels(v) for v in labels]
    return labels


def decompress_labels(labels):
    """Back to plain JSON-compatible values (bf16 tensors -> float lists)."""
    if isinstance(labels, torch.Tensor):
        return [float(x) for x in labels.float()]
    if isinstance(labels, dict):
        return {k: decompress_labels(v) for k, v in labels.items()}
    if isinstance(labels, list):
        return [decompress_labels(v) for v in labels]
    return labels


class ItemCache:
    def __init__(self, data_store) -> None:
        self._data = data_store
        self._lock = threading.RLock()
        self._items: dict[str, Item | None] = {}

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def prefetch(self, item_ids) -> None:
        """Load many items in one store round trip."""
        with self._lock:
            missing = [i for i in dict.fromkeys(item_ids) if i not in self._items]
            if not missing:
                return
            found = {it.item_id: it for it in self._data.batch_get_items(missing)}
            for iid in missing:
                self._items[iid] = self._compress(found.get(iid))

    @staticmethod
    def _compress(item: Item | None) -> Item | None:
        if item is None:
            return None
        return Item(
            item_id=sys.intern(item.item_id),
            is_hidden=item.is_hidden,
            categories=[sys.intern(c) for c in item.categories],
            timestamp=item.timestamp,
            labels=compress_labels(item.labels),
            comment=item.comment,
        )

    def get(self, item_id: str) -> Item | None:
        with self._lock:
            if item_id not in self._items:
                self._items[item_id] = self._compress(self._data.get_item(item_id))
            return self._items[item_id]

    def __len__(self) -> int:
        return sum(1 for v in self._items.values() if v is not None)
