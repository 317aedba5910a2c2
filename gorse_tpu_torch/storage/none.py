"""NoDatabase stores, selected when a store is unconfigured: every call
raises ``NoDatabaseError`` and ``ping()`` is False (copy of
gorse_tpu/storage/none.py)."""

from __future__ import annotations

from .cache import CacheStore
from .data import DataStore
from .vectors import VectorStore


class NoDatabaseError(RuntimeError):
    def __init__(self, store: str) -> None:
        super().__init__(f"no {store} store configured")


def _raising(store: str, names: tuple[str, ...]) -> dict:
    def make(name: str):
        def method(self, *args, **kwargs):
            raise NoDatabaseError(store)

        method.__name__ = name
        return method

    ns = {name: make(name) for name in names}
    ns["ping"] = lambda self: False
    ns["close"] = lambda self: None
    ns["purge"] = lambda self: None
    return ns


NoDataStore = type(
    "NoDataStore",
    (DataStore,),
    _raising(
        "data",
        (
            "insert_users", "get_user", "delete_user", "get_users",
            "insert_items", "get_item", "delete_item", "get_items",
            "batch_get_items", "get_latest_items", "insert_feedback",
            "get_user_feedback", "get_item_feedback", "get_feedback",
            "delete_user_item_feedback", "count_users", "count_items",
            "count_feedback", "reconcile", "search_items",
        ),
    ),
)

NoCacheStore = type(
    "NoCacheStore",
    (CacheStore,),
    _raising(
        "cache",
        (
            "set", "get", "delete", "push", "pop", "remain",
            "add_scores", "search_scores", "delete_scores", "update_scores",
            "scan_scores", "scan_score_subsets",
            "add_time_series_points", "get_time_series_points",
        ),
    ),
)

NoVectorStore = type(
    "NoVectorStore",
    (VectorStore,),
    _raising(
        "vector",
        (
            "create_collection", "describe_collection", "list_collections",
            "has_collection", "drop_collection", "add", "delete", "query",
        ),
    ),
)
