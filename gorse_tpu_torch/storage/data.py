"""Data store: users, items, feedback (the abstract store and the in-memory
one of gorse_tpu/storage/data.py). Streams are Python iterators; scan
options (begin id, feedback types, time ranges) are keyword arguments.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator

from .types import Feedback, Item, User


class DataStore:
    """Abstract data store."""

    # --- users
    def insert_users(self, users: Iterable[User]) -> None:
        raise NotImplementedError

    def get_user(self, user_id: str) -> User | None:
        raise NotImplementedError

    def delete_user(self, user_id: str) -> None:
        raise NotImplementedError

    def get_users(self, begin_id: str = "", limit: int | None = None) -> Iterator[User]:
        raise NotImplementedError

    # --- items
    def insert_items(self, items: Iterable[Item]) -> None:
        raise NotImplementedError

    def get_item(self, item_id: str) -> Item | None:
        raise NotImplementedError

    def delete_item(self, item_id: str) -> None:
        raise NotImplementedError

    def get_items(self, begin_id: str = "", limit: int | None = None) -> Iterator[Item]:
        raise NotImplementedError

    def batch_get_items(self, item_ids: list[str], skip_hidden: bool = False, after: float | None = None) -> list[Item]:
        out = []
        for iid in item_ids:
            item = self.get_item(iid)
            if item is None:
                continue
            if skip_hidden and item.is_hidden:
                continue
            if after is not None and item.timestamp < after:
                continue
            out.append(item)
        return out

    def get_latest_items(self, limit: int, categories: list[str] | None = None, after: float | None = None) -> list[Item]:
        """Newest non-hidden items, optionally filtered by category."""
        items = [i for i in self.get_items() if not i.is_hidden]
        if after is not None:
            items = [i for i in items if i.timestamp >= after]
        if categories:
            items = [i for i in items if all(c in i.categories for c in categories)]
        items.sort(key=lambda i: -i.timestamp)
        return items[:limit]

    # --- feedback
    def insert_feedback(
        self,
        feedback: Iterable[Feedback],
        insert_user: bool = True,
        insert_item: bool = True,
        overwrite: bool = True,
    ) -> None:
        raise NotImplementedError

    def get_user_feedback(self, user_id: str, end_time: float | None = None, feedback_types: list[str] | None = None) -> list[Feedback]:
        raise NotImplementedError

    def get_item_feedback(self, item_id: str, feedback_types: list[str] | None = None) -> list[Feedback]:
        raise NotImplementedError

    def get_feedback(
        self,
        begin_time: float | None = None,
        end_time: float | None = None,
        feedback_types: list[str] | None = None,
    ) -> Iterator[Feedback]:
        raise NotImplementedError

    def delete_user_item_feedback(self, user_id: str, item_id: str, feedback_types: list[str] | None = None) -> int:
        raise NotImplementedError

    def count_users(self) -> int:
        return sum(1 for _ in self.get_users())

    def count_items(self) -> int:
        return sum(1 for _ in self.get_items())

    def count_feedback(self) -> int:
        return sum(1 for _ in self.get_feedback())

    def purge(self) -> None:
        raise NotImplementedError

    def ping(self) -> bool:
        return True

    def close(self) -> None:
        pass


class MemoryDataStore(DataStore):
    """In-memory store; thread-safe. Serving-path reads are index-backed:
    per-user and per-item feedback dicts, plus a lazily rebuilt newest-first
    item list for get_latest_items, so the online path scans O(limit)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._users: dict[str, User] = {}
        self._items: dict[str, Item] = {}
        self._feedback: dict[tuple[str, str, str], Feedback] = {}
        # secondary indexes: user_id / item_id -> {feedback key -> Feedback}
        self._fb_by_user: dict[str, dict[tuple, Feedback]] = {}
        self._fb_by_item: dict[str, dict[tuple, Feedback]] = {}
        self._items_ver = 0  # bumped on any item mutation
        self._latest_cache: tuple[int, list[Item]] = (-1, [])

    def _index_feedback(self, f: Feedback) -> None:
        k = f.key()
        self._fb_by_user.setdefault(f.user_id, {})[k] = f
        self._fb_by_item.setdefault(f.item_id, {})[k] = f

    def _unindex_key(self, k: tuple) -> None:
        user_fb = self._fb_by_user.get(k[1])
        if user_fb is not None:
            user_fb.pop(k, None)
            if not user_fb:
                del self._fb_by_user[k[1]]
        item_fb = self._fb_by_item.get(k[2])
        if item_fb is not None:
            item_fb.pop(k, None)
            if not item_fb:
                del self._fb_by_item[k[2]]

    def insert_users(self, users: Iterable[User]) -> None:
        with self._lock:
            for u in users:
                self._users[u.user_id] = u

    def get_user(self, user_id: str) -> User | None:
        return self._users.get(user_id)

    def delete_user(self, user_id: str) -> None:
        with self._lock:
            self._users.pop(user_id, None)
            for k in list(self._fb_by_user.pop(user_id, {})):
                del self._feedback[k]
                item_fb = self._fb_by_item.get(k[2])
                if item_fb is not None:
                    item_fb.pop(k, None)
                    if not item_fb:
                        del self._fb_by_item[k[2]]

    def get_users(self, begin_id: str = "", limit: int | None = None) -> Iterator[User]:
        with self._lock:
            ids = sorted(self._users)
        n = 0
        for uid in ids:
            if uid <= begin_id and begin_id:
                continue
            yield self._users[uid]
            n += 1
            if limit is not None and n >= limit:
                return

    def insert_items(self, items: Iterable[Item]) -> None:
        with self._lock:
            for i in items:
                # overwrite semantics, as in every backend of the reference
                self._items[i.item_id] = i
            self._items_ver += 1

    def get_item(self, item_id: str) -> Item | None:
        return self._items.get(item_id)

    def delete_item(self, item_id: str) -> None:
        with self._lock:
            self._items.pop(item_id, None)
            self._items_ver += 1
            for k in list(self._fb_by_item.pop(item_id, {})):
                del self._feedback[k]
                user_fb = self._fb_by_user.get(k[1])
                if user_fb is not None:
                    user_fb.pop(k, None)
                    if not user_fb:
                        del self._fb_by_user[k[1]]

    def get_items(self, begin_id: str = "", limit: int | None = None) -> Iterator[Item]:
        with self._lock:
            ids = sorted(self._items)
        n = 0
        for iid in ids:
            if iid <= begin_id and begin_id:
                continue
            yield self._items[iid]
            n += 1
            if limit is not None and n >= limit:
                return

    def insert_feedback(self, feedback, insert_user=True, insert_item=True, overwrite=True) -> None:
        with self._lock:
            for f in feedback:
                if insert_user and f.user_id not in self._users:
                    self._users[f.user_id] = User(user_id=f.user_id)
                elif not insert_user and f.user_id not in self._users:
                    continue
                if insert_item and f.item_id not in self._items:
                    self._items[f.item_id] = Item(item_id=f.item_id)
                    self._items_ver += 1
                elif not insert_item and f.item_id not in self._items:
                    continue
                if overwrite or f.key() not in self._feedback:
                    self._feedback[f.key()] = f
                    self._index_feedback(f)

    def get_user_feedback(self, user_id, end_time=None, feedback_types=None):
        with self._lock:
            out = [
                f
                for f in self._fb_by_user.get(user_id, {}).values()
                if (end_time is None or f.timestamp <= end_time)
                and (not feedback_types or f.feedback_type in feedback_types)
            ]
        out.sort(key=lambda f: -f.timestamp)
        return out

    def get_item_feedback(self, item_id, feedback_types=None):
        with self._lock:
            return [
                f
                for f in self._fb_by_item.get(item_id, {}).values()
                if not feedback_types or f.feedback_type in feedback_types
            ]

    def get_latest_items(self, limit, categories=None, after=None):
        """Index-backed: a newest-first snapshot is rebuilt lazily after item
        mutations, so a call scans O(limit) instead of sorting the table."""
        with self._lock:
            ver, ordered = self._latest_cache
            if ver != self._items_ver:
                ordered = sorted(
                    (i for i in self._items.values() if not i.is_hidden),
                    key=lambda i: -i.timestamp,
                )
                self._latest_cache = (self._items_ver, ordered)
        out = []
        for i in ordered:
            if after is not None and i.timestamp < after:
                break  # newest-first: everything after is older still
            if categories and not all(c in i.categories for c in categories):
                continue
            out.append(i)
            if len(out) >= limit:
                break
        return out

    def get_feedback(self, begin_time=None, end_time=None, feedback_types=None):
        with self._lock:
            snapshot = list(self._feedback.values())
        for f in snapshot:
            if begin_time is not None and f.timestamp < begin_time:
                continue
            if end_time is not None and f.timestamp > end_time:
                continue
            if feedback_types and f.feedback_type not in feedback_types:
                continue
            yield f

    def delete_user_item_feedback(self, user_id, item_id, feedback_types=None) -> int:
        with self._lock:
            keys = [
                k
                for k in self._fb_by_user.get(user_id, {})
                if k[2] == item_id and (not feedback_types or k[0] in feedback_types)
            ]
            for k in keys:
                del self._feedback[k]
                self._unindex_key(k)
            return len(keys)

    def purge(self) -> None:
        with self._lock:
            self._users.clear()
            self._items.clear()
            self._feedback.clear()
            self._fb_by_user.clear()
            self._fb_by_item.clear()
            self._items_ver += 1
