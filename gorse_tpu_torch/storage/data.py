"""Data store: users, items, feedback (port of gorse_tpu/storage/data.py).

The abstract store, the in-memory store and the SQLite store, with the
reference's schema, statements and indexes (its FTS5 item-search index
included), so either package reads the other's ``data.sqlite``. Streams are
Python iterators; scan options (begin id, feedback types, time ranges) are
keyword arguments. ``open_data_store`` also opens the server SQL stores
(sqlstores.py), MongoDB (mongo.py) and the master's gRPC proxy
(``proxy://``, proxy.py).
"""

from __future__ import annotations

import json
import sqlite3
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

    def reconcile(self, search_columns: list[str]) -> None:
        """Record the full-text search columns for ``search_items`` (the
        SQLite store also builds its index from them)."""
        self._search_columns = list(search_columns)

    def search_items(self, query: str, n: int, columns: list[str] | None = None) -> list[Item]:
        """Ranked full-text item search over ``columns`` (the caller's
        ``[recommend.search].columns``; by default the columns ``reconcile``
        recorded, so a process that never reconciled can still search).
        The default engine is the tokenized scan of storage/search.py."""
        from .search import token_search

        columns = columns or getattr(self, "_search_columns", [])
        if not columns:
            return []
        return token_search(self.get_items(), query, n, columns)

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


class SQLiteDataStore(DataStore):
    """SQLite-backed store, the reference's schema and statements. One
    connection (``check_same_thread=False``) behind an ``RLock`` serves the
    reconcile thread, the REST handlers and the task cycle."""

    def __init__(self, path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                "CREATE TABLE IF NOT EXISTS users (user_id TEXT PRIMARY KEY, labels TEXT, comment TEXT, subscribe TEXT)"
            )
            cur.execute(
                "CREATE TABLE IF NOT EXISTS items (item_id TEXT PRIMARY KEY, is_hidden INTEGER, categories TEXT, timestamp REAL, labels TEXT, comment TEXT)"
            )
            cur.execute(
                "CREATE TABLE IF NOT EXISTS feedback (feedback_type TEXT, user_id TEXT, item_id TEXT, value REAL, timestamp REAL, comment TEXT, PRIMARY KEY (feedback_type, user_id, item_id))"
            )
            cur.execute("CREATE INDEX IF NOT EXISTS idx_feedback_user ON feedback (user_id)")
            cur.execute("CREATE INDEX IF NOT EXISTS idx_feedback_item ON feedback (item_id)")
            # serves get_latest_items newest-first without a table sort
            cur.execute("CREATE INDEX IF NOT EXISTS idx_items_timestamp ON items (timestamp DESC)")
            self._conn.commit()

    def insert_users(self, users) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO users VALUES (?, ?, ?, ?)",
                [
                    (u.user_id, json.dumps(u.labels), u.comment, json.dumps(u.subscribe))
                    for u in users
                ],
            )
            self._conn.commit()

    def get_user(self, user_id):
        with self._lock:
            row = self._conn.execute(
                "SELECT user_id, labels, comment, subscribe FROM users WHERE user_id = ?",
                (user_id,),
            ).fetchone()
        if row is None:
            return None
        return User(
            user_id=row[0], labels=json.loads(row[1] or "null"), comment=row[2] or "",
            subscribe=json.loads(row[3] or "null"),
        )

    def delete_user(self, user_id) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM users WHERE user_id = ?", (user_id,))
            self._conn.execute("DELETE FROM feedback WHERE user_id = ?", (user_id,))
            self._conn.commit()

    def get_users(self, begin_id: str = "", limit=None):
        with self._lock:
            rows = self._conn.execute(
                "SELECT user_id, labels, comment, subscribe FROM users WHERE user_id > ? ORDER BY user_id"
                + (f" LIMIT {int(limit)}" if limit is not None else ""),
                (begin_id,),
            ).fetchall()
        for row in rows:
            yield User(
                user_id=row[0], labels=json.loads(row[1] or "null"), comment=row[2] or "",
                subscribe=json.loads(row[3] or "null"),
            )

    def insert_items(self, items) -> None:
        items = list(items)
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO items VALUES (?, ?, ?, ?, ?, ?)",
                [
                    (
                        i.item_id, int(i.is_hidden), json.dumps(i.categories),
                        i.timestamp, json.dumps(i.labels), i.comment,
                    )
                    for i in items
                ],
            )
            self._fts_upsert(items)
            self._conn.commit()

    # -- full-text search (FTS5) ------------------------------------------
    _search_columns: list[str] = []
    _fts_ready = False

    def _fts_upsert(self, items) -> None:
        if not self._fts_ready:
            return
        from .search import search_document

        self._conn.executemany(
            "DELETE FROM items_fts WHERE item_id = ?", [(i.item_id,) for i in items]
        )
        self._conn.executemany(
            "INSERT INTO items_fts VALUES (?, ?)",
            [(i.item_id, search_document(i, self._search_columns)) for i in items],
        )

    def reconcile(self, search_columns: list[str]) -> None:
        from .search import search_document

        if list(search_columns) == self._search_columns and self._fts_ready:
            return  # unchanged config: keep the incrementally-maintained index
        self._search_columns = list(search_columns)
        with self._lock:
            self._conn.execute("DROP TABLE IF EXISTS items_fts")
            self._fts_ready = False
            if not self._search_columns:
                self._conn.commit()
                return
            self._conn.execute(
                "CREATE VIRTUAL TABLE items_fts USING fts5(item_id UNINDEXED, doc)"
            )
            rows = [
                (i.item_id, search_document(i, self._search_columns))
                for i in self.get_items()
            ]
            self._conn.executemany("INSERT INTO items_fts VALUES (?, ?)", rows)
            self._fts_ready = True
            self._conn.commit()

    def search_items(self, query: str, n: int, columns: list[str] | None = None):
        from .search import tokenize

        wanted = columns or self._search_columns
        if not wanted:
            return []
        if not self._fts_ready or list(wanted) != self._search_columns:
            # index absent or built for different columns: correct slow path
            return super().search_items(query, n, wanted)
        tokens = tokenize(query)
        if not tokens:
            return []
        # sanitized FTS5 query: quoted terms, prefix match on the last
        fts = " ".join(
            f'"{t}"*' if i == len(tokens) - 1 else f'"{t}"'
            for i, t in enumerate(tokens)
        )
        with self._lock:
            # one statement: join the ranked FTS hits back to item rows
            rows = self._conn.execute(
                "SELECT i.item_id, i.is_hidden, i.categories, i.timestamp,"
                " i.labels, i.comment FROM items_fts f JOIN items i"
                " ON i.item_id = f.item_id WHERE items_fts MATCH ?"
                " ORDER BY bm25(items_fts) LIMIT ?",
                (fts, int(n)),
            ).fetchall()
        return [self._row_to_item(r) for r in rows]

    def get_item(self, item_id):
        with self._lock:
            row = self._conn.execute(
                "SELECT item_id, is_hidden, categories, timestamp, labels, comment FROM items WHERE item_id = ?",
                (item_id,),
            ).fetchone()
        return self._row_to_item(row) if row else None

    @staticmethod
    def _row_to_item(row) -> Item:
        return Item(
            item_id=row[0], is_hidden=bool(row[1]),
            categories=json.loads(row[2] or "[]"), timestamp=row[3] or 0.0,
            labels=json.loads(row[4] or "null"), comment=row[5] or "",
        )

    def delete_item(self, item_id) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM items WHERE item_id = ?", (item_id,))
            self._conn.execute("DELETE FROM feedback WHERE item_id = ?", (item_id,))
            if self._fts_ready:
                self._conn.execute("DELETE FROM items_fts WHERE item_id = ?", (item_id,))
            self._conn.commit()

    def get_items(self, begin_id: str = "", limit=None):
        with self._lock:
            rows = self._conn.execute(
                "SELECT item_id, is_hidden, categories, timestamp, labels, comment FROM items WHERE item_id > ? ORDER BY item_id"
                + (f" LIMIT {int(limit)}" if limit is not None else ""),
                (begin_id,),
            ).fetchall()
        for row in rows:
            yield self._row_to_item(row)

    def get_latest_items(self, limit, categories=None, after=None):
        """Newest-first through the idx_items_timestamp index (the online
        fallback path calls this per request)."""
        sql = (
            "SELECT item_id, is_hidden, categories, timestamp, labels, comment"
            " FROM items WHERE is_hidden = 0"
        )
        args: list = []
        if after is not None:
            sql += " AND timestamp >= ?"
            args.append(after)
        sql += " ORDER BY timestamp DESC"
        out: list = []
        with self._lock:
            cur = self._conn.execute(sql, args)
            while len(out) < limit:
                rows = cur.fetchmany(max(limit, 64))
                if not rows:
                    break
                for row in rows:
                    item = self._row_to_item(row)
                    if categories and not all(c in item.categories for c in categories):
                        continue
                    out.append(item)
                    if len(out) >= limit:
                        break
        return out

    def insert_feedback(self, feedback, insert_user=True, insert_item=True, overwrite=True) -> None:
        with self._lock:
            for f in feedback:
                user_exists = self._conn.execute(
                    "SELECT 1 FROM users WHERE user_id = ?", (f.user_id,)
                ).fetchone()
                if not user_exists:
                    if not insert_user:
                        continue
                    self._conn.execute(
                        "INSERT OR IGNORE INTO users VALUES (?, 'null', '', 'null')", (f.user_id,)
                    )
                item_exists = self._conn.execute(
                    "SELECT 1 FROM items WHERE item_id = ?", (f.item_id,)
                ).fetchone()
                if not item_exists:
                    if not insert_item:
                        continue
                    self._conn.execute(
                        "INSERT OR IGNORE INTO items VALUES (?, 0, '[]', 0, 'null', '')",
                        (f.item_id,),
                    )
                    # keep the FTS index consistent with auto-inserted items
                    self._fts_upsert([Item(f.item_id)])
                op = "INSERT OR REPLACE" if overwrite else "INSERT OR IGNORE"
                self._conn.execute(
                    f"{op} INTO feedback VALUES (?, ?, ?, ?, ?, ?)",
                    (f.feedback_type, f.user_id, f.item_id, f.value, f.timestamp, f.comment),
                )
            self._conn.commit()

    def _feedback_query(self, where: str, args: tuple) -> list[Feedback]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT feedback_type, user_id, item_id, value, timestamp, comment FROM feedback WHERE {where}",
                args,
            ).fetchall()
        return [Feedback(*row) for row in rows]

    def get_user_feedback(self, user_id, end_time=None, feedback_types=None):
        where, args = "user_id = ?", [user_id]
        if end_time is not None:
            where += " AND timestamp <= ?"
            args.append(end_time)
        if feedback_types:
            where += f" AND feedback_type IN ({','.join('?' * len(feedback_types))})"
            args.extend(feedback_types)
        out = self._feedback_query(where, tuple(args))
        out.sort(key=lambda f: -f.timestamp)
        return out

    def get_item_feedback(self, item_id, feedback_types=None):
        where, args = "item_id = ?", [item_id]
        if feedback_types:
            where += f" AND feedback_type IN ({','.join('?' * len(feedback_types))})"
            args.extend(feedback_types)
        return self._feedback_query(where, tuple(args))

    def get_feedback(self, begin_time=None, end_time=None, feedback_types=None):
        where, args = "1=1", []
        if begin_time is not None:
            where += " AND timestamp >= ?"
            args.append(begin_time)
        if end_time is not None:
            where += " AND timestamp <= ?"
            args.append(end_time)
        if feedback_types:
            where += f" AND feedback_type IN ({','.join('?' * len(feedback_types))})"
            args.extend(feedback_types)
        yield from self._feedback_query(where, tuple(args))

    def delete_user_item_feedback(self, user_id, item_id, feedback_types=None) -> int:
        where, args = "user_id = ? AND item_id = ?", [user_id, item_id]
        if feedback_types:
            where += f" AND feedback_type IN ({','.join('?' * len(feedback_types))})"
            args.extend(feedback_types)
        with self._lock:
            cur = self._conn.execute(f"DELETE FROM feedback WHERE {where}", tuple(args))
            self._conn.commit()
            return cur.rowcount

    def count_users(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) FROM users").fetchone()[0]

    def count_items(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) FROM items").fetchone()[0]

    def count_feedback(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) FROM feedback").fetchone()[0]

    def purge(self) -> None:
        with self._lock:
            for t in ("users", "items", "feedback"):
                self._conn.execute(f"DELETE FROM {t}")
            if self._fts_ready:
                self._conn.execute("DELETE FROM items_fts")
            self._conn.commit()

    def close(self) -> None:
        self._conn.close()


def open_data_store(url: str, table_prefix: str = "", tls=None) -> DataStore:
    """Open a data store by URL: ``memory://``, ``sqlite://<path>``
    (``sqlite://`` alone is an in-memory database; a relative path is
    relative to the working directory), ``none://``, the server SQL stores
    ``postgres://``/``postgresql://``, ``mysql://`` and ``clickhouse://``
    (storage/sqlstores.py), ``mongodb://`` (storage/mongo.py) and
    ``proxy://host:port`` (the master's gRPC storage proxy, storage/proxy.py;
    over mutual TLS with ``tls``, a utils.tls.TLSConfig). ``table_prefix``
    applies to the server-SQL and MongoDB backends."""
    if url.startswith("memory://") or url == "memory":
        return MemoryDataStore()
    if url.startswith("sqlite://"):
        path = url[len("sqlite://"):] or ":memory:"
        return SQLiteDataStore(path)
    if url.startswith("proxy://"):
        from .proxy import ProxyDataStore

        return ProxyDataStore(url[len("proxy://"):], tls=tls)
    if url.split("://", 1)[0] in ("postgres", "postgresql", "mysql", "clickhouse"):
        from .sqlstores import open_sql_data_store

        return open_sql_data_store(url, table_prefix=table_prefix)
    if url.startswith("mongodb://"):
        from .mongo import MongoDataStore

        return MongoDataStore(url, collection_prefix=table_prefix)
    if url.startswith("none://") or url in ("", "none"):
        from .none import NoDataStore

        return NoDataStore()
    raise ValueError(f"unsupported data store URL {url!r}")


def open_data_store_from_config(db_cfg, tls=None) -> DataStore:
    """Open the data store a DatabaseConfig names (with its
    data_table_prefix or table_prefix; ``tls`` for ``proxy://``)."""
    return open_data_store(db_cfg.data_store, table_prefix=db_cfg.effective_data_prefix(),
                           tls=tls)
