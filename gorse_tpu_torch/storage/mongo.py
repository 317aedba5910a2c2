"""MongoDB data and cache stores over the pure-Python wire client (copy of
gorse_tpu/storage/mongo.py).

The reference's collections (users/items/feedback; documents/points for
the cache) with upserts keyed on natural ids and client-side score
ordering identical to MemoryCacheStore (cache.py). Labels and categories
are stored as native BSON."""

from __future__ import annotations

import json
import time
from typing import Iterable

from .cache import CacheStore, _match_categories
from .data import DataStore
from .mongowire import MongoConnection
from .types import Feedback, Item, Score, TimeSeriesPoint, User

__all__ = ["MongoCacheStore", "MongoDataStore"]


def _fb_id(feedback_type: str, user_id: str, item_id: str) -> str:
    return "\x00".join((feedback_type, user_id, item_id))


class MongoDataStore(DataStore):
    def __init__(self, url: str, collection_prefix: str = "") -> None:
        self.conn, self.db = MongoConnection.from_url(url)
        self._prefix = collection_prefix

    def _n(self, coll: str) -> str:
        return self._prefix + coll

    # -- helpers -------------------------------------------------------------
    def _upsert(self, coll: str, _id, doc: dict) -> None:
        self.conn.command(
            self.db,
            {
                "update": self._n(coll),
                "updates": [{"q": {"_id": _id}, "u": {"$set": doc}, "upsert": True}],
            },
        )

    def _insert_ignore(self, coll: str, _id, doc: dict) -> None:
        self.conn.command(
            self.db,
            {
                "update": self._n(coll),
                "updates": [
                    {"q": {"_id": _id}, "u": {"$setOnInsert": doc}, "upsert": True}
                ],
            },
        )

    def _delete(self, coll: str, q: dict) -> int:
        reply = self.conn.command(
            self.db, {"delete": self._n(coll), "deletes": [{"q": q, "limit": 0}]}
        )
        return int(reply.get("n", 0))

    def _count(self, coll: str) -> int:
        return int(self.conn.command(self.db, {"count": self._n(coll)}).get("n", 0))

    # -- users ---------------------------------------------------------------
    @staticmethod
    def _user_doc(u: User) -> dict:
        return {
            "user_id": u.user_id,
            "labels": json.dumps(u.labels),
            "comment": u.comment,
            "subscribe": json.dumps(u.subscribe),
        }

    @staticmethod
    def _doc_user(d: dict) -> User:
        return User(
            user_id=d["user_id"],
            labels=json.loads(d.get("labels") or "null"),
            comment=d.get("comment", ""),
            subscribe=json.loads(d.get("subscribe") or "null"),
        )

    def insert_users(self, users: Iterable[User]) -> None:
        for u in users:
            self._upsert("users", u.user_id, self._user_doc(u))

    def get_user(self, user_id: str):
        docs = self.conn.find_all(self.db, self._n("users"), {"_id": user_id}, limit=1)
        return self._doc_user(docs[0]) if docs else None

    def delete_user(self, user_id: str) -> None:
        self._delete("users", {"_id": user_id})
        self._delete("feedback", {"user_id": user_id})

    def get_users(self, begin_id: str = "", limit=None):
        docs = self.conn.find_all(
            self.db, self._n("users"), {"_id": {"$gt": begin_id}},
            sort={"_id": 1}, limit=limit or 0,
        )
        for d in docs:
            yield self._doc_user(d)

    # -- items ---------------------------------------------------------------
    @staticmethod
    def _item_doc(i: Item) -> dict:
        return {
            "item_id": i.item_id,
            "is_hidden": bool(i.is_hidden),
            "categories": list(i.categories),
            "timestamp": float(i.timestamp),
            "labels": json.dumps(i.labels),
            "comment": i.comment,
        }

    @staticmethod
    def _doc_item(d: dict) -> Item:
        return Item(
            item_id=d["item_id"],
            is_hidden=bool(d.get("is_hidden")),
            categories=list(d.get("categories") or []),
            timestamp=float(d.get("timestamp") or 0.0),
            labels=json.loads(d.get("labels") or "null"),
            comment=d.get("comment", ""),
        )

    def insert_items(self, items: Iterable[Item]) -> None:
        for i in items:
            self._upsert("items", i.item_id, self._item_doc(i))

    def get_item(self, item_id: str):
        docs = self.conn.find_all(self.db, self._n("items"), {"_id": item_id}, limit=1)
        return self._doc_item(docs[0]) if docs else None

    def delete_item(self, item_id: str) -> None:
        self._delete("items", {"_id": item_id})
        self._delete("feedback", {"item_id": item_id})

    def get_items(self, begin_id: str = "", limit=None):
        docs = self.conn.find_all(
            self.db, self._n("items"), {"_id": {"$gt": begin_id}},
            sort={"_id": 1}, limit=limit or 0,
        )
        for d in docs:
            yield self._doc_item(d)

    # -- feedback --------------------------------------------------------------
    @staticmethod
    def _fb_doc(f: Feedback) -> dict:
        return {
            "feedback_type": f.feedback_type,
            "user_id": f.user_id,
            "item_id": f.item_id,
            "value": float(f.value),
            "timestamp": float(f.timestamp),
            "comment": f.comment,
        }

    @staticmethod
    def _doc_fb(d: dict) -> Feedback:
        return Feedback(
            d["feedback_type"], d["user_id"], d["item_id"],
            float(d.get("value") or 0.0), float(d.get("timestamp") or 0.0),
            d.get("comment", ""),
        )

    def insert_feedback(
        self, feedback, insert_user=True, insert_item=True, overwrite=True
    ) -> None:
        for f in feedback:
            if not self.conn.find_all(self.db, self._n("users"), {"_id": f.user_id}, limit=1):
                if not insert_user:
                    continue
                self._insert_ignore(
                    "users", f.user_id, self._user_doc(User(f.user_id))
                )
            if not self.conn.find_all(self.db, self._n("items"), {"_id": f.item_id}, limit=1):
                if not insert_item:
                    continue
                self._insert_ignore(
                    "items", f.item_id, self._item_doc(Item(f.item_id))
                )
            _id = _fb_id(f.feedback_type, f.user_id, f.item_id)
            if overwrite:
                self._upsert("feedback", _id, self._fb_doc(f))
            else:
                self._insert_ignore("feedback", _id, self._fb_doc(f))

    def _fb_query(self, q: dict) -> list[Feedback]:
        return [self._doc_fb(d) for d in self.conn.find_all(self.db, self._n("feedback"), q)]

    @staticmethod
    def _with_types(q: dict, feedback_types) -> dict:
        if feedback_types:
            q["feedback_type"] = {"$in": list(feedback_types)}
        return q

    def get_user_feedback(self, user_id, end_time=None, feedback_types=None):
        q: dict = {"user_id": user_id}
        if end_time is not None:
            q["timestamp"] = {"$lte": float(end_time)}
        out = self._fb_query(self._with_types(q, feedback_types))
        out.sort(key=lambda f: -f.timestamp)
        return out

    def get_item_feedback(self, item_id, feedback_types=None):
        return self._fb_query(self._with_types({"item_id": item_id}, feedback_types))

    def get_feedback(self, begin_time=None, end_time=None, feedback_types=None):
        q: dict = {}
        ts: dict = {}
        if begin_time is not None:
            ts["$gte"] = float(begin_time)
        if end_time is not None:
            ts["$lte"] = float(end_time)
        if ts:
            q["timestamp"] = ts
        yield from self._fb_query(self._with_types(q, feedback_types))

    def delete_user_item_feedback(self, user_id, item_id, feedback_types=None) -> int:
        q = self._with_types({"user_id": user_id, "item_id": item_id}, feedback_types)
        return self._delete("feedback", q)

    # -- counts / lifecycle -----------------------------------------------------
    def count_users(self) -> int:
        return self._count("users")

    def count_items(self) -> int:
        return self._count("items")

    def count_feedback(self) -> int:
        return self._count("feedback")

    def purge(self) -> None:
        for coll in ("users", "items", "feedback"):
            self._delete(coll, {})

    def ping(self) -> bool:
        return self.conn.ping()

    def close(self) -> None:
        self.conn.close()


class MongoCacheStore(CacheStore):
    """Cache store over MongoDB collections ``kv``, ``queue``, ``documents``
    (scored collections), ``hidden``, ``points`` (time series) — mirroring
    storage/cache/mongodb.go's collection layout."""

    def __init__(self, url: str, collection_prefix: str = "") -> None:
        self.conn, self.db = MongoConnection.from_url(url)
        self._prefix = collection_prefix

    def _n(self, coll: str) -> str:
        return self._prefix + coll

    def _upsert(self, coll: str, _id, doc: dict, on_insert: dict | None = None) -> None:
        u: dict = {"$set": doc}
        if on_insert:
            u["$setOnInsert"] = on_insert
        self.conn.command(
            self.db,
            {"update": self._n(coll), "updates": [{"q": {"_id": _id}, "u": u, "upsert": True}]},
        )

    def _delete(self, coll: str, q: dict) -> None:
        self.conn.command(self.db, {"delete": self._n(coll), "deletes": [{"q": q, "limit": 0}]})

    # -- KV ---------------------------------------------------------------------
    def set(self, k, v) -> None:
        self._upsert("kv", k, {"v": str(v)})

    def get(self, k):
        docs = self.conn.find_all(self.db, self._n("kv"), {"_id": k}, limit=1)
        return docs[0]["v"] if docs else None

    def delete(self, k) -> None:
        self._delete("kv", {"_id": k})

    # -- queues -------------------------------------------------------------------
    def push(self, name, value) -> None:
        self._upsert(
            "queue",
            f"{name}\x00{value}",
            {"name": name, "value": value},
            on_insert={"seq": time.time_ns()},
        )

    def pop(self, name):
        # atomic find-and-remove — two concurrent consumers never pop the
        # same element (plain find-then-delete would race)
        reply = self.conn.command(
            self.db,
            {
                "findAndModify": self._n("queue"),
                "query": {"name": name},
                "sort": {"seq": 1},
                "remove": True,
            },
        )
        doc = reply.get("value")
        return doc["value"] if doc else None

    def remain(self, name) -> int:
        return len(self.conn.find_all(self.db, self._n("queue"), {"name": name}))

    # -- scored collections -------------------------------------------------------
    def add_scores(self, collection, subset, scores) -> None:
        # hidden items keep their flag when re-added; flags are scoped per
        # collection (a global flag would hide user "42" in user-to-user
        # because item "42" was hidden)
        hidden = {
            d["i"]
            for d in self.conn.find_all(
                self.db, self._n("hidden"),
                {"_id": {"$in": [f"{collection}\x00{s.id}" for s in scores]}},
            )
        }
        for s in scores:
            self._upsert(
                "documents",
                "\x00".join((collection, subset, s.id)),
                {
                    "c": collection, "s": subset, "i": s.id,
                    "score": float(s.score),
                    "categories": list(s.categories),
                    "timestamp": float(s.timestamp),
                    "hidden": s.id in hidden,
                },
            )

    def search_scores(self, collection, subset, categories=None, begin=0, end=-1):
        # hidden filter + sort run server-side; limit is pushed down when no
        # category filter applies (category matching is per-document)
        q = {"c": collection, "s": subset, "hidden": {"$ne": True}}
        limit = end if (end >= 0 and not categories) else 0
        docs = self.conn.find_all(
            self.db, self._n("documents"), q, sort={"score": -1}, limit=limit
        )
        matched = [
            Score(d["i"], float(d["score"]), list(d.get("categories") or []),
                  float(d.get("timestamp") or 0.0))
            for d in docs
            if _match_categories(list(d.get("categories") or []), categories)
        ]
        if end < 0:
            end = len(matched)
        return matched[begin:end]

    def delete_scores(self, collection, subsets=None, before=None) -> None:
        q: dict = {"c": collection}
        if subsets is not None:
            q["s"] = {"$in": list(subsets)}
        if before is not None:
            q["timestamp"] = {"$lt": float(before)}
        self._delete("documents", q)

    def update_scores(self, collections, subset, item_id, categories=None, is_hidden=None) -> None:
        if is_hidden is not None:
            for collection in collections:
                hid = f"{collection}\x00{item_id}"
                if is_hidden:
                    self._upsert("hidden", hid, {"c": collection, "i": item_id})
                else:
                    self._delete("hidden", {"_id": hid})
            # flag the item's documents in the NAMED collections so searches
            # filter server-side (a {"i": item_id} query hit every collection)
            self.conn.command(
                self.db,
                {
                    "update": self._n("documents"),
                    "updates": [
                        {
                            "q": {"c": {"$in": list(collections)}, "i": item_id},
                            "u": {"$set": {"hidden": bool(is_hidden)}},
                            "multi": True,
                        }
                    ],
                },
            )
        if categories is None or not collections:
            return
        q: dict = {"c": {"$in": list(collections)}, "i": item_id}
        if subset is not None:
            q["s"] = subset
        self.conn.command(
            self.db,
            {
                "update": self._n("documents"),
                "updates": [
                    {"q": q, "u": {"$set": {"categories": list(categories)}}, "multi": True}
                ],
            },
        )

    def scan_scores(self, collection):
        for d in self.conn.find_all(self.db, self._n("documents"), {"c": collection}):
            yield d["s"], Score(
                d["i"], float(d["score"]), list(d.get("categories") or []),
                float(d.get("timestamp") or 0.0),
            )

    def scan_score_subsets(self, collection):
        reply = self.conn.command(
            self.db,
            {"distinct": self._n("documents"), "key": "s", "query": {"c": collection}},
        )
        return list(reply.get("values") or [])

    # -- time series -----------------------------------------------------------------
    def add_time_series_points(self, points) -> None:
        if not points:
            return
        self.conn.command(
            self.db,
            {
                "insert": self._n("points"),
                "documents": [
                    {"name": p.name, "timestamp": float(p.timestamp), "value": float(p.value)}
                    for p in points
                ],
            },
        )

    def get_time_series_points(self, name, begin, end):
        docs = self.conn.find_all(
            self.db, self._n("points"),
            {"name": name, "timestamp": {"$gte": float(begin), "$lte": float(end)}},
            sort={"timestamp": 1},
        )
        return [TimeSeriesPoint(d["name"], float(d["timestamp"]), float(d["value"])) for d in docs]

    def ping(self) -> bool:
        return self.conn.ping()

    def purge(self) -> None:
        for coll in ("kv", "queue", "documents", "hidden", "points"):
            self._delete(coll, {})

    def close(self) -> None:
        self.conn.close()
