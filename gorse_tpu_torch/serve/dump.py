"""Whole-system dump and restore, and the CSV and JSONL bulk import and
export (port of gorse_tpu/serve/dump.py).

gorse's master dumps users, items and feedback as length-delimited
protobuf over HTTP (master/rest.go:1724), restores them (:1967) and imports
and exports CSV (:1280-1501). The stream here is the reference package's:
the magic ``GTPU1``, then one msgpack record ``["user"|"item"|"feedback",
dict]`` per row, each table in the store's order, written by the port's
stdlib codec (utils/msgpack.py), whose bytes equal msgpack's. So the two
packages read each other's dumps, and dump the same rows to the same bytes.
Restore inserts every 1,000 rows.
"""

from __future__ import annotations

import csv
import io
import json
from typing import BinaryIO, Iterable, TextIO

from ..storage.data import DataStore
from ..storage.types import Feedback, Item, User
from ..utils import msgpack

MAGIC = b"GTPU1"


def dump(data: DataStore, out: BinaryIO) -> dict:
    """Stream the full data store as framed msgpack records."""
    out.write(MAGIC)
    packer = msgpack.Packer()
    counts = {"users": 0, "items": 0, "feedback": 0}
    for user in data.get_users():
        out.write(packer.pack(["user", user.to_dict()]))
        counts["users"] += 1
    for item in data.get_items():
        out.write(packer.pack(["item", item.to_dict()]))
        counts["items"] += 1
    for fb in data.get_feedback():
        out.write(packer.pack(["feedback", fb.to_dict()]))
        counts["feedback"] += 1
    return counts


def restore(data: DataStore, src: BinaryIO) -> dict:
    """Restore a dump stream into the data store."""
    magic = src.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError("not a gorse_tpu dump stream")
    unpacker = msgpack.Unpacker(src)
    counts = {"users": 0, "items": 0, "feedback": 0}
    users, items, feedback = [], [], []

    def flush():
        if users:
            data.insert_users(users)
            users.clear()
        if items:
            data.insert_items(items)
            items.clear()
        if feedback:
            data.insert_feedback(feedback)
            feedback.clear()

    for kind, payload in unpacker:
        if kind == "user":
            users.append(User.from_dict(payload))
            counts["users"] += 1
        elif kind == "item":
            items.append(Item.from_dict(payload))
            counts["items"] += 1
        elif kind == "feedback":
            feedback.append(Feedback.from_dict(payload))
            counts["feedback"] += 1
        if len(users) + len(items) + len(feedback) >= 1000:
            flush()
    flush()
    return counts


# ------------------------------------------------------------------ JSONL
#
# /api/bulk/{users,items,feedback} export the rows as JSON lines (GET) and
# import an uploaded JSONL file (POST), each id validated as gorse's
# util.ValidateId does (common/util/util.go:81-89); a bad line's error names
# its 0-based line number.


def validate_id(text: str) -> None:
    text = text.strip()
    if not text:
        raise ValueError("id cannot be empty")
    if "/" in text:
        raise ValueError("id cannot contain `/`")


def export_users_jsonl(data: DataStore, out: TextIO) -> int:
    n = 0
    for u in data.get_users():
        out.write(json.dumps(u.to_dict()) + "\n")
        n += 1
    return n


def export_items_jsonl(data: DataStore, out: TextIO) -> int:
    n = 0
    for i in data.get_items():
        out.write(json.dumps(i.to_dict()) + "\n")
        n += 1
    return n


def export_feedback_jsonl(data: DataStore, out: TextIO) -> int:
    n = 0
    for f in data.get_feedback():
        out.write(json.dumps(f.to_dict()) + "\n")
        n += 1
    return n


def _import_jsonl(src: TextIO, parse, insert, batch_size: int = 1000) -> int:
    rows, n = [], 0
    for lineno, line in enumerate(src):
        line = line.strip()
        if not line:
            continue
        try:
            payload = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"invalid JSON at line {lineno}: {e}") from e
        try:
            rows.append(parse(payload))
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e}") from e
        n += 1
        if len(rows) >= batch_size:
            insert(rows)
            rows = []
    if rows:
        insert(rows)
    return n


def import_users_jsonl(data: DataStore, src: TextIO) -> int:
    def parse(payload: dict) -> User:
        u = User.from_dict(payload)
        try:
            validate_id(u.user_id)
        except ValueError as e:
            raise ValueError(f"invalid user id `{u.user_id}` ({e})") from e
        return u

    return _import_jsonl(src, parse, data.insert_users)


def import_items_jsonl(data: DataStore, src: TextIO) -> int:
    def parse(payload: dict) -> Item:
        i = Item.from_dict(payload)
        try:
            validate_id(i.item_id)
        except ValueError as e:
            raise ValueError(f"invalid item id `{i.item_id}` ({e})") from e
        return i

    return _import_jsonl(src, parse, data.insert_items)


def import_feedback_jsonl(data: DataStore, src: TextIO) -> int:
    def parse(payload: dict) -> Feedback:
        f = Feedback.from_dict(payload)
        for which, value in (("user", f.user_id), ("item", f.item_id)):
            try:
                validate_id(value)
            except ValueError as e:
                raise ValueError(f"invalid {which} id `{value}` ({e})") from e
        return f

    return _import_jsonl(src, parse, data.insert_feedback)


# ------------------------------------------------------------------ CSV

USER_HEADER = ["user_id", "labels"]
ITEM_HEADER = ["item_id", "is_hidden", "categories", "timestamp", "labels", "description"]
FEEDBACK_HEADER = ["feedback_type", "user_id", "item_id", "timestamp"]


def export_users(data: DataStore, out: TextIO) -> int:
    w = csv.writer(out)
    w.writerow(USER_HEADER)
    n = 0
    for u in data.get_users():
        w.writerow([u.user_id, json.dumps(u.labels)])
        n += 1
    return n


def import_users(data: DataStore, src: TextIO) -> int:
    r = csv.DictReader(src)
    users = []
    for row in r:
        users.append(
            User(
                user_id=row["user_id"],
                labels=json.loads(row["labels"]) if row.get("labels") else None,
            )
        )
    data.insert_users(users)
    return len(users)


def export_items(data: DataStore, out: TextIO) -> int:
    w = csv.writer(out)
    w.writerow(ITEM_HEADER)
    n = 0
    for i in data.get_items():
        w.writerow(
            [
                i.item_id,
                str(i.is_hidden).lower(),
                "|".join(i.categories),
                i.timestamp,
                json.dumps(i.labels),
                i.comment,
            ]
        )
        n += 1
    return n


def import_items(data: DataStore, src: TextIO) -> int:
    r = csv.DictReader(src)
    items = []
    for row in r:
        items.append(
            Item(
                item_id=row["item_id"],
                is_hidden=row.get("is_hidden", "").lower() == "true",
                categories=[c for c in (row.get("categories") or "").split("|") if c],
                timestamp=float(row.get("timestamp") or 0.0),
                labels=json.loads(row["labels"]) if row.get("labels") else None,
                comment=row.get("description", ""),
            )
        )
    data.insert_items(items)
    return len(items)


def export_feedback(data: DataStore, out: TextIO) -> int:
    w = csv.writer(out)
    w.writerow(FEEDBACK_HEADER)
    n = 0
    for f in data.get_feedback():
        w.writerow([f.feedback_type, f.user_id, f.item_id, f.timestamp])
        n += 1
    return n


def import_feedback(data: DataStore, src: TextIO) -> int:
    r = csv.DictReader(src)
    feedback = []
    for row in r:
        feedback.append(
            Feedback(
                feedback_type=row["feedback_type"],
                user_id=row["user_id"],
                item_id=row["item_id"],
                timestamp=float(row.get("timestamp") or 0.0),
            )
        )
    data.insert_feedback(feedback)
    return len(feedback)
