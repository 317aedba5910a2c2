"""Entity types shared across the storage layer (copy of
gorse_tpu/storage/types.py): User, Item, Feedback, Score and
TimeSeriesPoint as JSON dataclasses with the reference's Go-style wire
names, and ``now``."""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Any


def parse_timestamp(v) -> float:
    """Accept unix seconds (number) or RFC3339 strings."""
    if v is None or v == "":
        return 0.0
    if isinstance(v, str):
        return datetime.datetime.fromisoformat(v.replace("Z", "+00:00")).timestamp()
    return float(v)


@dataclasses.dataclass
class User:
    user_id: str
    labels: Any = None  # free-form JSON
    comment: str = ""
    subscribe: list[str] | None = None

    def to_dict(self) -> dict:
        return {
            "UserId": self.user_id,
            "Labels": self.labels,
            "Comment": self.comment,
            "Subscribe": self.subscribe,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "User":
        return cls(
            user_id=d.get("UserId", ""),
            labels=d.get("Labels"),
            comment=d.get("Comment", ""),
            subscribe=d.get("Subscribe"),
        )


@dataclasses.dataclass
class Item:
    item_id: str
    is_hidden: bool = False
    categories: list[str] = dataclasses.field(default_factory=list)
    timestamp: float = 0.0  # unix seconds
    labels: Any = None
    comment: str = ""

    def to_dict(self) -> dict:
        return {
            "ItemId": self.item_id,
            "IsHidden": self.is_hidden,
            "Categories": self.categories,
            "Timestamp": self.timestamp,
            "Labels": self.labels,
            "Comment": self.comment,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Item":
        return cls(
            item_id=d.get("ItemId", ""),
            is_hidden=bool(d.get("IsHidden", False)),
            categories=list(d.get("Categories") or []),
            timestamp=parse_timestamp(d.get("Timestamp")),
            labels=d.get("Labels"),
            comment=d.get("Comment", ""),
        )


@dataclasses.dataclass
class Feedback:
    feedback_type: str
    user_id: str
    item_id: str
    value: float = 0.0
    timestamp: float = 0.0
    comment: str = ""

    def key(self) -> tuple[str, str, str]:
        return (self.feedback_type, self.user_id, self.item_id)

    def to_dict(self) -> dict:
        return {
            "FeedbackType": self.feedback_type,
            "UserId": self.user_id,
            "ItemId": self.item_id,
            "Value": self.value,
            "Timestamp": self.timestamp,
            "Comment": self.comment,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Feedback":
        return cls(
            feedback_type=d.get("FeedbackType", ""),
            user_id=d.get("UserId", ""),
            item_id=d.get("ItemId", ""),
            value=float(d.get("Value") or 0.0),
            timestamp=parse_timestamp(d.get("Timestamp")),
            comment=d.get("Comment", ""),
        )


@dataclasses.dataclass
class Score:
    """A scored document in a cache collection."""

    id: str
    score: float
    categories: list[str] = dataclasses.field(default_factory=list)
    timestamp: float = 0.0

    def to_dict(self) -> dict:
        return {
            "Id": self.id,
            "Score": self.score,
            "Categories": self.categories,
            "Timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Score":
        return cls(
            id=d["Id"],
            score=float(d["Score"]),
            categories=list(d.get("Categories") or []),
            timestamp=float(d.get("Timestamp", 0.0)),
        )


@dataclasses.dataclass
class TimeSeriesPoint:
    name: str
    timestamp: float
    value: float


def now() -> float:
    return time.time()
