"""Unified feature index for factorization machines (copy of
gorse_tpu/data/unified_index.py).

Users, items, user labels, item labels and context labels packed into one
contiguous feature-id space:

    [users | items | user labels | item labels | context labels]

The AFM's factor table is indexed by these unified ids, so the offsets
define its row layout. ``to_dict``/``from_dict`` are the reference's, so a
saved AFM's index interchanges between the packages; ``AFM.load`` tells a
``DirectIndex`` by its ``"direct"`` key.
"""

from __future__ import annotations

from .dict import Index, NOT_ID


class UnifiedIndex:
    """Packed user/item/label feature space."""

    def __init__(
        self,
        users: Index | None = None,
        items: Index | None = None,
        user_labels: Index | None = None,
        item_labels: Index | None = None,
        context_labels: Index | None = None,
    ) -> None:
        self.users = users or Index()
        self.items = items or Index()
        self.user_labels = user_labels or Index()
        self.item_labels = item_labels or Index()
        self.context_labels = context_labels or Index()

    def __len__(self) -> int:
        return (
            len(self.users)
            + len(self.items)
            + len(self.user_labels)
            + len(self.item_labels)
            + len(self.context_labels)
        )

    # offsets into the unified space
    @property
    def item_offset(self) -> int:
        return len(self.users)

    @property
    def user_label_offset(self) -> int:
        return self.item_offset + len(self.items)

    @property
    def item_label_offset(self) -> int:
        return self.user_label_offset + len(self.user_labels)

    @property
    def context_label_offset(self) -> int:
        return self.item_label_offset + len(self.item_labels)

    def encode_user(self, user_id: str) -> int:
        idx = self.users.to_number(user_id)
        return idx

    def encode_item(self, item_id: str) -> int:
        idx = self.items.to_number(item_id)
        return idx + self.item_offset if idx != NOT_ID else int(NOT_ID)

    def encode_user_label(self, label: str) -> int:
        idx = self.user_labels.to_number(label)
        return idx + self.user_label_offset if idx != NOT_ID else int(NOT_ID)

    def encode_item_label(self, label: str) -> int:
        idx = self.item_labels.to_number(label)
        return idx + self.item_label_offset if idx != NOT_ID else int(NOT_ID)

    def encode_context_label(self, label: str) -> int:
        idx = self.context_labels.to_number(label)
        return idx + self.context_label_offset if idx != NOT_ID else int(NOT_ID)

    def to_dict(self) -> dict:
        return {
            "users": self.users.to_dict(),
            "items": self.items.to_dict(),
            "user_labels": self.user_labels.to_dict(),
            "item_labels": self.item_labels.to_dict(),
            "context_labels": self.context_labels.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "UnifiedIndex":
        return cls(
            users=Index.from_dict(d["users"]),
            items=Index.from_dict(d["items"]),
            user_labels=Index.from_dict(d["user_labels"]),
            item_labels=Index.from_dict(d["item_labels"]),
            context_labels=Index.from_dict(d["context_labels"]),
        )


class DirectIndex(UnifiedIndex):
    """Identity index for pre-encoded datasets like libFM files, whose
    feature ids are already integers."""

    def __init__(self, n: int) -> None:
        super().__init__()
        self.n = n

    def __len__(self) -> int:
        return self.n

    def encode_user(self, user_id: str) -> int:  # ids are ints-as-strings
        try:
            i = int(user_id)
        except ValueError:
            return int(NOT_ID)
        return i if 0 <= i < self.n else int(NOT_ID)

    encode_item = encode_user
    encode_user_label = encode_user
    encode_item_label = encode_user
    encode_context_label = encode_user

    def to_dict(self) -> dict:
        return {"direct": self.n}

    @classmethod
    def from_dict(cls, d: dict) -> "DirectIndex":
        return cls(d["direct"])
