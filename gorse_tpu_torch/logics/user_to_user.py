"""User-to-user similarity recommenders (port of
gorse_tpu/logics/user_to_user.py).

The item-to-item engines with the roles swapped: ``embedding`` (user
embedding vectors), ``tags`` (user label sets), ``items`` (co-consumed item
sets, IDF-weighted by item popularity) and ``auto`` (tags and items
averaged), computed in one blocked pass over all users on the engine's
device (ops/similarity.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

from ..storage.types import Score, User
from .item_to_item import (
    AutoItemToItem,
    EmbeddingItemToItem,
    ItemToItemConfig,
    TagsItemToItem,
    UsersItemToItem,
)


@dataclasses.dataclass
class UserToUserConfig:
    """Mirror of config.UserToUserConfig."""

    name: str
    type: str = "auto"  # embedding | tags | items | auto
    column: str = ""

    def digest(self) -> str:
        return hashlib.md5(f"{self.name}|{self.type}|{self.column}".encode()).hexdigest()


class _UserShim:
    """Adapts a User to the item-to-item engines (same math, another
    entity)."""

    def __init__(self, user: User) -> None:
        self.item_id = user.user_id
        self.categories: list[str] = []
        self.labels = user.labels
        self.is_hidden = False


def _to_i2i_cfg(cfg: UserToUserConfig) -> ItemToItemConfig:
    column = cfg.column.replace("user.Labels", "item.Labels").replace("user.", "item.")
    mapped_type = {"items": "users"}.get(cfg.type, cfg.type)
    return ItemToItemConfig(name=cfg.name, type=mapped_type, column=column)


class UserToUser:
    """Push users with their feedback (consumed item ids), pop each user's
    neighbour list; on ``device`` (``None``: the card)."""

    def __init__(
        self,
        cfg: UserToUserConfig,
        n: int,
        timestamp: float | None = None,
        tag_idf: np.ndarray | None = None,
        item_idf: np.ndarray | None = None,
        label_index=None,
        device=None,
    ) -> None:
        self.cfg = cfg
        self.name = cfg.name
        icfg = _to_i2i_cfg(cfg)
        ts = timestamp if timestamp is not None else time.time()
        if cfg.type == "embedding":
            self._engine = EmbeddingItemToItem(icfg, n, ts, device)
        elif cfg.type == "tags":
            self._engine = TagsItemToItem(icfg, n, ts, idf=tag_idf, label_index=label_index,
                                          device=device)
        elif cfg.type == "items":
            # co-consumed item sets: UsersItemToItem's push takes the set
            self._engine = UsersItemToItem(icfg, n, ts, user_idf=item_idf, device=device)
        elif cfg.type == "auto":
            self._engine = AutoItemToItem(icfg, n, ts, tag_idf=tag_idf, user_idf=item_idf,
                                          label_index=label_index, device=device)
        else:
            raise ValueError(f"unknown user-to-user type {cfg.type!r}")

    def push(self, user: User, feedback: list[int]) -> None:
        self._engine.push(_UserShim(user), feedback)

    def pop_all(self) -> list[tuple[str, list[Score]]]:
        return self._engine.pop_all()
