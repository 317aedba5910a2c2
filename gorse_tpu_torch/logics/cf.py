"""Matrix-factorization serving index (port of gorse_tpu/logics/cf.py).

Per-user top-k over item factors for a whole user shard at once, through
the exact top-k of ops/topk.py or its approximate tier, and user lookups by
cosine. Saved indexes
use the reference's files (``index.npz`` + ``index_meta.json``), so an
index saved by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.dict import FreqDict
from ..ops.topk import NEG_INF, prepare_items, topk_excluding
from ..storage.types import Score


class MatrixFactorizationIndex:
    """Item/user factor tables + dictionaries, built from a fitted MF model."""

    # Route rule, kept from the reference because it changes the scores
    # users get (gorse_tpu/logics/cf.py:138-139,168-169): a chunk of 256
    # users goes through the bf16 kernel route when its fetch (n + the
    # chunk's widest exclusion list) is at most 2048, and is scored from the
    # f32 table otherwise. With ``approx_recall`` below 1 every chunk takes
    # the approximate tier over the prepared bf16 table instead, whatever
    # its fetch (gorse_tpu/logics/cf.py:170-181).
    _SEARCH_CHUNK = 256
    _KERNEL_FETCH_MAX = 2048

    def __init__(
        self,
        user_factors: np.ndarray,
        item_factors: np.ndarray,
        user_index: FreqDict,
        item_index: FreqDict,
        item_categories: list[list[str]] | None = None,
        timestamp: float = 0.0,
        user_predictable: np.ndarray | None = None,
        item_predictable: np.ndarray | None = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.user_factors = torch.as_tensor(np.asarray(user_factors, np.float32), device=self.device)
        self.item_factors = torch.as_tensor(np.asarray(item_factors, np.float32), device=self.device)
        n_items = self.item_factors.shape[0]
        # Entities without training feedback keep random-init embeddings and
        # are left out of the serving table, which is COMPACTED to the
        # predictable rows; _serving_rows maps kernel row -> item index.
        self.user_predictable = (
            np.ones(self.user_factors.shape[0], bool)
            if user_predictable is None else np.asarray(user_predictable, bool)
        )
        self.item_predictable = (
            np.ones(n_items, bool)
            if item_predictable is None else np.asarray(item_predictable, bool)
        )
        self._serving_rows = np.flatnonzero(self.item_predictable).astype(np.int32)
        self._inv_rows = np.full(max(n_items, 1), -1, np.int32)
        self._inv_rows[self._serving_rows] = np.arange(len(self._serving_rows), dtype=np.int32)
        if len(self._serving_rows) == n_items:
            self._serving_factors = self.item_factors  # alias, don't copy
        else:
            rows = torch.as_tensor(self._serving_rows, dtype=torch.long, device=self.device)
            self._serving_factors = self.item_factors[rows]
        # bf16 table built once; the f32 route scores from _serving_factors
        self._prepared_items = prepare_items(self._serving_factors, device=self.device)
        self.user_index = user_index
        self.item_index = item_index
        self.item_categories = item_categories or [[] for _ in range(n_items)]
        self.timestamp = timestamp

    @classmethod
    def from_numpy(
        cls,
        user_factors: np.ndarray,
        item_factors: np.ndarray,
        user_index_dict: dict,
        item_index_dict: dict,
        item_categories: list[list[str]] | None = None,
        timestamp: float = 0.0,
        user_predictable: np.ndarray | None = None,
        item_predictable: np.ndarray | None = None,
        device=None,
    ) -> "MatrixFactorizationIndex":
        """Build from the reference's arrays and its ``FreqDict.to_dict()``
        dictionaries."""
        return cls(
            user_factors, item_factors,
            FreqDict.from_dict(user_index_dict), FreqDict.from_dict(item_index_dict),
            item_categories, timestamp,
            user_predictable=user_predictable, item_predictable=item_predictable,
            device=device,
        )

    @classmethod
    def from_model(
        cls, model, item_categories=None, timestamp: float = 0.0
    ) -> "MatrixFactorizationIndex":
        """Build from a fitted MF model (models/) on the model's device,
        keeping its dictionaries and predictability masks."""
        return cls(
            model.user_factors.cpu().numpy(),
            model.item_factors.cpu().numpy(),
            model.user_index,
            model.item_index,
            item_categories,
            timestamp,
            user_predictable=model.user_predictable,
            item_predictable=model.item_predictable,
            device=model.device,
        )

    def serving_items(self) -> tuple[list[str], np.ndarray]:
        """(item ids, factors) for predictable items only."""
        ids = [self.item_index.to_name(int(i)) for i in self._serving_rows]
        return ids, self._serving_factors.cpu().numpy()

    def search_users(
        self,
        user_ids: list[str],
        n: int,
        exclude: list[list[str]] | None = None,
        use_kernel: bool = True,
        approx_recall: float | None = None,
    ) -> list[list[Score]]:
        """Batched top-n recommendation for many users at once, in chunks of
        256 users. ``approx_recall`` below 1 sends every chunk through the
        approximate tier (ops/topk.py dot_topk_approx); otherwise
        ``use_kernel=False`` sends every chunk down the f32 route, and the
        route rule above picks it per chunk."""
        n_serving = len(self._serving_rows)
        if n_serving == 0:
            return [[] for _ in user_ids]
        n_eff = min(n, n_serving)
        out: list[list[Score]] = []
        for lo in range(0, len(user_ids), self._SEARCH_CHUNK):
            chunk_ids = user_ids[lo : lo + self._SEARCH_CHUNK]
            chunk_ex = exclude[lo : lo + self._SEARCH_CHUNK] if exclude else None
            out.extend(self._search_chunk(chunk_ids, n_eff, chunk_ex, use_kernel, approx_recall))
        return out

    def _search_chunk(self, user_ids, n_eff, exclude, use_kernel,
                      approx_recall: float | None = None) -> list[list[Score]]:
        rows, valid = [], []
        for uid in user_ids:
            idx = self.user_index.to_number(uid)
            # untrained users get no collaborative recommendations
            valid.append(idx >= 0 and bool(self.user_predictable[idx]))
            rows.append(max(idx, 0))
        queries = self.user_factors[torch.as_tensor(rows, dtype=torch.long, device=self.device)]
        ex_arr = None
        width = 0
        if exclude is not None:
            width = max((len(e) for e in exclude), default=0)
            if width:
                ex = np.full((len(user_ids), width), -1, dtype=np.int32)
                for i, ids in enumerate(exclude):
                    for j, iid in enumerate(ids):
                        orig = self.item_index.to_number(iid)
                        # remap into the compacted serving table; ids outside
                        # it (unpredictable/unknown) are never returned anyway
                        ex[i, j] = self._inv_rows[orig] if orig >= 0 else -1
                ex_arr = torch.as_tensor(ex, device=self.device)
        if n_eff + width > self._KERNEL_FETCH_MAX:
            use_kernel = False
        # the approximate tier reads the prepared table, never the f32 one
        use_prepared = use_kernel or (approx_recall is not None and approx_recall < 1.0)
        scores, idxs = topk_excluding(
            queries,
            self._prepared_items if use_prepared else self._serving_factors,
            n_eff, ex_arr, use_kernel=use_kernel, device=self.device,
            approx_recall=approx_recall,
        )
        scores = scores.cpu().numpy()
        idxs = idxs.cpu().numpy()
        out: list[list[Score]] = []
        for i, uid in enumerate(user_ids):
            if not valid[i]:
                out.append([])
                continue
            row = []
            for s, j in zip(scores[i], idxs[i]):
                if s <= -1e29:
                    continue
                orig = int(self._serving_rows[int(j)])
                row.append(
                    Score(
                        id=self.item_index.to_name(orig),
                        score=float(s),
                        categories=self.item_categories[orig],
                        timestamp=self.timestamp,
                    )
                )
            out.append(row)
        return out

    def similar_users(self, user_id: str, n: int) -> list[Score]:
        """Nearest users in factor space by cosine; unpredictable users are
        masked to NEG_INF, ties go to the lower user index."""
        idx = self.user_index.to_number(user_id)
        if idx < 0 or not self.user_predictable[idx]:
            return []
        norms = torch.linalg.vector_norm(self.user_factors, dim=1, keepdim=True)
        unit = self.user_factors / torch.clamp(norms, min=1e-12)
        scores = unit @ unit[idx]
        mask = torch.as_tensor(self.user_predictable, device=self.device)
        scores = torch.where(mask, scores, NEG_INF)
        scores[idx] = NEG_INF
        n_eff = max(min(n, self.user_factors.shape[0] - 1), 0)
        top = torch.sort(scores, descending=True, stable=True)
        out = []
        for s, j in zip(top.values[:n_eff].tolist(), top.indices[:n_eff].tolist()):
            if s <= NEG_INF / 2:
                break
            out.append(Score(id=self.user_index.to_name(int(j)), score=float(s)))
        return out

    # ------------------------------------------------------------- serialize

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(
            path / "index.npz",
            user_factors=self.user_factors.cpu().numpy(),
            item_factors=self.item_factors.cpu().numpy(),
            user_predictable=self.user_predictable,
            item_predictable=self.item_predictable,
        )
        (path / "index_meta.json").write_text(
            json.dumps(
                {
                    "user_index": self.user_index.to_dict(),
                    "item_index": self.item_index.to_dict(),
                    "item_categories": self.item_categories,
                    "timestamp": self.timestamp,
                }
            )
        )

    @classmethod
    def load(cls, path: str | Path, device=None) -> "MatrixFactorizationIndex":
        path = Path(path)
        meta = json.loads((path / "index_meta.json").read_text())
        with np.load(path / "index.npz") as arrays:
            return cls(
                arrays["user_factors"],
                arrays["item_factors"],
                FreqDict.from_dict(meta["user_index"]),
                FreqDict.from_dict(meta["item_index"]),
                meta["item_categories"],
                meta["timestamp"],
                user_predictable=arrays.get("user_predictable"),
                item_predictable=arrays.get("item_predictable"),
                device=device,
            )
