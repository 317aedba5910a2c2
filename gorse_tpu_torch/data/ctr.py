"""CTR (click-through-rate) dataset: sparse libFM-style rows (copy of
gorse_tpu/data/ctr.py).

Samples are sparse (feature id, value) lists with a binary target, plus
optional dense embedding columns. ``padded`` gives the model's view:
``[N, D]`` index and value matrices, pad index 0 with value 0 (it adds
nothing to an FM forward pass). ``split`` draws numpy's
``default_rng(seed).permutation``, so splits equal the reference's.
``load_libfm_file`` parses with the native C++ parser (native/) when it
builds, in Python otherwise.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .unified_index import DirectIndex, UnifiedIndex


@dataclasses.dataclass
class PaddedCTR:
    indices: np.ndarray  # [N, D] int32, pad 0
    values: np.ndarray  # [N, D] f32, pad 0
    valid: np.ndarray  # [N, D] bool, False on padding slots
    targets: np.ndarray  # [N] f32 in {0, 1}
    embeddings: list[np.ndarray]  # per embedding column: [N, dim] f32


class CTRDataset:
    """Sparse CTR dataset."""

    def __init__(self, index: UnifiedIndex | DirectIndex | None = None) -> None:
        self.index = index or UnifiedIndex()
        self.features: list[tuple[list[int], list[float]]] = []
        self.targets: list[float] = []
        self.timestamps: list[float] = []
        self.users: list[int] = []  # per-sample user id (for user-time split), -1 unknown
        # dense embedding features: list of columns; each column is a list of
        # per-sample vectors (or None)
        self.embedding_dims: list[int] = []
        self.embeddings: list[list[np.ndarray | None]] = []

    def add(
        self,
        indices: list[int],
        values: list[float],
        target: float,
        user: int = -1,
        timestamp: float = 0.0,
        embeddings: list[np.ndarray | None] | None = None,
    ) -> None:
        self.features.append((list(indices), list(values)))
        self.targets.append(float(target))
        self.users.append(user)
        self.timestamps.append(timestamp)
        if embeddings is not None:
            for c, e in enumerate(embeddings):
                self.embeddings[c].append(e)
        else:
            for c in range(len(self.embedding_dims)):
                self.embeddings[c].append(None)

    def __len__(self) -> int:
        return len(self.targets)

    def count_positive(self) -> int:
        return int(sum(1 for t in self.targets if t > 0.5))

    def count_negative(self) -> int:
        return len(self) - self.count_positive()

    def num_features(self) -> int:
        return len(self.index)

    def max_dimension(self) -> int:
        return max((len(f[0]) for f in self.features), default=1) or 1

    # ---------------------------------------------------------- device view

    def flat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every row's features concatenated: (lengths [N] int64, ids int32,
        values f32), in row order."""
        lengths = np.fromiter((len(f[0]) for f in self.features), np.int64, len(self))
        total = int(lengths.sum())
        ids = np.fromiter(itertools.chain.from_iterable(f[0] for f in self.features),
                          np.int32, total)
        values = np.fromiter(itertools.chain.from_iterable(f[1] for f in self.features),
                             np.float32, total)
        return lengths, ids, values

    def padded(self, pad_to: int | None = None) -> PaddedCTR:
        """``[N, D]`` views, each row's features in its first slots: the
        reference's row-by-row fill, as one masked assignment (row-major,
        so the same slots receive the same values)."""
        n = len(self)
        d = max(pad_to or self.max_dimension(), 1)
        lengths, ids, vals = self.flat()
        valid = np.arange(d)[None, :] < lengths[:, None]
        indices = np.zeros((n, d), dtype=np.int32)
        values = np.zeros((n, d), dtype=np.float32)
        indices[valid] = ids
        values[valid] = vals
        targets = np.asarray(self.targets, dtype=np.float32)
        embs = []
        for c, dim in enumerate(self.embedding_dims):
            col = np.zeros((n, dim), dtype=np.float32)
            for i, e in enumerate(self.embeddings[c]):
                if e is not None:
                    col[i] = e
            embs.append(col)
        return PaddedCTR(indices=indices, values=values, valid=valid, targets=targets, embeddings=embs)

    # ---------------------------------------------------------------- splits

    def _take(self, rows) -> "CTRDataset":
        """A dataset of ``rows``, in that order, sharing the index."""
        out = CTRDataset(self.index)
        out.embedding_dims = self.embedding_dims
        out.features = [self.features[i] for i in rows]
        out.targets = [self.targets[i] for i in rows]
        out.users = [self.users[i] for i in rows]
        out.timestamps = [self.timestamps[i] for i in rows]
        out.embeddings = [[col[i] for i in rows] for col in self.embeddings]
        return out

    def split(self, ratio: float = 0.2, seed: int = 0) -> tuple["CTRDataset", "CTRDataset"]:
        """Random split: the last ``1 - ratio`` of a seeded permutation to
        train, the first ``ratio`` to test."""
        rng = np.random.default_rng(seed)
        n = len(self)
        order = rng.permutation(n).tolist()
        n_test = int(n * ratio)
        return self._take(order[n_test:]), self._take(order[:n_test])

    def split_by_user_time(self, ratio: float = 0.2) -> tuple["CTRDataset", "CTRDataset"]:
        """Per-user temporal split: each user's most recent ``ratio`` of
        samples go to test, users in first-seen order."""
        by_user: dict[int, list[int]] = {}
        for i, u in enumerate(self.users):
            by_user.setdefault(u, []).append(i)
        train_rows: list[int] = []
        test_rows: list[int] = []
        for idxs in by_user.values():
            idxs.sort(key=lambda i: self.timestamps[i])
            cut = len(idxs) - int(len(idxs) * ratio)
            train_rows += idxs[:cut]
            test_rows += idxs[cut:]
        return self._take(train_rows), self._take(test_rows)


def load_libfm_file(path: str) -> CTRDataset:
    """Load a libFM-format file: ``target idx:val idx:val ...`` per line, a
    target of -1 read as 0, a bare ``idx`` as value 1. Uses the native C++
    parser (gorse_tpu_torch.native) when available; pure-Python fallback
    otherwise."""
    from ..native import parse_libfm_bytes

    with open(path, "rb") as f:
        buf = f.read()
    parsed = parse_libfm_bytes(buf)
    if parsed is not None:
        targets, indptr, indices, values, max_label = parsed
        d = CTRDataset(DirectIndex(int(max_label) + 1))
        for r in range(len(targets)):
            lo, hi = int(indptr[r]), int(indptr[r + 1])
            d.add(indices[lo:hi].tolist(), values[lo:hi].tolist(), float(targets[r]))
        return d
    features: list[tuple[list[int], list[float]]] = []
    targets_list: list[float] = []
    max_label = 0
    for line in buf.decode().splitlines():
        fields = line.strip().split()
        if not fields:
            continue
        targets_list.append(max(float(fields[0]), 0.0))  # -1 -> 0
        idx, val = [], []
        for tok in fields[1:]:
            k, _, v = tok.partition(":")
            k = int(k)
            idx.append(k)
            val.append(float(v) if v else 1.0)
            max_label = max(max_label, k)
        features.append((idx, val))
    d = CTRDataset(DirectIndex(max_label + 1))
    for (idx, val), t in zip(features, targets_list):
        d.add(idx, val, t)
    return d


def load_libfm(train_path: str, test_path: str) -> tuple[CTRDataset, CTRDataset]:
    train = load_libfm_file(train_path)
    test = load_libfm_file(test_path)
    n = max(len(train.index), len(test.index))
    train.index = DirectIndex(n)
    test.index = train.index
    return train, test


def synthetic_ctr(
    n_users: int = 200,
    n_items: int = 150,
    n_user_labels: int = 20,
    n_item_labels: int = 30,
    rank: int = 4,
    n_samples: int = 5000,
    seed: int = 0,
    numerical: bool = False,
) -> CTRDataset:
    """Low-rank ground-truth CTR dataset.

    Each sample is (user one-hot, item one-hot, a few label one-hots); the
    binary target is Bernoulli(sigmoid(latent FM score)), so a correct FM
    learner must reach high AUC. Draws in the reference's order, so the
    rows equal gorse_tpu's ``synthetic_ctr`` bit for bit.
    """
    rng = np.random.default_rng(seed)
    index = UnifiedIndex()
    for u in range(n_users):
        index.users.add(f"u{u}")
    for i in range(n_items):
        index.items.add(f"i{i}")
    for l in range(n_user_labels):
        index.user_labels.add(f"ul{l}")
    for l in range(n_item_labels):
        index.item_labels.add(f"il{l}")
    n_feat = len(index)
    v = rng.normal(scale=0.9, size=(n_feat, rank))
    w = rng.normal(scale=0.5, size=n_feat)
    d = CTRDataset(index)
    user_label = rng.integers(n_user_labels, size=n_users)
    item_label = rng.integers(n_item_labels, size=n_items)
    for _ in range(n_samples):
        u = int(rng.integers(n_users))
        i = int(rng.integers(n_items))
        idx = [
            u,
            index.item_offset + i,
            index.user_label_offset + int(user_label[u]),
            index.item_label_offset + int(item_label[i]),
        ]
        val = [1.0, 1.0, 1.0, 1.0]
        if numerical:
            val[2] = float(np.exp(rng.normal()))  # positive, long-tailed
        # FM score with ground-truth params
        x = np.zeros(n_feat)
        for k, vv in zip(idx, val):
            x[k] = vv
        vx = v.T @ x
        score = w @ x + 0.5 * (np.sum(vx**2) - np.sum((v.T**2) @ (x**2)))
        p = 1.0 / (1.0 + np.exp(-score))
        d.add(idx, val, float(rng.uniform() < p), user=u, timestamp=float(rng.uniform(0, 1e6)))
    return d
