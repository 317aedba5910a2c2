"""Implicit-feedback dataset for collaborative filtering (copy of
gorse_tpu/data/dataset.py).

Host-side bookkeeping in numpy: per-user and per-item feedback as ragged
int32 lists with string dictionaries, the edge arrays, the leave-one-out
and temporal splits, sampled evaluation negatives, the padded positives
matrices the trainers read, the full-set positives bitset and the IDF
weights of the similarity recommenders. Every random draw is numpy's ``default_rng(seed)`` in the
reference's order, so both packages build the same splits, padded rows and
candidates.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .dict import NOT_ID, FreqDict, Index

__all__ = ["Dataset", "NOT_ID", "FreqDict", "Index"]


@dataclasses.dataclass
class _PaddedCSR:
    """Padded view of a ragged int32 CSR matrix."""

    padded: np.ndarray  # [N, L] int32, pad = -1
    counts: np.ndarray  # [N]    int32


class Dataset:
    """Implicit-feedback dataset. Train/test splits share the dictionaries
    with the parent so ids stay comparable."""

    def __init__(self) -> None:
        self.user_dict = FreqDict()
        self.item_dict = FreqDict()
        self.user_label_dict = FreqDict()
        self.item_label_dict = FreqDict()
        self.user_feedback: list[list[int]] = []
        self.item_feedback: list[list[int]] = []
        self.timestamps: list[list[float]] = []
        self.user_labels: list[list[int]] = []
        self.item_labels: list[list[int]] = []
        self.num_feedback = 0
        self._negatives: dict[int, np.ndarray] = {}
        # fixed evaluation negatives of an NCF test file (data/loaders.py)
        self.file_negatives: list[list[int]] | None = None

    # ------------------------------------------------------------------ build

    def add_user(self, user_id: str, labels: list[str] | None = None) -> int:
        idx = self.user_dict.add_no_count(user_id)
        while len(self.user_feedback) <= idx:
            self.user_feedback.append([])
            self.timestamps.append([])
            self.user_labels.append([])
        if labels:
            self.user_labels[idx] = [self.user_label_dict.add(l) for l in labels]
        return idx

    def add_item(self, item_id: str, labels: list[str] | None = None) -> int:
        idx = self.item_dict.add_no_count(item_id)
        while len(self.item_feedback) <= idx:
            self.item_feedback.append([])
            self.item_labels.append([])
        if labels:
            self.item_labels[idx] = [self.item_label_dict.add(l) for l in labels]
        return idx

    def add_feedback(self, user_id: str, item_id: str, timestamp: float = 0.0) -> None:
        u = self.add_user(user_id)
        i = self.add_item(item_id)
        self.user_dict.add(user_id)  # occurrence counts
        self.item_dict.add(item_id)
        self.user_feedback[u].append(i)
        self.item_feedback[i].append(u)
        self.timestamps[u].append(timestamp)
        self.num_feedback += 1

    @classmethod
    def from_edges(
        cls,
        users: np.ndarray,
        items: np.ndarray,
        timestamps: np.ndarray | None = None,
        user_ids: list[str] | None = None,
        item_ids: list[str] | None = None,
    ) -> "Dataset":
        """Bulk-build from integer edge arrays; ids default to decimal
        strings."""
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        if timestamps is None:
            timestamps = np.zeros(len(users), dtype=np.float64)
        d = cls()
        n_users = int(users.max()) + 1 if len(users) else 0
        n_items = int(items.max()) + 1 if len(items) else 0
        if user_ids is None:
            user_ids = [str(i) for i in range(n_users)]
        if item_ids is None:
            item_ids = [str(i) for i in range(n_items)]
        for uid in user_ids:
            d.add_user(uid)
        for iid in item_ids:
            d.add_item(iid)
        d.user_dict._freq = [int(c) for c in np.bincount(users, minlength=len(user_ids))]
        d.item_dict._freq = [int(c) for c in np.bincount(items, minlength=len(item_ids))]
        order = np.argsort(users, kind="stable")
        su, si, st = users[order], items[order], np.asarray(timestamps)[order]
        splits = np.searchsorted(su, np.arange(len(user_ids) + 1))
        for u in range(len(user_ids)):
            lo, hi = splits[u], splits[u + 1]
            d.user_feedback[u] = si[lo:hi].tolist()
            d.timestamps[u] = st[lo:hi].tolist()
        order = np.argsort(items, kind="stable")
        si2, su2 = items[order], users[order]
        splits = np.searchsorted(si2, np.arange(len(item_ids) + 1))
        for i in range(len(item_ids)):
            lo, hi = splits[i], splits[i + 1]
            d.item_feedback[i] = su2[lo:hi].tolist()
        d.num_feedback = len(users)
        return d

    # ------------------------------------------------------------------ stats

    def count_users(self) -> int:
        return len(self.user_feedback)

    def count_items(self) -> int:
        return len(self.item_feedback)

    def count_feedback(self) -> int:
        return self.num_feedback

    def get_user_feedback(self) -> list[list[int]]:
        return self.user_feedback

    def get_item_feedback(self) -> list[list[int]]:
        return self.item_feedback

    # IDF weights for set similarity: log(n / occurrence count), counts
    # floored at 1 (the dictionaries' frequencies)

    def user_idf(self) -> np.ndarray:
        """IDF weight per user id, for user-set similarity."""
        n = max(self.count_items(), 1)
        freq = np.maximum(self.user_dict.freqs(), 1)
        return np.log(n / freq).astype(np.float32)

    def item_idf(self) -> np.ndarray:
        n = max(self.count_users(), 1)
        freq = np.maximum(self.item_dict.freqs(), 1)
        return np.log(n / freq).astype(np.float32)

    def item_label_idf(self) -> np.ndarray:
        n = max(self.count_items(), 1)
        freq = np.maximum(self.item_label_dict.freqs(), 1)
        return np.log(n / freq).astype(np.float32)

    def user_label_idf(self) -> np.ndarray:
        n = max(self.count_users(), 1)
        freq = np.maximum(self.user_label_dict.freqs(), 1)
        return np.log(n / freq).astype(np.float32)

    # ------------------------------------------------------------ padded rows

    def edge_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The (user, item) feedback edges, user-major, as int32 arrays."""
        counts = np.fromiter((len(fb) for fb in self.user_feedback), np.int64,
                             len(self.user_feedback))
        users = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
        items = np.fromiter((i for fb in self.user_feedback for i in fb), np.int32, len(users))
        return users, items

    @staticmethod
    def _pad(
        ragged: list[list[int]],
        pad_to: int | None = None,
        max_len: int | None = None,
        seed: int = 0,
    ) -> _PaddedCSR:
        """Pad ragged rows to a rectangle (pad=-1). ``max_len`` caps the
        width: rows longer than the cap keep a random subset, drawn from
        ``default_rng(seed)`` row by row as the reference draws it."""
        n = len(ragged)
        counts = np.fromiter((len(r) for r in ragged), dtype=np.int32, count=n)
        widest = int(counts.max()) if n else 0
        cap = min(widest, max_len) if max_len else widest
        width = max(pad_to or cap, cap, 1)
        rng = np.random.default_rng(seed) if max_len and widest > max_len else None
        padded = np.full((n, width), -1, dtype=np.int32)
        for i, r in enumerate(ragged):
            if rng is not None and len(r) > cap:
                padded[i, :cap] = rng.choice(np.asarray(r, dtype=np.int32), size=cap, replace=False)
                counts[i] = cap
            else:
                padded[i, : len(r)] = r
        return _PaddedCSR(padded=padded, counts=counts)

    def padded_user_positives(
        self, pad_to: int | None = None, max_len: int | None = None, seed: int = 0
    ) -> _PaddedCSR:
        """Padded [U, L] matrix of each user's positive item ids (pad=-1)."""
        return self._pad(self.user_feedback, pad_to, max_len, seed)

    def padded_item_positives(
        self, pad_to: int | None = None, max_len: int | None = None, seed: int = 0
    ) -> _PaddedCSR:
        """Padded [I, L] matrix of each item's positive user ids (pad=-1)."""
        return self._pad(self.item_feedback, pad_to, max_len, seed)

    def positives_bitset(self) -> np.ndarray:
        """``[U, ceil(I/32)]`` uint32 membership bitset of each user's whole
        positive set: bit ``i % 32`` of word ``i // 32`` is set when item
        ``i`` is among the user's feedback, whatever the cap of the padded
        rows. BPR rejects negatives against it as gorse does
        (model/cf/model.go:460-468). One ``bitwise_or.at`` over every row."""
        n_users, words = self.count_users(), -(-self.count_items() // 32)
        counts = np.fromiter((len(fb) for fb in self.user_feedback), dtype=np.int64,
                             count=n_users)
        items = np.fromiter(itertools.chain.from_iterable(self.user_feedback), dtype=np.int64,
                            count=int(counts.sum()))
        users = np.repeat(np.arange(n_users, dtype=np.int64), counts)
        bits = np.zeros(n_users * words, np.uint32)
        np.bitwise_or.at(bits, users * words + (items >> 5),
                         np.left_shift(np.uint32(1), (items & 31).astype(np.uint32)))
        return bits.reshape(n_users, words)

    # ---------------------------------------------------------------- splits

    def _empty_split(self) -> "Dataset":
        s = Dataset()
        s.user_dict, s.item_dict = self.user_dict, self.item_dict
        s.user_label_dict, s.item_label_dict = self.user_label_dict, self.item_label_dict
        s.user_feedback = [[] for _ in range(self.count_users())]
        s.item_feedback = [[] for _ in range(self.count_items())]
        s.timestamps = [[] for _ in range(self.count_users())]
        s.user_labels, s.item_labels = self.user_labels, self.item_labels
        return s

    def split_cf(self, num_test_users: int = 0, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """Leave-one-out split: one random feedback per (sampled) user goes
        to the test set, the rest to train; users not sampled keep all of
        theirs in train."""
        rng = np.random.default_rng(seed)
        train, test = self._empty_split(), self._empty_split()
        n_users = self.count_users()
        if num_test_users <= 0 or num_test_users >= n_users:
            test_users = np.arange(n_users)
        else:
            test_users = rng.choice(n_users, size=num_test_users, replace=False)
        test_user_set = set(int(u) for u in test_users)
        for u in range(n_users):
            fb, ts = self.user_feedback[u], self.timestamps[u]
            if not fb:
                continue
            k = int(rng.integers(len(fb))) if u in test_user_set else -1
            if k >= 0:
                test.user_feedback[u].append(fb[k])
                test.item_feedback[fb[k]].append(u)
                test.timestamps[u].append(ts[k])
                test.num_feedback += 1
            for i, item in enumerate(fb):
                if i != k:
                    train.user_feedback[u].append(item)
                    train.item_feedback[item].append(u)
                    train.timestamps[u].append(ts[i])
                    train.num_feedback += 1
        return train, test

    def split_latest(self, shots: int) -> tuple["Dataset", "Dataset"]:
        """Temporal split (gorse's dataset/dataset.go:325-355): each user's
        newest feedback goes to the test set, the next ``shots`` newest to
        the train set. Equal time stamps keep the earlier feedback first
        (a stable sort, newest first)."""
        train, test = self._empty_split(), self._empty_split()
        for u in range(self.count_users()):
            fb, ts = self.user_feedback[u], self.timestamps[u]
            if not fb:
                continue
            order = sorted(range(len(fb)), key=lambda i: ts[i], reverse=True)
            for split, slots in ((test, order[:1]), (train, order[1 : shots + 1])):
                for i in slots:
                    split.user_feedback[u].append(fb[i])
                    split.item_feedback[fb[i]].append(u)
                    split.timestamps[u].append(ts[i])
                    split.num_feedback += 1
        return train, test

    def sample_user_negatives(self, exclude: "Dataset", num_candidates: int, seed: int = 0) -> np.ndarray:
        """``num_candidates`` negatives per user, excluding this set's and
        ``exclude``'s positives, cached per width; a test file's own
        negatives where it has them. Returns int32 [U, C]."""
        if num_candidates in self._negatives:
            return self._negatives[num_candidates]
        rng = np.random.default_rng(seed)
        n_items = self.count_items()
        out = np.zeros((self.count_users(), num_candidates), dtype=np.int32)
        if self.file_negatives is not None:
            # an NCF test file's negatives, as they are (gorse's
            # dataset/dataset.go:246-257): the widest row's width (at most
            # num_candidates), shorter rows padded with -1, which the
            # evaluation masks
            widths = [len(n) for n in self.file_negatives]
            w = min(max(widths, default=0), num_candidates)
            out = np.full((self.count_users(), max(w, 1)), -1, dtype=np.int32)
            for u in range(min(len(self.file_negatives), out.shape[0])):
                negs = self.file_negatives[u][:w]
                if negs:
                    out[u, : len(negs)] = np.asarray(negs, np.int32)
            self._negatives[num_candidates] = out
            return out
        for u in range(self.count_users()):
            excl = set(self.user_feedback[u])
            excl.update(exclude.user_feedback[u])
            n_avail = n_items - len(excl)
            if n_avail <= num_candidates:
                pool = np.asarray([i for i in range(n_items) if i not in excl], dtype=np.int32)
                if len(pool) == 0:
                    continue
                out[u] = pool[rng.integers(len(pool), size=num_candidates)]
                continue
            # oversample + reject
            got: list[int] = []
            factor = 2.0
            while len(got) < num_candidates:
                need = num_candidates - len(got)
                cand = rng.integers(n_items, size=max(int(need * factor), 16))
                for c in cand:
                    ci = int(c)
                    if ci not in excl:
                        excl.add(ci)  # also dedups candidates
                        got.append(ci)
                        if len(got) == num_candidates:
                            break
                factor *= 1.5
            out[u] = got
        self._negatives[num_candidates] = out
        return out
