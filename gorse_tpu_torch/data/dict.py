"""String <-> int32 dictionaries (copy of gorse_tpu/data/dict.py).

Host-side bookkeeping (no device compute): contiguous int32 ids assigned in
first-seen order, with per-id occurrence counts. ``to_dict``/``from_dict``
are the reference's, so saved indexes interchange between the packages.
"""

from __future__ import annotations

import numpy as np

NOT_ID = np.int32(-1)


class Index:
    """Bidirectional string<->int32 index."""

    __slots__ = ("_to_id", "_to_name")

    def __init__(self) -> None:
        self._to_id: dict[str, int] = {}
        self._to_name: list[str] = []

    def add(self, name: str) -> int:
        """Insert ``name`` if absent; return its id."""
        idx = self._to_id.get(name)
        if idx is None:
            idx = len(self._to_name)
            self._to_id[name] = idx
            self._to_name.append(name)
        return idx

    def to_number(self, name: str) -> int:
        """Return the id for ``name`` or NOT_ID (-1)."""
        return self._to_id.get(name, int(NOT_ID))

    def to_name(self, idx: int) -> str:
        return self._to_name[idx]

    def __len__(self) -> int:
        return len(self._to_name)

    def __contains__(self, name: str) -> bool:
        return name in self._to_id

    def names(self) -> list[str]:
        return list(self._to_name)

    def to_dict(self) -> dict:
        return {"names": self._to_name}

    @classmethod
    def from_dict(cls, d: dict) -> "Index":
        out = cls()
        for name in d["names"]:
            out.add(name)
        return out


class FreqDict(Index):
    """Index that also counts occurrences."""

    __slots__ = ("_freq",)

    def __init__(self) -> None:
        super().__init__()
        self._freq: list[int] = []

    def add(self, name: str) -> int:
        idx = self._to_id.get(name)
        if idx is None:
            idx = len(self._to_name)
            self._to_id[name] = idx
            self._to_name.append(name)
            self._freq.append(1)
        else:
            self._freq[idx] += 1
        return idx

    def add_no_count(self, name: str) -> int:
        """Insert without incrementing the frequency (id reservation)."""
        idx = self._to_id.get(name)
        if idx is None:
            idx = len(self._to_name)
            self._to_id[name] = idx
            self._to_name.append(name)
            self._freq.append(0)
        return idx

    def count(self, idx: int) -> int:
        return self._freq[idx]

    def freqs(self) -> np.ndarray:
        return np.asarray(self._freq, dtype=np.int64)

    def to_dict(self) -> dict:
        return {"names": self._to_name, "freqs": self._freq}

    @classmethod
    def from_dict(cls, d: dict) -> "FreqDict":
        out = cls()
        out._to_name = list(d["names"])
        out._freq = list(d["freqs"])
        out._to_id = {n: i for i, n in enumerate(out._to_name)}
        return out
