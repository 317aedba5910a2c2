"""Feature scalers for numerical CTR features (copy of
gorse_tpu/models/scaler.py): MinMax to [0, 1], Robust (median/IQR), and
AutoScaler (log1p then MinMax for non-negative features, Robust then MinMax
where negatives exist). Applied on the host while the padded arrays are
built; the card sees scaled values. ``to_dict``/``from_dict`` are the
reference's, so a saved AFM's scalers interchange between the packages.
"""

from __future__ import annotations

import itertools

import numpy as np


class MinMaxScaler:
    """(v - min) / (max - min); a degenerate range maps to 1."""

    def __init__(self) -> None:
        self.min = np.inf
        self.max = -np.inf

    def fit(self, values: np.ndarray) -> "MinMaxScaler":
        if len(values):
            self.min = float(np.min(values))
            self.max = float(np.max(values))
        return self

    def transform(self, value):
        if self.min > self.max:
            return value
        rng = self.max - self.min
        if rng == 0:
            return np.ones_like(np.asarray(value, dtype=np.float32)) if np.ndim(value) else 1.0
        return (value - self.min) / rng

    def to_dict(self) -> dict:
        return {"min": self.min, "max": self.max}

    @classmethod
    def from_dict(cls, d: dict) -> "MinMaxScaler":
        s = cls()
        s.min, s.max = d["min"], d["max"]
        return s


class RobustScaler:
    """(v - median) / IQR."""

    def __init__(self) -> None:
        self.median = 0.0
        self.iqr = 0.0

    def fit(self, values: np.ndarray) -> "RobustScaler":
        if len(values):
            self.median = float(np.median(values))
            q1, q3 = np.percentile(values, [25, 75])
            self.iqr = float(q3 - q1)
        return self

    def transform(self, value):
        if self.iqr == 0:
            return value - self.median
        return (value - self.median) / self.iqr

    def to_dict(self) -> dict:
        return {"median": self.median, "iqr": self.iqr}

    @classmethod
    def from_dict(cls, d: dict) -> "RobustScaler":
        s = cls()
        s.median, s.iqr = d["median"], d["iqr"]
        return s


class AutoScaler:
    """log1p+MinMax for non-negative data; Robust then MinMax otherwise."""

    def __init__(self) -> None:
        self.use_log = True
        self.minmax = MinMaxScaler()
        self.robust = RobustScaler()

    def fit(self, values: np.ndarray) -> "AutoScaler":
        values = np.asarray(values, dtype=np.float32)
        if len(values) == 0:
            return self
        if np.any(values < 0):
            self.use_log = False
            self.robust.fit(values)
            self.minmax.fit(np.asarray(self.robust.transform(values)))
        else:
            self.use_log = True
            self.minmax.fit(np.log1p(np.maximum(values, 0.0)))
        return self

    def transform(self, value):
        if self.use_log:
            # clamped: a negative serve-time value would give -inf/NaN logits
            return self.minmax.transform(np.log1p(np.maximum(value, 0.0)))
        return self.minmax.transform(self.robust.transform(value))

    def to_dict(self) -> dict:
        return {
            "use_log": self.use_log,
            "minmax": self.minmax.to_dict(),
            "robust": self.robust.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AutoScaler":
        s = cls()
        s.use_log = d["use_log"]
        s.minmax = MinMaxScaler.from_dict(d["minmax"])
        s.robust = RobustScaler.from_dict(d["robust"])
        return s


def fit_auto_scalers(features: list[tuple[list[int], list[float]]]) -> dict[int, AutoScaler]:
    """An AutoScaler for every feature id whose values are not all 1, keyed
    in the order of each id's first occurrence (the reference's dict order,
    which its saved ``meta.json`` keeps). One pass of numpy over the flat
    rows; each scaler fits the same float32 values as the reference's."""
    ids = np.fromiter(itertools.chain.from_iterable(f[0] for f in features), np.int64)
    vals = np.fromiter(itertools.chain.from_iterable(f[1] for f in features), np.float32)
    odd = np.unique(ids[vals != 1.0])
    if not len(odd):
        return {}
    keep = np.isin(ids, odd)
    ids, vals = ids[keep], vals[keep]
    uniq, first = np.unique(ids, return_index=True)
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], uniq, side="right")
    starts = np.concatenate([[0], bounds[:-1]])
    groups = {int(k): vals[order[lo:hi]] for k, lo, hi in zip(uniq, starts, bounds)}
    return {int(k): AutoScaler().fit(groups[int(k)]) for k in uniq[np.argsort(first)]}


def apply_scalers(
    indices: np.ndarray,
    values: np.ndarray,
    scalers: dict[int, AutoScaler],
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """Apply per-feature scalers to a padded [N, D] value matrix.

    ``valid`` masks out padding slots (padding uses index 0, which may also be
    a real feature id — the mask disambiguates).
    """
    if not scalers:
        return values
    out = values.copy()
    for k, scaler in scalers.items():
        mask = indices == k
        if valid is not None:
            mask &= valid
        if np.any(mask):
            out[mask] = scaler.transform(values[mask])
    return out
