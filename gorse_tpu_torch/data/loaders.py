"""Synthetic dataset generators (copy of the numpy generators of
gorse_tpu/data/loaders.py). The same seed gives the same dataset in both
packages. ``load_built_in`` resolves only ``synthetic://`` names: the file
loaders of the built-in datasets are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .dataset import Dataset


def synthetic_cf(
    n_users: int = 1000,
    n_items: int = 500,
    rank: int = 8,
    density: float = 0.05,
    seed: int = 42,
    noise: float = 0.0,
) -> Dataset:
    """Low-rank ground truth: each user's positives are the items with the
    highest latent scores, about ``density * n_items`` of them."""
    rng = np.random.default_rng(seed)
    pu = rng.normal(size=(n_users, rank))
    qi = rng.normal(size=(n_items, rank))
    scores = pu @ qi.T + noise * rng.normal(size=(n_users, n_items))
    users, items, ts = [], [], []
    mean_count = max(int(density * n_items), 2)
    counts = np.clip(rng.poisson(mean_count, size=n_users), 1, n_items - 1)
    for u in range(n_users):
        top = np.argpartition(-scores[u], counts[u])[: counts[u]]
        users.extend([u] * len(top))
        items.extend(top.tolist())
        ts.extend(rng.uniform(0, 1e6, size=len(top)).tolist())
    return Dataset.from_edges(
        np.asarray(users),
        np.asarray(items),
        np.asarray(ts),
        user_ids=[f"u{i}" for i in range(n_users)],
        item_ids=[f"i{i}" for i in range(n_items)],
    )


def synthetic_cf_access(
    n_users: int,
    n_items: int,
    nnz: int,
    zipf_s: float = 1.0,
    seed: int = 42,
) -> Dataset:
    """Access statistics only, no latent structure: log-normal user
    activity and Zipf item popularity drawn from their marginals, (user,
    item) pairs deduplicated. For throughput runs at large shapes."""
    rng = np.random.default_rng(seed)
    raw = np.exp(rng.normal(0.0, 1.0, size=n_users))
    counts = np.clip(raw * (nnz / raw.sum()), 5, n_items - 1).astype(np.int64)
    total = int(counts.sum())
    p = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** zipf_s
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    items = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    users = np.repeat(np.arange(n_users, dtype=np.int64), counts)
    pair = np.unique(users * n_items + items)
    users, items = pair // n_items, pair % n_items
    ts = rng.random(len(users)) * 1e6
    return Dataset.from_edges(
        users,
        items.astype(np.int64),
        ts,
        user_ids=[f"u{i}" for i in range(n_users)],
        item_ids=[f"i{i}" for i in range(n_items)],
    )


def load_built_in(name: str) -> tuple[Dataset, Dataset]:
    """``synthetic://n_users,n_items,rank,density,seed`` -> the
    leave-one-out (train, test) split of :func:`synthetic_cf`."""
    if not name.startswith("synthetic://"):
        raise NotImplementedError(
            f"built-in dataset {name!r}: only synthetic:// names are ported yet"
        )
    spec = name[len("synthetic://"):]
    parts = [float(x) for x in spec.split(",")] if spec else []
    defaults = [1000, 500, 8, 0.05, 42]
    vals = parts + defaults[len(parts):]
    data = synthetic_cf(int(vals[0]), int(vals[1]), int(vals[2]), vals[3], int(vals[4]))
    return data.split_cf(seed=0)
