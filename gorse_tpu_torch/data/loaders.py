"""Dataset loaders and the built-in datasets (copy of gorse_tpu/data/
loaders.py).

gorse's model/built_in.go names ml-100k, ml-1m, pinterest-20 (NCF
``train.txt``/``test.txt``, dataset/dataset.go:402-493) and ml-tag, frappe,
criteo (libFM, model/ctr/data.go:270-339). They resolve through the
registry (data/registry.py): the dataset directory, else the mirror of
``GORSE_TPU_DATASET_MIRROR``. ``synthetic://n_users,n_items,rank,density,
seed`` names low-rank ground-truth datasets; the same seed gives the same
dataset in both packages.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dataset import Dataset

# name -> (subdir, format). Mirrors model/built_in.go:46-83.
BUILT_IN = {
    "ml-100k": ("ml-100k", "ncf"),
    "ml-1m": ("ml-1m", "ncf"),
    "pinterest-20": ("pinterest-20", "ncf"),
    "ml-tag": ("ml-tag", "libfm"),
    "frappe": ("frappe", "libfm"),
    "criteo": ("criteo", "libfm"),
}


def dataset_dir() -> Path:
    from .registry import dataset_dir as _dd

    return _dd()



def load_ncf_file(path: str | Path, dataset: Dataset | None = None) -> Dataset:
    """Load the NCF format: ``user<TAB>item[<TAB>...]`` per line, or
    ``(user,item)<TAB>label`` test format (reference: dataset/dataset.go:402-451)."""
    d = dataset or Dataset()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            if fields[0].startswith("("):
                # test format: (user,item)\tlabel...
                pair = fields[0].strip("()").split(",")
                d.add_feedback(pair[0], pair[1])
            else:
                d.add_feedback(fields[0], fields[1])
    return d


def load_ncf(train_path: str | Path, test_path: str | Path) -> tuple[Dataset, Dataset]:
    """Load an NCF-style train/test pair sharing one dictionary space.

    Test lines carry the file's fixed evaluation negatives
    (``(u,i)<TAB>neg1<TAB>neg2...``, 99 in the gorse zips); they are stored
    on the test set and honored by ``sample_user_negatives`` exactly like the
    reference's loaded ``d.negatives`` (dataset/dataset.go:246-257,472-493).
    """
    train = load_ncf_file(train_path)
    test = train._empty_split()
    test.num_feedback = 0
    file_negatives: list[list[int]] = []
    with open(test_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            negs: list[str] = []
            if fields[0].startswith("("):
                pair = fields[0].strip("()").split(",")
                uid, iid = pair[0], pair[1]
                negs = fields[1:]
            else:
                uid, iid = fields[0], fields[1]
            u = train.add_user(uid)
            i = train.add_item(iid)
            if negs:
                while len(file_negatives) <= u:
                    file_negatives.append([])
                file_negatives[u] = [train.add_item(n) for n in negs]
            while len(test.user_feedback) <= u:
                test.user_feedback.append([])
                test.timestamps.append([])
            while len(test.item_feedback) <= i:
                test.item_feedback.append([])
            test.user_feedback[u].append(i)
            test.item_feedback[i].append(u)
            test.timestamps[u].append(0.0)
            test.num_feedback += 1
    # realign train's ragged arrays in case test introduced new entities
    while len(train.user_feedback) < len(train.user_dict):
        train.user_feedback.append([])
        train.timestamps.append([])
        train.user_labels.append([])
    while len(train.item_feedback) < len(train.item_dict):
        train.item_feedback.append([])
        train.item_labels.append([])
    if any(file_negatives):
        while len(file_negatives) < len(train.user_dict):
            file_negatives.append([])
        test.file_negatives = file_negatives
    return train, test


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


def synthetic_cf_powerlaw(
    n_users: int = 6040,
    n_items: int = 3706,
    rank: int = 16,
    nnz: int = 1_000_000,
    zipf_s: float = 1.0,
    pop_weight: float = 1.5,
    noise: float = 1.0,
    seed: int = 42,
) -> Dataset:
    """The ml-1m-scale heavy-tailed corpus of the reference's quality gates:
    Zipf item popularity (``zipf_s``) over a random permutation, log-normal
    user activity scaled to ``nnz``, and each user's positives the top of a
    low-rank score plus ``pop_weight`` times the popularity and Gumbel
    noise. The defaults give 6,040 x 3,706 with about 1M feedback. Numpy
    draws only, in the reference's order, so a seed gives the reference's
    dataset."""
    rng = np.random.default_rng(seed)
    pu = rng.normal(size=(n_users, rank)).astype(np.float32)
    qi = rng.normal(size=(n_items, rank)).astype(np.float32)
    order = rng.permutation(n_items)
    pop = np.empty(n_items, np.float32)
    pop[order] = -zipf_s * np.log(np.arange(1, n_items + 1, dtype=np.float32))
    pop -= pop.mean()
    raw = np.exp(rng.normal(0.0, 1.0, size=n_users))
    counts = np.clip(raw * (nnz / raw.sum()), 5, n_items - 1).astype(np.int64)
    users, items, ts = [], [], []
    scale = 1.0 / np.sqrt(rank)
    block = 512
    for lo in range(0, n_users, block):
        hi = min(lo + block, n_users)
        scores = (
            pu[lo:hi] @ qi.T * scale
            + pop_weight * pop[None, :]
            + noise * rng.gumbel(size=(hi - lo, n_items)).astype(np.float32)
        )
        for r, u in enumerate(range(lo, hi)):
            c = counts[u]
            top = np.argpartition(-scores[r], c)[:c]
            users.append(np.full(c, u, np.int64))
            items.append(top)
            ts.append(rng.uniform(0, 1e6, size=c))
    return Dataset.from_edges(
        np.concatenate(users),
        np.concatenate(items),
        np.concatenate(ts),
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
    """Load a built-in CF dataset by name; synthetic fallback via
    ``synthetic://n_users,n_items,rank,density,seed``."""
    if name.startswith("synthetic://"):
        spec = name[len("synthetic://"):]
        parts = [float(x) for x in spec.split(",")] if spec else []
        defaults = [1000, 500, 8, 0.05, 42]
        vals = parts + defaults[len(parts):]
        data = synthetic_cf(int(vals[0]), int(vals[1]), int(vals[2]), vals[3], int(vals[4]))
        return data.split_cf(seed=0)
    if name not in BUILT_IN:
        raise KeyError(f"unknown built-in dataset {name!r}")
    _, fmt = BUILT_IN[name]
    if fmt != "ncf":
        raise ValueError(
            f"dataset {name!r} is a CTR dataset; use load_built_in_ctr"
        )
    from .registry import locate_built_in

    train_p, test_p = locate_built_in(name, "ncf")
    return load_ncf(train_p, test_p)


def load_built_in_ctr(name: str):
    """Load a built-in libFM CTR dataset (frappe/ml-tag/criteo) through the
    registry fetch layer (reference: model/ctr/data.go:270-339 +
    model/built_in.go LocateBuiltInDataset(FormatLibFM))."""
    from .ctr import load_libfm
    from .registry import locate_built_in

    if name not in BUILT_IN or BUILT_IN[name][1] != "libfm":
        raise KeyError(f"unknown built-in CTR dataset {name!r}")
    train_p, test_p = locate_built_in(name, "libfm")
    return load_libfm(str(train_p), str(test_p))
