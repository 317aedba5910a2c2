"""The port's approximate serving tier (gorse_tpu_torch.ops.topk
dot_topk_approx / sq_topk_approx, ``bin_max`` then ``merge_topk``, plain
versions on the CPU) held against gorse_tpu.ops.topk's
``jax.lax.approx_max_k`` routes on the CPU.

- ``approx_bins`` equals the width XLA's shape rule gives
  ``approx_max_k(..., aggregate_to_topk=False)``, exactly.
- Where the bins are as many as the reference's padded width (L >= n), both
  tiers are exact: scores and indices equal, tie order included. Inputs are
  bf16-exact (multiples of a power of two with few significant bits), so
  every partial sum is exact in f32 in either summation order (as in
  tests/test_torch_topk.py).
- On the CPU ``approx_max_k`` is an exact top-k, so at 100,000 x 32 the
  reference's lists are the exact ones: the port's mean recall against
  them must reach each target, and each returned score must equal the
  exact score of its index within the summation-order bound d 2^-23
  sum |q| |v| (bf16 products are exact in f32; only the order of the f32
  sum differs).
- ``bin_max_plain``, the version the card holds the kernel against, equals
  a numpy model of the strided bins, padding and empty bins included.
- ``bin_plan``, the work plan the card's ``bin_max`` launches take as
  arguments, covers every (bin, row) of the table once in each launch and
  every query once, and stores keys by plain writes only where one unit
  owns a bin's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.ops import topk as ref
from gorse_tpu_torch.ops import topk as port


def _ref_bins(n: int, k: int, target: float) -> int:
    spec = jax.ShapeDtypeStruct((2, n), jnp.float32)
    out = jax.eval_shape(
        lambda x: jax.lax.approx_max_k(x, k, recall_target=target, aggregate_to_topk=False),
        spec,
    )
    return out[0].shape[-1]


BIN_CASES = [
    (1_000_000, 10, 0.99), (100_000, 10, 0.99), (1_000_000, 100, 0.99),
    (1_000_000, 300, 0.95), (1_000_000, 10, 0.9), (100_000, 10, 0.9), (1000, 10, 0.99),
    (1_000_000, 298, 0.99), (1_000_000, 1, 0.99), (129, 1, 0.5), (128, 7, 0.9),
    (1024, 2, 0.5), (1792, 10, 0.99), (27_000, 150, 0.95), (500_000, 2048, 0.99),
    (3_000_000, 64, 0.999), (65_536, 16, 1.0), (4096, 3, 0.3), (131_072, 10, 0.97),
    (2_000_000, 10, 1e-9), (100_352, 10, 0.99), (1_048_576, 1000, 0.995),
]


@pytest.mark.parametrize("n,k,target", BIN_CASES)
def test_approx_bins_matches_reference(n, k, target):
    assert port.approx_bins(n, k, target) == _ref_bins(n, k, target)


@pytest.mark.parametrize("n,k,target,match", [
    (1000, 0, 0.9, "k must be positive"),
    (1000, 10, 0.0, "recall_target should range"),
    (1000, 10, 1.5, "recall_target should range"),
])
def test_approx_bins_errors_match_reference(n, k, target, match):
    with pytest.raises(Exception, match=match):
        _ref_bins(n, k, target)
    with pytest.raises(ValueError, match=match):
        port.approx_bins(n, k, target)


def _quantized(rng, shape, lo=-8, hi=8, scale=0.25):
    return (rng.integers(lo, hi + 1, size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n,d,b,k,ties", [
    (1000, 32, 16, 10, False), (100, 8, 5, 100, False), (1000, 8, 4, 15, True),
    (300, 16, 40, 7, True),
])
def test_dot_topk_approx_exact_where_bins_cover(n, d, b, k, ties):
    """L >= n: the reference's case of tests/test_topk.py:295 (1,000 x 32,
    k = 10) and small ones with ties, scores and indices equal."""
    rng = np.random.default_rng(n + k)
    if ties:
        items = rng.integers(0, 3, size=(n, d)).astype(np.float32)
        queries = rng.integers(0, 2, size=(b, d)).astype(np.float32)
    else:
        items, queries = _quantized(rng, (n, d)), _quantized(rng, (b, d))
    assert port.approx_bins(port._round_up(n, 128), min(k, n), 0.99) >= n
    rs, ri = ref.dot_topk_approx(jnp.asarray(queries), ref.prepare_items(jnp.asarray(items),
                                                                      jnp.bfloat16), k, 0.99)
    prep = port.prepare_items(items, device="cpu")
    ps, pi = port.dot_topk_approx(queries, prep, k, 0.99, device="cpu")
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    # a raw array is prepared on the fly
    rs2, ri2 = port.dot_topk_approx(queries, items, k, 0.99, device="cpu")
    np.testing.assert_array_equal(ri2.numpy(), pi.numpy())


def test_dot_topk_approx_k_zero_raises_like_reference():
    items = np.ones((10, 4), np.float32)
    with pytest.raises(ValueError, match="k must be positive"):
        ref.dot_topk_approx(jnp.ones((2, 4)), jnp.asarray(items), 0)
    with pytest.raises(ValueError, match="k must be positive"):
        port.dot_topk_approx(np.ones((2, 4), np.float32), items, 0, device="cpu")


def test_topk_excluding_approx_route_matches_reference():
    """tests/test_topk.py:322: the approximate branch comes first, even with
    the library route asked for, and drops the excluded ids."""
    rng = np.random.default_rng(1)
    items, queries = _quantized(rng, (500, 16)), _quantized(rng, (4, 16))
    _, i1 = ref.topk_excluding(jnp.asarray(queries), jnp.asarray(items), 5, use_pallas=False)
    exclude = np.asarray(i1)[:, :2]
    rs, ri = ref.topk_excluding(jnp.asarray(queries), jnp.asarray(items), 5,
                                exclude=jnp.asarray(exclude), use_pallas=False,
                                approx_recall=0.99)
    ps, pi = port.topk_excluding(queries, items, 5, exclude=exclude, use_kernel=False,
                                 device="cpu", approx_recall=0.99)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    for row, banned in zip(pi.numpy(), exclude):
        assert not set(row.tolist()) & set(banned.tolist())
    # a fetch above 2,048 stays approximate over the prepared bf16 table
    prep = port.prepare_items(items, device="cpu")
    ps2, pi2 = port.topk_excluding(queries, prep, 5, exclude=exclude, use_kernel=False,
                                   device="cpu", approx_recall=0.99)
    np.testing.assert_array_equal(pi2.numpy(), pi.numpy())


def _indexes(n_u, n_i, k, seed):
    from gorse_tpu.data.dict import FreqDict as RefDict
    from gorse_tpu.logics.cf import MatrixFactorizationIndex as RefIndex
    from gorse_tpu_torch.data.dict import FreqDict
    from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex

    rng = np.random.default_rng(seed)
    uf, itf = _quantized(rng, (n_u, k)), _quantized(rng, (n_i, k))
    out = []
    for dict_cls, cls, kw in ((RefDict, RefIndex, {}),
                              (FreqDict, MatrixFactorizationIndex, {"device": "cpu"})):
        users, items = dict_cls(), dict_cls()
        for u in range(n_u):
            users.add(f"u{u}")
        for i in range(n_i):
            items.add(f"i{i}")
        out.append(cls(uf, itf, users, items, **kw))
    return out


def test_search_users_approx_matches_reference():
    """tests/test_topk.py:343: search_users(approx_recall=0.99) over both
    indexes, with per-user exclusions, equal lists."""
    ref_idx, port_idx = _indexes(12, 200, 8, 2)
    uids = [f"u{u}" for u in range(12)] + ["nobody"]
    exclude = [[f"i{(u * 7 + j) % 200}" for j in range(u % 4)] for u in range(13)]
    want = ref_idx.search_users(uids, 5, exclude=exclude, use_pallas=False, approx_recall=0.99)
    got = port_idx.search_users(uids, 5, exclude=exclude, use_kernel=False, approx_recall=0.99)
    assert [[(s.id, s.score) for s in row] for row in got] == \
        [[(s.id, s.score) for s in row] for row in want]
    assert got[-1] == []


def test_search_users_approx_takes_the_prepared_table(monkeypatch):
    """Past the 2,048 fetch the exact route scores the f32 table; the
    approximate one keeps the prepared bf16 table."""
    _, port_idx = _indexes(4, 300, 8, 3)
    seen = []
    real = port.dot_topk_approx

    def spy(queries, items, *a, **kw):
        seen.append(type(items).__name__)
        return real(queries, items, *a, **kw)

    monkeypatch.setattr("gorse_tpu_torch.ops.topk.dot_topk_approx", spy)
    monkeypatch.setattr(port_idx, "_KERNEL_FETCH_MAX", 3)
    port_idx.search_users(["u0", "u1"], 5, approx_recall=0.9)
    assert seen == ["PreparedItems"]


def _sq_prep(rng, n, d):
    items = rng.normal(size=(n, d)).astype(np.float32)
    minv = items.min(axis=1)
    scale = ((items.max(axis=1) - minv) / 255.0).astype(np.float32)
    codes = np.clip(np.round((items - minv[:, None]) / scale[:, None]), 0, 255).astype(np.uint8)
    deq = minv[:, None] + scale[:, None] * codes.astype(np.float32)
    return codes, scale, minv, (deq * deq).sum(axis=1).astype(np.float32)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_sq_topk_approx_matches_reference(metric):
    """tests/test_topk.py:369 at L >= n: integer codes, scales and minima
    that are powers of two, integer queries, so both epilogues round
    alike."""
    rng = np.random.default_rng(3)
    n, d, b = 800, 32, 8
    codes = rng.integers(0, 16, size=(n, d)).astype(np.uint8)
    scale = np.full(n, 0.5, np.float32)
    minv = rng.integers(-2, 3, size=n).astype(np.float32)
    deq = minv[:, None] + scale[:, None] * codes.astype(np.float32)
    norms2 = (deq * deq).sum(axis=1).astype(np.float32)
    queries = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    rprep = ref.prepare_sq_items(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(minv),
                                 jnp.asarray(norms2))
    pprep = port.prepare_sq_items(codes, scale, minv, norms2, device="cpu")
    rs, ri = ref.sq_topk_approx(jnp.asarray(queries), rprep, 10, 0.99, metric=metric)
    ps, pi = port.sq_topk_approx(queries, pprep, 10, 0.99, metric=metric, device="cpu")
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_sq_topk_approx_euclidean_needs_norms2():
    rng = np.random.default_rng(4)
    codes, scale, minv, _ = _sq_prep(rng, 300, 16)
    q = rng.normal(size=(2, 16)).astype(np.float32)
    rprep = ref.prepare_sq_items(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(minv))
    pprep = port.prepare_sq_items(codes, scale, minv, device="cpu")
    with pytest.raises(ValueError) as want:
        ref.sq_topk_approx(jnp.asarray(q), rprep, 10, metric="euclidean")
    with pytest.raises(ValueError) as got:
        port.sq_topk_approx(q, pprep, 10, metric="euclidean", device="cpu")
    assert str(got.value) == str(want.value)


def _recall(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)]))


@pytest.fixture(scope="module")
def catalog_100k():
    rng = np.random.default_rng(100)
    items = rng.normal(size=(100_000, 32)).astype(np.float32)
    queries = rng.normal(size=(256, 32)).astype(np.float32)
    return queries, items, port.prepare_items(items, device="cpu")


@pytest.mark.parametrize("target", [0.9, 0.95, 0.99])
def test_dot_topk_approx_recall_at_100k(catalog_100k, target):
    """At 100,000 x 32, k = 10 the bins are fewer than the items (256 or
    1,664): the port's mean recall against the reference's lists reaches the
    target, and each score is its index's exact score."""
    queries, items, prep = catalog_100k
    n_bins = port.approx_bins(port._round_up(100_000, 128), 10, target)
    assert n_bins < 100_000
    _, ri = ref.dot_topk_approx(jnp.asarray(queries), ref.prepare_items(jnp.asarray(items),
                                                                      jnp.bfloat16), 10, target)
    ps, pi = port.dot_topk_approx(queries, prep, 10, target, device="cpu")
    assert _recall(pi.numpy(), np.asarray(ri)) >= target
    qb = torch.as_tensor(queries).bfloat16().double().numpy()
    tb = torch.as_tensor(items).bfloat16().double().numpy()
    idx = pi.numpy()
    exact = np.einsum("bd,bkd->bk", qb, tb[idx])
    tol = 32 * 2.0**-23 * np.einsum("bd,bkd->bk", np.abs(qb), np.abs(tb[idx]))
    assert np.all(np.abs(ps.numpy() - exact) <= tol)
    assert np.all(np.diff(ps.numpy(), axis=1) <= 0)


def _bins_model(scores: np.ndarray, n_items: int, n_bins: int) -> np.ndarray:
    """Best (score, -index) of each strided bin, as the int64 key or
    INT64_MIN for an empty bin."""
    b = scores.shape[0]
    out = np.full((b, n_bins), np.iinfo(np.int64).min, np.int64)
    keys = port._keys(torch.as_tensor(scores[:, :n_items]).contiguous(),
                      torch.arange(n_items)).numpy()
    for j in range(n_items):
        np.maximum(out[:, j % n_bins], keys[:, j], out=out[:, j % n_bins])
    return out


@pytest.mark.parametrize("n_items,n_bins", [(1000, 1024), (1000, 256), (999, 128),
                                            (3000, 1664), (2000, 1000), (700, 300)])
def test_bin_max_plain_against_a_model(n_items, n_bins):
    """Bins that straddle 256-item slabs (1,664, 300), bins without items
    (1,024 over 1,000), ties across bins and inside one."""
    rng = np.random.default_rng(n_items + n_bins)
    items = rng.integers(-2, 3, size=(n_items, 8)).astype(np.float32)
    queries = rng.integers(-1, 2, size=(5, 8)).astype(np.float32)
    prep = port.prepare_items(items, device="cpu")
    qp = port._pad_queries(queries, prep, 32)
    keys = port.bin_max(qp, prep.table, n_items, n_bins)
    scores = port._scores_plain(qp, prep.table).numpy()
    np.testing.assert_array_equal(keys.numpy(), _bins_model(scores, n_items, n_bins))
    s, i = port.merge_topk(keys, torch.full((32,), n_bins, dtype=torch.int32), 5,
                           min(7, n_items))
    assert np.all(i.numpy() < n_items)


@pytest.mark.parametrize("n_items,n_bins,b,n_sm", [
    (1_000_000, 31_360, 256, 132),  # phase 13: the worker's fetch (k = 298)
    (1_000_000, 1024, 256, 132),  # phase 13: k = 10, rows split
    (1_000_003, 1024, 300, 132),  # n_items not a multiple of L, two slices
    (100_000, 9000, 200, 132),  # more units than SMs: two rounds
    (101, 101, 1, 132),  # L = n <= 128, n odd: one row
    (127, 127, 33, 132),
    (3000, 37, 40, 132),  # L below a unit's 64 bins
    (1000, 16, 257, 132),
    (500, 500, 64, 132),  # one row
    (100, 128, 128, 132),  # bins without items
    (50_000, 1024, 300, 4),  # few SMs: chunks outnumber them, no split
    (50_000, 256, 64, 16),  # 4 chunks on 16 SMs: 4 segments
])
def test_bin_plan_covers_each_bin_and_row_once(n_items, n_bins, b, n_sm):
    """Each (bin, row) of the ``ceil(n_items / L)`` rows is in exactly one
    unit; each unit is ``BIN_W`` bins from a multiple of ``BIN_W`` over a
    non-empty range of rows; ``merge`` exactly where a bin's rows are split
    over units (the plan splits only when the chunks of bins are fewer than
    the SMs, and then into one wave); the persistent grid's walk (block b:
    units b, b + grid, ...) takes every unit once; the launches cover the
    padded queries once, at most 256 each."""
    b_pad = port._round_up(b, port.QUERY_TILE)
    plan = port.bin_plan(n_items, n_bins, b_pad, n_sm)
    n_rows = -(-n_items // n_bins)
    n_chunks = -(-n_bins // port.BIN_W)
    cover = np.zeros((n_rows, n_chunks * port.BIN_W), np.int64)
    owners = np.zeros(n_chunks * port.BIN_W, np.int64)
    for bin0, r_lo, r_hi in plan.units:
        assert bin0 % port.BIN_W == 0 and 0 <= r_lo < r_hi <= n_rows
        cover[r_lo:r_hi, bin0:bin0 + port.BIN_W] += 1
        owners[bin0:bin0 + port.BIN_W] += 1
    assert np.all(cover[:, :n_bins] == 1)
    assert plan.merge == bool(np.any(owners[:n_bins] > 1))
    if not plan.merge:
        assert all((r_lo, r_hi) == (0, n_rows) for _, r_lo, r_hi in plan.units)
    assert plan.merge == (n_chunks < n_sm and n_rows > 1 and n_sm // n_chunks > 1)
    if plan.merge:
        assert len(plan.units) <= n_sm
    assert 1 <= plan.grid <= min(n_sm, len(plan.units))
    walked = sorted(u for blk in range(plan.grid) for u in range(blk, len(plan.units), plan.grid))
    assert walked == list(range(len(plan.units)))
    queries = [q for q0, nq in plan.slices for q in range(q0, q0 + nq)]
    assert queries == list(range(b_pad))
    assert all(1 <= nq <= 256 for _, nq in plan.slices)


def test_worker_index_recall_matches_reference(tmp_path, monkeypatch):
    """``recommend.collaborative.index_recall = 0.99``: both workers take the
    approximate tier (the port through bin_max then merge_topk) over one
    saved index; the catalog is small enough that the bins cover it, so the
    caches are equal, ids and scores, and hold only catalog ids, none of
    the user's, at most cache_size of them."""
    from gorse_tpu.data.dict import FreqDict as RefDict
    from gorse_tpu.logics.cf import MatrixFactorizationIndex as RefIndex
    from gorse_tpu.serve.worker import Worker as RefWorker
    from gorse_tpu.storage import types as ref_types
    from gorse_tpu.storage.blob import BlobStore as RefBlob
    from gorse_tpu.storage.cache import MemoryCacheStore as RefCache
    from gorse_tpu.storage.data import MemoryDataStore as RefData
    from gorse_tpu.utils.config import Config as RefConfig
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import types
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.utils.config import Config

    n_users, n_items = 40, 300
    rng = np.random.default_rng(5)
    uf = rng.integers(-3, 4, size=(n_users, 8)).astype(np.float32)
    itf = rng.integers(-3, 4, size=(n_items, 8)).astype(np.float32)
    users, items = RefDict(), RefDict()
    for u in range(n_users):
        users.add(f"u{u}")
    for i in range(n_items):
        items.add(f"i{i}")
    RefIndex(uf, itf, users, items, [[] for _ in range(n_items)], 5.0).save(
        RefBlob(tmp_path / "blobs").create("7"))
    feedback = [(f"u{u}", f"i{j}") for u in range(n_users)
                for j in rng.choice(n_items, size=int(rng.integers(0, 30)), replace=False)]
    caches = {}
    seen = []
    real = port.dot_topk_approx
    monkeypatch.setattr("gorse_tpu_torch.ops.topk.dot_topk_approx",
                        lambda *a, **kw: seen.append(kw["recall_target"]) or real(*a, **kw))
    for name, cfg_cls, data_cls, cache_cls, blob_cls, t, worker_cls, kw in (
        ("ref", RefConfig, RefData, RefCache, RefBlob, ref_types, RefWorker, {}),
        ("port", Config, MemoryDataStore, MemoryCacheStore, BlobStore, types, Worker,
         {"device": "cpu"}),
    ):
        cfg = cfg_cls()
        cfg.recommend.cache_size = 20
        cfg.recommend.ranker.recommenders = ["collaborative"]
        cfg.recommend.collaborative.type = "mf"
        cfg.recommend.collaborative.index_recall = 0.99
        data, cache = data_cls(), cache_cls()
        data.insert_items(t.Item(f"i{i}", timestamp=float(i)) for i in range(n_items))
        data.insert_users(t.User(f"u{u}") for u in range(n_users))
        data.insert_feedback(t.Feedback("like", u, i, 1.0, 10.0) for u, i in feedback)
        worker = worker_cls(cfg, data, cache, blob_cls(tmp_path / "blobs"), **kw)
        worker.pull_models("7", "")
        assert worker.recommend([f"u{u}" for u in range(n_users)]) == n_users
        caches[name] = {u: [(s.id, s.score) for s in cache.search_scores(
            "collaborative_filtering", u)] for u in (f"u{k}" for k in range(n_users))}
    assert seen and set(seen) == {0.99}
    assert caches["port"] == caches["ref"]
    mine = {}
    for u, i in feedback:
        mine.setdefault(u, set()).add(i)
    for u, row in caches["port"].items():
        assert len(row) <= 20
        assert not {i for i, _ in row} & mine.get(u, set())
    assert sum(bool(row) for row in caches["port"].values()) >= n_users - 5
