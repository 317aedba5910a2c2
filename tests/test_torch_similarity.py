"""The port's ops/similarity.py against gorse_tpu.ops.similarity on the CPU.

The same numpy inputs, from a seed, go through both packages. Tolerances
(u = 2^-24, f32):

- IDF set distances: ``(4 L + 16) u``, L the most labels in a row. A
  distance is ``1 - r`` with ``r <= 1`` a ratio of sums of at most L
  non-negative weights: two summation orders put each sum within ``L u``
  of the exact one, so ``r`` differs by at most ``(4 L + 16) u`` of itself
  with the rounding of its few other operations.
- Squared Euclidean embedding distances: ``(4 d + 16) u (|x_i|^2 +
  |x_j|^2)`` (d dimensions: the dot and both norms summed in another
  order), cosine ``(6 d + 16) u``; queries add the augmented column.

Neighbour lists are held tie-aware: distances within the tolerance at
every slot; indices equal at every slot whose reference distance lies more
than twice the tolerance from both neighbours; every index well inside the
k-th distance present in the other list. Where every partial sum is exact
(0/1 incidence, IDF weights that are small integers) the two agree exactly,
and there the indices, tie order included, must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.ops import similarity as ref
from gorse_tpu_torch.ops import similarity as sim

U = 2.0**-24


def _idf_tol(*incs) -> float:
    widest = max(int(inc.sum(axis=1).max(initial=0)) for inc in incs)
    return (4 * widest + 16) * U


def _assert_neighbors(got, want, tol):
    """Tie-aware comparison of (distances, indices) ``[n, k]`` pairs;
    ``tol`` a scalar or an ``[n, k]`` array (the reference's slots)."""
    d, i = (np.asarray(x) for x in got)
    d_r, i_r = (np.asarray(x) for x in want)
    assert d.shape == d_r.shape and i.shape == i_r.shape
    tol = np.broadcast_to(np.asarray(tol, np.float64), d_r.shape)
    t = tol.max(axis=1, keepdims=True)
    err = np.abs(d.astype(np.float64) - d_r)
    assert (err <= t).all(), f"largest difference {err.max():.3g} over tolerance {t.max():.3g}"
    gap = np.diff(d_r.astype(np.float64), axis=1)
    inf = np.full((d_r.shape[0], 1), np.inf)
    apart = (np.concatenate([inf, gap], 1) > 2 * t) & (np.concatenate([gap, -inf], 1) > 2 * t)
    np.testing.assert_array_equal(i[apart], i_r[apart])
    kth = d_r[:, -1:]
    for row in range(d.shape[0]):
        assert set(i_r[row][d_r[row] < kth[row] - 2 * t[row]]) <= set(i[row])
        assert set(i[row][d[row] < kth[row] - t[row]]) <= set(i_r[row])


def _label_lists(rng, n, n_labels, lo, hi):
    return [sorted(rng.choice(n_labels, size=rng.integers(lo, hi), replace=False).tolist())
            for _ in range(n)]


def test_incidence_matrix_equal():
    rng = np.random.default_rng(0)
    lists = _label_lists(rng, 40, 12, 0, 6) + [[3, 3, 1], []]
    np.testing.assert_array_equal(sim.incidence_matrix(lists, 12), ref.incidence_matrix(lists, 12))
    assert sim.incidence_matrix([], 5).shape == (0, 5)


@pytest.mark.parametrize("n,n_labels,k,block,seed", [
    (30, 15, 5, 8, 0), (70, 40, 10, 32, 1), (300, 25, 20, 256, 2), (257, 9, 256, 64, 3),
])
def test_idf_neighbors_match_reference(n, n_labels, k, block, seed):
    rng = np.random.default_rng(seed)
    lists = _label_lists(rng, n, n_labels, 0, 7)
    idf = rng.uniform(0.1, 3.0, n_labels).astype(np.float32)
    inc = sim.incidence_matrix(lists, n_labels)
    want = ref.idf_neighbors(jnp.asarray(inc), jnp.asarray(idf), k_top=k, block=block)
    got = sim.idf_neighbors(inc, idf, k_top=k, block=block, device="cpu")
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_neighbors(got, want, _idf_tol(inc))


@pytest.mark.parametrize("seed", [0, 1])
def test_idf_distance_matrix_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lists = _label_lists(rng, 50, 20, 0, 8)
    idf = rng.uniform(0.1, 2.0, 20).astype(np.float32)
    inc = sim.incidence_matrix(lists, 20)
    got = sim.idf_distance_matrix(inc, idf, device="cpu").numpy()
    want = np.asarray(ref.idf_distance_matrix(jnp.asarray(inc), jnp.asarray(idf)))
    np.testing.assert_allclose(got, want, rtol=0, atol=_idf_tol(inc))
    # the special cases decide from exact counts: equal in both
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)


def test_idf_special_cases():
    """Identical sets give 0, disjoint and empty sets give 1, self is never
    a neighbour."""
    lists = [[0, 1], [0, 1], [2, 3], [], [1]]
    idf = np.ones(4, dtype=np.float32)
    inc = sim.incidence_matrix(lists, 4)
    d, i = (x.numpy() for x in sim.idf_neighbors(inc, idf, k_top=4, block=2, device="cpu"))
    assert d[0][0] == 0.0 and i[0][0] == 1 and d[1][0] == 0.0 and i[1][0] == 0
    assert d[2].tolist() == [1.0] * 4 and i[2].tolist() == [0, 1, 3, 4]
    assert d[3].tolist() == [1.0] * 4 and i[3].tolist() == [0, 1, 2, 4]
    for row in range(5):
        assert row not in i[row].tolist()
    full = sim.idf_distance_matrix(inc, idf, device="cpu").numpy()
    assert full[0, 1] == 0.0 and full[0, 2] == 1.0 and full[3, 3] == 1.0 and full[0, 0] == 0.0


def test_idf_neighbors_avg_matches_reference_and_dense_average():
    rng = np.random.default_rng(11)
    n, l1, l2, k = 70, 25, 40, 5
    lists1 = _label_lists(rng, n, l1, 1, 6)
    lists2 = _label_lists(rng, n, l2, 0, 8)
    idf1 = rng.uniform(0.1, 2.0, l1).astype(np.float32)
    idf2 = rng.uniform(0.1, 2.0, l2).astype(np.float32)
    inc1, inc2 = sim.incidence_matrix(lists1, l1), sim.incidence_matrix(lists2, l2)
    tol = _idf_tol(inc1, inc2)
    got = sim.idf_neighbors_avg(inc1, idf1, inc2, idf2, k_top=k, block=32, device="cpu")
    want = ref.idf_neighbors_avg(jnp.asarray(inc1), jnp.asarray(idf1), jnp.asarray(inc2),
                                 jnp.asarray(idf2), k_top=k, block=32)
    _assert_neighbors(got, want, tol)
    # the blockwise average is the dense one's top-k, in the same tie order
    dense = ((sim.idf_distance_matrix(inc1, idf1, device="cpu")
              + sim.idf_distance_matrix(inc2, idf2, device="cpu")) / 2.0).numpy()
    np.fill_diagonal(dense, sim.BIG)
    idx = np.argsort(dense, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got[1].numpy(), idx)
    np.testing.assert_array_equal(got[0].numpy(), np.take_along_axis(dense, idx, axis=1))


@pytest.mark.parametrize("avg", [False, True])
def test_exact_ties_keep_the_reference_order(avg):
    """Few labels from a small alphabet and integer IDF weights: many
    identical, disjoint and equal-overlap pairs, every sum exact. Distances
    and indices, tie order included, equal the reference's exactly."""
    rng = np.random.default_rng(5)
    n, n_labels, k = 90, 5, 30
    lists = _label_lists(rng, n, n_labels, 0, 3)
    idf = rng.integers(1, 3, n_labels).astype(np.float32)
    inc = sim.incidence_matrix(lists, n_labels)
    if avg:
        lists2 = _label_lists(rng, n, 4, 0, 2)
        inc2 = sim.incidence_matrix(lists2, 4)
        idf2 = np.ones(4, np.float32)
        got = sim.idf_neighbors_avg(inc, idf, inc2, idf2, k_top=k, block=32, device="cpu")
        want = ref.idf_neighbors_avg(jnp.asarray(inc), jnp.asarray(idf), jnp.asarray(inc2),
                                     jnp.asarray(idf2), k_top=k, block=32)
    else:
        got = sim.idf_neighbors(inc, idf, k_top=k, block=32, device="cpu")
        want = ref.idf_neighbors(jnp.asarray(inc), jnp.asarray(idf), k_top=k, block=32)
    d_r = np.asarray(want[0])
    ties = sum(len(row) - len(np.unique(row)) for row in d_r)
    assert ties > n * k // 2, f"only {ties} tied slots"
    np.testing.assert_array_equal(got[0].numpy(), d_r)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("metric,n,d,k", [
    ("euclidean", 20, 8, 3), ("euclidean", 300, 16, 10), ("cosine", 15, 6, 2),
    ("cosine", 270, 16, 12),
])
def test_embedding_neighbors_match_reference(metric, n, d, k):
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = sim.embedding_neighbors(x, k_top=k, metric=metric, device="cpu")
    want = ref.embedding_neighbors(jnp.asarray(x), k_top=k, metric=metric)
    if metric == "euclidean":
        sq = (x.astype(np.float64) ** 2).sum(1)
        tol = (4 * d + 16) * U * (sq[:, None] + sq[np.asarray(want[1])])
    else:
        tol = (6 * d + 16) * U
    _assert_neighbors(got, want, tol)
    with pytest.raises(ValueError, match="metric"):
        sim.embedding_neighbors(x, k_top=k, metric="dot", device="cpu")


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_embedding_query_matches_reference(metric):
    rng = np.random.default_rng(3)
    d = 8
    q = rng.normal(size=(4, d)).astype(np.float32)
    c = rng.normal(size=(50, d)).astype(np.float32)
    got = sim.embedding_query(q, c, k_top=5, metric=metric, device="cpu")
    want = ref.embedding_query(jnp.asarray(q), jnp.asarray(c), k_top=5, metric=metric)
    if metric == "euclidean":
        q2, c2 = (q.astype(np.float64) ** 2).sum(1), (c.astype(np.float64) ** 2).sum(1)
        tol = (4 * (d + 1) + 16) * U * 2 * (q2[:, None] + c2[np.asarray(want[1])])
    else:
        tol = (6 * d + 16) * U
    _assert_neighbors(got, want, tol)
