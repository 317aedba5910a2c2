"""The port's quantized top-k (gorse_tpu_torch.ops.topk: ``sq_topk`` on a
PreparedSQ through the SQ kernels' plain versions, the raw-array route,
``pq_topk`` and ``rq_topk``) held against gorse_tpu.ops.topk (Pallas in
interpret mode, and its XLA formulations).

Inputs are made with numpy from a seed. The two packages sum the same
products in another order, and XLA may fuse a multiply and an add, so a
score is held to 1e-5 of the magnitude of the terms it sums, plus 1e-6:
for the SQ routes |scale|·Σ|q|·code + |qsum·minv| (q rounded to bf16 on the
kernel route), twice that plus |norms2| + |q2| for euclidean, and the same
magnitudes for the pq and rq products. Scores of the port are held to the
exact (f64) value of the formula within that tolerance, and to the
reference's at the same rank; indices must equal the reference's wherever
the item is farther than both tolerances from every other item's exact
score (where no rounding can reorder it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.ops import topk as ref
from gorse_tpu_torch.ops import topk as port


def _sq_rows(rng, n, d):
    """Codes, per-row scale and minv, and norms2 of the dequantized rows."""
    codes = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    scale = rng.uniform(0.002, 0.02, size=n).astype(np.float32)
    minv = rng.normal(scale=1.0, size=n).astype(np.float32)
    approx = minv[:, None] + scale[:, None] * codes.astype(np.float32)
    return codes, scale, minv, (approx * approx).sum(1).astype(np.float32)


def _bf16(x):
    return torch.as_tensor(x).bfloat16().double().numpy()


def _sq_exact(q, codes, scale, minv, norms2, metric, q_dot=None):
    """The formula in f64, and the magnitude of the terms it sums. ``q_dot``
    (default ``q``) is the query the dot reads; qsum and q2 come from ``q``."""
    q = q.astype(np.float64)
    q_dot = q if q_dot is None else q_dot.astype(np.float64)
    c = codes.astype(np.float64)
    qsum = q.sum(1, keepdims=True)
    dots = (q_dot @ c.T) * scale[None, :] + qsum * minv[None, :]
    mag = (np.abs(q_dot) @ c.T) * np.abs(scale)[None, :] + np.abs(qsum * minv[None, :])
    if metric != "euclidean":
        return dots, mag
    q2 = (q * q).sum(1, keepdims=True)
    return 2.0 * dots - norms2[None, :] - q2, 2.0 * mag + np.abs(norms2)[None, :] + q2


def _assert_topk(s, i, rs, ri, exact, mag):
    s, i = np.asarray(s, np.float64), np.asarray(i).astype(np.int64)
    rs, ri = np.asarray(rs, np.float64), np.asarray(ri).astype(np.int64)
    assert s.shape == rs.shape and i.shape == ri.shape
    tol = 1e-5 * mag + 1e-6
    rows = np.arange(s.shape[0])[:, None]
    np.testing.assert_array_less(np.abs(s - exact[rows, i]), tol[rows, i])
    np.testing.assert_array_less(np.abs(s - rs), tol[rows, i] + tol[rows, ri])
    # the reference's item at each rank, apart from every other item by
    # more than both tolerances, must be the port's too
    gap = np.abs(exact[:, None, :] - exact[rows, ri][:, :, None])  # [B, k, n]
    gap[rows[:, :, None], np.arange(ri.shape[1])[None, :, None], ri[:, :, None]] = np.inf
    apart = (gap > tol[:, None, :] + tol[rows, ri][:, :, None]).all(axis=2)
    assert apart.mean() > 0.5, "the inputs leave too few ranks to check"
    np.testing.assert_array_equal(i[apart], ri[apart])


# n in {300, 3000}, d in {16, 64}, B in {4, 300} (300 runs two chunks), k in
# {1, 10, n}, each metric at each k; and k = 300 over 3,000 items (12 blocks
# < k <= 3072 / 4: the group gate)
SQ_CASES = [
    (3000, 64, 4, 300, "dot"),
    (300, 16, 4, 1, "dot"),
    (300, 64, 300, 10, "cosine"),
    (300, 16, 300, 300, "euclidean"),
    (3000, 64, 4, 10, "dot"),
    (3000, 16, 300, 1, "cosine"),
    (3000, 64, 4, 1, "euclidean"),
    (300, 64, 4, 300, "dot"),
    (3000, 16, 4, 3000, "cosine"),
    (3000, 64, 300, 10, "euclidean"),
    (3000, 16, 300, 10, "dot"),
]


@pytest.mark.parametrize("n,d,b,k,metric", SQ_CASES)
def test_sq_topk_prepared_matches_reference(n, d, b, k, metric):
    """The kernel route (plain versions here) against the reference's
    PreparedSQ Pallas route in interpret mode: q rounded to bf16 for the
    dot, qsum and q2 from the f32 q, euclidean 2·dots − norms2 − q2."""
    rng = np.random.default_rng(n + d + b + k)
    codes, scale, minv, norms2 = _sq_rows(rng, n, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    rprep = ref.prepare_sq_items(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(minv),
                                 jnp.asarray(norms2))
    rs, ri = ref.sq_topk(jnp.asarray(q), rprep, k_top=k, metric=metric, interpret=True)
    prep = port.prepare_sq_items(codes, scale, minv, norms2, device="cpu")
    s, i = port.sq_topk(q, prep, k_top=k, metric=metric, device="cpu")
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    exact, mag = _sq_exact(q, codes, scale, minv, norms2, metric, q_dot=_bf16(q))
    _assert_topk(s.numpy(), i.numpy(), rs, ri, exact, mag)
    assert torch.equal(i, port.sq_topk_plain(q, prep, k, metric)[1])


@pytest.mark.parametrize("n,d,b,k,metric", SQ_CASES)
def test_sq_topk_raw_matches_reference_xla(n, d, b, k, metric):
    """Raw arrays take the XLA formulation: q in f32 throughout, euclidean
    −(q2 − 2·dots + norms2)."""
    rng = np.random.default_rng(n * d + b + k)
    codes, scale, minv, norms2 = _sq_rows(rng, n, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    rs, ri = ref.sq_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
                         jnp.asarray(minv), k, norms2=jnp.asarray(norms2), metric=metric)
    s, i = port.sq_topk(q, codes, scale, minv, k, norms2, metric, device="cpu")
    exact, mag = _sq_exact(q, codes, scale, minv, norms2, metric)
    _assert_topk(s.numpy(), i.numpy(), rs, ri, exact, mag)


def _pq_rows(rng, n, m, ds):
    codes = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    books = rng.normal(size=(m, 256, ds)).astype(np.float32)
    vhat = books[np.arange(m)[None, :], codes.astype(np.int64)].reshape(n, -1)
    return codes, books, (vhat.astype(np.float64) ** 2).sum(1).astype(np.float32)


@pytest.mark.parametrize("n,d,m,b,k,metric", [
    (300, 16, 16, 4, 10, "dot"), (3000, 64, 32, 300, 1, "euclidean"),
    (3000, 16, 8, 4, 3000, "cosine"),
])
def test_pq_topk_matches_reference(n, d, m, b, k, metric):
    """Decoded rows rounded to bf16, scored by an f32 product."""
    rng = np.random.default_rng(n + m + k)
    codes, books, norms2 = _pq_rows(rng, n, m, d // m)
    q = rng.normal(size=(b, d)).astype(np.float32)
    rs, ri = ref.pq_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(books),
                         jnp.asarray(norms2), k, metric=metric)
    s, i = port.pq_topk(q, codes, books, norms2, k, metric, device="cpu")
    vb = _bf16(books[np.arange(m)[None, :], codes.astype(np.int64)].reshape(n, -1))
    qd = q.astype(np.float64)
    exact, mag = qd @ vb.T, np.abs(qd) @ np.abs(vb).T
    if metric == "euclidean":
        q2 = (qd * qd).sum(1, keepdims=True)
        exact = 2.0 * exact - norms2[None, :] - q2
        mag = 2.0 * mag + np.abs(norms2)[None, :] + q2
    _assert_topk(s.numpy(), i.numpy(), rs, ri, exact, mag)


@pytest.mark.parametrize("n,d,bits,b,k,metric", [
    (300, 16, 1, 4, 10, "dot"), (3000, 64, 4, 300, 10, "euclidean"),
    (3000, 16, 2, 4, 1, "cosine"), (300, 64, 4, 4, 300, "dot"),
])
def test_rq_topk_matches_reference(n, d, bits, b, k, metric):
    """Sub-byte codes unpacked, scored in the rotated basis."""
    from gorse_tpu.storage.vectors import _encode_rq, _rotation

    rng = np.random.default_rng(n + bits + k)
    rot = _rotation(d, seed=3)
    packed, scale, minv, norms2 = _encode_rq(rng.normal(size=(n, d)).astype(np.float32), rot,
                                             bits)
    q = rng.normal(size=(b, d)).astype(np.float32)
    rs, ri = ref.rq_topk(jnp.asarray(q), jnp.asarray(packed), jnp.asarray(scale),
                         jnp.asarray(minv), jnp.asarray(rot), jnp.asarray(norms2), k,
                         bits=bits, dim=d, metric=metric)
    s, i = port.rq_topk(q, packed, scale, minv, rot, norms2, k, bits, d, metric, device="cpu")
    per_byte = 8 // bits
    shifts = (np.arange(per_byte, dtype=np.uint8) * bits)[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(n, -1)[:, :d]
    qd = q.astype(np.float64)
    rq = qd @ rot.T.astype(np.float64)
    rq_mag = np.abs(qd) @ np.abs(rot.T.astype(np.float64))
    c = codes.astype(np.float64)
    exact = (rq @ c.T) * scale[None, :] + rq.sum(1, keepdims=True) * minv[None, :]
    mag = rq_mag @ (c * np.abs(scale)[:, None] + np.abs(minv)[:, None]).T
    if metric == "euclidean":
        q2 = (qd * qd).sum(1, keepdims=True)
        exact = 2.0 * exact - norms2[None, :] - q2
        mag = 2.0 * mag + np.abs(norms2)[None, :] + q2
    _assert_topk(s.numpy(), i.numpy(), rs, ri, exact, mag)


def test_euclidean_without_norms2_raises():
    """Both routes refuse euclidean without norms2, as the reference does
    (gorse_tpu/ops/topk.py:207-214,220-221)."""
    rng = np.random.default_rng(0)
    codes, scale, minv, _ = _sq_rows(rng, 20, 8)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    rprep = ref.prepare_sq_items(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(minv))
    prep = port.prepare_sq_items(codes, scale, minv, device="cpu")
    assert not prep.has_norms2 and not rprep.has_norms2
    for fn in (lambda: ref.sq_topk(jnp.asarray(q), rprep, k_top=3, metric="euclidean"),
               lambda: port.sq_topk(q, prep, k_top=3, metric="euclidean", device="cpu"),
               lambda: ref.sq_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale),
                                   jnp.asarray(minv), 3, metric="euclidean"),
               lambda: port.sq_topk(q, codes, scale, minv, 3, metric="euclidean",
                                    device="cpu")):
        with pytest.raises(ValueError, match="norms2"):
            fn()


def _exact_inputs(rng, n, d, b):
    """Inputs on which every product and sum of the SQ scores is exact in
    f32 (q multiples of 1/4, scale 2^-6, minv multiples of 1/8), with
    duplicate rows, constant rows (all codes 0, scale 1.0) and a catalog
    that is not a multiple of 256."""
    q = (rng.integers(-4, 5, size=(b, d)) / 4).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    scale = np.full(n, 2.0**-6, np.float32)
    minv = (rng.integers(-16, 17, size=n) / 8).astype(np.float32)
    codes[10:20] = codes[3]
    scale[10:20], minv[10:20] = scale[3], minv[3]
    codes[40:60] = 0
    scale[40:60] = 1.0
    approx = minv[:, None].astype(np.float64) + scale[:, None] * codes.astype(np.float64)
    return q, codes, scale, minv, (approx * approx).sum(1).astype(np.float32)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("n,k", [(1000, 5), (1000, 7), (700, 700)])
def test_sq_plain_kernels_equal_the_formula(metric, n, k):
    """block_max_sq (block and group maxima) and the chains of every route
    that applies (plain versions) equal a dense f64 evaluation of the
    epilogue formula, tolerance 0: k = 7 > n_blocks (4) leaves the group
    gate and no gate, k = n returns every item (no gate only)."""
    rng = np.random.default_rng(n + k)
    d, b = 16, 40
    q, codes, scale, minv, norms2 = _exact_inputs(rng, n, d, b)
    exact, _ = _sq_exact(q, codes, scale, minv, norms2, metric)
    exact = exact.astype(np.float32)  # exact in f32 on these inputs
    prep = port.prepare_sq_items(codes, scale, minv, norms2, device="cpu")
    b_pad = port._round_up(b, port.QUERY_TILE)
    qp, aff = port._sq_operands(torch.as_tensor(q), prep, b_pad, metric)
    n_pad = prep.table.shape[0]
    nb = n_pad // port.BLOCK_N
    bmax, gmax = port.block_max_sq(qp, prep.table, aff, n, groups=True)
    padded = np.full((b, n_pad), port.NEG_INF, np.float32)
    padded[:, :n] = exact
    np.testing.assert_array_equal(bmax.numpy()[:b], padded.reshape(b, nb, -1).max(2))
    np.testing.assert_array_equal(gmax.numpy()[:b], padded.reshape(b, -1, port.GROUP).max(2))
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    want_s = np.take_along_axis(exact, order, 1)
    routes = [r for r, fits in (("block", k <= nb), ("group", 4 * k <= n_pad), ("none", True))
              if fits]
    for route in routes:
        cand, count = port._candidates(qp, prep.table, b, n, k, route, aff)
        s, i = port.merge_topk(cand, count, b, k)
        np.testing.assert_array_equal(i.numpy(), order)
        np.testing.assert_array_equal(s.numpy(), want_s)
    s, i = port.sq_topk(q, prep, k_top=k, metric=metric, device="cpu")
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(s.numpy(), want_s)
