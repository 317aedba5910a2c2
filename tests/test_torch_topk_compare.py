"""How the card's top-k is held against its plain version, and the kernel
route at k above 2048.

``chip_smoke.compare_lists`` is the tie-aware comparison the card's checks
use now that the kernels score on the tensor cores (another summation order
than the plain version's): it must accept what rounding can do to a list
and reject what it cannot. ``chip_smoke.score_tol`` and ``tol_at`` give the
tolerance it is fed. Then the plain kernel route (``dot_topk`` and
``sq_topk`` on a ``PreparedSQ``, on the CPU) at k = 3,000, past the 2,048
keys the card's merge once sorted at most, against gorse_tpu's Pallas
route in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gorse_tpu.ops import topk as ref
from gorse_tpu_torch.ops import topk as port

NEG = port.NEG_INF
T = 1e-3  # every item's tolerance in the constructed lists


def _lists(scores, ids):
    return (torch.tensor([scores], dtype=torch.float32), torch.tensor([ids], dtype=torch.int32))


# (kernel scores, kernel ids), (plain scores, plain ids)
ACCEPT = {
    "permuted_equal_scores": (([5.0, 3.0, 3.0, 3.0, 1.0], [7, 4, 2, 9, 1]),
                              ([5.0, 3.0, 3.0, 3.0, 1.0], [7, 2, 4, 9, 1])),
    "swap_inside_2tol": (([10.0, 9.0004, 9.0003, 7.0], [1, 3, 2, 4]),
                         ([10.0, 9.0005, 9.0, 7.0], [1, 2, 3, 4])),
    "neg_inf_tails": (([4.0, 2.0, NEG, NEG], [3, 0, 0, 0]),
                      ([4.0, 2.0, NEG, NEG], [3, 0, 0, 0])),
}
# ... and the rule that must catch each
REJECT = {
    "swap_beyond_2tol": (([10.0, 9.0, 8.0, 7.0], [1, 3, 2, 4]),
                         ([10.0, 9.0, 8.0, 7.0], [1, 2, 3, 4]), "ids at the slots apart"),
    "missing_above_boundary": (([10.0, 9.0, 9.0, 7.0], [1, 3, 5, 4]),
                               ([10.0, 9.0, 9.0, 7.0], [1, 2, 3, 4]), "keeps every id"),
    "score_off_by_more_than_tol": (([10.0 + 2 * T, 9.0, 8.0, 7.0], [1, 2, 3, 4]),
                                   ([10.0, 9.0, 8.0, 7.0], [1, 2, 3, 4]), "scores within"),
}


def _compare(kernel, plain):
    s, i = _lists(*kernel)
    s_p, i_p = _lists(*plain)
    tol = torch.full(s.shape, T)
    return chip_smoke.compare_lists("case", s, i, s_p, i_p, tol, tol)


@pytest.mark.parametrize("name", sorted(ACCEPT))
def test_compare_lists_accepts(name):
    worst = _compare(*ACCEPT[name])
    assert 0.0 <= worst <= 1.0


@pytest.mark.parametrize("name", sorted(REJECT))
def test_compare_lists_rejects(name):
    kernel, plain, rule = REJECT[name]
    with pytest.raises(RuntimeError, match=rule):
        _compare(kernel, plain)


@pytest.mark.parametrize("metric", [None, "dot", "euclidean"])
def test_tolerance_at_listed_items_equals_the_full_matrix(metric):
    """``tol_at`` (gathered rows, the lists' checks) and ``score_tol`` (every
    item, the maxima's checks) state one tolerance; it bounds the gap
    between the plain scores and an f64 sum of the same products."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(5, 40)).astype(np.float32)
    if metric is None:
        prep = port.prepare_items(rng.normal(size=(700, 40)).astype(np.float32), device="cpu")
        qp, aff = port._pad_queries(q, prep, 32), None
        table = prep.table
    else:
        codes = rng.integers(0, 256, size=(700, 40)).astype(np.uint8)
        scale = rng.uniform(0.002, 0.02, size=700).astype(np.float32)
        minv = rng.normal(size=700).astype(np.float32)
        vhat = minv[:, None] + scale[:, None] * codes
        prep = port.prepare_sq_items(codes, scale, minv, (vhat * vhat).sum(1), device="cpu")
        qp, aff = port._sq_operands(torch.as_tensor(q), prep, 32, metric)
        table = prep.table
    idx = torch.as_tensor(rng.integers(0, 700, size=(5, 9)), dtype=torch.int32)
    full = chip_smoke.score_tol(qp, table, aff)
    at = chip_smoke.tol_at(qp, table, idx, aff)
    torch.testing.assert_close(at, full[:5].gather(1, idx.long()), rtol=1e-6, atol=0.0)
    plain = port._scores_plain(qp, table, aff)[:5, :700].double()
    exact = qp[:5].double() @ table[:700].double().T
    if aff is not None:
        exact = exact * aff.affine[0, :700].double() + (
            aff.qstats[0, :5, None].double() * aff.affine[1, :700].double())
        if aff.euclidean:
            exact = 2.0 * exact - aff.affine[2, :700].double() - aff.qstats[1, :5, None].double()
    assert bool(((plain - exact).abs() <= full[:5, :700].double() / 2).all())


def _quantized(rng, shape):
    return (rng.integers(-8, 9, size=shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("seeded", [True, False])
def test_dot_topk_past_2048_matches_reference(seeded):
    """k = 3,000 of 4,000 items (the group gate seeded, no gate otherwise):
    bf16-exact inputs, so scores and ids equal the reference's."""
    rng = np.random.default_rng(30)
    q, items = _quantized(rng, (8, 16)), _quantized(rng, (4000, 16))
    rs, ri = ref.dot_topk(jnp.asarray(q), jnp.asarray(items), 3000, interpret=True)
    s, i = port.dot_topk(q, port.prepare_items(items, device="cpu"), 3000, seeded=seeded,
                         device="cpu")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_sq_topk_past_2048_matches_reference(metric):
    """k = 3,000 of 4,000 quantized rows through the SQ route: integer
    queries and codes, a power-of-two scale and half-integer minimums keep
    every dot and every epilogue op exact, so scores and ids equal the
    reference's PreparedSQ route."""
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 256, size=(4000, 16)).astype(np.uint8)
    scale = np.full(4000, 0.25, np.float32)
    minv = (rng.integers(-8, 9, size=4000) * 0.5).astype(np.float32)
    vhat = minv[:, None] + scale[:, None] * codes
    norms2 = (vhat * vhat).sum(1).astype(np.float32)
    q = rng.integers(-3, 4, size=(8, 16)).astype(np.float32)
    rprep = ref.prepare_sq_items(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(minv),
                                 jnp.asarray(norms2))
    rs, ri = ref.sq_topk(jnp.asarray(q), rprep, k_top=3000, metric=metric, interpret=True)
    prep = port.prepare_sq_items(codes, scale, minv, norms2, device="cpu")
    s, i = port.sq_topk(q, prep, k_top=3000, metric=metric, device="cpu")
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
