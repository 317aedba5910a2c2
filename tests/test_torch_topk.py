"""The port's top-k (gorse_tpu_torch.ops.topk, plain versions on the CPU)
held against gorse_tpu.ops.topk (Pallas kernels in interpret mode).

Inputs are made with numpy from a seed and are bf16-exact: multiples of a
power of two with few significant bits. Every product and partial sum is
then exact in f32 on both sides, whatever the summation order, so scores
must be equal (tolerance 0) and indices equal, tie order included, even
though the reference scores these cases in f32 and the port in bf16.
The cases are those of tests/test_topk.py:30-187 and :261.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.ops import topk as ref
from gorse_tpu_torch.ops import topk as port


def _quantized(rng, shape, lo=-8, hi=8, scale=0.25):
    return (rng.integers(lo, hi + 1, size=shape) * scale).astype(np.float32)


def _plant(items, cols, top, denom):
    for rank, col in enumerate(cols):
        items[col] = (top - rank) / denom
    return items


def _case(name):
    """(queries, items, k, exclude or None) for one reference case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "small":
        return _quantized(rng, (4, 16)), _quantized(rng, (100, 16)), 10, None
    if name == "unaligned":
        return _quantized(rng, (7, 37)), _quantized(rng, (1333, 37)), 13, None
    if name == "multi_block":
        return _quantized(rng, (8, 64)), _quantized(rng, (2048, 64)), 25, None
    if name == "k_all_items":
        return _quantized(rng, (3, 8)), _quantized(rng, (20, 8)), 20, None
    if name == "massive_ties":
        items = rng.integers(0, 3, size=(1000, 8)).astype(np.float32)
        return np.eye(4, 8, dtype=np.float32), items, 15, None
    if name == "hot_chunk":
        items = _quantized(rng, (512, 8), -4, 4, 1 / 256)
        items = _plant(items, range(130, 138), 100.0, 8.0)
        items[137] = items[136]  # exact tie inside the hot chunk
        return np.ones((2, 8), np.float32), items, 8, None
    if name == "hot_block":
        items = _quantized(rng, (8192, 16), -4, 4, 1 / 256)
        hot = [5, 200, 300, 700, 900, 1100, 1900, 2047, 2048, 2100]
        return np.ones((3, 16), np.float32), _plant(items, hot, 50.0, 16.0), 10, None
    if name == "many_blocks":
        return _quantized(rng, (16, 32)), _quantized(rng, (3000, 32)), 12, None
    if name == "duplicate_scores":
        items = np.repeat(np.eye(8, dtype=np.float32), 40, axis=0)  # every dot = 1
        return np.ones((4, 8), np.float32), items, 5, None
    if name == "exclusions":
        q, items = _quantized(rng, (5, 16)), _quantized(rng, (200, 16))
        order = np.argsort(-(q @ items.T), axis=1, kind="stable")
        return q, items, 5, order[:, :2].astype(np.int32)  # ban each true top-2
    if name == "ragged_exclusions":
        q, items = _quantized(rng, (6, 16)), _quantized(rng, (300, 16))
        ex = np.full((6, 9), -1, np.int32)
        for b in range(6):
            ex[b, : b + 3] = rng.choice(300, size=b + 3, replace=False)
        return q, items, 7, ex
    if name == "wide_k":  # k past 256 and the 6 blocks: the group gate; ungated, whole blocks
        return _quantized(rng, (3, 16)), _quantized(rng, (1500, 16)), 300, None
    if name == "chunked_batch":
        return _quantized(rng, (600, 32)), _quantized(rng, (2048, 32)), 7, None
    if name == "group_k":  # 8 blocks < k <= 2048 / 4: the group gate
        return _quantized(rng, (3, 16)), _quantized(rng, (2000, 16)), 300, None
    raise KeyError(name)


CASES = [
    "small", "unaligned", "multi_block", "k_all_items", "massive_ties", "hot_chunk",
    "hot_block", "many_blocks", "duplicate_scores", "exclusions", "ragged_exclusions",
    "wide_k", "chunked_batch", "group_k",
]


@pytest.mark.parametrize("name", CASES)
def test_topk_matches_reference(name):
    q, items, k, ex = _case(name)
    if ex is None:
        rs, ri = ref.dot_topk(jnp.asarray(q), jnp.asarray(items), k, interpret=True)
    else:
        rs, ri = ref.topk_excluding(jnp.asarray(q), jnp.asarray(items), k, jnp.asarray(ex),
                                    use_pallas=True, interpret=True)
    rs, ri = np.asarray(rs), np.asarray(ri)
    prep = port.prepare_items(items, device="cpu")
    for seeded in (True, False):
        if ex is None:
            s, i = port.dot_topk(q, prep, k, seeded=seeded, device="cpu")
        else:
            s, i = port.topk_excluding(q, prep, k, ex, device="cpu")
        np.testing.assert_array_equal(i.numpy(), ri)
        np.testing.assert_array_equal(s.numpy(), rs)
    # prepared table reuse: the same call again on the same PreparedItems
    s2, i2 = port.dot_topk(q, prep, k, device="cpu")
    assert torch.equal(i2, port.dot_topk(q, items, k, device="cpu")[1])
    # the f32 route agrees with the reference's XLA route
    fs, fi = ref.topk_excluding(jnp.asarray(q), jnp.asarray(items), k,
                                None if ex is None else jnp.asarray(ex), use_pallas=False)
    ps, pi = port.topk_excluding(q, items, k, ex, use_kernel=False, device="cpu")
    np.testing.assert_array_equal(pi.numpy(), np.asarray(fi))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(fs))


def test_topk_bf16_table_matches_reference_bf16():
    """Random normal factors: both packages round to the same bf16 table and
    bf16 queries; only the f32 summation order differs, so scores agree to
    1e-5 relative and each returned index scores within that of the
    reference's at its rank."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    items = rng.normal(size=(300, 32)).astype(np.float32)
    rs, ri = ref.dot_topk(jnp.asarray(q), ref.prepare_items(jnp.asarray(items), jnp.bfloat16),
                          10, interpret=True)
    s, i = port.dot_topk(q, port.prepare_items(items, device="cpu"), 10, device="cpu")
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    qb = torch.as_tensor(q).bfloat16().float().numpy()
    ib = torch.as_tensor(items).bfloat16().float().numpy()
    rescored = np.take_along_axis(qb @ ib.T, i.numpy().astype(np.int64), axis=1)
    np.testing.assert_allclose(rescored, np.asarray(rs), rtol=1e-5, atol=1e-5)


def test_topk_fills_missing_slots():
    """k beyond the catalog: NEG_INF scores and index 0 in the empty slots,
    as the reference kernels leave them."""
    rng = np.random.default_rng(3)
    q, items = _quantized(rng, (3, 8)), _quantized(rng, (20, 8))
    rs, ri = ref.dot_topk(jnp.asarray(q), jnp.asarray(items), 24, interpret=True)
    s, i = port.dot_topk(q, items, 24, device="cpu")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert (s[:, 20:] == port.NEG_INF).all() and (i[:, 20:] == 0).all()


@pytest.mark.parametrize("gated", ["block", "group", "none"])
def test_kernel_stages_compose(gated):
    """block_max -> block_seeds -> block_topk -> merge_topk equals the
    whole-route plain version, and every candidate list fits its buffer:
    min(k, 256) keys for each block that fires for the query that fires
    most (min(k, 4) for each group under the group gate), every block when
    ungated. 3,000 items are 12 blocks: k = 12 for the block gate, 20 for
    the others."""
    rng = np.random.default_rng(11)
    q, items = _quantized(rng, (40, 16), -2, 2, 1.0), _quantized(rng, (3000, 16), -2, 2, 1.0)
    prep = port.prepare_items(items, device="cpu")
    qp = port._pad_queries(torch.as_tensor(q), prep, 64)
    nb = prep.table.shape[0] // port.BLOCK_N
    k = nb if gated == "block" else 20
    gate = None
    if gated == "block":
        gate = port.block_seeds(port.block_max(qp, prep.table, prep.n_items), 40, k)
    elif gated == "group":
        bmax, gmax = port.block_max(qp, prep.table, prep.n_items, groups=True)
        gate = port.block_seeds(gmax, 40, k)._replace(bmax=bmax, width=port.GROUP)
    cand, count = port.block_topk(qp, prep.table, gate, 40, prep.n_items, k)
    per = min(k, port.GROUP if gated == "group" else port.BLOCK_N)
    units = nb if gate is None else int(gate.fired.max())
    assert cand.shape == (64, units * per) and int(count.max()) <= units * per
    if gate is not None:
        assert (count[:40] <= gate.fired * per).all()
    if gated == "group":  # fired groups hold far fewer items than the catalog
        assert int(count.max()) < prep.n_items // 4
    assert (count[40:] == 0).all()  # padded query rows never fire
    s, i = port.merge_topk(cand, count, 40, k)
    ps, pi = port.dot_topk_plain(torch.as_tensor(q), prep, k)
    assert torch.equal(s, ps) and torch.equal(i, pi)


@pytest.mark.parametrize("kind", ["bf16", "sq"])
def test_block_max_group_output(kind):
    """The group output of block_max (plain) is the maximum of each 4
    items of a dense score matrix, NEG_INF for groups past the catalog; its
    block output is unchanged by asking for groups."""
    rng = np.random.default_rng(13)
    n, b = 1030, 5  # 1,030 items pad to 1,280: groups 258 on are padding
    q = _quantized(rng, (b, 16), -2, 2, 1.0)
    if kind == "bf16":
        items = _quantized(rng, (n, 16), -2, 2, 1.0)
        prep = port.prepare_items(items, device="cpu")
        qp, aff = port._pad_queries(torch.as_tensor(q), prep, 32), None
        dense = q @ items.T
    else:
        codes = rng.integers(0, 256, size=(n, 16)).astype(np.uint8)
        scale = np.full(n, 2.0**-6, np.float32)
        minv = (rng.integers(-16, 17, size=n) / 8).astype(np.float32)
        prep = port.prepare_sq_items(codes, scale, minv, device="cpu")
        qp, aff = port._sq_operands(torch.as_tensor(q), prep, 32, "dot")
        dense = (q @ codes.T.astype(np.float32)) * scale + q.sum(1, keepdims=True) * minv
    n_pad = prep.table.shape[0]
    padded = np.full((b, n_pad), port.NEG_INF, np.float32)
    padded[:, :n] = dense  # exact in f32 on these inputs
    if kind == "bf16":
        bmax, gmax = port.block_max(qp, prep.table, n, groups=True)
        alone = port.block_max(qp, prep.table, n)
    else:
        bmax, gmax = port.block_max_sq(qp, prep.table, aff, n, groups=True)
        alone = port.block_max_sq(qp, prep.table, aff, n)
    assert gmax.shape == (32, n_pad // port.GROUP) and bmax.shape == (32, n_pad // port.BLOCK_N)
    np.testing.assert_array_equal(gmax.numpy()[:b], padded.reshape(b, -1, port.GROUP).max(2))
    assert (gmax[:, n_pad // port.GROUP - (n_pad - n) // port.GROUP :] == port.NEG_INF).all()
    assert torch.equal(bmax, alone)
    np.testing.assert_array_equal(bmax.numpy()[:b], padded.reshape(b, -1, port.BLOCK_N).max(2))


@pytest.mark.parametrize("kind", ["bf16", "sq"])
@pytest.mark.parametrize("k,route", [(12, "block"), (13, "group"), (769, "none")])
def test_kernel_chain_dispatch(monkeypatch, kind, k, route):
    """_kernel_chain's route at the boundaries of a 3,000-item catalog (12
    blocks, 768 groups): the block gate up to k = n_blocks, the group gate
    up to n_pad / 4, then no gate. Each stage is counted as it is called,
    and the lists equal the whole-route plain version."""
    rng = np.random.default_rng(k)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    items = rng.normal(size=(3000, 16)).astype(np.float32)
    calls = []
    for name in ("block_max", "block_max_sq", "block_seeds", "block_topk", "block_topk_sq",
                 "merge_topk"):
        def spy(*args, _fn=getattr(port, name), _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            calls.append(_name + ("+groups" if isinstance(out, tuple) and "max" in _name else ""))
            return out
        monkeypatch.setattr(port, name, spy)
    if kind == "bf16":
        prep = port.prepare_items(items, device="cpu")
        s, i = port.dot_topk(q, prep, k, device="cpu")
        ps, pi = port.dot_topk_plain(q, prep, k)
    else:
        codes = rng.integers(0, 256, size=(3000, 16)).astype(np.uint8)
        prep = port.prepare_sq_items(codes, np.full(3000, 0.01, np.float32),
                                     rng.normal(size=3000).astype(np.float32), device="cpu")
        s, i = port.sq_topk(q, prep, k_top=k, device="cpu")
        ps, pi = port.sq_topk_plain(q, prep, k)
    sfx = "" if kind == "bf16" else "_sq"
    want = {
        "block": ["block_max" + sfx, "block_seeds", "block_topk" + sfx, "merge_topk"],
        "group": ["block_max" + sfx + "+groups", "block_seeds", "block_topk" + sfx, "merge_topk"],
        "none": ["block_topk" + sfx, "merge_topk"],
    }[route]
    assert port.kernel_route(prep.table.shape[0], k) == route
    assert calls == want
    assert torch.equal(s, ps) and torch.equal(i, pi)


@pytest.mark.parametrize("k", [1, 7, 12, 13])
def test_block_seeds(k):
    """The seed is the k-th largest block maximum nudged down by
    |v| * 1.2e-7 + 1e-30 in f32 (gorse_tpu/ops/topk.py:501), NEG_INF when k
    exceeds the 12 blocks; fired counts the maxima above it. Exact."""
    rng = np.random.default_rng(12)
    bmax = _quantized(rng, (8, 12), -3, 3, 0.5)  # many ties among the maxima
    gate = port.block_seeds(torch.as_tensor(bmax), 5, k)
    if k > 12:
        want = np.full(5, port.NEG_INF, np.float32)
    else:
        v = -np.sort(-bmax[:5], axis=1)[:, k - 1]
        want = v - (np.abs(v) * np.float32(1.2e-7) + np.float32(1e-30))
    np.testing.assert_array_equal(gate.seeds.numpy(), want)
    np.testing.assert_array_equal(gate.fired.numpy(), (bmax[:5] > want[:, None]).sum(1))
    assert (gate.fired >= min(k, 12)).all()


def test_f32_route_refuses_a_bf16_table():
    """The f32 route scores from f32 factors only: a PreparedItems (bf16)
    with use_kernel=False is refused, not rounded."""
    prep = port.prepare_items(np.ones((4, 8), np.float32), device="cpu")
    with pytest.raises(TypeError):
        port.topk_excluding(np.ones((1, 8), np.float32), prep, 2, use_kernel=False, device="cpu")
