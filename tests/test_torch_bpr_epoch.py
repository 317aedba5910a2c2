"""What bpr_epoch (gorse_tpu_torch/csrc/bpr.cu) decides, modelled in numpy
on the CPU and held against the port's plain versions and gorse_tpu:

- the sampler's count-bounded rejection scan (each lane reads its user's
  first ``min(count, L)`` entries and holds each against the first MAXC
  candidates, then draws any further ones one at a time) against the
  full-row scan of ``sample_pair`` and the reference's ``_sample_pair``;
- the epoch with p carried in place from step to step against chained plain
  sweeps and folds, and through them the reference's sharded fused epoch
  (interpret mode);
- the hot-item table the epoch stages in shared memory (its size the
  kernel's ``HOT_ITEMS``), and the staged sums against the unstaged ones
  (within chip_smoke.py's ``order_bound``);
- the ``ablate`` switch's plain semantics against the reference's lines;
- the step-key tensor the kernel reads.

Samples and tables must be equal. Factors follow the tolerances of
tests/test_torch_bpr_kernel.py (rtol 2e-5 / atol 1e-7 over an epoch of
0.01-scale factors; bf16 payloads are rounded on both sides at the same
points, so bf16 is held as f32).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gorse_tpu.data.dataset import Dataset as RefDataset
from gorse_tpu.ops.bpr_kernel import _kernel_block_update, pack_items, unpack_items
from gorse_tpu.parallel import make_mesh
from gorse_tpu.parallel.sharded import (
    _per_user_uniforms,
    _sample_pair,
    make_sharded_bpr_epoch_fused,
    shard_bpr_inputs,
)
from gorse_tpu_torch.data.dataset import Dataset
from gorse_tpu_torch.ops import bpr_kernel as port
from gorse_tpu_torch.ops import sampling

LR, REG = 0.05, 0.01
_CU = (Path(port.__file__).resolve().parent.parent / "csrc" / "bpr.cu").read_text()


def _cu_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


WARPS = _cu_const("WARPS")  # warps per thread block
MAXC = _cu_const("MAXC")  # candidates each lane draws ahead of the scan


# ------------------------------------------------------------ the numpy model


def _uniforms(step, uids, n):
    return sampling.per_user_uniforms(step, torch.as_tensor(uids), n).numpy()


def model_sample(padded, counts, step, n_items, n_tries, late=None):
    """The kernel's sampler, one lane a user: the count, the draws, the
    positive row[slot] (0 when the slot lies past the row's L entries),
    then the rejection scan over the first min(count, L) entries of the row
    only, each entry held against the first MAXC candidates, the first one
    no entry equals winning; if all collide, the further candidates are
    drawn and scanned one at a time, the first free one winning (else
    candidate 0). ``late``, a list, receives the users that took the
    one-at-a-time draws. Returns (pos, neg)."""
    n_users, max_len = padded.shape
    rand = _uniforms(step, np.arange(n_users), 1 + n_tries)
    pos = np.zeros(n_users, np.int32)
    neg = np.zeros(n_users, np.int32)
    for u in range(n_users):
        count, row = int(counts[u]), padded[u]
        valid = row[: min(count, max_len)]
        slot = int(np.float32(rand[u, 0]) * np.float32(max(count, 1)))
        assert slot < max(count, 1)
        pos[u] = max(row[slot], 0) if slot < max_len else 0
        cands = (rand[u, 1:] * np.float32(n_items)).astype(np.int32)
        ahead = cands[:MAXC]
        hit = np.zeros(ahead.size, bool)
        for v in valid:
            hit |= ahead == v
        free = np.flatnonzero(~hit)
        neg[u] = ahead[free[0]] if free.size else cands[0]
        if not free.size and n_tries > MAXC:
            if late is not None:
                late.append(u)
            for c in cands[MAXC:]:  # one at a time
                if not (valid == c).any():
                    neg[u] = c
                    break
    return pos, neg


def _rows(rng, n_users, n_items, cap, widths):
    """Ragged histories padded by both packages' Dataset._pad (the same
    cap and seed): empty rows, rows at the cap, rows past 32 entries."""
    ragged = [rng.choice(n_items, size=int(w), replace=False).tolist() for w in widths]
    ref = RefDataset._pad(ragged, max_len=cap, seed=1)
    mine = Dataset._pad(ragged, max_len=cap, seed=1)
    assert np.array_equal(ref.padded, mine.padded) and np.array_equal(ref.counts, mine.counts)
    return mine.padded, mine.counts


@pytest.mark.parametrize("n_tries", [2, 4, 8])
@pytest.mark.parametrize("cap", [10, 69])
def test_count_bounded_scan_is_the_full_row_scan(n_tries, cap):
    """Rows with count 0, count = L (the cap binds) and counts on both sides
    of 32: the model's samples equal sample_pair's (which scans every entry
    of the padded row) and the reference's _sample_pair."""
    rng = np.random.default_rng(cap + n_tries)
    n_items = 120
    widths = np.concatenate([[0, 0, cap, cap + 5, 31, 32, 33, 1],
                             rng.integers(0, cap + 10, size=150)])
    padded, counts = _rows(rng, len(widths), n_items, cap, widths)
    assert (counts == 0).any() and (counts == padded.shape[1]).any()
    if cap > 33:
        assert (counts > 32).any()
    for step in sampling.raw_step_keys(sampling.prng_key(n_tries), 3):
        pos, neg = model_sample(padded, counts, step, n_items, n_tries)
        pp, pn = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                      torch.arange(len(widths)), step, n_items, n_tries)
        rp, rn = _sample_pair(jnp.asarray(padded), jnp.asarray(counts),
                              jnp.arange(len(widths), dtype=jnp.int32),
                              jnp.asarray(np.array(step, np.uint32)), n_items, n_tries)
        assert np.array_equal(pos, pp.numpy()) and np.array_equal(neg, pn.numpy())
        assert np.array_equal(pos, np.asarray(rp)) and np.array_equal(neg, np.asarray(rn))


@pytest.mark.parametrize("last", [1, 31, 32, 33, 69])
def test_scan_rejects_a_candidate_equal_to_the_last_valid_entry(last):
    """A row whose last valid entry (index count - 1, at either side of a
    32-entry boundary) is the user's first candidate: the count-bounded scan
    must reach it and move on to the next candidate, as the full scan
    does."""
    n_items, n_tries, L = 500, 4, 69
    step = sampling.raw_step_keys(sampling.prng_key(last), 1)[0]
    uids = np.arange(40)
    cands = (_uniforms(step, uids, 1 + n_tries)[:, 1:] * np.float32(n_items)).astype(np.int32)
    rng = np.random.default_rng(last)
    padded = np.full((40, L), -1, np.int32)
    counts = np.full(40, last, np.int32)
    for u in uids:
        others = np.setdiff1d(np.arange(n_items), cands[u])
        padded[u, :last] = rng.choice(others, size=last, replace=False)
        padded[u, last - 1] = cands[u, 0]
    pos, neg = model_sample(padded, counts, step, n_items, n_tries)
    pp, pn = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                  torch.as_tensor(uids), step, n_items, n_tries)
    assert np.array_equal(pos, pp.numpy()) and np.array_equal(neg, pn.numpy())
    want = [next(c for c in cands[u, 1:] if c != cands[u, 0]) for u in uids]
    assert (neg != cands[:, 0]).all() and np.array_equal(neg, want)


def test_counts_past_the_row_read_the_row():
    """Counts above L (not built by Dataset._pad, but taken by the
    wrappers): the kernel reads the row's L entries only, and a slot past
    them gives positive 0, as sample_pair and the reference's _sample_pair
    do."""
    rng = np.random.default_rng(21)
    n_users, n_items, L = 200, 60, 8
    padded = np.stack([rng.choice(n_items, size=L, replace=False) for _ in range(n_users)])
    padded = padded.astype(np.int32)
    counts = rng.integers(L + 1, 3 * L, size=n_users).astype(np.int32)
    for step in sampling.raw_step_keys(sampling.prng_key(21), 3):
        pos, neg = model_sample(padded, counts, step, n_items, 4)
        rand = _uniforms(step, np.arange(n_users), 1)[:, 0]
        past = (np.float32(rand) * counts.astype(np.float32)).astype(np.int64) >= L
        assert past.any() and (pos[past] == 0).all()
        pp, pn = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                      torch.arange(n_users), step, n_items, 4)
        rp, rn = _sample_pair(jnp.asarray(padded), jnp.asarray(counts),
                              jnp.arange(n_users, dtype=jnp.int32),
                              jnp.asarray(np.array(step, np.uint32)), n_items, 4)
        assert np.array_equal(pos, pp.numpy()) and np.array_equal(neg, pn.numpy())
        assert np.array_equal(pos, np.asarray(rp)) and np.array_equal(neg, np.asarray(rn))


@pytest.mark.parametrize("n_tries", [MAXC + 1, 12, port.MAX_TRIES])
def test_draws_past_the_first_candidates(n_tries):
    """Rows holding most of a 16-item catalog (some every item), so the
    first MAXC candidates often all collide: the model's one-at-a-time
    draws, reached by many users, some freed and some not, equal
    sample_pair's choice among all n_tries candidates."""
    rng = np.random.default_rng(n_tries)
    n_users, n_items = 400, 16
    counts = rng.integers(10, n_items + 1, size=n_users).astype(np.int32)
    padded = np.full((n_users, n_items), -1, np.int32)
    for u in range(n_users):
        padded[u, : counts[u]] = rng.permutation(n_items)[: counts[u]]
    step = sampling.raw_step_keys(sampling.prng_key(n_tries), 1)[0]
    late = []
    pos, neg = model_sample(padded, counts, step, n_items, n_tries, late)
    cands = (_uniforms(step, np.arange(n_users), 1 + n_tries)[:, 1:]
             * np.float32(n_items)).astype(np.int32)
    freed = [u for u in late if neg[u] != cands[u, 0]]  # cands[u, 0] lies in the row
    assert len(late) > 20 and 0 < len(freed) < len(late)
    pp, pn = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                  torch.arange(n_users), step, n_items, n_tries)
    assert np.array_equal(pos, pp.numpy()) and np.array_equal(neg, pn.numpy())


def test_chip_smoke_names_the_kernels_draws_ahead():
    """chip_smoke's dense case counts draws past the kernel's MAXC."""
    assert chip_smoke.SAMPLE_AHEAD == MAXC < chip_smoke.DENSE_TRIES <= port.MAX_TRIES


# -------------------------------------------------------------- the epoch


def _epoch_inputs(k=16):
    """The setup of test_epoch_matches_sharded_fused_epoch."""
    n_users, n_items = 96, 64
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 12, size=n_users).astype(np.int32)
    padded = np.full((n_users, 16), -1, dtype=np.int32)
    for u in range(n_users):
        padded[u, : counts[u]] = rng.choice(n_items, size=counts[u], replace=False)
    p0 = rng.normal(scale=0.01, size=(n_users, k)).astype(np.float32)
    q0 = rng.normal(scale=0.01, size=(n_items, k)).astype(np.float32)
    return p0, q0, padded, counts, n_items


@pytest.mark.parametrize("n_steps", [1, 7])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_epoch_is_chained_sweeps_and_the_sharded_epoch(n_steps, mm):
    """bpr_epoch_fused (p carried in place from step to step, one launch on
    the card) equals the chained plain sweeps and folds exactly, and the
    reference's sharded fused epoch on a 4-device mesh to rounding."""
    p0, q0, padded, counts, n_items = _epoch_inputs()
    dt = getattr(torch, mm)
    keys = sampling.raw_step_keys(sampling.prng_key(7), n_steps)
    q = torch.as_tensor(q0).clone()
    p_new, q_new, cost = port.bpr_epoch_fused(torch.as_tensor(p0), q, torch.as_tensor(padded),
                                              torch.as_tensor(counts), keys, n_items, LR, REG,
                                              mm_dtype=dt)
    assert q_new is q

    p_c, q_c = torch.as_tensor(p0), torch.as_tensor(q0).clone()
    delta, cost_c = torch.zeros_like(q_c), torch.zeros(1)
    for step in keys:
        p_c, _, _ = port.bpr_sweep_sampled(p_c, q_c, delta, cost_c, torch.as_tensor(padded),
                                           torch.as_tensor(counts), step, n_items, LR, REG,
                                           mm_dtype=dt)
        port.bpr_fold_plain(q_c, delta)
    assert torch.equal(p_new, p_c) and torch.equal(q_new, q_c)
    assert float(cost) == float(cost_c[0])

    mesh = make_mesh(4)
    p, _, pp, pc, uids, _ = shard_bpr_inputs(mesh, p0, q0, padded, counts)
    qp = jax.device_put(pack_items(jnp.asarray(q0)),
                        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    epoch = make_sharded_bpr_epoch_fused(mesh, n_steps=n_steps, n_items=n_items, lr=LR, reg=REG,
                                         interpret=True, mm_dtype=getattr(jnp, mm))
    r_p, r_qp, r_cost = epoch(p, qp, pp, pc, uids, jax.random.PRNGKey(7))
    np.testing.assert_allclose(p_new.numpy(), np.asarray(r_p), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(unpack_items(r_qp, n_items, 16)),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(cost), float(r_cost[0]), rtol=1e-5)


def test_epoch_pairs_are_each_steps_samples():
    """bpr_epoch's ``pairs`` output holds every step's (pos, neg), the
    sampler's, and the epoch leaves delta zero."""
    p0, q0, padded, counts, n_items = _epoch_inputs()
    keys = sampling.raw_step_keys(sampling.prng_key(2), 3)
    pairs = torch.full((2, 3, p0.shape[0]), -7, dtype=torch.int32)
    delta = torch.zeros(q0.shape)
    port.bpr_epoch(torch.as_tensor(p0), torch.as_tensor(q0).clone(), delta, torch.zeros(1),
                   torch.as_tensor(padded), torch.as_tensor(counts), keys, n_items, LR, REG,
                   pairs=pairs)
    for s, step in enumerate(keys):
        pos, neg = model_sample(padded, counts, step, n_items, 4)
        assert np.array_equal(pairs[0, s].numpy(), pos)
        assert np.array_equal(pairs[1, s].numpy(), neg)
    assert not delta.any()


# ------------------------------------------------------- the staged head


def model_hot_table(padded, n_rows, h):
    occ = np.bincount(padded[padded >= 0], minlength=n_rows)[:n_rows]
    order = sorted(range(n_rows), key=lambda i: (-occ[i], i))[:h]
    slot = np.full(n_rows, -1, np.int16)
    slot[order] = np.arange(len(order))
    return slot, np.asarray(order, np.int32)


@pytest.mark.parametrize("h", [1, 5, 64, 500])
def test_hot_table_is_the_most_frequent_items(h):
    """Top h by occurrence in the padded rows, ties to the lower index, -1
    elsewhere; h beyond the catalog takes every item."""
    rng = np.random.default_rng(h)
    n_items = 90
    zipf = np.minimum(rng.zipf(1.3, size=4000) - 1, n_items - 1)
    padded = np.full((200, 30), -1, np.int32)
    padded.ravel()[: zipf.size] = zipf
    padded[:, 0] = 7  # ties: several items with equal counts below
    padded[:5, 1] = [40, 41, 42, 43, 44]
    slot, items = port.hot_table(torch.as_tensor(padded), n_items, h)
    want_slot, want_items = model_hot_table(padded, n_items, h)
    assert slot.dtype == torch.int16 and items.dtype == torch.int32
    assert np.array_equal(items.numpy(), want_items)
    assert np.array_equal(slot.numpy(), want_slot)
    assert items.numel() == min(h, n_items)
    assert int(items[0]) == int(np.bincount(padded[padded >= 0]).argmax())


def test_hot_items_is_the_kernels_stage():
    """The head the wrappers build is the one the kernel stages: its
    HOT_ITEMS rows, every one of them at k = 64 (16 KB of shared memory)."""
    assert port.HOT_ITEMS == _cu_const("HOT_ITEMS")
    assert re.search(r"constexpr int STAGE_FLOATS = HOT_ITEMS \* 64;", _CU)


def test_staged_sums_are_within_the_order_bound():
    """The kernel's staging, modelled: each block sums its users' payloads
    for the hot items in f32, then adds its partial row into delta; every
    other payload goes to delta directly. Against the plain sweep's
    index_add (user order): within chip_smoke.order_bound, the most two
    summation orders of a row's adds can differ."""
    rng = np.random.default_rng(4)
    n_users, n_items, k, grid, h = 600, 50, 16, 3, 8
    counts = rng.integers(1, 10, size=n_users).astype(np.int32)
    padded = np.full((n_users, 10), -1, np.int32)
    for u in range(n_users):
        pool = rng.zipf(1.5, size=40) % n_items
        padded[u, : counts[u]] = np.unique(pool)[: counts[u]]
        counts[u] = int((padded[u] >= 0).sum())
    p = torch.as_tensor(rng.normal(size=(n_users, k)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(n_items, k)).astype(np.float32))
    step = sampling.raw_step_keys(sampling.prng_key(4), 1)[0]
    pos, neg = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                    torch.arange(n_users), step, n_items, 4)
    active = torch.ones(n_users, dtype=torch.bool)
    delta, cost = torch.zeros_like(q), torch.zeros(1)
    port.bpr_sweep_pairs_plain(p, q, delta, cost, pos, neg, active, LR, REG)

    qi, qj = q[pos.long()], q[neg.long()]
    grad = torch.sigmoid(-((p * qi).sum(1) - (p * qj).sum(1)))[:, None]
    d_pos = (LR * (grad * p - REG * qi)).numpy()
    d_neg = (LR * (-grad * p - REG * qj)).numpy()
    slot, _ = model_hot_table(padded, n_items, h)
    per_warp = -(-n_users // (grid * WARPS))  # each warp's contiguous users
    stage = np.zeros((grid, h, k), np.float32)
    staged = np.zeros((n_items, k), np.float32)
    for u in range(n_users):
        block = (u // per_warp) // WARPS
        for item, d in ((int(pos[u]), d_pos[u]), (int(neg[u]), d_neg[u])):
            if slot[item] >= 0:
                stage[block, slot[item]] += d
            else:
                staged[item] += d
    for block in range(grid):
        for item in np.flatnonzero(slot >= 0):
            staged[item] += stage[block, slot[item]]
    hot_adds = np.isin(pos.numpy(), np.flatnonzero(slot >= 0)).sum()
    assert hot_adds > n_users // 4  # the head takes a good share of the adds
    bound = chip_smoke.order_bound(p, q, pos, neg, active.to(torch.int32), torch.float32)
    err = np.abs(staged - delta.numpy())
    assert (err <= bound.numpy() + 1e-12).all()
    assert err.max() > 0  # the orders differ: the bound is what holds them


# --------------------------------------------------------------- ablate


def test_ablate_scatter_dim0_raises():
    p0, q0, padded, counts, n_items = _epoch_inputs()
    with pytest.raises(ValueError, match="transposed"):
        port.bpr_epoch_fused(torch.as_tensor(p0), torch.as_tensor(q0), torch.as_tensor(padded),
                             torch.as_tensor(counts), [(0, 1)], n_items, LR, REG,
                             ablate="scatter_dim0")
    with pytest.raises(ValueError, match="ablate"):
        port.bpr_epoch_fused(torch.as_tensor(p0), torch.as_tensor(q0), torch.as_tensor(padded),
                             torch.as_tensor(counts), [(0, 1)], n_items, LR, REG,
                             ablate="nothing")


@pytest.mark.parametrize("ablate", ["nosample", "samp_nopos", "samp_norej"])
def test_ablated_samples_follow_the_reference_lines(ablate):
    """gorse_tpu/ops/bpr_kernel.py:83-93 and 361-363 on the counter
    sampler's uniforms: nosample pos = max(row[0], 0), neg = (pos + 37) %
    n_items; samp_nopos that pos with the rejected neg; samp_norej the
    sampled pos with the first candidate."""
    p0, q0, padded, counts, n_items = _epoch_inputs()
    step = sampling.raw_step_keys(sampling.prng_key(5), 1)[0]
    pos, neg = port.sample_pair_ablated(torch.as_tensor(padded), torch.as_tensor(counts), step,
                                        n_items, 4, ablate)
    pp = jnp.asarray(padded)
    uids = jnp.arange(padded.shape[0], dtype=jnp.int32)
    kd = jnp.asarray(np.array(step, np.uint32))
    r_pos, r_neg = _sample_pair(pp, jnp.asarray(counts), uids, kd, n_items, 4)
    first = jnp.maximum(pp[:, 0:1], 0)[:, 0]
    if ablate == "nosample":
        r_pos, r_neg = first, (first + 37) % jnp.int32(n_items)
    elif ablate == "samp_nopos":
        r_pos = first
    else:
        u01 = _per_user_uniforms(kd, uids, 1 + 4)
        r_neg = (u01[:, 1:] * jnp.float32(n_items)).astype(jnp.int32)[:, 0]
    assert np.array_equal(pos.numpy(), np.asarray(r_pos))
    assert np.array_equal(neg.numpy(), np.asarray(r_neg))


@pytest.mark.parametrize("ablate", ["", "nogather", "noscatter"])
def test_ablated_update_follows_the_reference_block(ablate):
    """One step of the plain epoch under ablate against the reference's
    _kernel_block_update (transposed scatter, as the epoch kernel runs it)
    at k = 128, where its packed row 0 is item 0: nogather reads q row 0
    for both items, noscatter adds nothing into q."""
    k = 128
    p0, q0, padded, counts, n_items = _epoch_inputs(k=k)
    step = sampling.raw_step_keys(sampling.prng_key(6), 1)
    q = torch.as_tensor(q0).clone()
    p_new, q_new, cost = port.bpr_epoch_fused(torch.as_tensor(p0), q, torch.as_tensor(padded),
                                              torch.as_tensor(counts), step, n_items, LR, REG,
                                              mm_dtype=torch.float32, ablate=ablate)
    pos, neg = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                    torch.arange(p0.shape[0]), step[0], n_items, 4)
    rows = q0.shape[0]
    r_p, r_qd, r_cost = _kernel_block_update(
        jnp.asarray(pos.numpy())[:, None], jnp.asarray(neg.numpy())[:, None],
        jnp.asarray((counts > 0).astype(np.float32))[:, None], jnp.asarray(p0),
        pack_items(jnp.asarray(q0)), jnp.zeros((rows, 128), jnp.float32), jnp.float32(0.0),
        k=k, lr=LR, reg=REG, block_u=p0.shape[0], rows_pad=rows, mm_dtype=jnp.float32,
        transposed_scatter=True, ablate=ablate,
    )
    np.testing.assert_allclose(p_new.numpy(), np.asarray(r_p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((q_new - torch.as_tensor(q0)).numpy(),
                               np.asarray(unpack_items(r_qd, n_items, k)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(cost), float(r_cost), rtol=1e-5)
    if ablate == "noscatter":
        assert torch.equal(q_new, torch.as_tensor(q0))


# ------------------------------------------------------------- step keys


def test_step_key_tensor_layout():
    """[n_steps, 2] int32, row s the two words of step s, each the int32 of
    the same 32 bits (words from 2^31 up read negative)."""
    keys = sampling.raw_step_keys(sampling.prng_key(11), 9) + [(2**32 - 1, 2**31), (0, 2**31 - 1)]
    t = port.step_key_tensor(keys, "cpu")
    assert t.dtype == torch.int32 and t.shape == (len(keys), 2) and t.is_contiguous()
    assert np.array_equal(t.numpy().view(np.uint32), np.array(keys, dtype=np.uint32))
    assert t[-2].tolist() == [-1, -(2**31)] and t[-1].tolist() == [0, 2**31 - 1]
    assert port.step_key_tensor([], "cpu").shape == (0, 2)
