"""The port's BPR samplers and sweep (gorse_tpu_torch.ops.sampling and
.bpr_kernel, plain versions on the CPU) held against gorse_tpu: the key
stream, the counter sampler of gorse_tpu/parallel/sharded.py (the sharded
epochs' draw), the one-device sampler of gorse_tpu/models/bpr.py (K1's and
K2's draw), the fused Pallas step (interpret mode), the reference's
one-device XLA epoch, and the XLA pair rule.

Keys and samples must be bit-equal. The sweeps sum in the reference
kernels' order but not its exact association (the Pallas kernel sums 128
packed lanes, the port k factors; the XLA epoch sums ``sum(p * (qi -
qj))``), so factors and deltas are held to rtol 1e-5 / atol 1e-6 for N(0,
1) factors and 2e-5 / 1e-7 over an epoch of 0.01-scale factors, as
tests/test_sharded.py holds the two reference epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.data.dataset import Dataset as RefDataset
from gorse_tpu.models.bpr import _bpr_epoch as ref_bpr_epoch
from gorse_tpu.models.bpr import _sample_pairs as ref_sample_pairs
from gorse_tpu.models.bpr import bpr_apply_pairs as ref_apply_pairs
from gorse_tpu.ops.bpr_kernel import bpr_fused_step as ref_fused_step
from gorse_tpu.ops.bpr_kernel import pack_items, unpack_items
from gorse_tpu.parallel.sharded import (
    _raw_step_keys,
    _sample_pair,
    _threefry2x32,
)
from gorse_tpu_torch.data.dataset import Dataset
from gorse_tpu_torch.models.bpr import bpr_apply_pairs
from gorse_tpu_torch.ops import bpr_kernel as port
from gorse_tpu_torch.ops import sampling

LR, REG = 0.05, 0.01


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 2, 5, 33])
def test_key_stream_is_jax_random(seed, n):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(sampling.prng_key(seed).numpy(), np.asarray(key))
    assert np.array_equal(sampling.split(sampling.prng_key(seed), n).numpy(),
                          np.asarray(jax.random.split(key, n)))
    assert sampling.raw_step_keys(sampling.prng_key(seed), n) == [
        tuple(int(w) for w in row) for row in np.asarray(_raw_step_keys(key, n))
    ]
    # the fit's epoch keys: key, epoch_key = split(key), repeatedly
    k_ref, k_port = key, sampling.prng_key(seed)
    for _ in range(3):
        k_ref, e_ref = jax.random.split(k_ref)
        k_port, e_port = sampling.split(k_port)
        assert np.array_equal(e_port.numpy(), np.asarray(e_ref))


def test_threefry_is_the_reference_block():
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, 2**32, size=257, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2**32, size=257, dtype=np.uint64).astype(np.uint32)
    for k0, k1 in [(0, 0), (0, 42), (2**32 - 1, 123456789)]:
        r0, r1 = _threefry2x32(np.uint32(k0), np.uint32(k1), jnp.asarray(x0), jnp.asarray(x1))
        p0, p1 = sampling.threefry2x32(k0, k1, torch.as_tensor(x0.astype(np.int64)),
                                       torch.as_tensor(x1.astype(np.int64)))
        assert np.array_equal(p0.numpy(), np.asarray(r0).astype(np.int64))
        assert np.array_equal(p1.numpy(), np.asarray(r1).astype(np.int64))


def _capped_rows(rng, n_users=120, n_items=90, cap=10):
    """Ragged histories (some empty, some wider than the cap) padded by
    both packages' Dataset._pad with the same seed."""
    ragged = []
    for u in range(n_users):
        n = 0 if u % 9 == 0 else int(rng.integers(1, 25))
        ragged.append(rng.choice(n_items, size=n, replace=False).tolist())
    ref = RefDataset._pad(ragged, max_len=cap, seed=3)
    mine = Dataset._pad(ragged, max_len=cap, seed=3)
    assert np.array_equal(ref.padded, mine.padded) and np.array_equal(ref.counts, mine.counts)
    assert (mine.counts == 0).any() and (mine.counts == cap).sum() > 10
    return mine.padded, mine.counts, n_items


@pytest.mark.parametrize("n_tries", [2, 3, 4, 8])
def test_sample_pair_is_bit_equal(n_tries):
    """Count-0 users, capped rows and every rejection depth the fit uses."""
    padded, counts, n_items = _capped_rows(np.random.default_rng(n_tries))
    uids = np.arange(padded.shape[0], dtype=np.int32) + 1000  # global ids
    for step in sampling.raw_step_keys(sampling.prng_key(n_tries), 3):
        rp, rn = _sample_pair(jnp.asarray(padded), jnp.asarray(counts), jnp.asarray(uids),
                              jnp.asarray(np.array(step, np.uint32)), n_items, n_tries)
        pp, pn = sampling.sample_pair(torch.as_tensor(padded), torch.as_tensor(counts),
                                      torch.as_tensor(uids), step, n_items, n_tries)
        assert np.array_equal(pp.numpy(), np.asarray(rp))
        assert np.array_equal(pn.numpy(), np.asarray(rn))


@pytest.mark.parametrize("k", [8, 16, 64])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_pairs_sweep_matches_fused_step(k, mm):
    """K3 against bpr_fused_step(interpret=True); items repeat within the
    sweep and a tenth of the users are inactive."""
    rng = np.random.default_rng(k)
    n_users, n_items = 150, 70
    p = rng.normal(size=(n_users, k)).astype(np.float32)
    q = rng.normal(size=(n_items, k)).astype(np.float32)
    pos = rng.integers(0, n_items, size=n_users).astype(np.int32)
    neg = rng.integers(0, n_items, size=n_users).astype(np.int32)
    active = rng.uniform(size=n_users) > 0.1
    r_p, r_qd, r_cost = ref_fused_step(
        jnp.asarray(p), pack_items(jnp.asarray(q)), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(active), LR, REG, block_u=64, interpret=True, mm_dtype=getattr(jnp, mm),
    )
    p_new, q_delta, cost = port.bpr_fused_step(
        torch.as_tensor(p), torch.as_tensor(q), torch.as_tensor(pos), torch.as_tensor(neg),
        torch.as_tensor(active), LR, REG, mm_dtype=getattr(torch, mm),
    )
    np.testing.assert_allclose(p_new.numpy(), np.asarray(r_p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q_delta.numpy(), np.asarray(unpack_items(r_qd, n_items, k)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(cost), float(r_cost), rtol=1e-5)


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_sampled_sweep_is_pairs_sweep_on_its_samples(mm):
    """K2 = the one-device sampler + K3: the sampled step returns the
    sampler's pairs (the reference's ``_sample_pairs``) and the pairs
    step's result on them."""
    padded, counts, n_items = _capped_rows(np.random.default_rng(5))
    rng = np.random.default_rng(6)
    p = torch.as_tensor(rng.normal(size=(padded.shape[0], 16)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(n_items, 16)).astype(np.float32))
    step = sampling.raw_step_keys(sampling.prng_key(9), 1)[0]
    r_pos, r_neg = ref_sample_pairs(jnp.asarray(padded), jnp.asarray(counts), n_items,
                                    jnp.asarray(np.array(step, np.uint32)), 3)
    padded, counts = torch.as_tensor(padded), torch.as_tensor(counts)
    dt = getattr(torch, mm)
    p_s, qd_s, c_s, pos, neg = port.bpr_fully_fused_step(p, q, padded, counts, step, n_items,
                                                         LR, REG, mm_dtype=dt, n_tries=3)
    want_pos, want_neg = sampling._sample_pairs(padded, counts, n_items, step, 3)
    assert torch.equal(pos, want_pos) and torch.equal(neg, want_neg)
    assert np.array_equal(pos.numpy(), np.asarray(r_pos))
    assert np.array_equal(neg.numpy(), np.asarray(r_neg))
    p_p, qd_p, c_p = port.bpr_fused_step(p, q, pos, neg, counts > 0, LR, REG, mm_dtype=dt)
    assert torch.equal(p_s, p_p) and torch.equal(qd_s, qd_p) and float(c_s) == float(c_p)
    # inactive users keep their factors and add nothing
    idle = counts == 0
    assert torch.equal(p_s[idle], p[idle])


def test_epoch_matches_sharded_fused_epoch():
    """Five sampled sweeps + folds against the reference's one-device XLA
    epoch (``_bpr_epoch``) from the same key: the same samples (its
    ``_sample_pairs``), the same update, item sums in another order."""
    n_users, n_items, k = 96, 64, 16
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 12, size=n_users).astype(np.int32)
    padded = np.full((n_users, 16), -1, dtype=np.int32)
    for u in range(n_users):
        padded[u, : counts[u]] = rng.choice(n_items, size=counts[u], replace=False)
    p0 = rng.normal(scale=0.01, size=(n_users, k)).astype(np.float32)
    q0 = rng.normal(scale=0.01, size=(n_items, k)).astype(np.float32)
    r_p, r_q, r_cost = ref_bpr_epoch(jnp.array(p0), jnp.array(q0), jnp.asarray(padded),
                                     jnp.asarray(counts), jax.random.PRNGKey(7), n_steps=5,
                                     n_items=n_items, lr=LR, reg=REG)

    q = torch.as_tensor(q0).clone()
    p_new, q_new, cost = port.bpr_epoch_fused(
        torch.as_tensor(p0), q, torch.as_tensor(padded), torch.as_tensor(counts),
        sampling.raw_step_keys(sampling.prng_key(7), 5), n_items, LR, REG,
        mm_dtype=torch.float32,
    )
    assert q_new is q  # the epoch updates q in place
    np.testing.assert_allclose(p_new.numpy(), np.asarray(r_p), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(r_q), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(cost), float(r_cost), rtol=1e-5)


def test_fold_adds_and_clears():
    """bpr_epoch's fold phase: q += delta, delta = 0, q in place; after a
    one-step epoch q is q plus that step's sweep deltas and delta is zero."""
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(9, 8)).astype(np.float32))
    delta = torch.as_tensor(rng.normal(size=(9, 8)).astype(np.float32))
    want = q + delta
    assert port.bpr_fold_plain(q, delta) is q
    assert torch.equal(q, want) and not delta.any()

    padded, counts, n_items = _capped_rows(np.random.default_rng(4))
    p = torch.as_tensor(rng.normal(size=(padded.shape[0], 8)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(n_items, 8)).astype(np.float32))
    padded, counts = torch.as_tensor(padded), torch.as_tensor(counts)
    step = sampling.raw_step_keys(sampling.prng_key(2), 1)
    _, qd, _, _, _ = port.bpr_fully_fused_step(p, q, padded, counts, step[0], n_items, LR, REG,
                                               mm_dtype=torch.float32, n_tries=3)
    q0 = q.clone()
    delta, cost = torch.zeros_like(q), torch.zeros(1)
    port.bpr_epoch(p, q, delta, cost, padded, counts, step, n_items, LR, REG, n_tries=3)
    assert torch.equal(q, q0 + qd) and not delta.any()


def test_apply_pairs_matches_the_xla_rule():
    """bpr_apply_pairs (sum(p * (qi - qj)) order) against the reference's."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(50, 8)).astype(np.float32)
    q = rng.normal(size=(20, 8)).astype(np.float32)
    pos = rng.integers(0, 20, size=50).astype(np.int32)
    neg = rng.integers(0, 20, size=50).astype(np.int32)
    active = (rng.uniform(size=(50, 1)) > 0.2)
    r_p, r_q, r_cost = ref_apply_pairs(jnp.asarray(p), jnp.asarray(q), jnp.asarray(pos),
                                       jnp.asarray(neg), jnp.asarray(active), LR, REG)
    p_new, q_new, cost = bpr_apply_pairs(torch.as_tensor(p), torch.as_tensor(q),
                                         torch.as_tensor(pos), torch.as_tensor(neg),
                                         torch.as_tensor(active), LR, REG)
    np.testing.assert_allclose(p_new.numpy(), np.asarray(r_p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(r_q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(cost), float(r_cost), rtol=1e-5)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here,
    with no card, the kernel's checks refuse it before any build."""
    meta = {"device": "meta"}
    p, q = torch.zeros((3, 8), **meta), torch.zeros((5, 8), **meta)
    i32 = torch.zeros(3, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        port.bpr_sweep_pairs(p, q, torch.zeros_like(q), torch.zeros(1, **meta), i32, i32, i32,
                             LR, REG)
    with pytest.raises(ValueError, match="CUDA"):
        port.bpr_sweep_sampled(p, q, torch.zeros_like(q), torch.zeros(1, **meta),
                               torch.zeros((3, 4), dtype=torch.int32, **meta), i32, (0, 1), 5,
                               LR, REG)
    with pytest.raises(ValueError, match="CUDA"):
        port.bpr_epoch(p, q, torch.zeros_like(q), torch.zeros(1, **meta),
                       torch.zeros((3, 4), dtype=torch.int32, **meta), i32, [(0, 1)], 5, LR, REG)
