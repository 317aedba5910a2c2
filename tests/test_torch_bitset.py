"""Full-set negative rejection in the port's single-card BPR fit, held
against gorse_tpu on the CPU.

The reference rejects a candidate negative against the user's whole
positive set (``Dataset.positives_bitset``) in its one-device epoch when
the history cap binds and the bitset takes at most 64 MiB
(gorse_tpu/models/bpr.py:66-113, :398-409). The port's fit on one card
draws that epoch's sampler, so its pairs with bits are held against the
reference's own ``_sample_pairs(..., bits)``, its epochs against the
reference's ``_bpr_epoch(..., bits=...)`` and its fit against the
reference's ``BPR.fit`` with the cap binding.

Samples and bitsets must be equal. Factors: the epoch at the tolerances of
tests/test_torch_bpr_epoch.py (rtol 2e-5 / atol 1e-7 over 0.01-scale
factors, the cost rtol 1e-5); the fit at those of tests/test_torch_bpr.py
(rtol 1e-4 / atol 1e-6, from the seed). The reference sums ``sum(p * (qi -
qj))`` where the port sums ``sum(p*qi) - sum(p*qj)``: the two differ in
rounding only.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.data import load_built_in as ref_load_built_in
from gorse_tpu.data.dataset import Dataset as RefDataset
from gorse_tpu.data.loaders import synthetic_cf_access as ref_synthetic_cf_access
from gorse_tpu.models import BPR as RefBPR
from gorse_tpu.models import FitConfig as RefFitConfig
from gorse_tpu.models import Params as RefParams
from gorse_tpu.models import bpr as ref_bpr
from gorse_tpu.models.bpr import _bpr_epoch as ref_bpr_epoch
from gorse_tpu.models.bpr import _sample_pairs as ref_sample_pairs
from gorse_tpu.models.bpr import bpr_apply_pairs as ref_bpr_apply_pairs
from gorse_tpu_torch.data.dataset import Dataset
from gorse_tpu_torch.data.loaders import load_built_in, synthetic_cf_access
from gorse_tpu_torch.models import BPR, FitConfig, Params
from gorse_tpu_torch.models import bpr as port_bpr
from gorse_tpu_torch.ops import bpr_kernel as port
from gorse_tpu_torch.ops import sampling
from gorse_tpu_torch.parallel.mesh import make_mesh

LR, REG = 0.05, 0.01
SPEC = "synthetic://400,300,8,0.08,1"
FIT_CAP = 12  # narrower than SPEC's widest training history


def _bits_t(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int32))


def _both(ragged: list[list[int]], n_items: int):
    """The same ragged histories in both packages' Dataset."""
    users = np.repeat(np.arange(len(ragged)), [len(r) for r in ragged])
    items = np.concatenate([np.asarray(r, np.int64) for r in ragged] + [np.zeros(0, np.int64)])
    ids_u, ids_i = [str(u) for u in range(len(ragged))], [str(i) for i in range(n_items)]
    return (Dataset.from_edges(users, items, user_ids=ids_u, item_ids=ids_i),
            RefDataset.from_edges(users, items, user_ids=ids_u, item_ids=ids_i))


def _capped_corpus(seed=2):
    """Heavy-tailed histories over a small catalog whose widest rows are
    far past the cap, in both packages."""
    mine = synthetic_cf_access(300, 200, nnz=6000, seed=seed)
    ref = ref_synthetic_cf_access(300, 200, nnz=6000, seed=seed)
    assert mine.user_feedback == ref.user_feedback
    return mine, ref


def _key(step) -> jax.Array:
    return jnp.asarray(np.asarray(step, np.uint32))


def _ref_pairs(capped, bits, step, n_items, n_tries):
    """The reference's one-device sampler: the positive from the capped
    rows, the negative rejected against ``bits`` (uint32, or None: the
    capped rows)."""
    pos, neg = ref_sample_pairs(jnp.asarray(capped.padded), jnp.asarray(capped.counts), n_items,
                                _key(step), n_tries, None if bits is None else jnp.asarray(bits))
    return np.asarray(pos), np.asarray(neg)


# ---------------------------------------------------------------- the bitset


@pytest.mark.parametrize("case", ["edges", "multiple_of_32", "synthetic"])
def test_bitset_is_the_reference(case):
    """Bit-equal to the reference's row-by-row build: empty users, items 31,
    32 and I - 1, I not a multiple of 32, repeated items in a row."""
    if case == "synthetic":
        mine, ref = _capped_corpus(seed=4)
        n_items = mine.count_items()
    else:
        n_items = 70 if case == "edges" else 96
        rng = np.random.default_rng(n_items)
        ragged = [[], [31, 32, n_items - 1], [0], [], [n_items - 1, 31, 31],
                  list(range(n_items)), []]
        ragged += [rng.choice(n_items, size=int(w), replace=False).tolist()
                   for w in rng.integers(0, 20, size=40)]
        mine, ref = _both(ragged, n_items)
    got, want = mine.positives_bitset(), ref.positives_bitset()
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape == (mine.count_users(), -(-n_items // 32))
    assert np.array_equal(got, want)
    if case == "edges":
        assert got[1, 0] == 1 << 31 and got[1, 1] == 1 and got[1, 2] == 1 << ((n_items - 1) % 32)
        assert not got[0].any() and not got[3].any() and not got[6].any()
    # the device copy: int32 with the same bits, read as (word >> (c & 31)) & 1
    bits_t = _bits_t(got)
    for u, fb in enumerate(mine.user_feedback[:10]):
        c = torch.arange(n_items)
        member = ((bits_t[u, c >> 5] >> (c & 31)) & 1).bool()
        assert set(torch.nonzero(member)[:, 0].tolist()) == set(fb)


# --------------------------------------------------------------- the sampler


@pytest.mark.parametrize("n_tries", [2, 4, 12])
@pytest.mark.parametrize("cap", [5, 20])
def test_sampler_with_bits_is_the_composed_reference(n_tries, cap):
    """For every user and every step key: the pairs with bits equal the
    reference's ``_sample_pairs`` with its bitset, and, for set membership,
    its pairs on the uncapped rows' negatives (rejecting against the full
    bitset is rejecting against the uncapped row)."""
    mine, ref = _capped_corpus()
    widest = max(len(fb) for fb in mine.user_feedback)
    assert cap < widest
    n_items = mine.count_items()
    capped = mine.padded_user_positives(max_len=cap, seed=3)
    full = ref.padded_user_positives(max_len=widest, seed=3)
    assert np.array_equal(capped.padded, ref.padded_user_positives(max_len=cap, seed=3).padded)
    assert (full.counts > cap).sum() > 10  # users the cap cuts
    bits = mine.positives_bitset()
    steps = [tuple(int(w) for w in kd)
             for kd in np.asarray(jax.random.split(jax.random.PRNGKey(n_tries + cap), 4))]
    padded, counts = torch.as_tensor(capped.padded), torch.as_tensor(capped.counts)
    pos, neg = sampling.sample_epoch_pairs(padded, counts, n_items, steps, n_tries, _bits_t(bits))
    for s, step in enumerate(steps):
        r_pos, r_neg = _ref_pairs(capped, ref.positives_bitset(), step, n_items, n_tries)
        assert np.array_equal(pos[s].numpy(), r_pos)
        assert np.array_equal(neg[s].numpy(), r_neg)
        _, full_neg = ref_sample_pairs(jnp.asarray(full.padded), jnp.asarray(full.counts),
                                       n_items, _key(step), n_tries)
        assert np.array_equal(r_neg, np.asarray(full_neg))
        one_pos, one_neg = sampling._sample_pairs(padded, counts, n_items, step, n_tries,
                                                  _bits_t(bits))
        assert torch.equal(one_pos, pos[s]) and torch.equal(one_neg, neg[s])


def test_bits_on_an_uncapped_corpus_change_nothing():
    """Where no row is cut, the bitset holds the rows' items: the pairs are
    those of the row test."""
    mine, _ = _capped_corpus(seed=5)
    widest = max(len(fb) for fb in mine.user_feedback)
    full = mine.padded_user_positives(max_len=widest, seed=0)
    args = (torch.as_tensor(full.padded), torch.as_tensor(full.counts), mine.count_items(),
            sampling.raw_step_keys(sampling.prng_key(9), 5), 4)
    with_bits = sampling.sample_epoch_pairs(*args, bits=_bits_t(mine.positives_bitset()))
    without = sampling.sample_epoch_pairs(*args)
    assert torch.equal(with_bits[0], without[0]) and torch.equal(with_bits[1], without[1])


@pytest.mark.parametrize("wrong", ["words", "users", "dtype"])
def test_a_wrong_bitset_raises(wrong):
    """No fall back to the rows: a bitset of the wrong shape or type
    raises, in the sampler and in the epoch's entry."""
    mine, _ = _capped_corpus()
    capped = mine.padded_user_positives(max_len=10, seed=0)
    bits = _bits_t(mine.positives_bitset())
    bad = {"words": bits[:, :-1], "users": bits[:-1],
           "dtype": torch.from_numpy(mine.positives_bitset().astype(np.int64))}[wrong]
    err = TypeError if wrong == "dtype" else ValueError
    padded, counts = torch.as_tensor(capped.padded), torch.as_tensor(capped.counts)
    with pytest.raises(err, match="bits"):
        sampling._sample_pairs(padded, counts, mine.count_items(), (0, 1), 4, bad)
    p = torch.zeros((padded.shape[0], 4))
    q = torch.zeros((mine.count_items(), 4))
    with pytest.raises(err, match="bits"):
        port.bpr_epoch_fused(p, q, padded, counts, [(0, 1)], mine.count_items(), LR, REG,
                             ablate="nosample", bits=bad)


def test_with_bits_no_capped_users_negative_is_a_positive_but_all_collide():
    """With bits, a capped user's negative lies in its full positive set
    only when every one of its n_tries candidates does (the first is kept);
    without bits the same draws give such negatives: the bias the bitset
    removes."""
    rng = np.random.default_rng(7)
    n_items, cap, n_tries = 60, 10, 4
    ragged = [rng.choice(n_items, size=int(w), replace=False).tolist()
              for w in rng.choice([3, 8, 45, 55], size=200)]
    mine, _ = _both(ragged, n_items)
    capped = mine.padded_user_positives(max_len=cap, seed=1)
    full_counts = np.array([len(r) for r in ragged])
    bits = _bits_t(mine.positives_bitset())
    steps = sampling.raw_step_keys(sampling.prng_key(3), 6)
    args = (torch.as_tensor(capped.padded), torch.as_tensor(capped.counts), n_items, steps,
            n_tries)
    _, neg_bits = sampling.sample_epoch_pairs(*args, bits=bits)
    _, neg_rows = sampling.sample_epoch_pairs(*args)
    capped_users = np.flatnonzero(full_counts > cap)
    in_full = {"bits": 0, "rows": 0}
    all_collide = 0
    for s, step in enumerate(steps):
        _, kn = jax.random.split(_key(step))
        cand = np.asarray(jax.random.randint(kn, (len(ragged), n_tries), 0, n_items))
        for u in capped_users:
            full = set(ragged[u])
            collide = all(int(c) in full for c in cand[u])
            all_collide += collide
            in_full["bits"] += int(neg_bits[s, u]) in full
            in_full["rows"] += int(neg_rows[s, u]) in full
            if int(neg_bits[s, u]) in full:
                assert collide and int(neg_bits[s, u]) == cand[u, 0]
    assert in_full["bits"] == all_collide
    assert in_full["rows"] > in_full["bits"]


# ----------------------------------------------------------------- the epoch


def _epoch_setup(cap=8, k=16):
    mine, ref = _capped_corpus(seed=6)
    widest = max(len(fb) for fb in mine.user_feedback)
    capped = mine.padded_user_positives(max_len=cap, seed=2)
    full = ref.padded_user_positives(max_len=widest, seed=2)
    rng = np.random.default_rng(k)
    p0 = rng.normal(scale=0.01, size=(mine.count_users(), k)).astype(np.float32)
    q0 = rng.normal(scale=0.01, size=(mine.count_items(), k)).astype(np.float32)
    return mine, capped, full, p0, q0


def _ref_epoch(capped, bits, p0, q0, steps, n_items, n_tries):
    """The reference's one-device step with its bitset: ``bpr_apply_pairs``
    on its ``_sample_pairs``, a step at a time."""
    p, q = jnp.asarray(p0), jnp.asarray(q0)
    active = jnp.asarray(capped.counts > 0)[:, None]
    total = 0.0
    for step in steps:
        pos, neg = _ref_pairs(capped, bits, step, n_items, n_tries)
        p, q, cost = ref_bpr_apply_pairs(p, q, jnp.asarray(pos), jnp.asarray(neg), active, LR,
                                         REG)
        total += float(cost)
    return np.asarray(p), np.asarray(q), total


@pytest.mark.parametrize("n_steps", [1, 3, 5])
def test_epoch_with_bits_is_the_composed_reference(n_steps):
    """bpr_epoch_plain (and bpr_epoch_fused, its entry on the CPU) with
    bits, each step's pairs the reference's, against its one-device epoch
    with its bitset (``_bpr_epoch(..., bits=...)``) from the same key, and
    ``bpr_apply_pairs`` step by step."""
    mine, capped, full, p0, q0 = _epoch_setup()
    n_items, n_tries = mine.count_items(), 4
    ubits = mine.positives_bitset()
    bits = _bits_t(ubits)
    steps = sampling.raw_step_keys(sampling.prng_key(n_steps), n_steps)
    padded, counts = torch.as_tensor(capped.padded), torch.as_tensor(capped.counts)
    q = torch.as_tensor(q0).clone()
    pairs = torch.full((2, n_steps, p0.shape[0]), -7, dtype=torch.int32)
    delta, cost = torch.zeros_like(q), torch.zeros(1)
    p = port.bpr_epoch_plain(torch.as_tensor(p0), q, delta, cost, padded, counts, steps, n_items,
                             LR, REG, n_tries, pairs=pairs, bits=bits)
    for s, step in enumerate(steps):
        r_pos, r_neg = _ref_pairs(capped, ubits, step, n_items, n_tries)
        assert np.array_equal(pairs[0, s].numpy(), r_pos)
        assert np.array_equal(pairs[1, s].numpy(), r_neg)
    r_p, r_q, r_cost = _ref_epoch(capped, ubits, p0, q0, steps, n_items, n_tries)
    np.testing.assert_allclose(p.numpy(), r_p, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(q.numpy(), r_q, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(cost), r_cost, rtol=1e-5)
    assert not delta.any()
    e_p, e_q, e_cost = ref_bpr_epoch(jnp.array(p0), jnp.array(q0), jnp.asarray(capped.padded),
                                     jnp.asarray(capped.counts), jax.random.PRNGKey(n_steps),
                                     n_steps=n_steps, n_items=n_items, lr=LR, reg=REG,
                                     n_tries=n_tries, bits=jnp.asarray(ubits))
    np.testing.assert_allclose(p.numpy(), np.asarray(e_p), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(q.numpy(), np.asarray(e_q), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(cost), float(e_cost), rtol=1e-5)

    q2 = torch.as_tensor(q0).clone()
    p2, q2_out, cost2 = port.bpr_epoch_fused(torch.as_tensor(p0), q2, padded, counts, steps,
                                             n_items, LR, REG, mm_dtype=torch.float32,
                                             n_tries=n_tries, bits=bits)
    assert q2_out is q2
    assert torch.equal(p2, p) and torch.equal(q2, q) and float(cost2) == float(cost)


def test_sweep_with_bits_is_the_composed_reference():
    """One sampled sweep (K2's plain version, and its wrapper on the CPU)
    with bits: the reference's pairs, p_new and q + delta against one
    ``bpr_apply_pairs``."""
    mine, capped, full, p0, q0 = _epoch_setup(cap=6, k=8)
    n_items, n_tries = mine.count_items(), 3
    ubits = mine.positives_bitset()
    bits = _bits_t(ubits)
    step = sampling.raw_step_keys(sampling.prng_key(11), 1)[0]
    padded, counts = torch.as_tensor(capped.padded), torch.as_tensor(capped.counts)
    q = torch.as_tensor(q0)
    delta, cost = torch.zeros_like(q), torch.zeros(1)
    p_new, pos, neg = port.bpr_sweep_sampled(torch.as_tensor(p0), q, delta, cost, padded, counts,
                                             step, n_items, LR, REG, n_tries, bits=bits)
    r_pos, r_neg = _ref_pairs(capped, ubits, step, n_items, n_tries)
    assert np.array_equal(pos.numpy(), r_pos) and np.array_equal(neg.numpy(), r_neg)
    r_p, r_q, r_cost = _ref_epoch(capped, ubits, p0, q0, [step], n_items, n_tries)
    np.testing.assert_allclose(p_new.numpy(), r_p, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose((q + delta).numpy(), r_q, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(cost), r_cost, rtol=1e-5)
    _, _, _, f_pos, f_neg = port.bpr_fully_fused_step(torch.as_tensor(p0), q, padded, counts,
                                                      step, n_items, LR, REG, n_tries=n_tries,
                                                      bits=bits)
    assert torch.equal(f_pos, pos) and torch.equal(f_neg, neg)


# ------------------------------------------------------------------- the fit


def _ref_fit(epochs: int, full_set: bool, monkeypatch, seed: int = 0):
    """The reference's fit on one device with the cap at ``FIT_CAP``: its
    ``BPR.fit`` itself when ``full_set`` (its gate takes the bitset), else
    its one-device epoch (``_bpr_epoch``) without the bitset, on its key
    stream, cap, steps and rejection depth from its init."""
    r_train, r_test = ref_load_built_in(SPEC)
    widest = max(len(fb) for fb in r_train.user_feedback)
    params = RefParams(n_factors=8, n_epochs=epochs, lr=LR, reg=REG)
    if full_set:
        model = RefBPR(params)
        with monkeypatch.context() as patch:
            patch.setattr(ref_bpr, "history_cap", lambda tr: (FIT_CAP, widest))
            model.fit(r_train, r_test, RefFitConfig(verbose=epochs, seed=seed))
        return np.asarray(model.user_factors), np.asarray(model.item_factors), widest
    capped = r_train.padded_user_positives(max_len=FIT_CAP, seed=seed)
    n_items = r_train.count_items()
    n_active = max(int(np.sum(capped.counts > 0)), 1)
    n_steps = max(round(r_train.count_feedback() / n_active), 1)
    n_tries = ref_bpr.adaptive_neg_tries(float(np.mean(capped.counts)) / max(n_items, 1))
    init = RefBPR(params)
    init.init(r_train, seed=seed)
    p, q = init.user_factors, init.item_factors
    key = jax.random.PRNGKey(seed + 1)
    for _ in range(epochs):
        key, epoch_key = jax.random.split(key)
        p, q, _ = ref_bpr_epoch(p, q, jnp.asarray(capped.padded), jnp.asarray(capped.counts),
                                epoch_key, n_steps=n_steps, n_items=n_items, lr=LR, reg=REG,
                                n_tries=n_tries)
    return np.asarray(p), np.asarray(q), widest


def _port_fit(epochs, monkeypatch, widest, config=None):
    train, test = load_built_in(SPEC)
    assert max(len(fb) for fb in train.user_feedback) == widest > FIT_CAP
    monkeypatch.setattr(port_bpr, "history_cap", lambda tr: (FIT_CAP, widest))
    model = BPR(Params(n_factors=8, n_epochs=epochs, lr=LR, reg=REG), device="cpu")
    model.fit(train, test, config or FitConfig(verbose=epochs))
    return model


@pytest.mark.parametrize("epochs", [1, 3])
def test_fit_with_bits_is_the_composed_reference(epochs, monkeypatch, caplog):
    """BPR.fit on the CPU with the cap binding, from the seed: the gate
    builds the bitset, says so, and the factors are those of the
    reference's BPR.fit under its own gate."""
    r_p, r_q, widest = _ref_fit(epochs, True, monkeypatch)
    with caplog.at_level(logging.INFO, logger="gorse_tpu_torch.models.bpr"):
        model = _port_fit(epochs, monkeypatch, widest)
    assert any("full positive sets" in r.getMessage() for r in caplog.records)
    np.testing.assert_allclose(model.user_factors.numpy(), r_p, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.item_factors.numpy(), r_q, rtol=1e-4, atol=1e-6)


def test_fit_past_the_bitset_limit_rejects_against_the_rows(monkeypatch, caplog):
    """With the 64 MiB limit below this corpus's bitset, no bitset is built
    and the fit is the reference's one-device epochs on the capped rows
    alone."""
    r_p, r_q, widest = _ref_fit(2, False, monkeypatch)
    train, _ = load_built_in(SPEC)
    need = train.count_users() * -(-train.count_items() // 32) * 4
    assert port_bpr.BITSET_MAX_BYTES == 64 * 1024 * 1024
    monkeypatch.setattr(port_bpr, "BITSET_MAX_BYTES", need - 1)
    monkeypatch.setattr(Dataset, "positives_bitset", lambda self: pytest.fail("bitset built"))
    with caplog.at_level(logging.INFO, logger="gorse_tpu_torch.models.bpr"):
        model = _port_fit(2, monkeypatch, widest)
    assert not any("full positive sets" in r.getMessage() for r in caplog.records)
    np.testing.assert_allclose(model.user_factors.numpy(), r_p, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.item_factors.numpy(), r_q, rtol=1e-4, atol=1e-6)


def test_gate_sends_bits_only_to_the_single_card_fit(monkeypatch):
    """``rejection_bitset``: one card, cap < widest and the words within
    the limit (at it exactly, too); a 2-shard mesh, cap = widest or one
    byte more than the limit give none. A sharded fit builds none."""
    train, test = load_built_in(SPEC)
    widest = max(len(fb) for fb in train.user_feedback)
    need = train.count_users() * -(-train.count_items() // 32) * 4
    one, two = make_mesh(1, devices=["cpu"]), make_mesh(2, devices=["cpu"])
    want = train.positives_bitset()
    for mesh in (None, one):
        assert np.array_equal(port_bpr.rejection_bitset(train, FIT_CAP, widest, mesh), want)
    assert port_bpr.rejection_bitset(train, FIT_CAP, widest, two) is None
    assert port_bpr.rejection_bitset(train, widest, widest) is None
    monkeypatch.setattr(port_bpr, "BITSET_MAX_BYTES", need)
    assert port_bpr.rejection_bitset(train, FIT_CAP, widest) is not None
    monkeypatch.setattr(port_bpr, "BITSET_MAX_BYTES", need - 1)
    assert port_bpr.rejection_bitset(train, FIT_CAP, widest) is None
    monkeypatch.undo()

    monkeypatch.setattr(Dataset, "positives_bitset", lambda self: pytest.fail("bitset built"))
    _port_fit(1, monkeypatch, widest, FitConfig(mesh=two, verbose=1))
