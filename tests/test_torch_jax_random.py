"""The port's ``jax.random`` (gorse_tpu_torch/ops/prng.py) and its one-device
BPR sampler (``sampling._sample_pairs``) held against jax and gorse_tpu on
the CPU.

``random_bits``, ``randint``, ``uniform`` and ``normal`` must equal jax's
draws exactly, and so must the sampler's pairs, with and without the
full-set bitset. ``log1p_f32`` must equal ``jax.numpy.log1p`` on every f32
the sweep takes, and ``fma_f32`` the exact ``a * b + c`` rounded once.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gorse_tpu.data.dataset import Dataset as RefDataset
from gorse_tpu.models.bpr import _sample_pairs as ref_sample_pairs
from gorse_tpu_torch.data.dataset import Dataset
from gorse_tpu_torch.ops import prng, sampling

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(1,), (33,), (5, 7), (2, 3, 4)]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_are_jax_bits(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    got = prng.random_bits(prng.prng_key(seed), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_batched_keys_are_each_keys_draw():
    """random_bits and randint_batch under [S, 2] keys give row s the draw
    of key s; split_batch is split key by key."""
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 5))
    inner = prng.split_batch(keys)
    rows = prng.random_bits(keys, (4, 3))
    ints = prng.randint_batch(inner, (6,), 0, 1000)
    for s, key in enumerate(keys):
        assert np.array_equal(inner[s], np.asarray(jax.random.split(key)))
        assert np.array_equal(rows[s].numpy(),
                              np.asarray(jax.random.bits(key, (4, 3), jnp.uint32)))
        assert np.array_equal(ints[s].numpy(), np.asarray(jax.random.randint(key, (6,), 0, 1000)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_per_row_maxima(seed):
    """Per-row maxima as the sampler gives them (max(count, 1) with counts
    0 and 1 among them), spans that do not divide 2^32, spans past 2^16
    (where jax's multiplier wraps to 0), and maxval <= minval (span 1)."""
    rng = np.random.default_rng(seed % 1000)
    counts = rng.integers(-3, 200_000, size=5000).astype(np.int32)
    counts[:8] = [0, 1, 2, 3, 65535, 65536, 65537, 2**31 - 1]
    key = jax.random.PRNGKey(seed)
    for lo, hi in ((0, np.maximum(counts, 1)), (0, counts), (5, counts)):
        want = np.asarray(jax.random.randint(key, (5000,), lo, hi))
        got = prng.randint(prng.prng_key(seed), (5000,), lo, hi)
        assert np.array_equal(got.numpy(), want)
    hi = counts[:40].reshape(40, 1)  # a maximum a row, broadcast over the columns
    want = np.asarray(jax.random.randint(key, (40, 3), 0, hi))
    assert np.array_equal(prng.randint(prng.prng_key(seed), (40, 3), 0, hi).numpy(), want)


@pytest.mark.parametrize("lo, hi", [(0, 1), (0, 7), (0, 27_278), (0, 70_000), (-10, -3),
                                    (-(2**31), 2**31 - 1), (9, 9), (9, 2)])
def test_randint_scalar_bounds(lo, hi):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.randint(key, (600, 3), lo, hi))
    got = prng.randint(prng.prng_key(11), (600, 3), lo, hi)
    assert np.array_equal(got.numpy(), want)
    if hi <= lo:
        assert (got == lo).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), lo=st.integers(-(2**31), 2**31 - 1),
       width=st.integers(-5, 2**32), n=st.integers(1, 64))
def test_randint_any_span(seed, lo, width, n):
    hi = int(np.clip(lo + width, -(2**31), 2**31 - 1))
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), lo, hi))
    assert np.array_equal(prng.randint(prng.prng_key(seed), (n,), lo, hi).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-3.5, 2.25), (1e-3, 7.0)])
def test_uniform_is_jax_uniform(seed, bounds):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, (100, 100), minval=bounds[0], maxval=bounds[1]))
    got = prng.uniform(prng.prng_key(seed), (100, 100), *bounds)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(3, 5), (1000, 64), (200_000,)])
def test_normal_is_within_4_ulp_of_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _ulps(got.numpy(), want).max() == 0


@pytest.mark.parametrize("seed, shape", [(1, (1_000_003,)), (42, (1000, 1001)),
                                         (2**31 - 1, (8, 125_000)), (12345, (3, 7, 47_620))])
def test_normal_is_jax_normal_over_millions(seed, shape):
    """Over 4M draws from four keys and shapes (both of ErfInv's branches
    and both of log1p's are taken many times), every bit jax's."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _log1p_sweep() -> np.ndarray:
    """f32s for log1p: every exponent of both signs (each with a few
    mantissas), subnormals, -1 and its neighbours, the edge of log1p's
    small branch, the arguments where ErfInv's w = -log1p(-x^2) crosses 5,
    the range (-1, 0] that ErfInv takes, and the special values."""
    rng = np.random.default_rng(3)
    exps = np.arange(0, 255, dtype=np.uint32)
    mants = np.concatenate([[0, 1, 0x7FFFFF, 0x400000],
                            rng.integers(0, 1 << 23, 28)]).astype(np.uint32)
    bits = (exps[:, None] << 23 | mants[None, :]).reshape(-1)
    every = np.concatenate([bits, bits | np.uint32(1 << 31)]).view(np.float32)
    subnormal = np.concatenate([np.arange(1, 4096, dtype=np.uint32),
                                rng.integers(1, 1 << 23, 4096).astype(np.uint32)])
    subnormal = np.concatenate([subnormal, subnormal | np.uint32(1 << 31)]).view(np.float32)
    one = np.float32(-1.0).view(np.uint32)
    near_one = (one + np.arange(-64, 65, dtype=np.int64)).astype(np.uint32).view(np.float32)
    near_one = near_one[near_one >= -1.0]
    small = np.float32(np.sqrt(2) - 1)

    def around(x):
        return (np.float32(x).view(np.int32) + np.arange(-256, 257)).astype(np.int32).view(
            np.float32)

    w5 = np.float32(-(1 - np.exp(-5.0)))
    dense = -rng.random(1_000_000, dtype=np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -2.0, 1.0], np.float32)
    return np.concatenate([every, subnormal, near_one, around(small), around(-small),
                           around(w5), dense, specials])


def test_log1p_is_xlas():
    """``log1p_f32`` against ``jax.numpy.log1p`` (jitted, f32) on the
    sweep, bit for bit (NaN where jax gives NaN)."""
    x = _log1p_sweep()
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng.log1p_f32(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def test_erfinv_edges():
    """The ends of the range and both branches (w < 5 and w >= 5)."""
    x = np.array([-1.0, -0.99999994, -0.9999, -0.5, -1e-30, 0.0, 1e-7, 0.3, 0.99, 0.9999999,
                  1.0], np.float32)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    got = prng.erfinv_f32(torch.from_numpy(x)).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[-1]) and got[-1] > 0
    assert (_ulps(got[1:-1], want[1:-1]) == 0).all()


def test_fma_rounds_once():
    """a * b + c with one rounding, also where the two roundings of the
    unfused form differ."""
    a = torch.tensor([1.0 + 2.0**-23, 3.0, 0.1], dtype=torch.float32)
    b = torch.tensor([1.0 - 2.0**-23, 7.0, 10.0], dtype=torch.float32)
    c = torch.tensor([-1.0, 2.0**-30, -1.0], dtype=torch.float32)
    exact = a.double() * b.double() + c.double()
    got = prng.fma_f32(a, b, c)
    assert torch.equal(got, exact.float())
    assert got[0] != (a[0] * b[0] + c[0])  # the unfused form rounds twice


def _exact_f32(a: float, b: float, c: float) -> np.float32:
    """``a * b + c`` exactly, rounded to the nearest f32 (ties to even)."""
    x = Fraction(a) * Fraction(b) + Fraction(c)
    near = np.float32(float(x))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x), int(v.view(np.int32)) & 1))


def test_fma_rounds_once_where_f64_lands_on_a_midpoint():
    """A sum whose f64 rounding lands on the midpoint of two f32s while the
    exact value lies below it: ``(1 - 2^-18)(1 + 2^-18) 2^-24 + (1 +
    2^-23)`` is ``1 + 3 * 2^-24 - 2^-60``, whose f64 is the midpoint; the
    f32 is ``1 + 2^-23``. Then random triples of every scale against the
    exact value."""
    a = torch.tensor([(1 - 2.0**-18) * 2.0**-12], dtype=torch.float32)
    b = torch.tensor([(1 + 2.0**-18) * 2.0**-12], dtype=torch.float32)
    c = torch.tensor([1 + 2.0**-23], dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).item() == 1 + 3 * 2.0**-24
    assert prng.fma_f32(a, b, c).item() == 1 + 2.0**-23
    rng = np.random.default_rng(8)
    n = 3000
    a, b = (rng.normal(size=(2, n)) * np.exp(rng.uniform(-20, 20, (2, n)))).astype(np.float32)
    c = (rng.normal(size=n) * np.exp(rng.uniform(-40, 40, n))).astype(np.float32)
    got = prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_exact_f32(float(x), float(y), float(z)) for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


# ------------------------------------------------------ the one-device sampler


def _corpus():
    """Heavy-tailed histories, some empty, whose widest rows pass the caps:
    the shape at which the reference's fit takes the bitset (cap < widest).
    Built by both packages from the same edges."""
    rng = np.random.default_rng(2)
    n_users, n_items = 300, 200
    widths = np.minimum(rng.zipf(1.6, size=n_users), 120)
    widths[::17] = 0
    ragged = [rng.choice(n_items, size=int(w), replace=False) for w in widths]
    users = np.repeat(np.arange(n_users), widths)
    items = np.concatenate(ragged)
    ids_u, ids_i = [str(u) for u in range(n_users)], [str(i) for i in range(n_items)]
    mine = Dataset.from_edges(users, items, user_ids=ids_u, item_ids=ids_i)
    ref = RefDataset.from_edges(users, items, user_ids=ids_u, item_ids=ids_i)
    assert mine.user_feedback == ref.user_feedback
    assert np.array_equal(mine.positives_bitset(), ref.positives_bitset())
    return mine


def _key(step) -> jax.Array:
    return jnp.asarray(np.asarray(step, np.uint32))


@pytest.mark.parametrize("n_tries", [2, 3, 8, 12])
@pytest.mark.parametrize("cap", [6, 25, None])
@pytest.mark.parametrize("with_bits", [False, True])
def test_sample_pairs_is_the_reference(n_tries, cap, with_bits):
    """Every padded row (empty ones, rows the cap cuts) and every step:
    pos and neg equal the reference's ``_sample_pairs``, against the capped
    rows or, with bits, against the whole positive sets; the epoch-wide
    form equals the per-step one."""
    mine = _corpus()
    widest = max(len(fb) for fb in mine.user_feedback)
    csr = mine.padded_user_positives(max_len=cap or widest, seed=1)
    if cap:
        assert (csr.counts == cap).sum() > 5 and cap < widest
    assert (csr.counts == 0).any()
    n_items = mine.count_items()
    bits = mine.positives_bitset() if with_bits else None
    bits_t = None if bits is None else torch.from_numpy(bits.view(np.int32))
    padded, counts = torch.as_tensor(csr.padded), torch.as_tensor(csr.counts)
    steps = sampling.raw_step_keys(sampling.prng_key(n_tries + (cap or 0)), 4)
    pos, neg = sampling.sample_epoch_pairs(padded, counts, n_items, steps, n_tries, bits_t)
    assert pos.shape == neg.shape == (4, csr.padded.shape[0]) and pos.dtype == torch.int32
    for s, step in enumerate(steps):
        r_pos, r_neg = ref_sample_pairs(jnp.asarray(csr.padded), jnp.asarray(csr.counts), n_items,
                                        _key(step), n_tries,
                                        None if bits is None else jnp.asarray(bits))
        assert np.array_equal(pos[s].numpy(), np.asarray(r_pos))
        assert np.array_equal(neg[s].numpy(), np.asarray(r_neg))
        one = sampling._sample_pairs(padded, counts, n_items, step, n_tries, bits_t)
        assert torch.equal(one[0], pos[s]) and torch.equal(one[1], neg[s])


def test_sample_pairs_in_chunks_of_steps(monkeypatch):
    """Steps drawn in chunks (the comparison's element budget) give the
    pairs drawn at once."""
    mine = _corpus()
    csr = mine.padded_user_positives(max_len=10, seed=0)
    args = (torch.as_tensor(csr.padded), torch.as_tensor(csr.counts), mine.count_items(),
            sampling.raw_step_keys(sampling.prng_key(5), 7), 3)
    whole = sampling.sample_epoch_pairs(*args)
    monkeypatch.setattr(sampling, "_COMPARE_ELEMENTS", 3 * csr.padded.size * 3)
    chunked = sampling.sample_epoch_pairs(*args)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    empty = sampling.sample_epoch_pairs(*args[:3], [], 3)
    assert empty[0].shape == (0, csr.padded.shape[0])


def test_randint_keys_are_the_references_splits():
    """Each step's four keys: split(ks) then split(kn), ks, kn =
    split(step key)."""
    steps = sampling.raw_step_keys(sampling.prng_key(9), 6)
    keys = sampling.randint_keys(steps)
    assert keys.shape == (6, 4, 2) and keys.dtype == np.uint32
    for s, step in enumerate(steps):
        ks, kn = jax.random.split(_key(step))
        want = np.concatenate([np.asarray(jax.random.split(ks)), np.asarray(jax.random.split(kn))])
        assert np.array_equal(keys[s], want)


def test_draws_in_chunks_are_the_whole_draw(monkeypatch):
    """uniform and normal drawn a few hundred elements at a time (the
    host's chunks) equal the draw in one piece, across chunk edges."""
    key = prng.prng_key(21)
    whole = prng.uniform(key, (37, 50), -2.0, 3.0), prng.normal(key, (37, 50))
    monkeypatch.setattr(prng, "_CHUNK", 333)
    assert torch.equal(prng.uniform(key, (37, 50), -2.0, 3.0), whole[0])
    assert torch.equal(prng.normal(key, (37, 50)), whole[1])
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(21), (37, 50)))
    assert _ulps(whole[1].numpy(), want).max() == 0
