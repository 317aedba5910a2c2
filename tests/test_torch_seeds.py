"""The select of the block_seeds kernel (gorse_tpu_torch/csrc/topk.cu),
modelled step by step in numpy, held against the port's plain version
(``block_seeds_plain``) and the reference's seed rule.

The kernel itself runs only on a CUDA card (chip_smoke.py phases 2, 2b
and 7); these tests run on the CPU. The model follows the kernel's steps on
one row: the order-preserving key, 12-bit digits from the top, the
boundary bin of the k-th largest found by a scan from the top bin down,
the shared buffer of at most ``SEED_CAP`` keys with further histogram
passes over the row when the boundary bin holds more, the select finished
in the buffer, and ``fired`` from the buffer or, when the nudged seed
leaves the buffer's prefix, by a counting pass over the row. It reports
which of those branches the row took, so each input below is shown to
reach the branch it is meant for. Seeds must be bit-equal and fired counts
equal (tolerance 0): both outputs are exact.

The reference's rule (gorse_tpu/ops/topk.py:490-501, inside the Pallas
kernel _topk_seeded_kernel, where it cannot be called alone) is copied
here in jax.numpy: take the maximum, consume one occurrence, re-take the
maximum, k - 1 times, then nudge down. It runs on the small rows only (it
costs k passes).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu_torch.ops import topk as port

NEG_INF = np.float32(port.NEG_INF)
_CU = (Path(port.__file__).resolve().parent.parent / "csrc" / "topk.cu").read_text()


def _cu_int(name: str) -> int:
    """A ``constexpr int`` of the kernel's source, so the model follows it."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


BITS, CAP = _cu_int("SEED_BITS"), _cu_int("SEED_CAP")


def _ord(x) -> np.ndarray:
    """ord_u32: f32 bits -> an unsigned key in the floats' order."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _from_ord(u: int) -> np.float32:
    b = u & 0x7FFFFFFF if u & 0x80000000 else ~u & 0xFFFFFFFF
    return np.array([b], np.uint32).view(np.float32)[0]


def _nudge(v: np.float32) -> np.float32:
    """v - (|v| 1.2e-7 + 1e-30), each op rounded to f32."""
    t = np.float32(np.abs(v) * np.float32(1.2e-7))
    return np.float32(v - np.float32(t + np.float32(1e-30)))


def _pass(src, prefix, mask, need, shift):
    """One histogram pass: the digit below ``shift`` of the keys under
    (prefix, mask), the bin of the need-th largest, the keys above it."""
    bits = min(BITS, shift)
    shift -= bits
    sel = src[(src & np.uint32(mask)) == np.uint32(prefix)]
    hist = np.bincount((sel >> np.uint32(shift)) & np.uint32((1 << bits) - 1),
                       minlength=1 << bits)
    at_or_above = np.cumsum(hist[::-1])[::-1]  # the scan from the top bin down
    b = int(np.nonzero(at_or_above >= need)[0].max())
    above = int(at_or_above[b] - hist[b])
    return (prefix | b << shift, mask | ((1 << bits) - 1) << shift, need - above, shift,
            int(hist[b]))


def model_seed(row: np.ndarray, k: int, cap: int = CAP):
    """(seed, fired, branch, row reads) of one row, as the kernel takes them.
    Branches: "k>n"; "staged" (n <= cap: the row read once into the
    buffer); "bin" (a histogram pass, then the boundary bin into the
    buffer); "edge" (as "bin", the seed below the bin: fired by a count);
    "overflow" / "overflow-edge" (more than one histogram pass over the
    row before the buffer); "global" (the boundary never fit the buffer:
    every bit from passes over the row, fired by a count)."""
    keys = _ord(row)
    n = len(keys)
    if k > n:
        return NEG_INF, int((keys > _ord(NEG_INF)).sum()), "k>n", 1
    prefix, mask, need, shift, cnt, reads = 0, 0, k, 32, n, 0
    while shift > 0 and cnt > cap:
        prefix, mask, need, shift, cnt = _pass(keys, prefix, mask, need, shift)
        reads += 1
    passes = reads
    buffered = shift > 0
    if buffered:
        buf = keys[(keys & np.uint32(mask)) == np.uint32(prefix)]
        reads += 1
        assert len(buf) == cnt <= cap
        bprefix, bmask, bneed = prefix, mask, need
        while shift > 0:
            prefix, mask, need, shift, cnt = _pass(buf, prefix, mask, need, shift)
    assert 1 <= need <= cnt  # cnt keys equal v; the k-th is the need-th of them
    s = _nudge(_from_ord(prefix))
    us = int(_ord(s))
    if buffered and us & bmask == bprefix:
        fired = (k - bneed) + int((buf > us).sum())
        counted = False
    else:
        fired = int((keys > us).sum())
        reads += 1
        counted = True
    if not buffered:
        branch = "global"
    elif passes == 0:
        branch = "staged"
    else:
        branch = ("bin" if passes == 1 else "overflow") + ("-edge" if counted else "")
        branch = branch.replace("bin-edge", "edge")
    return s, fired, branch, reads


def reference_seed(rows: np.ndarray, k: int) -> np.ndarray:
    """gorse_tpu/ops/topk.py:487-501 in jax.numpy, on [b, n] maxima."""
    n = rows.shape[1]
    if k > n:
        return np.full(rows.shape[0], NEG_INF, np.float32)
    bm0 = jnp.asarray(rows)
    cols = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), bm0.shape)
    big0 = jnp.int32(2**31 - 1)
    v = jnp.max(bm0, axis=1, keepdims=True)
    for _ in range(k - 1):  # consume one occurrence, re-max
        at = bm0 == v
        first = jnp.min(jnp.where(at, cols, big0), axis=1, keepdims=True)
        bm0 = jnp.where(jnp.logical_and(at, cols == first), NEG_INF, bm0)
        v = jnp.max(bm0, axis=1, keepdims=True)
    return np.asarray(v - (jnp.abs(v) * 1.2e-7 + 1e-30))[:, 0]


# ------------------------------------------------------------------ inputs


def _pow2_kth(rng, n, k, v=16.0):
    """k - 1 maxima above v, the k-th exactly v (a power of two: the lower
    edge of its bin), the rest below."""
    row = np.empty(n, np.float32)
    row[: k - 1] = rng.uniform(v + 1, 2 * v - 1, k - 1)
    row[k - 1] = v
    row[k:] = rng.uniform(-v, v - 0.5, n - k)
    return rng.permutation(row)


def _signed_zeros(rng, n, k):
    """k - 1 positive maxima, then n / 16 of +0.0 and -0.0 mixed (the k-th
    among them), then negatives."""
    row = np.concatenate([rng.uniform(1, 2, k - 1), np.where(rng.random(n // 16) < 0.5, 0.0, -0.0),
                          -rng.uniform(1, 2, n - k + 1 - n // 16)]).astype(np.float32)
    return rng.permutation(row)


def _edge24(rng, n, k):
    """Every maximum in the 12-bit bin [1, 1.125), the k-th exactly
    1 + 2^-15, the lower edge of a 24-bit bin, the rest below it."""
    v = np.float32(1 + 2**-15)
    row = np.concatenate([rng.uniform(1.01, 1.12, k - 1), [v],
                          rng.uniform(1.0, v, n - k)]).astype(np.float32)
    return rng.permutation(row)


def _neg_inf_tail(rng, n, live):
    """Group maxima with the groups past the catalog at NEG_INF."""
    row = np.full(n, NEG_INF, np.float32)
    row[:live] = rng.standard_normal(live).astype(np.float32) * 8
    return row


def _case(name: str):
    """(rows [b, n] f32, k, cap, the branch every row must take)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random_block":  # the block gate at 1M items
        return (rng.standard_normal((2, 3907)) * 3 + 10).astype(np.float32), 298, CAP, "staged"
    if name == "random_group":  # the group gate at 500k items: max of 4 scores
        rows = (rng.standard_normal((2, 125_056, 4)) * 8).max(2).astype(np.float32)
        return rows, 2048, CAP, "bin"
    if name == "random_small_cap":
        return rng.standard_normal((3, 500)).astype(np.float32), 40, 64, "bin"
    if name == "constant":
        return np.full((2, 20_000), 1.5, np.float32), 100, CAP, "global"
    if name == "constant_small":
        return np.full((2, 3907), -2.25, np.float32), 298, CAP, "staged"
    if name == "heavy_ties":  # three values, 20,000 copies each
        return rng.choice(np.float32([0.5, 3.0, 7.0]), (2, 60_000)), 30_000, CAP, "global"
    if name == "one_bin":  # every key in one 12-bit bin, spread below it
        rows = rng.uniform(1.0, 1.125, (2, 40_000)).astype(np.float32)
        return rows, 2048, CAP, "overflow"
    if name == "one_bin_small_cap":
        rows = rng.uniform(1.0, 1.125, (2, 300)).astype(np.float32)
        return rows, 20, 64, "overflow"
    if name == "ties_small_cap":  # the boundary value repeated past the cap
        rows = rng.choice(np.float32([0.25, 1.5, 6.0]), (2, 200))
        return rows, 70, 16, "global"
    if name == "pow2_group":
        return np.stack([_pow2_kth(rng, 40_000, 2048) for _ in range(2)]), 2048, CAP, "edge"
    if name == "pow2_small_cap":
        return np.stack([_pow2_kth(rng, 200, 9) for _ in range(2)]), 9, 32, "edge"
    if name == "edge24":  # two passes over the row, then the seed leaves the 24-bit bin
        return np.stack([_edge24(rng, 40_000, 2048) for _ in range(2)]), 2048, CAP, "overflow-edge"
    if name == "edge24_small_cap":
        return np.stack([_edge24(rng, 300, 20) for _ in range(2)]), 20, 64, "overflow-edge"
    if name == "pow2_block":
        return np.stack([_pow2_kth(rng, 3907, 298) for _ in range(2)]), 298, CAP, "staged"
    if name == "neg_inf_tail":
        rows = np.stack([_neg_inf_tail(rng, 40_000, 30_000) for _ in range(2)])
        return rows, 2048, CAP, "bin"
    if name == "neg_inf_kth":  # the k-th largest is itself NEG_INF
        return np.stack([_neg_inf_tail(rng, 150, 60) for _ in range(2)]), 100, CAP, "staged"
    if name == "signed_zeros":
        return np.stack([_signed_zeros(rng, 40_000, 500) for _ in range(2)]), 500, CAP, "edge"
    if name == "signed_zeros_small":
        return np.stack([_signed_zeros(rng, 60, 7) for _ in range(2)]), 7, CAP, "staged"
    if name == "k_one":
        return (rng.standard_normal((2, 40_000)) * 8).astype(np.float32), 1, CAP, "bin"
    if name == "k_n":
        rows = (rng.standard_normal((2, 20_003)) * 8).astype(np.float32)
        return rows, 20_003, CAP, "bin"
    if name == "k_above_n":
        return rng.standard_normal((2, 37)).astype(np.float32), 38, CAP, "k>n"
    if name == "n_below_32":
        return _quantized(rng, (3, 7)), 3, CAP, "staged"
    if name == "n_unaligned":  # n % 4 == 1: every row but the first starts unaligned
        return (rng.standard_normal((3, 30_001)) * 8).astype(np.float32), 2048, CAP, "bin"
    raise KeyError(name)


def _quantized(rng, shape):
    return (rng.integers(-3, 4, size=shape) * 0.5).astype(np.float32)  # many ties


CASES = ["random_block", "random_group", "random_small_cap", "constant", "constant_small",
         "heavy_ties", "one_bin", "one_bin_small_cap", "ties_small_cap", "pow2_group",
         "pow2_small_cap", "pow2_block", "edge24", "edge24_small_cap", "neg_inf_tail",
         "neg_inf_kth", "signed_zeros", "signed_zeros_small", "k_one", "k_n", "k_above_n",
         "n_below_32", "n_unaligned"]
SMALL = [c for c in CASES if c.endswith("_small_cap") or c in
         ("signed_zeros_small", "neg_inf_kth", "k_above_n", "n_below_32")]


@pytest.mark.parametrize("name", CASES)
def test_seed_model_equals_the_plain_version(name):
    """Each row takes the branch it is built for, and the model's seed is
    bit-equal to block_seeds_plain's and its fired count equal."""
    rows, k, cap, branch = _case(name)
    gate = port.block_seeds_plain(torch.as_tensor(rows), rows.shape[0], k)
    for r, row in enumerate(rows):
        s, fired, got, reads = model_seed(row, k, cap)
        assert got == branch, f"row {r}: branch {got}, want {branch}"
        assert np.float32(s).view(np.uint32) == gate.seeds[r].numpy().view(np.uint32)
        assert fired == int(gate.fired[r])
        assert fired >= min(k, rows.shape[1])
        assert reads == {"k>n": 1, "staged": 1, "bin": 2, "edge": 3}.get(branch, reads)


@pytest.mark.parametrize("name", SMALL)
def test_seed_model_equals_the_reference_rule(name):
    """On the small rows: the model's seed is bit-equal to the reference's
    consume-and-remax rule."""
    rows, k, cap, _ = _case(name)
    want = reference_seed(rows, k)
    got = np.array([model_seed(row, k, cap)[0] for row in rows], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_cases_reach_every_branch_the_kernel_counts():
    """The cases' branches are the kernel's (csrc/topk.cu SeedBranch, named
    by SEED_BRANCHES), each reached by one case at least."""
    assert {_case(c)[3] for c in CASES} == set(port.SEED_BRANCHES)
    enum = re.search(r"enum SeedBranch \{([^}]*)\}", _CU).group(1)
    assert len(re.findall(r"SB_\w+", enum)) == len(port.SEED_BRANCHES)


def test_seed_model_edge_counts_the_bin_below():
    """A power-of-two k-th largest: the seed drops into the bin below v's
    (so the buffer cannot count fired), and the maxima between the seed and
    v's bin are counted: equal copies of v just under the edge count too."""
    rng = np.random.default_rng(3)
    row = _pow2_kth(rng, 40_000, 500)
    s = _nudge(np.float32(16.0))
    assert int(_ord(s)) >> 20 != int(_ord(np.float32(16.0))) >> 20
    row[np.argsort(row)[:3]] = np.nextafter(np.float32(16.0), np.float32(0))  # above s, below v
    seed, fired, branch, _ = model_seed(row, 500)
    assert branch == "edge" and seed == s and fired == 503
