"""The merge_topk kernel (gorse_tpu_torch/csrc/topk.cu), modelled step by
step in numpy, held against the port's plain version (``merge_topk_plain``)
and the reference's ordering.

The kernel itself runs only on a CUDA card (chip_smoke.py ``hold_merge``
and phases 2, 2b, 7, 7c); these tests run on the CPU. The model follows the
kernel's steps on one query's candidate row: the output cut by rank into
slices, one block a slice; the slice's two boundary keys, the (lo + 1)-th
and the hi-th largest, by 12-bit digit passes over the keys' high words,
then over the low words of the keys that share the high word, stopping when
the boundary bin holds one key; the row staged whole when it has at most
``stage`` keys, else one pass over the row for the top digit of both
boundaries and each boundary bin staged (or, past ``stage`` keys, passes
over the row); the keys between the boundaries compacted and sorted (runs
of 32 by a bitonic network, then merge-path rounds); slots past the count
NEG_INF / 0. It reports the path each
slice took, named as the kernel counts them (``MERGE_PATHS``). Outputs must
be bit-equal (tolerance 0): keys are unique, so the merge is exact.

The reference's ordering is ``jax.lax.top_k`` on the decoded scores placed
at their item ids (-inf elsewhere): score descending, the lower index first
on ties (gorse_tpu/ops/topk.py:404,425,530).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu_torch.ops import topk as port

NEG_INF = np.float32(port.NEG_INF)
SIGN = np.uint64(1 << 63)
_CU = (Path(port.__file__).resolve().parent.parent / "csrc" / "topk.cu").read_text()


def _cu_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


BITS = _cu_int("SEED_BITS")
N_SM = 132  # an H100 SXM's SMs


def _pass(words, prefix, mask, need, shift):
    """seed_pass on uint32 ``words`` (the keys the caller filtered): the
    digit below ``shift`` of those under (prefix, mask), the bin of the
    need-th largest by a scan from the top bin down."""
    bits = min(BITS, shift)
    shift -= bits
    sel = words[(words & np.uint32(mask)) == np.uint32(prefix)]
    hist = np.bincount((sel >> np.uint32(shift)) & np.uint32((1 << bits) - 1),
                       minlength=1 << bits)
    at_or_above = np.cumsum(hist[::-1])[::-1]
    b = int(np.nonzero(at_or_above >= need)[0].max())
    above = int(at_or_above[b] - hist[b])
    return (prefix | b << shift, mask | ((1 << bits) - 1) << shift, need - above, shift,
            int(hist[b]))


def model_select(src, need, cnt, prefix=0, mask=0, shift=32):
    """merge_select: the need-th largest of the uint64 keys ``src``,
    continuing from high-word digits (prefix, mask, shift) with cnt keys
    under them. Returns (key, histogram passes)."""
    hi = (src >> np.uint64(32)).astype(np.uint32)
    lo = (src & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    passes = 0
    while shift > 0 and cnt > 1:
        prefix, mask, need, shift, cnt = _pass(hi, prefix, mask, need, shift)
        passes += 1
    if cnt > 1:  # every high bit fixed; the low words of the keys sharing them
        hword = prefix
        prefix, mask, shift = 0, 0, 32
        while shift > 0 and cnt > 1:
            prefix, mask, need, shift, cnt = _pass(lo[hi == hword], prefix, mask, need, shift)
            passes += 1
        if shift == 0:
            return np.uint64(hword << 32 | prefix), passes
        found = src[(hi == hword) & ((lo & np.uint32(mask)) == np.uint32(prefix))]
    else:
        found = src[(hi & np.uint32(mask)) == np.uint32(prefix)]
    assert len(found) == 1  # keys are unique
    return found[0], passes


def bitonic_desc(x):
    """A bitonic network sorting ``x`` (a power of two long) descending;
    on 32 keys, warp_sort32's network, each stride one shuffle step."""
    n = len(x)
    i = np.arange(n)
    size = 2
    while size <= n:
        stride = size // 2
        while stride > 0:
            y = x[i ^ stride]
            keep_max = ((i & stride) == 0) == ((i & size) == 0)
            x = np.where(keep_max, np.maximum(x, y), np.minimum(x, y))
            stride //= 2
        size *= 2
    return x


ITEMS = _cu_int("MERGE_ITEMS")


def model_sort(x, items=ITEMS):
    """sort_desc: runs of 32 sorted by warp_sort32, then rounds of merges
    doubling the runs, each thread writing ``items`` outputs of a pair of
    runs from the split a binary search finds on its diagonal (merge path):
    the first run's key first on ties."""
    n = len(x)
    src = np.concatenate([bitonic_desc(x[r:r + 32]) for r in range(0, n, 32)])
    run = 32
    while run < n:
        dst = np.empty_like(src)
        for o in range(0, n, items):
            d = o % (2 * run)
            a, b = src[o - d:o - d + run], src[o - d + run:o - d + 2 * run]
            lo, hi = max(0, d - run), min(d, run)
            while lo < hi:
                mid = (lo + hi) // 2
                if a[mid] >= b[d - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, d - lo
            for e in range(items):
                if j >= run or (i < run and a[i] >= b[j]):
                    dst[o + e], i = a[i], i + 1
                else:
                    dst[o + e], j = b[j], j + 1
        src, run = dst, 2 * run
    return src


def model_merge(keys, k, slice_, stage):
    """One query: ``keys`` the live candidate keys (uint64, compared
    unsigned) -> (the k output keys, 0 past the count; the path of each
    slice)."""
    c = len(keys)
    out = np.zeros(k, np.uint64)
    paths = []
    for r in range(-(-k // slice_)):
        lo, hi = r * slice_, min(k, (r + 1) * slice_)
        hi_live = min(hi, c)
        m = hi_live - lo
        if m <= 0:
            paths.append("fill")
            continue
        want = {"upper": (lo > 0, lo + 1), "lower": (hi_live < c, hi_live)}
        bound = {"upper": np.uint64(2**64 - 1), "lower": np.uint64(0)}
        if not (want["upper"][0] or want["lower"][0]):
            path = "whole"
        elif c <= stage:
            path = "staged"
            for name, (needed, need) in want.items():
                if needed:
                    bound[name], _ = model_select(keys, need, c)
        else:
            path = "bin"
            top = (keys >> np.uint64(64 - BITS)).astype(np.int64)  # one read, both boundaries
            hist = np.bincount(top, minlength=1 << BITS)
            for name, (needed, need) in want.items():
                if not needed:
                    continue
                prefix, mask, need, shift, cnt = _pass(
                    top.astype(np.uint32), 0, 0, need, BITS)
                prefix, mask, shift = prefix << (32 - BITS), mask << (32 - BITS), 32 - BITS
                assert cnt == hist[prefix >> (32 - BITS)]
                in_bin = ((keys >> np.uint64(32)).astype(np.uint32) & np.uint32(mask)) == prefix
                if cnt <= stage:
                    src = keys[in_bin]  # the bin appended to shared memory
                    assert len(src) == cnt
                else:
                    path, src = "global", keys
                bound[name], _ = model_select(src, need, cnt, prefix, mask, shift)
        part = keys[(keys >= bound["lower"]) & (keys <= bound["upper"])]
        assert len(part) == m
        pc = max(32, 1 << (m - 1).bit_length())
        ranked = model_sort(np.concatenate([part, np.zeros(pc - m, np.uint64)]))
        np.testing.assert_array_equal(ranked[:m], np.sort(part)[::-1])
        out[lo:lo + m] = ranked[:m]
        paths.append(path)
    return out, paths


def _decode(u, n_live):
    """Output keys -> (scores f32, ids int32), NEG_INF / 0 past n_live."""
    hi = (u >> np.uint64(32)).astype(np.uint32)
    bits = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    s = bits.view(np.float32).copy()
    i = (np.uint64(0xFFFFFFFF) - (u & np.uint64(0xFFFFFFFF))).astype(np.int64).astype(np.int32)
    s[n_live:], i[n_live:] = NEG_INF, 0
    return s, i


# ------------------------------------------------------------------ inputs


def _rows(name):
    """(scores [b, cap] f32, ids [b, cap] int32, counts [b]): row q's first
    counts[q] entries are its candidates (unique ids), the rest junk."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def build(counts, score_fn, cap=None):
        cap = cap or max(max(counts), 1) + 3
        b = len(counts)
        scores = rng.standard_normal((b, cap)).astype(np.float32) * 50  # junk past the count
        ids = rng.integers(0, 2**31 - 1, (b, cap)).astype(np.int32)
        for q, c in enumerate(counts):
            scores[q, :c] = score_fn(c)
            ids[q, :c] = rng.permutation(60_000)[:c]
        return scores, ids, np.asarray(counts, np.int32)

    def normal(c):
        return rng.standard_normal(c).astype(np.float32) * 4

    def few(values):
        return lambda c: rng.choice(np.float32(values), c)

    def with_neg_inf(c):
        x = normal(c)
        x[rng.permutation(c)[: c // 3]] = NEG_INF
        return x

    table = {
        "c_zero": ([0, 0], normal),
        "c_below_k": ([50, 37, 1], normal),
        "c_equal_k": ([100, 100, 100], normal),
        "c_above_k": ([120, 101, 127], normal),
        "long_row": ([1000, 777], normal),
        "bin_overflow": ([600, 601], few([0.5, 2.0])),
        "k_one_long": ([500], normal),
        "k_one_staged": ([20, 1, 2], normal),
        "ties_split": ([300, 299, 300], few([-1.0, 0.25, 3.0])),
        "all_equal_long": ([300, 300], lambda c: np.full(c, 1.5, np.float32)),
        "all_equal_staged": ([300, 250], lambda c: np.full(c, -2.0, np.float32)),
        "neg_inf": ([200, 150, 90], with_neg_inf),
        "serving_298": ([400, 298, 0], normal),
        "group_2048": ([2130, 2100], normal),
        "wide_20000": ([20_800, 20_100], normal),
    }
    for k in (127, 128, 129):
        table[f"k_{k}"] = ([200, 129, 128], normal)
    counts, fn = table[name]
    return build(counts, fn)


# name -> (k, slice, stage, the path of every slice of every row)
CASES = {
    "c_zero": (10, 64, 128, [["fill"], ["fill"]]),
    "c_below_k": (100, 64, 128, [["whole", "fill"], ["whole", "fill"], ["whole", "fill"]]),
    "c_equal_k": (100, 64, 128, [["staged", "staged"]] * 3),
    "c_above_k": (50, 64, 128, [["staged"]] * 3),
    "long_row": (150, 64, 256, [["bin"] * 3] * 2),
    "bin_overflow": (200, 64, 128, [["global"] * 4] * 2),
    "k_one_long": (1, 64, 128, [["bin"]]),
    "k_one_staged": (1, 64, 128, [["staged"], ["whole"], ["staged"]]),
    "ties_split": (250, 64, 512, [["staged"] * 4] * 3),
    "all_equal_long": (200, 64, 128, [["global"] * 4] * 2),
    "all_equal_staged": (200, 64, 512, [["staged"] * 4] * 2),
    "neg_inf": (180, 64, 256, [["staged"] * 3, ["staged"] * 3, ["staged", "staged", "fill"]]),
    "k_127": (127, 64, 256, [["staged"] * 2] * 3),
    "k_128": (128, 64, 256, [["staged"] * 2] * 3),
    "k_129": (129, 64, 256, [["staged"] * 3, ["staged"] * 3, ["staged", "staged", "fill"]]),
    # the kernel's own sizes (merge_slice on an H100's 132 SMs)
    "serving_298": (298, 4096, 4096, [["staged"], ["whole"], ["fill"]]),
    "group_2048": (2048, 4096, 4096, [["staged"], ["staged"]]),
    "wide_20000": (20_000, 4096, 4096, [["bin"] * 5] * 2),
}


def _keys(scores, ids):
    return port._keys(torch.as_tensor(scores), torch.as_tensor(ids)).numpy()


def _model(name):
    k, slice_, stage, paths = CASES[name]
    scores, ids, counts = _rows(name)
    keys = _keys(scores, ids)
    out_s = np.empty((len(counts), k), np.float32)
    out_i = np.empty((len(counts), k), np.int32)
    for q, c in enumerate(counts):
        live = keys[q, :c].view(np.uint64) ^ SIGN
        u, got = model_merge(live, k, slice_, stage)
        assert got == paths[q], f"row {q}: paths {got}, want {paths[q]}"
        out_s[q], out_i[q] = _decode(u, min(c, k))
    return keys, counts, out_s, out_i


@pytest.mark.parametrize("name", list(CASES))
def test_merge_model_equals_the_plain_version(name):
    """Every slice takes the path it is built for, and the model's scores
    and ids are bit-equal to merge_topk_plain's (also through merge_topk,
    which takes the plain version on the CPU)."""
    keys, counts, s, i = _model(name)
    k = CASES[name][0]
    cand, count = torch.as_tensor(keys), torch.as_tensor(counts)
    for fn in (port.merge_topk_plain, port.merge_topk):
        s_p, i_p = fn(cand, count, len(counts), k)
        np.testing.assert_array_equal(s.view(np.uint32), s_p.numpy().view(np.uint32))
        np.testing.assert_array_equal(i, i_p.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_merge_model_follows_the_reference_order(name):
    """The filled slots are jax.lax.top_k of the candidates' scores placed
    at their ids: score descending, the lower id first on ties."""
    keys, counts, s, i = _model(name)
    k = CASES[name][0]
    scores, ids, _ = _rows(name)
    for q, c in enumerate(counts):
        n = min(int(c), k)
        if n == 0:
            continue
        dense = np.full(60_000, -np.inf, np.float32)
        dense[ids[q, :c]] = scores[q, :c]
        v, at = jax.lax.top_k(jnp.asarray(dense), n)
        np.testing.assert_array_equal(s[q, :n].view(np.uint32), np.asarray(v).view(np.uint32))
        np.testing.assert_array_equal(i[q, :n], np.asarray(at))


def test_cases_reach_every_path_the_kernel_counts():
    """The cases' paths are the kernel's (csrc/topk.cu MergePath, named by
    MERGE_PATHS), each reached; the model's sizes are the kernel's."""
    seen = {p for case in CASES.values() for row in case[3] for p in row}
    assert seen == set(port.MERGE_PATHS)
    enum = re.search(r"enum MergePath \{([^}]*)\}", _CU).group(1)
    assert len(re.findall(r"MP_\w+", enum)) == len(port.MERGE_PATHS)
    assert _cu_int("MERGE_SLICE") == port.MERGE_SLICE
    for name in ("serving_298", "group_2048", "wide_20000"):
        k, slice_, stage, paths = CASES[name]
        assert stage == _cu_int("MERGE_STAGE")
        b = 256 if name != "wide_20000" else 32
        assert slice_ == port.merge_slice(b, k, N_SM)


@pytest.mark.parametrize("b,k,want", [
    (256, 298, 4096), (256, 20_000, 4096), (32, 20_000, 4096), (32, 4096, 1024),
    (3, 9000, 1024), (1, 1, 1024), (132, 10, 4096), (33, 16_384, 4096), (32, 16_384, 2048),
])
def test_merge_slice_fills_the_card(b, k, want):
    """The slice is halved, down to 1,024, while b x slices < the SMs."""
    assert port.merge_slice(b, k, N_SM) == want


@pytest.mark.parametrize("n", [32, 64, 1024, 4096])
def test_sort_model_sorts_descending(n):
    """The sort's model on random keys, and on keys with the zero padding's
    ties."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2**63, n, dtype=np.uint64)
    x[rng.permutation(n)[: n // 3]] = 0
    np.testing.assert_array_equal(model_sort(x), np.sort(x)[::-1])
