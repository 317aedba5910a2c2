"""Exact blocked dot-product top-k retrieval (port of gorse_tpu/ops/topk.py).

Semantics are the reference's: the top ``k`` items of every query by
(score descending, item index ascending), scores accumulated in f32, slots
with no item filled with ``NEG_INF`` and index 0.

Routes, as in the reference:

- ``dot_topk``: the serving route. The item table is bf16 (the reference's
  serving embeddings are bf16 too) and the queries are cast to bf16 before
  the dot. Four hand-written CUDA kernels (``csrc/topk.cu``) do the work
  on the card: ``block_max`` (per-query maximum of each 256-item block,
  and optionally of each group of 4 items), ``block_seeds`` (each query's
  seed and how many maxima beat it), ``block_topk`` (blocks that beat a
  query's seed append their best entries to its candidates) and
  ``merge_topk`` (the final k). Each wrapper takes its kernel's plain
  PyTorch version when its tensors lie on the CPU, launches the kernel for
  CUDA tensors, and counts its launches in ``<wrapper>.launches``.

  :func:`kernel_route` picks the gate for a top-k of k over ``n_pad``
  items (``n_blocks = n_pad / 256``): ``"block"`` when k <= n_blocks (the
  seed is the k-th largest block maximum, nudged down; the reference's
  seeded kernel), ``"group"`` when k <= n_pad / 4 (the seed is the k-th
  largest maximum of the 4-item groups: k group maxima belong to k
  distinct items, so it too lies below the k-th best score), and
  ``"none"`` otherwise, or with ``seeded=False``: every block fires, the
  reference's single-pass kernel.
- ``dot_topk_xla``: the f32 route, a full f32 score matrix and a stable
  sort (the reference's non-Pallas path). ``dot_topk_xla.uses`` counts it.
- ``sq_topk`` on a :class:`PreparedSQ`: the quantized vector store's
  serving route. The table is uint8 codes with a per-row affine
  (``v = minv + scale * codes``), and the same four kernels run with an
  affine epilogue (``block_max_sq`` and ``block_topk_sq``, the
  ``has_affine`` body of the reference's kernels). On raw arrays
  ``sq_topk`` takes the reference's XLA formulation instead, as do
  ``pq_topk`` and ``rq_topk``: plain PyTorch, an f32 product and a stable
  sort.

- ``dot_topk_approx`` / ``sq_topk_approx``: the approximate tier (the
  reference's ``jax.lax.approx_max_k`` routes). ``bin_max`` (``bin_max_sq``)
  keeps each query's best item in each of :func:`approx_bins` strided bins,
  a fifth CUDA kernel, and ``merge_topk`` takes the top k of those.

The table layout is the port's own: row-major ``[n_pad, d_pad]`` bf16 (or
uint8 codes), zero padded to multiples of 256 items and 64 dimensions. Zero
dimensions add exactly nothing to an f32 sum, so padding never changes a
score.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import _build

NEG_INF = -1e30
BLOCK_N = 256  # items per block (csrc/topk.cu BLOCK_N)
GROUP = 4  # items per group maximum (csrc/topk.cu GROUP)
QUERY_TILE = 32  # query padding: a warp of the score tile holds 32 query rows
DIM_CHUNK = 64  # dimensions per staged pass (csrc/topk.cu DC)
BIN_W = 64  # bins a bin_max work unit owns (csrc/topk.cu BIN_W)
MERGE_SLICE = 4096  # most output ranks one merge_topk block sorts (csrc/topk.cu)
MERGE_SLICE_MIN = 1024  # merge_slice halves the slice down to this
# the paths of merge_topk's blocks, in csrc/topk.cu MergePath's order
MERGE_PATHS = ("fill", "whole", "staged", "bin", "global")
# the branches of block_seeds' select, in csrc/topk.cu SeedBranch's order
SEED_BRANCHES = ("k>n", "staged", "bin", "edge", "overflow", "overflow-edge", "global")
_CHUNK_B = 256  # queries per kernel chunk
_INT64_MIN = -(2**63)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class PreparedItems(NamedTuple):
    """Item table laid out for :func:`dot_topk`: row-major ``[n_pad, d_pad]``
    bf16, zero padded. Build once, serve many."""

    table: torch.Tensor
    n_items: int
    dim: int


def prepare_items(items, device=None) -> PreparedItems:
    """``[N, d]`` factors -> the padded bf16 table on ``device``."""
    dev = resolve_device(device)
    items = torch.as_tensor(items).to(dev, torch.float32)
    n, d = items.shape
    table = torch.zeros(
        (_round_up(max(n, 1), BLOCK_N), _round_up(max(d, 1), DIM_CHUNK)),
        dtype=torch.bfloat16, device=dev,
    )
    table[:n, :d] = items.to(torch.bfloat16)
    return PreparedItems(table, n, d)


class PreparedSQ(NamedTuple):
    """Scalar-quantized table laid out for :func:`sq_topk`: row-major
    ``[n_pad, d_pad]`` uint8 codes, zero padded like :class:`PreparedItems`,
    and an f32 ``[3, n_pad]`` affine (rows scale / minv / norms2, zero
    padded). Build once with :func:`prepare_sq_items`, serve many."""

    table: torch.Tensor
    affine: torch.Tensor
    n_items: int
    dim: int
    has_norms2: bool = False  # affine row 2 populated (euclidean-capable)


def prepare_sq_items(codes, scale, minv, norms2=None, device=None) -> PreparedSQ:
    """``[N, d]`` uint8 codes and their per-row ``scale``, ``minv`` (and
    ``norms2`` = ||dequantized row||^2 for euclidean) -> the padded layout on
    ``device``."""
    dev = resolve_device(device)
    codes = torch.as_tensor(codes).to(dev, torch.uint8)
    n, d = codes.shape
    n_pad = _round_up(max(n, 1), BLOCK_N)
    table = torch.zeros((n_pad, _round_up(max(d, 1), DIM_CHUNK)), dtype=torch.uint8, device=dev)
    table[:n, :d] = codes
    affine = torch.zeros((3, n_pad), dtype=torch.float32, device=dev)
    affine[0, :n] = torch.as_tensor(scale).to(dev, torch.float32)
    affine[1, :n] = torch.as_tensor(minv).to(dev, torch.float32)
    if norms2 is not None:
        affine[2, :n] = torch.as_tensor(norms2).to(dev, torch.float32)
    return PreparedSQ(table, affine, n, d, norms2 is not None)


class Affine(NamedTuple):
    """The quantized table's epilogue operands for one query chunk."""

    affine: torch.Tensor  # [3, n_pad] f32: scale, minv, norms2 per item
    qstats: torch.Tensor  # [2, b_pad] f32: sum(q), sum(q * q) of the f32 queries
    euclidean: bool


# ------------------------------------------------------------------- keys
# (score desc, index asc) as one int64: high word the score mapped to an
# order-preserving signed int, low word 0xFFFFFFFF - index (csrc/topk.cu).


def _keys(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    bits = scores.contiguous().view(torch.int32)
    ordv = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return ordv * (1 << 32) + (0xFFFFFFFF - idx.to(torch.int64))


def _decode(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ordv = torch.div(keys, 1 << 32, rounding_mode="floor")
    idx = (0xFFFFFFFF - (keys - ordv * (1 << 32))).to(torch.int32)
    bits = torch.where(ordv >= 0, ordv, ordv ^ 0x7FFFFFFF).to(torch.int32)
    return bits.view(torch.float32), idx


# ---------------------------------------------------------- plain versions


def _scores_plain(qp: torch.Tensor, table: torch.Tensor, aff: Affine | None = None) -> torch.Tensor:
    """``[b_pad, n_pad]`` f32 scores: one f32 multiply-add per dimension,
    ascending. bf16 x bf16 and bf16 x uint8 products are exact in f32; the
    kernels sum the same products on the tensor cores in another order, so
    they agree with this within a summation-order bound, and exactly where
    every partial sum is an integer below 2^24 (scaled by a power of two).
    With ``aff`` (a uint8 table) the affine epilogue follows as separate
    rounded ops, as the kernels apply it (gorse_tpu/ops/topk.py
    _block_scores :353-357): raw * scale + qsum * minv, and for euclidean
    2 * that - norms2 - q2."""
    qf = qp.float()
    tf = table.float().t().contiguous()  # [d_pad, n_pad]
    acc = torch.zeros((qp.shape[0], table.shape[0]), dtype=torch.float32, device=qp.device)
    for j in range(qp.shape[1]):
        acc.addcmul_(qf[:, j : j + 1], tf[j])
    if aff is None:
        return acc
    dots = acc * aff.affine[0] + aff.qstats[0][:, None] * aff.affine[1]
    if aff.euclidean:
        return 2.0 * dots - aff.affine[2] - aff.qstats[1][:, None]
    return dots


def block_max_plain(qp, table, n_items: int, aff: Affine | None = None, groups: bool = False):
    """Block maxima ``[b_pad, n_blocks]``; with ``groups`` also the group
    maxima ``[b_pad, n_pad / 4]``, as ``(bmax, gmax)``. Padded items count
    as NEG_INF."""
    s = _scores_plain(qp, table, aff)
    s[:, n_items:] = NEG_INF
    bmax = s.view(qp.shape[0], -1, BLOCK_N).amax(dim=2)
    if not groups:
        return bmax
    return bmax, s.view(qp.shape[0], -1, GROUP).amax(dim=2)


class Gate(NamedTuple):
    """What :func:`block_topk` gates on: block maxima, and the seeds and
    fired counts :func:`block_seeds` derived from maxima over ``width``
    items (the blocks themselves, or the 4-item groups)."""

    bmax: torch.Tensor  # [b_pad, n_blocks] f32 block maxima
    seeds: torch.Tensor  # [b] f32
    fired: torch.Tensor  # [b] int32: blocks (groups) whose maximum beats the seed
    width: int = BLOCK_N  # items per maximum the seeds came from


def block_seeds_plain(bmax: torch.Tensor, b: int, k: int) -> Gate:
    """k-th largest block maximum per query, nudged down as at
    gorse_tpu/ops/topk.py:501 (NEG_INF when k > n_blocks), and the number
    of blocks that beat it."""
    rows = bmax[:b]
    if k > bmax.shape[1]:
        seeds = torch.full((b,), NEG_INF, dtype=torch.float32, device=bmax.device)
    else:
        v = rows.sort(dim=1, descending=True).values[:, k - 1]
        seeds = v - (v.abs() * 1.2e-7 + 1e-30)
    fired = (rows > seeds[:, None]).sum(dim=1).to(torch.int32)
    return Gate(bmax, seeds.contiguous(), fired)


def _candidate_cap(gate: Gate | None, nb: int, k: int) -> int:
    """Keys per query in block_topk's buffer: min(k, width) for each block
    or group that fires for the query that fires most (a candidate beats
    the seed, so its group's maximum does). Every block fires ungated."""
    if gate is None:
        return nb * min(k, BLOCK_N)
    return max(int(gate.fired.max()), 1) * min(k, gate.width)


def block_topk_plain(qp, table, gate: Gate | None, b: int, n_items: int, k: int,
                     aff: Affine | None = None):
    """Candidates as the kernel writes them, sorted descending per query
    (the kernel's order within a query is arbitrary), and their counts."""
    b_pad, n_pad = qp.shape[0], table.shape[0]
    nb = n_pad // BLOCK_N
    dev = qp.device
    scores = _scores_plain(qp, table, aff).view(b_pad, nb, BLOCK_N)
    idx = torch.arange(n_pad, device=dev).view(nb, BLOCK_N)
    valid = idx < n_items
    seeds = torch.full((b_pad,), NEG_INF, dtype=torch.float32, device=dev)
    fire = (torch.arange(b_pad, device=dev) < b)[:, None].expand(b_pad, nb)
    if gate is not None:
        seeds[:b] = gate.seeds
        fire = fire & (gate.bmax > seeds[:, None])
    keys = torch.where(valid, _keys(scores, idx), _INT64_MIN)
    above = valid & (scores > seeds[:, None, None]) & fire[:, :, None]
    n_above = above.sum(dim=2, keepdim=True)
    order = keys.argsort(dim=2, descending=True)
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(BLOCK_N, device=dev).expand_as(order)
    )
    sel = above & ((n_above <= k) | (rank < k))
    count = sel.sum(dim=(1, 2)).to(torch.int32)
    flat = torch.where(sel, keys, _INT64_MIN).view(b_pad, -1)
    cand = flat.sort(dim=1, descending=True).values[:, : _candidate_cap(gate, nb, k)]
    return cand.contiguous(), count


def merge_topk_plain(cand, count, b: int, k: int):
    cap = cand.shape[1]
    dev = cand.device
    live = torch.arange(cap, device=dev)[None, :] < count[:b, None]
    keys = torch.where(live, cand[:b], _INT64_MIN)
    if cap < k:
        keys = torch.cat([keys, torch.full((b, k - cap), _INT64_MIN, device=dev)], dim=1)
    top = keys.sort(dim=1, descending=True).values[:, :k]
    s, i = _decode(top)
    empty = torch.arange(k, device=dev)[None, :] >= count[:b, None]
    return (
        torch.where(empty, NEG_INF, s).contiguous(),
        torch.where(empty, 0, i).contiguous(),
    )


def bin_max_plain(qp, table, n_items: int, n_bins: int, aff: Affine | None = None):
    """Each query's maximum key in each of ``n_bins`` strided bins (item j
    in bin j mod n_bins), ``[b_pad, n_bins]`` int64: the scores of
    :func:`_scores_plain`, padded to a whole number of rows of ``n_bins``
    with keys that never win (``INT64_MIN``, which a bin without items
    keeps), viewed ``[b_pad, rows, n_bins]`` and reduced over the rows."""
    b_pad = qp.shape[0]
    s = _scores_plain(qp, table, aff)[:, :n_items]
    keys = _keys(s.contiguous(), torch.arange(n_items, device=qp.device))
    rows = -(-n_items // n_bins)
    pad = torch.full((b_pad, rows * n_bins - n_items), _INT64_MIN, dtype=torch.int64,
                     device=qp.device)
    return torch.cat([keys, pad], dim=1).view(b_pad, rows, n_bins).amax(dim=1)


def _sorted_topk(s: torch.Tensor, k_top: int, n_items: int):
    """Top ``k_top`` of ``s`` ``[b, n_items]`` by a stable descending sort,
    NEG_INF / 0 past the catalog."""
    b, dev = s.shape[0], s.device
    top = torch.sort(s, dim=1, descending=True, stable=True)
    k = min(k_top, n_items)
    out_s = torch.full((b, k_top), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.zeros((b, k_top), dtype=torch.int32, device=dev)
    out_s[:, :k] = top.values[:, :k]
    out_i[:, :k] = top.indices[:, :k].to(torch.int32)
    return out_s, out_i


def dot_topk_plain(queries, prep: PreparedItems, k_top: int):
    """The whole serving route in plain PyTorch: every score, then a stable
    sort. On the CPU :func:`dot_topk` agrees with it index for index; on the
    card within the score tile's summation order (:func:`_scores_plain`)."""
    b = queries.shape[0]
    qp = _pad_queries(queries, prep, _round_up(max(b, 1), QUERY_TILE))
    s = _scores_plain(qp, prep.table)[:b, : prep.n_items]
    return _sorted_topk(s, k_top, prep.n_items)


def sq_topk_plain(queries, prep: PreparedSQ, k_top: int, metric: str = "dot"):
    """The whole quantized route in plain PyTorch, in chunks of 256 queries:
    every score, then a stable sort. Agrees with :func:`sq_topk` on a
    :class:`PreparedSQ` as :func:`dot_topk_plain` with :func:`dot_topk`."""
    def chunk(q):
        b = q.shape[0]
        qp, aff = _sq_operands(q, prep, _round_up(max(b, 1), QUERY_TILE), metric)
        s = _scores_plain(qp, prep.table, aff)[:b, : prep.n_items]
        return _sorted_topk(s, k_top, prep.n_items)

    return _chunked(chunk, torch.as_tensor(queries).to(prep.table.device, torch.float32))


# ---------------------------------------------------------------- kernels


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    if not getattr(lib, "_gt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gt_block_max.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gt_block_max_sq.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.gt_block_seeds.argtypes = [p, p, p, i, i, i, p]
        lib.gt_block_seeds_branches.argtypes = [p]
        lib.gt_block_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.gt_block_topk_sq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.gt_merge_topk.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.gt_merge_topk_paths.argtypes = [p]
        lib.gt_bin_max.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        lib.gt_bin_max_sq.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
        for fn in (lib.gt_block_max, lib.gt_block_max_sq, lib.gt_block_seeds,
                   lib.gt_block_seeds_branches, lib.gt_block_topk, lib.gt_block_topk_sq,
                   lib.gt_merge_topk, lib.gt_merge_topk_paths, lib.gt_bin_max,
                   lib.gt_bin_max_sq):
            fn.restype = ctypes.c_int
        lib._gt_typed = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def _check_operands(qp: torch.Tensor, table: torch.Tensor,
                    table_dtype: torch.dtype = torch.bfloat16) -> None:
    if qp.device.type != "cuda" or table.device != qp.device:
        raise ValueError(f"operands on {qp.device} and {table.device}, need one CUDA device")
    if qp.dtype != torch.bfloat16 or table.dtype != table_dtype:
        raise TypeError(f"queries must be bf16 and the table {table_dtype}")
    if not (qp.is_contiguous() and table.is_contiguous()):
        raise ValueError("queries and table must be contiguous")
    b_pad, d_pad = qp.shape
    n_pad, d_tab = table.shape
    if d_tab != d_pad or d_pad % DIM_CHUNK or b_pad % QUERY_TILE or n_pad % BLOCK_N:
        raise ValueError(f"bad padded shapes q {tuple(qp.shape)}, table {tuple(table.shape)}")


def _check_affine(aff: Affine, qp: torch.Tensor, table: torch.Tensor) -> None:
    want = {"affine": (3, table.shape[0]), "qstats": (2, qp.shape[0])}
    for name, shape in want.items():
        t = getattr(aff, name)
        if (t.device != qp.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous f32 {shape} on {qp.device}")


def _maxima_out(qp, table, groups: bool):
    """block_max's outputs: block maxima, and the group maxima or None."""
    b_pad, n_pad = qp.shape[0], table.shape[0]
    bmax = torch.empty((b_pad, n_pad // BLOCK_N), dtype=torch.float32, device=qp.device)
    gmax = (torch.empty((b_pad, n_pad // GROUP), dtype=torch.float32, device=qp.device)
            if groups else None)
    return bmax, gmax


def block_max(qp: torch.Tensor, table: torch.Tensor, n_items: int, groups: bool = False):
    """Per-query maximum score of each 256-item block, ``[b_pad, n_blocks]``
    f32 (pass 1; replaces gorse_tpu/ops/topk.py _block_max_kernel). With
    ``groups``, ``(bmax, gmax)``: also the maximum of each 4-item group,
    ``[b_pad, n_pad / 4]``, what the group gate seeds from."""
    if qp.device.type == "cpu":
        return block_max_plain(qp, table, n_items, groups=groups)
    _check_operands(qp, table)
    b_pad, d_pad = qp.shape
    bmax, gmax = _maxima_out(qp, table, groups)
    with torch.cuda.device(qp.device):  # the tensors' card
        rc = _lib().gt_block_max(
            qp.data_ptr(), table.data_ptr(), bmax.data_ptr(), gmax.data_ptr() if groups else None,
            b_pad, d_pad, n_items, bmax.shape[1], _stream(qp),
        )
    _raise_on(rc, "block_max")
    block_max.launches += 1
    return (bmax, gmax) if groups else bmax


def block_max_sq(qp: torch.Tensor, table: torch.Tensor, aff: Affine, n_items: int,
                 groups: bool = False):
    """:func:`block_max` over a uint8 table with the affine epilogue (the
    ``has_affine`` body of gorse_tpu/ops/topk.py _block_max_kernel)."""
    if qp.device.type == "cpu":
        return block_max_plain(qp, table, n_items, aff, groups)
    _check_operands(qp, table, torch.uint8)
    _check_affine(aff, qp, table)
    b_pad, d_pad = qp.shape
    bmax, gmax = _maxima_out(qp, table, groups)
    with torch.cuda.device(qp.device):  # the tensors' card
        rc = _lib().gt_block_max_sq(
            qp.data_ptr(), table.data_ptr(), aff.affine.data_ptr(), aff.qstats.data_ptr(),
            bmax.data_ptr(), gmax.data_ptr() if groups else None, b_pad, d_pad, n_items,
            bmax.shape[1], int(aff.euclidean), _stream(qp),
        )
    _raise_on(rc, "block_max_sq")
    block_max_sq.launches += 1
    return (bmax, gmax) if groups else bmax


def block_seeds(bmax: torch.Tensor, b: int, k: int) -> Gate:
    """Each of the first ``b`` queries' seed and fired count from its block
    maxima, or from its group maxima for the group gate (the seed step of
    gorse_tpu/ops/topk.py _topk_seeded_kernel), exactly as
    :func:`block_seeds_plain`. The kernel selects on the maxima's
    order-preserving keys: a row of at most 8,000 maxima is read once into
    shared memory; a longer one is read once for a histogram of the top 12
    key bits and once more for the keys of the bin that holds the k-th
    largest, and further passes over the row are taken only when that bin
    holds more than 8,000 keys or the nudged seed leaves it
    (:func:`block_seeds_branches` counts which)."""
    if bmax.device.type == "cpu":
        return block_seeds_plain(bmax, b, k)
    if bmax.dtype != torch.float32 or not bmax.is_contiguous() or bmax.shape[0] < b:
        raise ValueError("bmax must be a contiguous f32 [b_pad, n_blocks] with a row per query")
    nb = bmax.shape[1]
    seeds = torch.empty((b,), dtype=torch.float32, device=bmax.device)
    fired = torch.empty((b,), dtype=torch.int32, device=bmax.device)
    with torch.cuda.device(bmax.device):  # the tensors' card
        rc = _lib().gt_block_seeds(
            bmax.data_ptr(), seeds.data_ptr(), fired.data_ptr(), b, nb, k, _stream(bmax)
        )
    _raise_on(rc, "block_seeds")
    block_seeds.launches += 1
    return Gate(bmax, seeds, fired)


def block_seeds_branches() -> dict[str, int]:
    """Rows that took each branch of ``block_seeds``' select (named as in
    ``SEED_BRANCHES``) on the current CUDA device since the last call, which
    clears the counts. Waits for the device."""
    torch.cuda.synchronize()
    rows = (ctypes.c_uint * len(SEED_BRANCHES))()
    _raise_on(_lib().gt_block_seeds_branches(rows), "block_seeds_branches")
    return {name: rows[i] for i, name in enumerate(SEED_BRANCHES) if rows[i]}


def _gate_args(qp, table, gate: Gate | None, b: int):
    b_pad = qp.shape[0]
    nb = table.shape[0] // BLOCK_N
    if gate is not None and (
        gate.bmax.shape != (b_pad, nb) or gate.seeds.shape != (b,)
        or gate.bmax.device != qp.device or gate.seeds.device != qp.device
    ):
        raise ValueError("the gate must hold [b_pad, n_blocks] maxima and [b] seeds "
                         "on the queries' device")
    if gate is None:
        return None, None
    return gate.bmax.data_ptr(), gate.seeds.data_ptr()


def block_topk(qp, table, gate: Gate | None, b: int, n_items: int, k: int):
    """Candidates ``[b_pad, cap]`` int64 keys (the first ``count[q]`` of row
    q are live, in no order) and ``count`` ``[b_pad]``. ``gate`` gates
    blocks on their maxima against seeds from block (K5) or group maxima
    (K6's function) and sizes ``cap`` from its fired counts (one read back
    to the host); ``None`` lets every block fire (K6's single pass)."""
    if qp.device.type == "cpu":
        return block_topk_plain(qp, table, gate, b, n_items, k)
    _check_operands(qp, table)
    b_pad, d_pad = qp.shape
    nb = table.shape[0] // BLOCK_N
    bmax_ptr, seeds_ptr = _gate_args(qp, table, gate, b)
    cap = _candidate_cap(gate, nb, k)
    cand = torch.empty((b_pad, cap), dtype=torch.int64, device=qp.device)
    count = torch.zeros((b_pad,), dtype=torch.int32, device=qp.device)
    with torch.cuda.device(qp.device):  # the tensors' card
        rc = _lib().gt_block_topk(
            qp.data_ptr(), table.data_ptr(), bmax_ptr, seeds_ptr,
            cand.data_ptr(), count.data_ptr(), b, b_pad, d_pad, n_items, nb, k, cap, _stream(qp),
        )
    _raise_on(rc, "block_topk")
    block_topk.launches += 1
    return cand, count


def block_topk_sq(qp, table, aff: Affine, gate: Gate | None, b: int, n_items: int, k: int):
    """:func:`block_topk` over a uint8 table with the affine epilogue (the
    ``has_affine`` body of gorse_tpu/ops/topk.py _topk_seeded_kernel and
    _topk_kernel)."""
    if qp.device.type == "cpu":
        return block_topk_plain(qp, table, gate, b, n_items, k, aff)
    _check_operands(qp, table, torch.uint8)
    _check_affine(aff, qp, table)
    b_pad, d_pad = qp.shape
    nb = table.shape[0] // BLOCK_N
    bmax_ptr, seeds_ptr = _gate_args(qp, table, gate, b)
    cap = _candidate_cap(gate, nb, k)
    cand = torch.empty((b_pad, cap), dtype=torch.int64, device=qp.device)
    count = torch.zeros((b_pad,), dtype=torch.int32, device=qp.device)
    with torch.cuda.device(qp.device):  # the tensors' card
        rc = _lib().gt_block_topk_sq(
            qp.data_ptr(), table.data_ptr(), aff.affine.data_ptr(), aff.qstats.data_ptr(),
            bmax_ptr, seeds_ptr, cand.data_ptr(), count.data_ptr(), b, b_pad, d_pad, n_items, nb,
            k, cap, int(aff.euclidean), _stream(qp),
        )
    _raise_on(rc, "block_topk_sq")
    block_topk_sq.launches += 1
    return cand, count


def merge_slice(b: int, k: int, n_sm: int) -> int:
    """Output ranks one ``merge_topk`` block owns: ``MERGE_SLICE``, halved
    (down to ``MERGE_SLICE_MIN``) while ``b`` x ceil(k / slice) blocks would
    leave some of the card's ``n_sm`` SMs idle."""
    s = MERGE_SLICE
    while s > MERGE_SLICE_MIN and b * -(-k // s) < n_sm:
        s //= 2
    return s


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def merge_topk(cand: torch.Tensor, count: torch.Tensor, b: int, k: int):
    """Final ``(scores [b, k] f32, indices [b, k] int32)`` from the
    candidates, NEG_INF / 0 where a query has fewer than k; exactly
    :func:`merge_topk_plain`. Any k: each query's output is cut by rank into
    slices of :func:`merge_slice` ranks, one kernel block a slice, which
    selects the slice's two boundary keys among the candidates and sorts
    the keys between them in shared memory (:func:`merge_topk_paths` counts
    the path each block took)."""
    if cand.device.type == "cpu":
        return merge_topk_plain(cand, count, b, k)
    if cand.dtype != torch.int64 or count.dtype != torch.int32 or count.device != cand.device:
        raise TypeError("cand must be int64 and count int32 on one device")
    if not (cand.is_contiguous() and count.is_contiguous()) or count.shape[0] < b:
        raise ValueError("cand and count must be contiguous, with a count per query")
    out_s = torch.empty((b, k), dtype=torch.float32, device=cand.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=cand.device)
    slice_ = merge_slice(b, k, _sm_count(cand.device.index))
    with torch.cuda.device(cand.device):  # the tensors' card
        rc = _lib().gt_merge_topk(
            cand.data_ptr(), count.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, k, cand.shape[1], slice_, _stream(cand),
        )
    _raise_on(rc, "merge_topk")
    merge_topk.launches += 1
    return out_s, out_i


def merge_topk_paths() -> dict[str, int]:
    """Blocks of ``merge_topk`` that took each path (named as in
    ``MERGE_PATHS``) on the current CUDA device since the last call, which
    clears the counts. Waits for the device."""
    torch.cuda.synchronize()
    blocks = (ctypes.c_uint * len(MERGE_PATHS))()
    _raise_on(_lib().gt_merge_topk_paths(blocks), "merge_topk_paths")
    return {name: blocks[i] for i, name in enumerate(MERGE_PATHS) if blocks[i]}


class BinPlan(NamedTuple):
    """How :func:`bin_max` spreads over the card (csrc/topk.cu bin_max_kernel):
    ``units`` of work, each ``(bin0, r_lo, r_hi)``: the ``BIN_W`` bins
    ``bin0 + [0, BIN_W)`` (those below ``n_bins``) over the rows
    ``[r_lo, r_hi)`` of ``n_bins`` items; ``grid`` persistent blocks, block
    b taking units b, b + grid, ...; ``merge``: units share bins (the keys
    are filled with ``INT64_MIN`` and combined by atomicMax) rather than
    each bin's key written once by a plain store; ``slices``: the launches,
    ``(q0, nq)`` over at most 256 queries each."""

    units: tuple
    grid: int
    merge: bool
    slices: tuple


@functools.lru_cache(maxsize=256)
def bin_plan(n_items: int, n_bins: int, b_pad: int, n_sm: int) -> BinPlan:
    """The work plan of :func:`bin_max` over ``n_items`` items in ``n_bins``
    strided bins for ``b_pad`` queries on ``n_sm`` SMs. A unit owns a chunk
    of ``BIN_W`` bins; its rows are split into segments only when the chunks
    are fewer than the SMs, and then into as many as fill one wave (a block
    an SM: the kernel's registers hold the running maxima of 64 bins x 256
    queries). With more chunks than SMs every unit owns its bins' rows and
    the persistent grid takes ceil(chunks / n_sm) rounds; the last round
    holds the remainder."""
    n_chunks = -(-n_bins // BIN_W)
    n_rows = -(-n_items // n_bins)
    n_seg = 1 if n_chunks >= n_sm else max(1, min(n_rows, n_sm // n_chunks))
    units = tuple((c * BIN_W, s * n_rows // n_seg, (s + 1) * n_rows // n_seg)
                  for s in range(n_seg) for c in range(n_chunks))
    slices = tuple((q0, min(_CHUNK_B, b_pad - q0)) for q0 in range(0, b_pad, _CHUNK_B))
    return BinPlan(units, min(len(units), n_sm), n_seg > 1, slices)


@functools.lru_cache(maxsize=64)
def _bin_units(n_items: int, n_bins: int, n_sm: int, device: torch.device) -> torch.Tensor:
    """The plan's units as the kernel reads them, ``[n_units, 3]`` int32 on
    ``device`` (they do not depend on the queries)."""
    plan = bin_plan(n_items, n_bins, _CHUNK_B, n_sm)
    return torch.tensor(plan.units, dtype=torch.int32, device=device)


def _bin_launch(name: str, qp, table, n_items: int, n_bins: int, aff: Affine | None):
    """bin_max (or bin_max_sq with ``aff``) on the card by :func:`bin_plan`:
    one launch a slice of 256 queries, the keys written once (``torch.empty``)
    or merged over an ``INT64_MIN`` fill."""
    b_pad, d_pad = qp.shape
    n_sm = _sm_count(qp.device.index)
    plan = bin_plan(n_items, n_bins, b_pad, n_sm)
    units = _bin_units(n_items, n_bins, n_sm, qp.device)
    keys = (torch.full((b_pad, n_bins), _INT64_MIN, dtype=torch.int64, device=qp.device)
            if plan.merge else torch.empty((b_pad, n_bins), dtype=torch.int64, device=qp.device))
    wrapper = bin_max if aff is None else bin_max_sq
    with torch.cuda.device(qp.device):  # the tensors' card
        for q0, nq in plan.slices:
            common = (keys.data_ptr(), units.data_ptr(), len(plan.units), plan.grid,
                      int(plan.merge), q0, nq, b_pad, d_pad, n_items, table.shape[0], n_bins)
            if aff is None:
                rc = _lib().gt_bin_max(qp.data_ptr(), table.data_ptr(), *common, _stream(qp))
            else:
                rc = _lib().gt_bin_max_sq(qp.data_ptr(), table.data_ptr(), aff.affine.data_ptr(),
                                          aff.qstats.data_ptr(), *common, int(aff.euclidean),
                                          _stream(qp))
            _raise_on(rc, name)
            wrapper.launches += 1
    return keys


def bin_max(qp: torch.Tensor, table: torch.Tensor, n_items: int, n_bins: int) -> torch.Tensor:
    """Each query's maximum key (score descending, index ascending) in each
    of ``n_bins`` strided bins, ``[b_pad, n_bins]`` int64 candidate keys
    (``INT64_MIN`` where a bin holds no item): the PartialReduce step of
    ``jax.lax.approx_max_k`` in gorse_tpu/ops/topk.py dot_topk_approx, in
    one read of the table a launch and without the ``[B, N]`` score
    matrix."""
    if qp.device.type == "cpu":
        return bin_max_plain(qp, table, n_items, n_bins)
    _check_operands(qp, table)
    return _bin_launch("bin_max", qp, table, n_items, n_bins, None)


def bin_max_sq(qp: torch.Tensor, table: torch.Tensor, aff: Affine, n_items: int,
               n_bins: int) -> torch.Tensor:
    """:func:`bin_max` over a uint8 table with the affine epilogue
    (gorse_tpu/ops/topk.py sq_topk_approx)."""
    if qp.device.type == "cpu":
        return bin_max_plain(qp, table, n_items, n_bins, aff)
    _check_operands(qp, table, torch.uint8)
    _check_affine(aff, qp, table)
    return _bin_launch("bin_max_sq", qp, table, n_items, n_bins, aff)


block_max.launches = 0
block_max_sq.launches = 0
bin_max.launches = 0
bin_max_sq.launches = 0
block_seeds.launches = 0
block_topk.launches = 0
block_topk_sq.launches = 0
merge_topk.launches = 0


# ------------------------------------------------------------ entry points


def _pad_queries(queries, prep: PreparedItems, b_pad: int) -> torch.Tensor:
    dev = prep.table.device
    qp = torch.zeros((b_pad, prep.table.shape[1]), dtype=torch.bfloat16, device=dev)
    q = torch.as_tensor(queries).to(dev, torch.float32)
    qp[: q.shape[0], : prep.dim] = q[:, : prep.dim].to(torch.bfloat16)
    return qp


def _empty(b: int, dev):
    return (torch.zeros((b, 0), dtype=torch.float32, device=dev),
            torch.zeros((b, 0), dtype=torch.int32, device=dev))


def kernel_route(n_pad: int, k: int, seeded: bool = True) -> str:
    """The gate of a top-k of ``k`` over ``n_pad`` padded items: "block"
    (k <= n_blocks), "group" (k <= n_pad / 4) or "none"."""
    if not seeded or k * GROUP > n_pad:
        return "none"
    return "block" if k <= n_pad // BLOCK_N else "group"


def _candidates(qp, table, b: int, n_items: int, k_top: int, route: str,
                aff: Affine | None = None):
    """The passes of ``route`` before the merge: ``(cand, count)``."""
    gate = None
    if route != "none":
        groups = route == "group"
        if aff is None:
            maxima = block_max(qp, table, n_items, groups)
        else:
            maxima = block_max_sq(qp, table, aff, n_items, groups)
        if groups:
            gate = block_seeds(maxima[1], b, k_top)._replace(bmax=maxima[0], width=GROUP)
        else:
            gate = block_seeds(maxima, b, k_top)
    if aff is None:
        return block_topk(qp, table, gate, b, n_items, k_top)
    return block_topk_sq(qp, table, aff, gate, b, n_items, k_top)


def _kernel_chain(qp, table, b: int, n_items: int, k_top: int, seeded: bool,
                  aff: Affine | None = None):
    """K4 -> seeds -> K5 (or K6) -> merge on one padded query chunk, gated
    as :func:`kernel_route` says."""
    route = kernel_route(table.shape[0], k_top, seeded)
    cand, count = _candidates(qp, table, b, n_items, k_top, route, aff)
    return merge_topk(cand, count, b, k_top)


def _dot_topk_prepared(queries, prep: PreparedItems, k_top: int, seeded: bool):
    b = queries.shape[0]
    if k_top <= 0:
        return _empty(b, prep.table.device)
    qp = _pad_queries(queries, prep, _round_up(max(b, 1), QUERY_TILE))
    return _kernel_chain(qp, prep.table, b, prep.n_items, k_top, seeded)


def _sq_operands(queries, prep: PreparedSQ, b_pad: int, metric: str):
    """bf16 queries for the dot and the epilogue's operands: qsum and q2
    come from the f32 queries (gorse_tpu/ops/topk.py:342,353,356)."""
    dev = prep.table.device
    qf = torch.zeros((b_pad, prep.table.shape[1]), dtype=torch.float32, device=dev)
    q = torch.as_tensor(queries).to(dev, torch.float32)
    qf[: q.shape[0], : prep.dim] = q[:, : prep.dim]
    qstats = torch.stack([qf.sum(dim=1), (qf * qf).sum(dim=1)]).contiguous()
    return qf.to(torch.bfloat16), Affine(prep.affine, qstats, metric == "euclidean")


def _sq_topk_prepared(queries, prep: PreparedSQ, k_top: int, metric: str):
    b = queries.shape[0]
    if k_top <= 0:
        return _empty(b, prep.table.device)
    qp, aff = _sq_operands(queries, prep, _round_up(max(b, 1), QUERY_TILE), metric)
    return _kernel_chain(qp, prep.table, b, prep.n_items, k_top, True, aff)


def _chunked(fn, queries, *args):
    """``fn`` on chunks of 256 queries, results concatenated."""
    if queries.shape[0] <= _CHUNK_B:
        return fn(queries, *args)
    parts = [fn(queries[lo : lo + _CHUNK_B], *args)
             for lo in range(0, queries.shape[0], _CHUNK_B)]
    return torch.cat([s for s, _ in parts]), torch.cat([i for _, i in parts])


def dot_topk(queries, items, k_top: int = 10, seeded: bool = True, device=None):
    """Top-k by dot product through the CUDA kernels (their plain versions
    on the CPU): ``(scores [B, k_top] f32, indices [B, k_top] int32)``.

    ``items`` is a :class:`PreparedItems` (serving paths: build once) or a
    raw ``[N, d]`` array, prepared on the fly. ``seeded=False`` skips the
    block-maxima pass (the reference's single-pass kernel). Batches run in
    chunks of 256 queries."""
    dev = resolve_device(device)
    if not isinstance(items, PreparedItems):
        items = prepare_items(items, device=dev)
    elif items.table.device != dev:
        raise ValueError(f"items are prepared on {items.table.device}, not {dev}")
    queries = torch.as_tensor(queries).to(dev, torch.float32)
    return _chunked(_dot_topk_prepared, queries, items, k_top, seeded)


def sq_topk(queries, codes, scale=None, minv=None, k_top: int = 10, norms2=None,
            metric: str = "dot", device=None):
    """Top-k over scalar-quantized rows ``v = minv + scale * codes``:
    ``(scores [B, k_top] f32, indices [B, k_top] int32)``.

    A :class:`PreparedSQ` goes through the CUDA kernels with the affine
    epilogue (their plain versions on the CPU), in chunks of 256 queries:
    the dot uses bf16(q), the corrections the f32 q, and euclidean scores
    are ``2 dots - norms2 - q2`` (gorse_tpu/ops/topk.py _block_scores).
    Raw ``(codes, scale, minv)`` arrays take the reference's XLA
    formulation, q in f32 throughout and euclidean
    ``-(q2 - 2 dots + norms2)``: the two routes round differently, so both
    are kept. ``metric``: "dot" | "cosine" (rows normalized at ingest) |
    "euclidean" (needs norms2; larger is closer)."""
    dev = resolve_device(device)
    if isinstance(codes, PreparedSQ):
        if metric == "euclidean" and not codes.has_norms2:
            raise ValueError(
                "sq_topk(metric='euclidean') on a PreparedSQ built without "
                "norms2 — pass norms2 to prepare_sq_items"
            )
        if codes.table.device != dev:
            raise ValueError(f"items are prepared on {codes.table.device}, not {dev}")
        queries = torch.as_tensor(queries).to(dev, torch.float32)
        return _chunked(_sq_topk_prepared, queries, codes, k_top, metric)
    if metric == "euclidean" and norms2 is None:
        raise ValueError("sq_topk(metric='euclidean') requires norms2 (||v||^2 per row)")
    return _sq_topk_xla(queries, codes, scale, minv, k_top, norms2, metric, dev)


# ----------------------------------------------------- the approximate tier

APPROX_TILING = 128  # XLA's reduction tiling for a rank-2 approx_max_k
REF_LANES = 128  # the reference pads the item axis it reduces to a multiple of this


def approx_bins(n: int, k: int, recall_target: float) -> int:
    """L, the number of strided bins ``jax.lax.approx_max_k`` reduces ``n``
    scores a row to before its top k, as XLA's shape rule gives it on every
    platform (``approx_max_k(..., aggregate_to_topk=False).shape[-1]``).
    With M bins the expected recall is about exp((1 - k) / M), so M =
    (1 - k) / log(recall), at least the 128 tiling; L is n cut by the
    largest power of two 2^r with n / 2^r >= M, rounded up to the tiling,
    or n where no halving fits. At most 128 scores are not reduced, and a
    top-1 reduces to the tiling whatever the target. The target is read as
    f32, as the op stores it."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k > n:
        raise ValueError(f"k must be smaller than the size of reduction_dim {n}, got {k}")
    if n <= APPROX_TILING:
        return n
    if k == 1:
        return APPROX_TILING
    target = float(np.float32(recall_target))
    if not 0.0 < target <= 1.0:
        raise ValueError("recall_target should range in (0,1]")
    if target == 1.0:
        return n
    m = min(max(int((1.0 - k) / math.log(target)), APPROX_TILING), n)
    r = (n // m).bit_length() - 1
    if r == 0:
        return n
    return _round_up(-(-n // (1 << r)), APPROX_TILING)


def _approx_chunk(queries, table, n_items: int, k: int, n_bins: int, operands):
    """bin_max (or bin_max_sq) then merge_topk over the bins' keys on one
    chunk of at most 256 queries."""
    b = queries.shape[0]
    qp, aff = operands(queries, _round_up(max(b, 1), QUERY_TILE))
    if aff is None:
        keys = bin_max(qp, table, n_items, n_bins)
    else:
        keys = bin_max_sq(qp, table, aff, n_items, n_bins)
    count = torch.full((qp.shape[0],), n_bins, dtype=torch.int32, device=qp.device)
    return merge_topk(keys, count, b, k)


def dot_topk_approx(queries, items, k_top: int = 10, recall_target: float = 0.99, device=None):
    """Approximate top-k by dot product (gorse_tpu/ops/topk.py
    dot_topk_approx, the serving tier the reference offers beside the exact
    kernels, its HNSW analog): ``(scores [B, k], indices [B, k])`` with k =
    min(k_top, n_items). The items, reduced over the reference's 128-padded
    width, fall into :func:`approx_bins` strided bins; :func:`bin_max` keeps
    each query's best item a bin and :func:`merge_topk` the k best of those,
    lower index first on ties. Where the bins are as many as the items the
    result is exact. Queries are cast to bf16 like the table, in chunks of
    256."""
    dev = resolve_device(device)
    if not isinstance(items, PreparedItems):
        items = prepare_items(items, device=dev)
    elif items.table.device != dev:
        raise ValueError(f"items are prepared on {items.table.device}, not {dev}")
    k = min(k_top, items.n_items)
    n_bins = approx_bins(_round_up(max(items.n_items, REF_LANES), REF_LANES), k, recall_target)
    queries = torch.as_tensor(queries).to(dev, torch.float32)

    def operands(q, b_pad):
        return _pad_queries(q, items, b_pad), None

    return _chunked(_approx_chunk, queries, items.table, items.n_items, k, n_bins, operands)


def sq_topk_approx(queries, prep: PreparedSQ, k_top: int = 10, recall_target: float = 0.99,
                   metric: str = "dot", device=None):
    """Approximate top-k over a scalar-quantized table (gorse_tpu/ops/topk.py
    sq_topk_approx): :func:`dot_topk_approx` with the affine epilogue of
    :func:`sq_topk` (``bin_max_sq``)."""
    if metric == "euclidean" and not prep.has_norms2:
        raise ValueError(
            "sq_topk_approx(metric='euclidean') on a PreparedSQ built "
            "without norms2 — pass norms2 to prepare_sq_items"
        )
    dev = resolve_device(device)
    if prep.table.device != dev:
        raise ValueError(f"items are prepared on {prep.table.device}, not {dev}")
    k = min(k_top, prep.n_items)
    n_bins = approx_bins(_round_up(max(prep.n_items, REF_LANES), REF_LANES), k, recall_target)
    queries = torch.as_tensor(queries).to(dev, torch.float32)

    def operands(q, b_pad):
        return _sq_operands(q, prep, b_pad, metric)

    return _chunked(_approx_chunk, queries, prep.table, prep.n_items, k, n_bins, operands)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, torch.float32)


def _top(scores: torch.Tensor, k_top: int):
    """``jax.lax.top_k``: the k largest, the lower index first on ties."""
    top = torch.sort(scores, dim=1, descending=True, stable=True)
    return top.values[:, :k_top].contiguous(), top.indices[:, :k_top].to(torch.int32)


def _xla_top(q: torch.Tensor, dots: torch.Tensor, norms2, metric: str, k_top: int):
    """The XLA routes' scores, ``dots`` or for euclidean
    ``-(q2 - 2 dots + norms2)`` with q2 from the f32 queries ``q``, and
    their top ``k_top``."""
    if metric == "euclidean":
        q2 = (q * q).sum(dim=1, keepdim=True)
        dots = -(q2 - 2.0 * dots + _f32(norms2, q.device)[None, :])
    return _top(dots, k_top)


def _sq_topk_xla(queries, codes, scale, minv, k_top: int, norms2=None, metric: str = "dot",
                 device=None):
    """gorse_tpu/ops/topk.py _sq_topk_xla: an f32 product with the codes
    (TF32 off), the affine corrections, a stable sort."""
    dev = resolve_device(device)
    q = _f32(queries, dev)
    partial = q @ torch.as_tensor(codes).to(dev).float().T
    dots = partial * _f32(scale, dev)[None, :] + q.sum(dim=1, keepdim=True) * _f32(minv, dev)[None, :]
    return _xla_top(q, dots, norms2, metric, k_top)


def pq_topk(queries, codes, codebooks, norms2, k_top: int, metric: str = "dot", device=None):
    """Top-k over product-quantized rows (gorse_tpu/ops/topk.py pq_topk):
    ``codes`` ``[N, M]`` uint8 index ``codebooks`` ``[M, C, ds]``; the
    decoded rows are rounded to bf16 and scored by an f32 product."""
    dev = resolve_device(device)
    codes = torch.as_tensor(codes).to(dev).long()
    books = _f32(codebooks, dev)
    m = books.shape[0]
    vhat = books[torch.arange(m, device=dev)[None, :], codes]  # [N, M, ds]
    vhat = vhat.reshape(codes.shape[0], -1).to(torch.bfloat16).float()
    q = _f32(queries, dev)
    dots = q @ vhat.T
    return _xla_top(q, dots, norms2, metric, k_top)


def rq_topk(queries, packed, scale, minv, rot, norms2, k_top: int, bits: int, dim: int,
            metric: str = "dot", device=None):
    """Top-k over rotational quantized rows (gorse_tpu/ops/topk.py
    rq_topk): unpack the ``bits``-bit codes, score in the rotated basis
    with the sq affine corrections."""
    dev = resolve_device(device)
    packed = torch.as_tensor(packed).to(dev, torch.uint8)
    per_byte = 8 // bits
    shifts = (torch.arange(per_byte, device=dev, dtype=torch.uint8) * bits)[None, None, :]
    vals = (packed[:, :, None] >> shifts) & ((1 << bits) - 1)
    codes = vals.reshape(packed.shape[0], -1)[:, :dim].float()
    q = _f32(queries, dev)
    rq = q @ _f32(rot, dev).T
    dots = (rq @ codes.T) * _f32(scale, dev)[None, :] + rq.sum(dim=1, keepdim=True) * _f32(minv, dev)[None, :]
    return _xla_top(q, dots, norms2, metric, k_top)


def dot_topk_xla(queries, items, k_top: int, device=None):
    """The f32 route: full f32 scores (``torch.matmul``; TF32 must be off,
    which is PyTorch's default) and a stable sort, lower index first on
    ties like ``jax.lax.top_k``."""
    dev = resolve_device(device)
    dot_topk_xla.uses += 1
    return _top(_f32(queries, dev) @ _f32(items, dev).T, k_top)


dot_topk_xla.uses = 0


def topk_excluding(queries, items, k_top: int, exclude=None, use_kernel: bool = True,
                   device=None, approx_recall: float | None = None):
    """Top-k with per-query exclusion sets (``exclude`` ``[B, E]`` int ids,
    padded with -1): fetch k_top + E, mask the excluded, re-sort stably
    (gorse_tpu/ops/topk.py:943-975). ``approx_recall`` below 1 fetches
    through the approximate tier (:func:`dot_topk_approx`) whatever
    ``use_kernel`` says, as the reference does; otherwise
    ``use_kernel=False`` takes the f32 route, which scores from f32 factors
    only, never a bf16 table."""
    dev = resolve_device(device)
    approx = approx_recall is not None and approx_recall < 1.0
    if not approx and not use_kernel and isinstance(items, PreparedItems):
        raise TypeError("the f32 route takes [N, d] f32 factors, not a bf16 PreparedItems")
    n = items.n_items if isinstance(items, PreparedItems) else items.shape[0]
    e = 0 if exclude is None else exclude.shape[1]
    fetch = min(k_top + e, n)
    if approx:
        s, i = dot_topk_approx(queries, items, fetch, recall_target=approx_recall, device=dev)
    elif use_kernel:
        s, i = dot_topk(queries, items, fetch, device=dev)
    else:
        s, i = dot_topk_xla(queries, items, fetch, device=dev)
    if e == 0:
        return s[:, :k_top], i[:, :k_top]
    ex = torch.as_tensor(exclude).to(dev, torch.int32)
    banned = (i[:, :, None] == ex[:, None, :]).any(dim=-1)
    s = torch.where(banned, NEG_INF, s)
    order = torch.argsort(-s, dim=1, stable=True)[:, :k_top]
    return torch.gather(s, 1, order), torch.gather(i, 1, order)
