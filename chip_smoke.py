#!/usr/bin/env python3
"""Smoke run of gorse_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases 2,2b,...]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda`` or ``CUDA_HOME``) and ``nvidia-smi``. Phases, in order;
any failure ends the run with a non-zero exit code. ``--phases`` runs phase
1 and the phases named (for a short check, or to time another checkout's
package with these measurements), prints their numbers and no result line.

How kernels are held against their plain versions. The top-k kernels score
on the tensor cores, the plain versions by a sequential f32 FMA chain, so
on integer-valued inputs (every partial sum exact) every stage must be
equal, and elsewhere (random normal factors) a score may differ by the
summation-order tolerance (``score_tol``): maxima and candidate scores
within it, lists by ``compare_lists`` (tie-aware: ids equal wherever the
plain score is more than twice the tolerance from its neighbours, the same
set well above the k-th score). Exactly, always: seeds and merges of the
same candidates, each candidate above its seed, at least min(k, n)
candidates a query, and each query's top score equal to the largest of the
kernel's own block maxima.

1. Environment: the card's name and power limit, the torch version, and the
   build of ``gorse_tpu_torch/csrc/topk.cu`` (its bf16 and SQ entries) and
   ``bpr.cu`` (one nvcc each, started together) with its seconds and
   ptxas's register, shared-memory and spill lines for each kernel
   (``bpr_epoch_kernel`` among them).
2. Kernels: every kernel of the serving path (``block_max`` with and
   without its group output, ``block_seeds`` on block and on group maxima,
   ``block_topk`` under the block gate, the group gate and no gate,
   ``merge_topk``) held against its plain PyTorch version on the card, on
   small tie-heavy inputs (exact; one of 128 dimensions over 320 queries)
   and at the serving shape (1M x 64 bf16 items, a 256-user chunk, k = 10
   and the path's k = 100 + widest history; within tolerance). Then each
   kernel's median time (CUDA events), bound, plain time and library time
   (the bf16 ``torch.matmul`` of the same product beside ``block_max``),
   and the whole top-k per chunk, gated (K4 + K5) and ungated (K6),
   against the bound of the top-k itself. ``block_seeds`` is also held
   bit-equal on synthetic maxima that reach each branch of its select
   (``hold_seeds``: constant rows, heavy ties, one 12-bit bin, a
   power-of-two k-th, a k-th on a 24-bit bin's edge, NEG_INF tails, +-0,
   k = 1, n, n + 1, n = 7 and 30,001), with the rows that took each branch,
   as the kernel counted them, in the log. ``merge_topk`` likewise
   (``hold_merge``): bit-equal on synthetic candidate rows that reach each
   path of its rank-split select (ranks past the count, no select, the row
   staged, a long row's boundary bins staged, a bin too large to stage):
   counts from 0 to above k, k = 1, k at, under and over a multiple of the
   slice, ties across slices, all-equal scores, NEG_INF among the live
   keys, b = 1 and b not a multiple of 32. ``merge_topk``'s times here and
   in 2b, 7 and 7c: median and queued ms, bound, plain ms and
   ``torch.topk`` of the same keys.
2b. K6's function where the dispatch sends it (k between n_blocks and
   n_pad / 4): 27,000 x 64 items (the repo's ml-20m catalog) at k = 150 and
   300, and 500,000 x 64 at k = 2048 (the widest fetch on the largest
   catalog that takes the kernels there), held as above, and its two
   routes timed in turn: the old one (no gate) and the group gate, each
   with its launches, candidates per query, plain time, the top-k's bound
   and the library's time; ``block_seeds`` on the group maxima beside
   ``torch.kthvalue`` on the same maxima, its one-read bound and two-read
   floor.
2c. A catalog of 65,536 item blocks (16,777,216 x 64 bf16, made on the
   card): ``dot_topk`` through the kernels against ``dot_topk_plain``.
3. Path: a 1,000,000 x 64 item index and 50,000 users, made from ``--seed``,
   saved in gorse_tpu's index format to a blob store; a 4,096-user shard with
   feedback histories of up to 200 items in a MemoryDataStore;
   ``Worker.pull_models`` + ``Worker.recommend`` on the card, with every
   kernel launched and the f32 route unused; a sample of users' fetched
   lists held against the plain version, and their caches equal to those
   lists after the exclusions; ``GET /api/recommend/...`` through
   ``RestServer`` on 127.0.0.1, equal to the cache.
4. BPR kernels: ``bpr_sweep`` in both modes (sampled, explicit pairs) and
   ``bpr_epoch`` (K1: a whole epoch in one cooperative launch) held against
   their plain PyTorch versions on the card, on small tie-heavy inputs
   (repeated items in a sweep, users with no positives, one item in every
   history; k = 8, 16, 64; f32 and bf16; the epoch over 1, 3 and 5 steps),
   on a wide case (more users than 32 x the most warps the card holds, so
   warps take several 32-user batches; 4,000 items, so staged and unstaged
   rows; k = 64 and 128), on a dense case whose rows collide with
   the first 8 candidates (12 tries: the one-at-a-time draws), and at the
   training shape below (the epoch over 1 and 3 steps). Sampled pos and neg
   (every step's, for the epoch) must be equal; p_new and the cost agree to
   1e-5 relative +
   1e-7 absolute (the dot products sum in another order and expf/log1pf
   differ from torch's by ulps), delta and a one-step epoch's q to that plus
   the most two summation orders of a row's adds can differ (atomics add in
   any order; the epoch also stages the Zipf head in shared memory); over
   several steps, where each step's reordered sums feed the next, p and q
   within ``EPOCH_TOL`` of each table's largest magnitude. The pairs mode
   fed the sampled mode's pairs must give its p_new and delta. Then each
   kernel's median and queued time, bound and plain time (the epoch's bound
   both by the rule and with p, q and delta making a round trip every
   step), the epoch under each ``ablate`` value of the reference's cost
   attribution, and one epoch each of the explicit-pairs path (the
   reference's sharded-fused step on one card) and of K2's entry.
5. Training: ``BPR.fit`` at k = 64 on ``synthetic_cf_access(138000, 27000,
   nnz=2000000, seed=1)`` (the repo's bpr_ml20m_shape_k64) for a few epochs,
   each epoch one launch of ``bpr_epoch``, the first epoch held against its
   plain version on the card (every step's samples equal; both beside an
   f64 evaluation of the plain epoch); examples/s per epoch. Quality:
   ``synthetic://400,300,8,0.08,1`` at k = 8 for 20 epochs reaches NDCG@10
   >= 0.35 and agrees with the fit's plain version on the CPU.
6. Master: feedback rows of the ml-1m-shaped ``synthetic_cf`` in a
   MemoryDataStore; ``Master.load_dataset`` and
   ``train_collaborative_filtering`` (fit_epoch cut to 10: ten launches of
   ``bpr_epoch``) on the card;
   the index saved to a blob store; ``Worker.sync_and_recommend`` of the
   master's meta fills every user's cache; a sample of fetched lists agrees
   with the plain top-k, the caches equal them after the exclusions, and
   ``GET /api/recommend`` equals the cache; each chunk's launches are those
   of the route ``kernel_route`` gives its fetch (the group gate on this
   15-block catalog). The master also syncs its serving items into an sq
   ``MemoryVectorStore``; 16 item queries of that collection at k = 10 and
   at the cache size, 100, go through the SQ kernels and agree with the
   plain version.
7. Vector store: the SQ kernels (``block_max_sq`` with and without groups,
   ``block_topk_sq`` under each gate, with ``block_seeds`` and
   ``merge_topk``) held against their plain versions on the card, exactly
   on small tie-heavy tables (duplicate and constant rows, catalogs not a
   multiple of 256, k > n_blocks, k = n, 128 dimensions), within tolerance
   at 27,000 (k = 150, 300) and 500,000 rows (k = 2048), where both routes
   are also timed, and at bench.py's ``topk_qps_1000k_sq8`` shape (1M x 64
   rows from ``--seed``, a 256-query chunk, k = 10, dot and euclidean);
   their median times (``block_topk_sq`` gated and ungated), bounds, plain
   and library times, and the whole SQ top-k per chunk. Then
   ``MemoryVectorStore.add`` of the 1M rows and 1,024 queries through
   ``query`` (four chunks, each launching the four kernels once; lists
   agree with ``sq_topk_plain``; first-query and warm seconds), and pq
   (8 bits), rq (4 bits), euclidean and cosine sq collections of 100,000
   rows, each through the kernels and agreeing with the plain version.
7c. Top-k above 2048 on the kernel route: a bf16 ``dot_topk`` at 27,000 x
   64, k = 4,096, and an sq ``MemoryVectorStore`` of 100,000 rows queried
   at k = 4,096 and 20,000, each agreeing with the plain version;
   ``merge_topk`` timed at each k.

8. eALS and neighbours: phase 6's ml-1m-shaped feedback, each item with
   1-3 of 18 genres and a 16-float ``embedding`` label. One eALS epoch
   (``ALS.epoch``: the user then the item half, 256-row blocks, 16
   factors) timed by CUDA events, and the card's epochs 1 and 3 held
   against the port's on the CPU from the same factors (``EALS_TOL`` of
   each table's largest magnitude). ``Master.train_collaborative_filtering``
   with ``model = "als"`` (``fit_epoch`` 10): its fit-seconds gauge and
   NDCG@10 (at least 0.35). The worker serves its whole shard from that
   eALS index; ``block_max``, ``block_seeds``, ``block_topk`` and
   ``merge_topk`` each launch. The master's ``update_non_personalized``
   (``popular``, ``latest``), ``update_item_to_item`` (types users, tags,
   auto, embedding; one entry a call) and ``update_user_to_user`` (items),
   each timed on the host clock ending on a synchronise, beside the CUDA-
   event time of its similarity op (the rest is the host's share). Every
   cache held against the same update run by a master on the CPU: the
   non-personalized lists and the digests equal, every entity's neighbour
   list by ``compare_lists`` on distances (IDF within ``(4 L + 16) 2^-24``,
   L the most labels in a row; squared Euclidean within ``(4 d + 16) 2^-24
   (|x_i|^2 + |x_j|^2)``). ``GET /api/recommend/u1`` with the chain
   item-to-item/users then non-personalized/popular equals those caches'
   aggregate.

9. CTR ranker and the master's cycle. The AFM at ``bench.py``
   ``stage_afm``'s shape (``synthetic_ctr`` of 2,000 users and items,
   131,072 samples: 4,050 features, 4 slots; 8 factors, batch 1024, 128
   steps an epoch): its first epoch on the card held against the same epoch
   on the CPU from the same init (``AFM_TOL`` of each table's largest
   magnitude, and the loss), then epochs timed by CUDA events and by the
   host clock ending on a synchronise (padded examples/s, ms a step), the
   kernels of an epoch and their device time from a ``torch.profiler``
   trace; ``tests/test_fm.py``'s accuracy gate on the card (AUC > 0.75).
   Then phase 8's ml-1m data without the embedding label, each user with a
   gender (2), an age (7) and an occupation (21) from the seed;
   ``ranker.type = "fm"`` over the ``collaborative`` candidates, the AFM's
   ``fit_epoch`` cut to 3. One ``Master.run_tasks_once`` on the card: each
   load step's gauge, the CTR dataset's size, the CTR fit's gauge and AUC,
   the memory accounting's seconds, ``collect_garbage`` leaving only the
   two live blobs; one epoch of the master's AFM by CUDA events; a card
   master's one-epoch CTR fit held against a CPU master's on the same rows
   (``AFM_TOL``). ``Worker.sync_and_recommend`` re-ranks the whole shard on
   the card (``block_max``, ``block_seeds``, ``block_topk`` and
   ``merge_topk`` each launch in the CF recall); the ranking step's seconds
   beside its ``batch_predict`` time by CUDA events (the rest is the
   host's share); 16 users' ``recommend`` caches held tie-aware against a
   CPU worker's ranking of the same candidates by the same saved model
   (``RANK_TOL``); ``GET /api/recommend/u1`` equals the cache.

The last three lines of standard output are the kernels' JSON record, the
card's ``name, power.limit`` as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``gorse_tpu_torch`` beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import http.client
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The serving design point of gorse_tpu (bench.py topk stage: d=64,
# batch=256; utils/config.py cache_size=100) at 1M items.
N_ITEMS = 1_000_000
N_USERS = 50_000
DIM = 64
SHARD = 4096
MAX_HISTORY = 200
N_CATEGORIES = 8
SAMPLE_USERS = 32
REST_USERS = 8
REST_REQUESTS = 200

# Published peaks of one H100 SXM (dense): HBM bytes/s and bf16 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12

# block_seeds, block_topk and merge_topk together replace K5 (gated);
# with block_max's group output, or ungated, they replace K6.
REPLACES = {
    "block_max": "gorse_tpu/ops/topk.py:361",
    "block_seeds": "gorse_tpu/ops/topk.py:442",
    "block_topk": "gorse_tpu/ops/topk.py:442",
    "merge_topk": "gorse_tpu/ops/topk.py:442",
}
KERNELS = ("block_max", "block_seeds", "block_topk", "merge_topk")
# K6's function where kernel_route sends it (n_blocks < k <= n_pad / 4),
# as (items, k): the worker's fetch of 100 + history on the repo's ml-20m
# catalog (bench.py:315-320), below and above 256, and the widest kernel
# fetch (logics/cf.py _KERNEL_FETCH_MAX) on the largest catalog that
# still takes this route for it
ROUTE_SHAPES = ((27_000, 150), (27_000, 300), (500_000, 2048))

# BPR: the sampled sweep replaces K2, the pairs sweep K3, bpr_epoch K1 (a
# whole epoch: the sampled sweep's body and the fold each step)
BPR_KERNELS = ("bpr_sweep_sampled", "bpr_sweep_pairs", "bpr_epoch")
BPR_REPLACES = {
    "bpr_sweep_sampled": "gorse_tpu/ops/bpr_kernel.py:285",
    "bpr_sweep_pairs": "gorse_tpu/ops/bpr_kernel.py:206",
    "bpr_epoch": "gorse_tpu/ops/bpr_kernel.py:329",
}
# bpr_epoch over several steps: each step's reordered sums feed the next, so
# p and q are held to this share of each table's largest magnitude (f32: a
# hundred times a step's order bound on the small cases; bf16: one bf16 ulp,
# a payload near a rounding boundary may round the other way)
EPOCH_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8}
EPOCH_STEPS = (1, 3, 5)
# the sweep's candidates drawn ahead of the scan (csrc/bpr.cu MAXC); more
# tries are drawn one at a time, so the dense case asks for more
SAMPLE_AHEAD = 8
DENSE_TRIES = 12
ABLATIONS = ("", "nosample", "samp_nopos", "samp_norej", "nogather", "noscatter")
F32_FLOP_S = 67e12  # f32 outside the tensor cores
BPR_RTOL, BPR_ATOL = 1e-5, 1e-7
LR, REG = 0.05, 0.01
# bench.py bpr_ml20m_shape_k64 (138k x 27k, 2M feedback, k = 64)
TRAIN_USERS, TRAIN_ITEMS, TRAIN_NNZ, TRAIN_SEED, TRAIN_DIM = 138_000, 27_000, 2_000_000, 1, 64
TRAIN_EPOCHS = 4
QUALITY_SPEC, QUALITY_NDCG = "synthetic://400,300,8,0.08,1", 0.35
# bench.py _make_ml1m: 6040 x 3706, rank 16, density 0.045
MASTER_SHAPE = (6040, 3706, 16, 0.045, 0)
MASTER_EPOCHS = 10
MASTER_SAMPLE_USERS = 16
# phase 7: the quantized vector store. bench.py topk_qps_1000k_sq8 (1M x 64
# normal rows, per-row affine uint8 codes, B = 256, k = 10)
SQ_ROWS, SQ_SMALL_ROWS, SQ_QUERIES, SQ_K = 1_000_000, 100_000, 1024, 10
SQ_WARM_REPS = 5
SQ_KERNELS = ("block_max_sq", "block_topk_sq")
# phase 2c: a catalog of 65,536 item blocks (the old grid.y limit + 1)
WIDE_BLOCKS, WIDE_QUERIES, WIDE_K = 65_536, 32, 10
# phase 7c: top-k above 2048 (merge_topk once sorted at most 2048 keys)
WIDE_K_ROWS, WIDE_K_QUERIES, WIDE_KS = 100_000, 32, (4096, 20_000)
# phase 8: eALS and the neighbour recommenders at the ml-1m shape (bench.py
# stage_eals: 16 factors, 256-row solve blocks); 18 genres (ml-1m's), 1-3 an
# item, and a 16-float embedding per item
N_GENRES, GENRES_MAX, EMBED_DIM = 18, 3, 16
EALS_REPS, EALS_HOLD_EPOCHS = 5, (1, 3)
# the card's eALS epochs against the port's on the CPU from the same
# factors: each half-epoch solves the same systems with its sums in another
# order and another Cholesky (cuSOLVER, LAPACK); held to this share of each
# table's largest magnitude after epochs 1 and 3
EALS_TOL = 1e-3
I2I_TYPES = ("users", "tags", "auto", "embedding")
# phase 9: the AFM at bench.py stage_afm's shape (synthetic_ctr of 2,000
# users and items, 131,072 samples; 8 factors, batch 1024: 128 steps an
# epoch), tests/test_fm.py's accuracy gate, then the master's cycle at the
# ml-1m shape with ml-1m's user fields (gender 2, age 7, occupation 21) and
# the fm ranker over the CF candidates, its CTR fit cut to 3 epochs
AFM_SHAPE = {"n_users": 2000, "n_items": 2000, "n_samples": 131_072, "seed": 0}
AFM_K, AFM_BATCH, AFM_REPS = 8, 1024, 5
AFM_GATE_AUC = 0.75
USER_FIELDS = (("gender", 2), ("age", 7), ("occupation", 21))
CTR_EPOCHS = 3
# the card's AFM epoch against the port's on the CPU from the same init
# (drawn on the host): the gather's backward adds by atomics and the sums
# run in another order, and Adam divides each step's rounding by the root
# of the second moment; held to this share of each table's largest magnitude
AFM_TOL = 1e-3
# the worker's fm scores against a CPU batch_predict: a logit sums at most
# 8 x 8 products in another order
RANK_TOL = 2.0**-14
PHASES = ("2", "2b", "2c", "3", "4", "5", "6", "7", "7c", "8", "9")
SQ_REPLACES = {
    "block_max_sq": "gorse_tpu/ops/topk.py:361",
    "block_topk_sq": "gorse_tpu/ops/topk.py:442",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(*parts) -> None:
    print(*parts, flush=True)


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, n: int = 20) -> float:
    """ms a call when ``n`` calls are queued between two CUDA events: the
    card's time with the host's work per call overlapped."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(bytes_moved: float, flops: float, flop_s: float = BF16_FLOP_S) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- tolerance
#
# The score tile sums each dot on the tensor cores, the plain version as a
# sequential f32 FMA chain. Two f32 summation orders of d terms each differ
# from the exact sum by at most (d - 1) 2^-24 sum|terms|, so the two agree
# within d_pad 2^-23 sum_j |q_j| |v_j|, from the same bf16 operands (codes
# for the quantized table). The SQ epilogue carries that through its ops:
#     tol = m (|scale| M (d_pad 2^-23 + 2^-21) + 2^-21 |qsum minv|)
#           [+ 2^-21 (|norms2| + q2) for euclidean]
# with M = sum_j |q_j| code_j and m = 2 for euclidean, 1 for the dot: each
# rounded op of the epilogue, applied to sums that differ, may round to a
# value up to an ulp apart, and four ulps of each magnitude (2^-21) cover
# the ops. Integer-valued inputs have every partial sum exact, so there the
# kernels are held to equality instead.


def _tol_from_mag(mag, d_pad: int, aff, rows, items):
    """Tolerance from ``mag`` = sum_j |q_j| |v_j| (any shape); ``rows`` and
    ``items`` index the queries and items of ``mag``'s entries (same
    shape, or broadcastable) for the SQ epilogue's terms."""
    u = 2.0**-23
    if aff is None:
        return d_pad * u * mag
    scale, minv, n2 = (aff.affine[j][items].abs() for j in range(3))
    qsum, q2 = aff.qstats[0][rows].abs(), aff.qstats[1][rows].abs()
    dot = scale * mag * (d_pad * u + 4 * u) + 4 * u * qsum * minv
    if not aff.euclidean:
        return dot
    return 2.0 * dot + 4 * u * (n2 + q2)


def score_tol(qp, table, aff=None):
    """``[b_pad, n_pad]`` tolerance of every kernel score against its plain
    version (the form above)."""
    import torch

    mag = torch.matmul(qp.float().abs(), table.float().abs().T)
    rows = torch.arange(qp.shape[0], device=qp.device)[:, None]
    items = torch.arange(table.shape[0], device=qp.device)[None, :]
    return _tol_from_mag(mag, qp.shape[1], aff, rows, items)


def tol_at(qp, table, idx, aff=None):
    """The tolerance of the scores of items ``idx`` ``[b, k]`` for the first
    ``b`` queries of ``qp``."""
    import torch

    idx = idx.long()
    mag = torch.einsum("bd,bkd->bk", qp[: idx.shape[0]].float().abs(),
                       table[idx].float().abs())
    rows = torch.arange(idx.shape[0], device=qp.device)[:, None]
    return _tol_from_mag(mag, qp.shape[1], aff, rows, idx)


def compare_lists(what: str, s, i, s_p, i_p, tol, tol_p) -> float:
    """Hold a kernel's top-k lists ``(s, i)`` ``[b, k]`` against the plain
    version's ``(s_p, i_p)``, tie-aware, when each score may differ from
    its plain value by its tolerance (``tol`` for the kernel's item at each
    slot, ``tol_p`` for the plain version's). Per query, with T the largest
    tolerance of its listed items:
    - the same slots are filled; empty slots are NEG_INF with index 0 in both;
    - scores at each slot within T (the j-th largest of values moved by at
      most T each moves by at most T);
    - ids equal at every slot whose plain score is more than 2 T from both
      neighbours (no rounding can reorder it; the last filled slot's lower
      neighbour is unknown, so the next rule holds it);
    - every id whose plain score is more than 2 T above the plain k-th score
      is in the kernel's list, and every id whose kernel score is more than
      T above the plain k-th is in the plain list.
    Raises on the first rule broken; returns the largest |s - s_p| / T."""
    import torch

    from gorse_tpu_torch.ops.topk import NEG_INF

    s, s_p = s.double(), s_p.double()
    i, i_p = i.long(), i_p.long()
    filled, filled_p = s > NEG_INF / 2, s_p > NEG_INF / 2
    check(torch.equal(filled, filled_p), f"{what}: the same slots are filled")
    check(bool((i[~filled] == 0).all() and (i_p[~filled] == 0).all()
               and (s[~filled] == s_p[~filled]).all()), f"{what}: empty slots NEG_INF / 0")
    zero = torch.zeros((), dtype=torch.float64, device=s.device)
    t = torch.maximum(torch.where(filled, tol.double(), zero).amax(1),
                      torch.where(filled, tol_p.double(), zero).amax(1))[:, None]
    err = (s - s_p).abs()
    worst = float((err / t.clamp_min(1e-300))[filled].max()) if bool(filled.any()) else 0.0
    check(bool((err <= t)[filled].all()),
          f"{what}: scores within tolerance (worst {worst:.3g} of it)")
    gap = s_p[:, :-1] - s_p[:, 1:]  # slot j to slot j + 1
    inf = torch.full_like(s_p[:, :1], float("inf"))
    above_ok = torch.cat([inf, gap], 1) > 2 * t
    below_ok = torch.cat([gap, -inf], 1) > 2 * t
    apart = filled_p & above_ok & below_ok
    check(torch.equal(i[apart], i_p[apart]), f"{what}: ids at the slots apart from their neighbours")
    kth = s_p[:, -1:]
    must = filled_p & (s_p > kth + 2 * t)
    known = filled & (s > kth + t)
    for q in range(s.shape[0]):
        check(bool(torch.isin(i_p[q][must[q]], i[q][filled[q]]).all()),
              f"{what}: query {q} keeps every id well above the k-th score")
        check(bool(torch.isin(i[q][known[q]], i_p[q][filled_p[q]]).all()),
              f"{what}: query {q} has no id well above the k-th score that the plain list lacks")
    return worst


# ---------------------------------------------------------------- phase 1


def phase_environment() -> str:
    import torch

    from gorse_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("card:", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0), "count", torch.cuda.device_count())
    t0 = time.perf_counter()
    _build.build(["topk", "bpr"])
    log(f"build_seconds {time.perf_counter() - t0:.2f}")
    for name in ("topk", "bpr"):
        for line in _build.build_log.get(name, "").splitlines():
            entry = re.search(r"Compiling entry function '\w*?\d([a-z][a-z_]*_kernel)(I(\w+?)E)?",
                              line)
            if entry:
                # template arguments: the top-k kernels' item type, the BPR
                # kernels' <sampled, bf16, KPL, vec> flags and widths
                kind = {"h": "<uint8>", "13__nv_bfloat16": "<bf16>"}.get(entry.group(3), "")
                flags = re.search(entry.group(1) + r"I((?:L[bi]\d+E)+)E", line)
                if flags:
                    kind = "<" + ", ".join(
                        ("false", "true")[int(v)] if t == "b" else v
                        for t, v in re.findall(r"L([bi])(\d+)E", flags.group(1))) + ">"
                log(f"  ptxas {name}: {entry.group(1)}{kind}")
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name}:", line.strip())
    return smi


# ---------------------------------------------------------------- data


def make_data(seed: int):
    """Factors, dictionaries and the shard's histories, all from ``seed``."""
    rng = np.random.default_rng(seed)
    item_factors = rng.standard_normal((N_ITEMS, DIM), dtype=np.float32)
    user_factors = rng.standard_normal((N_USERS, DIM), dtype=np.float32)
    lengths = rng.integers(0, MAX_HISTORY + 1, size=SHARD)
    histories = [np.unique(rng.integers(0, N_ITEMS, size=int(n))) for n in lengths]
    return user_factors, item_factors, histories


# ---------------------------------------------------------------- phase 2


def _sorted_live(cand, count):
    import torch

    from gorse_tpu_torch.ops import topk

    live = torch.arange(cand.shape[1], device=cand.device)[None] < count[:, None]
    return torch.where(live, cand, topk._INT64_MIN).sort(dim=1, descending=True).values


def hold_chain(name: str, qp, table, b: int, n: int, k: int, aff=None, exact=False) -> dict:
    """``block_max`` (``_sq`` with ``aff``) with and without its group
    output, ``block_seeds`` on the block and on the group maxima,
    ``block_topk`` (``_sq``) under the block gate, the group gate (where
    4 k <= n_pad) and no gate, and ``merge_topk``, each against its plain
    version on the card. Every gate is the kernels' own: seeds from the
    kernel's maxima, as the route computes them. ``exact`` (integer-valued
    inputs): every stage equal. Otherwise maxima and candidate scores
    within the score tolerance, the seeds and the merge of the kernel's
    candidates equal, the merged lists by ``compare_lists``, and,
    exactly: each candidate beats its seed, each query has at least
    min(k, n) candidates, and on the gated routes its top score is the
    largest of the kernel's own block maxima. Returns the largest absolute
    score difference seen per kernel."""
    import torch

    from gorse_tpu_torch.ops import topk

    sq = "" if aff is None else "_sq"
    nb = table.shape[0] // topk.BLOCK_N

    def maxima(groups):
        if aff is None:
            return topk.block_max(qp, table, n, groups)
        return topk.block_max_sq(qp, table, aff, n, groups)

    def topk_k(gate):
        if aff is None:
            return topk.block_topk(qp, table, gate, b, n, k)
        return topk.block_topk_sq(qp, table, aff, gate, b, n, k)

    bm, gm = maxima(True)
    bm_p, gm_p = topk.block_max_plain(qp, table, n, aff, groups=True)
    check(torch.equal(maxima(False), bm), f"{name}: block_max{sq} with and without groups")
    if exact:
        check(torch.equal(bm, bm_p) and torch.equal(gm, gm_p),
              f"{name}: block_max{sq} (block and group maxima) equals its plain version")
        tol = scores_p = None
    else:
        tol = score_tol(qp, table, aff)
        tol[:, n:] = 0.0  # padded items: NEG_INF on both sides
        share = 0.0  # the largest |kernel - plain| as a share of its tolerance
        for got, want, width in ((bm, bm_p, topk.BLOCK_N), (gm, gm_p, topk.GROUP)):
            t = tol.view(qp.shape[0], -1, width).amax(dim=2)
            check(bool(((got - want).abs() <= t).all()),
                  f"{name}: block_max{sq} maxima over {width} items within tolerance")
            share = max(share, float(((got - want).abs() / t.clamp_min(1e-30)).max()))
        log(f"  {name}: block_max{sq} maxima within tolerance, at most {share:.3g} of it")
        scores_p = topk._scores_plain(qp, table, aff)
    err = {"block_max" + sq: float(max((bm - bm_p).abs().max(), (gm - gm_p).abs().max())),
           "block_seeds": 0.0, "block_topk" + sq: 0.0, "merge_topk": 0.0}
    # per route: the kernels' gate, block_seeds_plain on the same maxima,
    # and the plain chain's own gate (from the plain maxima: the kernels'
    # seeds sit an ulp below the kernels' scores, not the plain ones)
    gates = {"block": (topk.block_seeds(bm, b, k), topk.block_seeds_plain(bm, b, k),
                       topk.block_seeds_plain(bm_p, b, k))}
    if topk.GROUP * k <= table.shape[0]:
        gates["group"] = tuple(
            g._replace(bmax=m, width=topk.GROUP)
            for g, m in ((topk.block_seeds(gm, b, k), bm), (topk.block_seeds_plain(gm, b, k), bm),
                         (topk.block_seeds_plain(gm_p, b, k), bm_p)))
    gates["none"] = (None, None, None)
    for route, (gate, gate_same, gate_p) in gates.items():
        if gate is not None:
            check(torch.equal(gate.seeds, gate_same.seeds)
                  and torch.equal(gate.fired, gate_same.fired),
                  f"{name} {route}: block_seeds equals its plain version")
        cand, count = topk_k(gate)
        cand_p, count_p = topk.block_topk_plain(qp, table, gate_p, b, n, k, aff)
        live, live_p = _sorted_live(cand, count), _sorted_live(cand_p, count_p)
        s, i = topk.merge_topk(cand, count, b, k)
        s_m, i_m = topk.merge_topk_plain(cand, count, b, k)
        check(torch.equal(i, i_m) and torch.equal(s, s_m),
              f"{name} {route}: merge_topk equals its plain version on the kernel's candidates")
        s_p, i_p = topk.merge_topk_plain(cand_p, count_p, b, k)
        if exact:
            check(torch.equal(count, count_p), f"{name} {route}: block_topk{sq} counts")
            width = live_p.shape[1]
            check(torch.equal(live[:, :width], live_p), f"{name} {route}: block_topk{sq} keys")
            check(torch.equal(i, i_p) and torch.equal(s, s_p), f"{name} {route}: merge_topk")
        else:
            c_s, c_i = topk._decode(live[:b])
            filled = live[:b] != topk._INT64_MIN
            seeds = gate.seeds if gate is not None else torch.full_like(c_s[:, 0], topk.NEG_INF)
            check(bool((c_s > seeds[:, None])[filled].all()),
                  f"{name} {route}: every candidate beats the kernel's seed")
            check(bool((count[:b] >= min(k, n)).all()),
                  f"{name} {route}: at least min(k, n) candidates a query")
            want = scores_p[:b].gather(1, c_i.long().clamp_min(0))
            t = tol[:b].gather(1, c_i.long().clamp_min(0))
            diff = (c_s - want).abs()
            check(bool((diff <= t)[filled].all()),
                  f"{name} {route}: block_topk{sq} scores within tolerance")
            if bool(filled.any()):
                err["block_topk" + sq] = max(err["block_topk" + sq], float(diff[filled].max()))
            compare_lists(f"{name} {route}: merged lists", s, i, s_p, i_p,
                          tol[:b].gather(1, i.long()), tol[:b].gather(1, i_p.long()))
            if gate is not None:
                check(torch.equal(s[:, 0], bm[:b].amax(dim=1)),
                      f"{name} {route}: top score equals the largest of the kernel's maxima")
        err["merge_topk"] = max(err["merge_topk"], float((s - s_p).abs().max()))
        log(f"  {name} k={k} {route} gate: {'equal' if exact else 'within tolerance'}; "
            f"candidates per query {int(count[:b].min())}..{int(count[:b].max())} in a buffer "
            f"of {cand.shape[1]}")
        del cand, count, cand_p, count_p, live, live_p
    del bm_p, gm_p
    torch.cuda.empty_cache()
    return err


def hold_lists(what: str, got, want, qp, table, aff=None, exact=False) -> float:
    """A route's ``(scores, ids)`` against the plain version's: equal when
    ``exact``, else ``compare_lists`` with the score tolerance. Returns the
    largest |score difference|."""
    import torch

    (s, i), (s_p, i_p) = got, want
    if exact:
        check(torch.equal(i, i_p) and torch.equal(s, s_p), f"{what}: equal")
    else:
        compare_lists(what, s, i, s_p, i_p, tol_at(qp, table, i, aff), tol_at(qp, table, i_p, aff))
    return float((s - s_p).abs().max()) if s.numel() else 0.0


def hold_kernels(name: str, queries, prep, k: int, exact=False) -> dict:
    """Each kernel against its plain version on the card under every gate
    (hold_chain), then the dot_topk route. Returns the largest absolute
    score difference seen per kernel."""
    import torch

    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    qp = topk._pad_queries(queries, prep, topk._round_up(b, topk.QUERY_TILE))
    err = hold_chain(name, qp, prep.table, b, prep.n_items, k, exact=exact)
    s, i = topk.dot_topk(queries, prep, k, device=prep.table.device)
    s_p, i_p = topk.dot_topk_plain(queries, prep, k)
    hold_lists(f"{name}: dot_topk route", (s, i), (s_p, i_p), qp, prep.table, exact=exact)
    # the plain version itself against an independent f32 product of the
    # bf16-rounded operands (summation order differs: 1e-4 relative)
    qb = queries[:, : prep.dim].to(torch.bfloat16).float()
    rescored = (qb @ prep.table[:, : prep.dim].float().T).gather(1, i_p.long())
    real = s_p > topk.NEG_INF / 2
    check(torch.allclose(rescored[real], s_p[real], rtol=1e-4, atol=1e-4),
          f"{name}: plain scores equal an f32 product to 1e-4")
    return err


def small_cases(dev):
    """Tie-heavy shapes, integer-valued (every partial sum exact, so held
    equal): integer factors, all-equal scores, one hot block, and 128
    dimensions over 320 queries."""
    import torch

    from gorse_tpu_torch.ops import topk

    rng = np.random.default_rng(7)
    cases = []
    q = rng.integers(-2, 3, size=(40, 16)).astype(np.float32)
    items = rng.integers(-2, 3, size=(3000, 16)).astype(np.float32)
    cases.append(("integer", q, items, 20))
    q = np.ones((4, 8), np.float32)
    items = np.repeat(np.eye(8, dtype=np.float32), 40, axis=0)  # every score 1
    cases.append(("equal", q, items, 5))
    items = (rng.integers(-4, 5, size=(8192, 16)) / 256).astype(np.float32)
    items[2048:2048 + 12] = 4.0  # one hot block, all tied
    cases.append(("hot_block", np.ones((3, 16), np.float32), items, 10))
    # 128 padded dimensions (two passes of the tile) and 320 queries (two
    # launches of at most 256)
    q = rng.integers(-2, 3, size=(300, 100)).astype(np.float32)
    items = rng.integers(-2, 3, size=(3000, 100)).astype(np.float32)
    cases.append(("wide", q, items, 20))
    return [
        (name, torch.as_tensor(q, device=dev), topk.prepare_items(items, device=dev), k)
        for name, q, items, k in cases
    ]


def seed_rows(kind: str, b: int, n: int, k: int, gen, dev):
    """[b, n] f32 maxima of one kind, made on the card from ``gen``."""
    import torch

    from gorse_tpu_torch.ops import topk

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def shuffled(rows):
        order = torch.rand(rows.shape, generator=gen, device=dev).argsort(dim=1)
        return rows.gather(1, order)

    if kind == "random":  # the maxima of 4 normal scores of scale 8
        return (torch.randn((b, n, 4), generator=gen, device=dev) * 8).amax(2)
    if kind == "constant":
        return torch.full((b, n), 1.5, device=dev)
    if kind == "ties":  # three values: the boundary value repeated n / 3 times
        vals = torch.tensor([0.5, 3.0, 7.0], device=dev)
        return vals[torch.randint(0, 3, (b, n), generator=gen, device=dev)]
    if kind == "one_bin":  # every key in one 12-bit bin (1 <= x < 1.125)
        return uniform(1.0, 1.12, (b, n))
    if kind == "pow2":  # the k-th largest is exactly 16.0, its bin's lower edge
        return shuffled(torch.cat([uniform(17.0, 31.0, (b, k - 1)),
                                   torch.full((b, 1), 16.0, device=dev),
                                   uniform(-16.0, 15.5, (b, n - k))], 1))
    if kind == "edge24":  # every key in one 12-bit bin, the k-th on a 24-bit bin's lower edge
        v = 1.0 + 256 * 2.0**-23
        return shuffled(torch.cat([uniform(1.01, 1.12, (b, k - 1)),
                                   torch.full((b, 1), v, device=dev),
                                   uniform(1.0, v, (b, n - k))], 1))
    if kind == "neg_inf_tail":  # the groups past the catalog
        rows = torch.randn((b, n), generator=gen, device=dev) * 8
        rows[:, n - n // 4 :] = topk.NEG_INF
        return rows
    if kind == "signed_zeros":  # the k-th largest and a 16th of the row are +0.0 or -0.0
        zeros = torch.where(torch.rand((b, n // 16), generator=gen, device=dev) < 0.5,
                            torch.tensor(0.0, device=dev), torch.tensor(-0.0, device=dev))
        return shuffled(torch.cat([uniform(1.0, 2.0, (b, k - 1)), zeros,
                                   -uniform(1.0, 2.0, (b, n - k + 1 - n // 16))], 1))
    raise KeyError(kind)


SEED_KINDS = ("random", "constant", "ties", "one_bin", "pow2", "edge24", "neg_inf_tail",
              "signed_zeros")
# block_seeds' two shapes on the main path (n maxima a query, k): the block
# gate at 1M items (3,907 blocks, k = 100 + the widest history) and the group
# gate at 500k items (125,056 groups, the widest kernel fetch)
SEED_SHAPES = ((3907, 298), (125_056, 2048))


def hold_seeds(dev) -> dict:
    """``block_seeds`` on the card against ``block_seeds_plain``, exactly
    (seeds bit-equal, fired equal), on 256 queries of each SEED_KINDS kind at
    each SEED_SHAPES shape, then at k = 1, k = n and k = n + 1 on the random
    rows, on 13 rows of 7 maxima and on 256 rows of 30,001 (rows that start
    unaligned). Logs the rows that took each branch of the select on each
    input, as the kernel counted them (``block_seeds_branches``); fails
    unless every branch was reached. Returns those counts by input."""
    import torch

    from gorse_tpu_torch.ops import topk

    gen = torch.Generator(device=dev).manual_seed(11)
    b = 256
    seen, out = set(), {}
    topk.block_seeds_branches()  # clears the kernel's counts

    def hold(what, rows, k):
        got = topk.block_seeds(rows, rows.shape[0], k)
        branches = topk.block_seeds_branches()
        want = topk.block_seeds_plain(rows, rows.shape[0], k)
        check(torch.equal(got.seeds.view(torch.int32), want.seeds.view(torch.int32))
              and torch.equal(got.fired, want.fired),
              f"block_seeds {what}: seeds bit-equal and fired equal to the plain version")
        check(sum(branches.values()) == rows.shape[0], f"block_seeds {what}: a branch a row")
        seen.update(branches)
        out[what] = branches

    for n, k in SEED_SHAPES:
        for kind in SEED_KINDS:
            hold(f"{kind} n={n} k={k}", seed_rows(kind, b, n, k, gen, dev), k)
        rows = seed_rows("random", b, n, k, gen, dev)
        for kk in (1, n, n + 1):
            hold(f"random n={n} k={kk}", rows, kk)
        del rows
    hold("random n=7 k=3", seed_rows("random", 13, 7, 3, gen, dev), 3)
    hold("random n=30001 k=2048", seed_rows("random", b, 30_001, 2048, gen, dev), 2048)
    torch.cuda.empty_cache()
    check(seen == set(topk.SEED_BRANCHES), f"block_seeds holds reach every branch: {sorted(seen)}")
    log("  block_seeds equals its plain version (seeds bit-equal, fired equal); branches by "
        "input: " + json.dumps(out))
    return out


# merge_topk's holds: (what, b, k, the counts cycled over the b rows, the
# scores). Every row holds count unique keys, then junk to its width (the
# largest count + 1: odd widths start every other row unaligned). They
# reach each path of the kernel: ranks past the count, no select, the row
# staged, a long row's boundary bins staged, a bin too large to stage.
MERGE_CASES = (
    ("main path", 256, 298, (0, 1, 297, 298, 299, 400, 600), "normal"),
    ("group gate", 256, 2048, (2048, 2100, 2200, 2047), "normal"),
    ("k=1", 33, 1, (1, 2, 50, 0), "normal"),
    ("k=1 long", 1, 1, (5000,), "normal"),
    ("b=1 k=S-1", 1, 1023, (1523,), "normal"),
    ("b=2 k=S", 2, 1024, (1524, 1024), "normal"),
    ("b=1 k=S+1", 1, 1025, (1525,), "normal"),
    ("b=1 k=2S", 1, 2048, (2548,), "neg_inf"),
    ("b=256 k=S-1", 256, 4095, (4795, 4095, 2000), "normal"),
    ("b=256 k=S", 256, 4096, (4796,), "normal"),
    ("b=256 k=S+1", 256, 4097, (4797, 4096), "normal"),
    ("b=256 k=2S", 256, 8192, (8892,), "normal"),
    ("b=256 k=4S", 256, 16_384, (17_084,), "normal"),
    ("wide k", 32, 20_000, (20_800, 20_001, 20_000, 19_000, 0), "normal"),
    ("ties across slices", 3, 9000, (12_000,), "five"),
    ("two scores", 5, 3000, (10_000,), "two"),
    ("all equal long", 7, 3000, (10_000, 3000), "equal"),
    ("all equal staged", 7, 100, (1000,), "equal"),
    ("NEG_INF among the live", 40, 500, (800, 600, 300, 499), "neg_inf"),
)


def merge_rows(b: int, counts, kind: str, gen, dev):
    """(cand [b, width] int64, count [b] int32) for a merge_topk hold, made
    on the card from ``gen``."""
    import torch

    from gorse_tpu_torch.ops import topk

    count = torch.tensor([counts[q % len(counts)] for q in range(b)], dtype=torch.int32,
                         device=dev)
    width = max(counts) + 1
    levels = {"five": [-1.0, 0.25, 0.5, 3.0, 7.0], "two": [0.5, 2.0], "equal": [1.5]}
    if kind in levels:
        vals = torch.tensor(levels[kind], device=dev)
        scores = vals[torch.randint(0, len(vals), (b, width), generator=gen, device=dev)]
    else:
        scores = torch.randn((b, width), generator=gen, device=dev) * 4
        if kind == "neg_inf":
            scores[torch.rand((b, width), generator=gen, device=dev) < 0.3] = topk.NEG_INF
    ids = torch.rand((b, width), generator=gen, device=dev).argsort(dim=1) * 7 + 3  # unique
    junk = torch.randint(-2**62, 2**62, (b, width), generator=gen, device=dev)
    live = torch.arange(width, device=dev)[None] < count[:, None]
    return torch.where(live, topk._keys(scores, ids), junk).contiguous(), count


def hold_merge(dev) -> dict:
    """``merge_topk`` on the card against ``merge_topk_plain``, exactly
    (scores bit-equal, ids equal), on the MERGE_CASES rows. Logs each
    input's slice and the blocks that took each path, as the kernel counted
    them (``merge_topk_paths``); fails unless every path was reached.
    Returns those counts by input."""
    import torch

    from gorse_tpu_torch.ops import topk

    gen = torch.Generator(device=dev).manual_seed(12)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    seen, out = set(), {}
    topk.merge_topk_paths()  # clears the kernel's counts
    for what, b, k, counts, kind in MERGE_CASES:
        cand, count = merge_rows(b, counts, kind, gen, dev)
        s, i = topk.merge_topk(cand, count, b, k)
        paths = topk.merge_topk_paths()
        s_p, i_p = topk.merge_topk_plain(cand, count, b, k)
        check(torch.equal(s.view(torch.int32), s_p.view(torch.int32)) and torch.equal(i, i_p),
              f"merge_topk {what}: scores bit-equal and ids equal to the plain version")
        slice_ = topk.merge_slice(b, k, n_sm)
        check(sum(paths.values()) == b * -(-k // slice_), f"merge_topk {what}: a path a block")
        seen.update(paths)
        out[f"{what} (b={b}, k={k}, slice={slice_})"] = paths
        del cand, count
    torch.cuda.empty_cache()
    check(seen == set(topk.MERGE_PATHS), f"merge_topk holds reach every path: {sorted(seen)}")
    log("  merge_topk equals its plain version (bit-equal); blocks by path and input: "
        + json.dumps(out))
    return out


def merge_timing(cand, count, b: int, k: int, reps: int = 20) -> dict:
    """``merge_topk`` on these candidates: median ms, queued ms, plain ms,
    ``torch.topk`` of the same keys, its bound (the live keys read once, the
    output written once), candidates per query and the slice."""
    import torch

    from gorse_tpu_torch.ops import topk

    live = torch.arange(cand.shape[1], device=cand.device)[None] < count[:, None]
    keys = torch.where(live, cand, topk._INT64_MIN)[:b]
    n_sm = torch.cuda.get_device_properties(cand.device).multi_processor_count
    bms, by = bound(int(count[:b].sum()) * 8 + b * 4 + b * k * 8, 0.0)
    return dict(
        ms=median_ms(lambda: topk.merge_topk(cand, count, b, k), reps),
        queued_ms=queued_ms(lambda: topk.merge_topk(cand, count, b, k)),
        plain_ms=median_ms(lambda: topk.merge_topk_plain(cand, count, b, k), 3),
        library_ms=(median_ms(lambda: torch.topk(keys, k, dim=1), reps)
                    if keys.shape[1] >= k else None),
        bound_ms=bms, bound_by=by, candidates=[int(count[:b].min()), int(count[:b].max())],
        slice=topk.merge_slice(b, k, n_sm),
    )


def time_kernels(queries, prep, k: int) -> dict:
    """Median times, bounds, plain and library times of every kernel at one
    shape (gated block_topk for the main path, ungated beside it), and of
    the whole top-k, gated and ungated, against the top-k's own bound."""
    import torch

    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    qp = topk._pad_queries(queries, prep, topk._round_up(b, topk.QUERY_TILE))
    b_pad, d_pad = qp.shape
    table, n, nb = prep.table, prep.n_items, prep.table.shape[0] // topk.BLOCK_N
    q_bytes, bmax_bytes = qp.numel() * 2, b_pad * nb * 4
    out = {}

    bm = topk.block_max(qp, table, n)
    ms = median_ms(lambda: topk.block_max(qp, table, n), 20)
    plain = median_ms(lambda: topk.block_max_plain(qp, table, n), 3)
    bms, by = bound(table.numel() * 2 + q_bytes + bmax_bytes, 2.0 * b * n * prep.dim)
    # no call computes block maxima; the bf16 product of the same operands
    # alone is the yardstick of the scoring pass
    matmul = median_ms(lambda: torch.matmul(qp, table.T), 20)
    out["block_max"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                            matmul_ms=matmul)

    gate = topk.block_seeds(bm, b, k)
    ms = median_ms(lambda: topk.block_seeds(bm, b, k), 20)
    plain = median_ms(lambda: topk.block_seeds_plain(bm, b, k), 3)
    lib = None  # the k-th largest block maximum: no seed when k > n_blocks
    if k <= nb:
        lib = median_ms(lambda: torch.kthvalue(bm[:b], nb - k + 1, dim=1), 20)
    bms, by = bound(b * nb * 4 + b * 8, 0.0)
    out["block_seeds"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                              queued_ms=queued_ms(lambda: topk.block_seeds(bm, b, k)))

    # the top-k itself: each table item and query read once, the k results
    # written once, every dot on bf16 tensor cores
    lib_topk = median_ms(lambda: torch.topk(torch.matmul(qp, table.T)[:b, :n], k, dim=1), 10)
    fn_ms, fn_by = bound(table.numel() * 2 + q_bytes + b * k * 8, 2.0 * b * n * prep.dim)
    for gated in (True, False):
        g = gate if gated else None
        cand, count = topk.block_topk(qp, table, g, b, n, k)
        ms = median_ms(lambda: topk.block_topk(qp, table, g, b, n, k), 10)
        plain = median_ms(lambda: topk.block_topk_plain(qp, table, g, b, n, k), 3)
        if gated:
            fire = bm[:b] > gate.seeds[:, None]
        else:
            fire = torch.ones((b, nb), dtype=torch.bool, device=qp.device)
        pairs, blocks = int(fire.sum()), int(fire.any(0).sum())
        cand_bytes = int(count.sum()) * 8 + b_pad * 4
        bms, by = bound(
            blocks * topk.BLOCK_N * d_pad * 2 + q_bytes + (bmax_bytes + b * 4 if gated else 0)
            + cand_bytes,
            2.0 * pairs * topk.BLOCK_N * prep.dim,
        )
        suffix = "" if gated else "_ungated"
        out["block_topk" + suffix] = dict(
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib_topk,
            fired_pairs=pairs, candidates=int(count.sum()), buffer_bytes=cand.numel() * 8,
        )
        out["merge_topk" + suffix] = merge = merge_timing(cand, count, b, k)
        m_ms, m_plain = merge["ms"], merge["plain_ms"]
        del cand, count
        torch.cuda.empty_cache()
        first = ("block_max", "block_seeds") if gated else ()
        out["topk" + ("_gated" if gated else "_ungated")] = dict(
            ms=sum(out[x]["ms"] for x in first) + ms + m_ms,
            plain_ms=sum(out[x]["plain_ms"] for x in first) + plain + m_plain,
            bound_ms=fn_ms, bound_by=fn_by, library_ms=lib_topk,
            candidate_bytes=cand_bytes - b_pad * 4,
        )
    return out


def plain_chain(qp, table, b: int, n: int, k: int, route: str, aff=None):
    """``route``'s passes and the merge by the plain versions:
    ``(scores, ids, count)``."""
    from gorse_tpu_torch.ops import topk

    gate = None
    if route != "none":
        bm, gm = topk.block_max_plain(qp, table, n, aff, groups=True)
        if route == "group":
            gate = topk.block_seeds_plain(gm, b, k)._replace(bmax=bm, width=topk.GROUP)
        else:
            gate = topk.block_seeds_plain(bm, b, k)
    cand, count = topk.block_topk_plain(qp, table, gate, b, n, k, aff)
    return (*topk.merge_topk_plain(cand, count, b, k), count)


def sq_library(qp, prep, aff, b: int, k: int):
    """The library's SQ top-k: a bf16 ``torch.matmul`` over the table
    dequantized to bf16 once (the euclidean epilogue after it), then
    ``torch.topk``."""
    import torch

    n = prep.n_items
    scale, minv, n2 = aff.affine[0, :n], aff.affine[1, :n], aff.affine[2, :n]
    vhat = (minv[:, None] + scale[:, None] * prep.table[:n].float()).to(torch.bfloat16)

    def call():
        dots = torch.matmul(qp[:b], vhat.T)
        if aff.euclidean:
            dots = 2.0 * dots.float() - n2 - aff.qstats[1, :b][:, None]
        return torch.topk(dots, k, dim=1)

    return call


def time_routes(queries, prep, k: int, metric: str | None = None) -> dict:
    """K6's function at one shape by its two routes, in turn: the old one
    (no gate: every block fires, then the merge of every candidate) and the
    new one (the group gate); the SQ kernels with ``metric``. Per route:
    the chain's median ms (its host read of the fired counts included),
    plain ms, launches of one chunk and candidates per query (min, max),
    its lists held against the plain version's (``compare_lists``); the
    top-k's own bound and the library's ``torch.matmul`` + ``torch.topk``
    (bf16; for SQ over the dequantized table) beside them; and the new
    route's stages one by one, with ``block_max`` without groups for
    comparison and ``merge_timing`` for the merge."""
    import torch

    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    b_pad = topk._round_up(b, topk.QUERY_TILE)
    table, n = prep.table, prep.n_items
    if metric is None:
        qp, aff = topk._pad_queries(queries, prep, b_pad), None
        table_bytes = table.numel() * 2
        lib = median_ms(lambda: torch.topk(torch.matmul(qp, table.T)[:b, :n], k, dim=1), 10)

        def maxima(groups=False):
            return topk.block_max(qp, table, n, groups)

        def candidates(gate):
            return topk.block_topk(qp, table, gate, b, n, k)
    else:
        qp, aff = topk._sq_operands(queries, prep, b_pad, metric)
        table_bytes = table.numel() + n * (12 if aff.euclidean else 8)
        lib = median_ms(sq_library(qp, prep, aff, b, k), 10)

        def maxima(groups=False):
            return topk.block_max_sq(qp, table, aff, n, groups)

        def candidates(gate):
            return topk.block_topk_sq(qp, table, aff, gate, b, n, k)
    check(topk.kernel_route(table.shape[0], k) == "group", f"{n} items, k = {k}: the group gate")
    fn_ms, fn_by = bound(table_bytes + qp.numel() * 2 + b * k * 8, 2.0 * b * n * prep.dim)
    out, lists = {}, []
    for label, route in (("old", "none"), ("new", "group")):
        def chain():
            cand, count = topk._candidates(qp, table, b, n, k, route, aff)
            return (*topk.merge_topk(cand, count, b, k), count)

        wrappers = zero_counts()
        s, i, count = chain()
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        s_p, i_p, _ = plain_chain(qp, table, b, n, k, route, aff)
        hold_lists(f"{n} items k={k} {route}", (s, i), (s_p, i_p), qp, table, aff)
        lists.append((s, i))
        out[label] = dict(
            route=route, ms=median_ms(chain, 10),
            plain_ms=median_ms(lambda: plain_chain(qp, table, b, n, k, route, aff), 3),
            bound_ms=fn_ms, bound_by=fn_by, library_ms=lib, launches=launches,
            candidates=[int(count[:b].min()), int(count[:b].max())],
        )
        torch.cuda.empty_cache()
    # both routes score with the one tile: the same lists, exactly
    check(all(torch.equal(x, y) for x, y in zip(*lists)), "both routes give the same lists")
    bm, gm = maxima(True)
    gate = topk.block_seeds(gm, b, k)._replace(bmax=bm, width=topk.GROUP)
    cand, count = candidates(gate)
    n_groups = gm.shape[1]
    out["new"]["stages_ms"] = dict(
        block_max_groups=median_ms(lambda: maxima(True), 10),
        block_max=median_ms(maxima, 10),
        block_seeds=median_ms(lambda: topk.block_seeds(gm, b, k), 10),
        block_topk=median_ms(lambda: candidates(gate), 10),
    )
    out["new"]["merge"] = merge_timing(cand, count, b, k, 10)
    # block_seeds' yardsticks: the k-th largest group maximum by one library
    # call (no fired count), one read of the group maxima (the bound) and
    # two (the floor of a histogram pass and a pass for the boundary bin)
    seeds_bytes = b * n_groups * 4 + b * 8
    out["new"]["seeds_yardsticks"] = dict(
        queued_ms=queued_ms(lambda: topk.block_seeds(gm, b, k)),
        kthvalue_ms=median_ms(lambda: torch.kthvalue(gm[:b], n_groups - k + 1, dim=1), 10),
        bound_ms=bound(seeds_bytes, 0.0)[0], two_reads_ms=bound(2 * seeds_bytes, 0.0)[0],
    )
    out["new"]["fired_groups"] = [int(gate.fired.min()), int(gate.fired.max())]
    return out


def phase_routes(dev, seed: int) -> tuple[dict, dict]:
    """K6's function at ROUTE_SHAPES: every kernel held under every gate,
    then the two routes timed. Returns (errors, timings by "items x k")."""
    import torch

    from gorse_tpu_torch.ops import topk

    rng = np.random.default_rng(seed + 3)
    queries = torch.as_tensor(rng.standard_normal((256, DIM), dtype=np.float32), device=dev)
    errors, out, preps = {}, {}, {}
    for n, k in ROUTE_SHAPES:
        if n not in preps:
            items = rng.standard_normal((n, DIM), dtype=np.float32)
            preps = {n: topk.prepare_items(torch.as_tensor(items, device=dev), device=dev)}
        for key, v in hold_kernels(f"routes{n}", queries, preps[n], k).items():
            errors[key] = max(errors.get(key, 0.0), v)
        out[f"{n}x{k}"] = rows = time_routes(queries, preps[n], k)
        for label, row in rows.items():
            log(f"  time {n} items k={k} {label} route: " + json.dumps(row))
    return errors, out


def phase_kernels(user_factors, item_factors, histories, dev):
    """Returns (prep, errors, timings, main-path k)."""
    import torch

    from gorse_tpu_torch.ops import topk

    errors: dict[str, float] = {}

    def merge_err(e):
        for key, v in e.items():
            errors[key] = max(errors.get(key, 0.0), v)

    for name, q, prep, k in small_cases(dev):
        merge_err(hold_kernels(name, q, prep, k, exact=True))
    hold_seeds(dev)
    hold_merge(dev)

    prep = topk.prepare_items(torch.as_tensor(item_factors, device=dev), device=dev)
    chunk = torch.as_tensor(user_factors[:256], device=dev)
    widest = max(len(h) for h in histories[:256])
    k_path = min(100 + widest, N_ITEMS)
    for k in (10, k_path):
        merge_err(hold_kernels(f"serving{k}", chunk, prep, k))
    torch.cuda.empty_cache()
    timings = {k: time_kernels(chunk, prep, k) for k in (10, k_path)}
    torch.cuda.empty_cache()
    for k, rows in timings.items():
        for name, row in rows.items():
            log(f"  time k={k} {name}: " + json.dumps(row))
    return prep, errors, timings, k_path


# ---------------------------------------------------------------- phase 3


def phase_path(user_factors, item_factors, histories, dev, seed: int) -> dict:
    import torch

    from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.serve.rest import RestServer
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.types import Feedback, User
    from gorse_tpu_torch.utils.config import Config

    result = {}
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        item_names = [f"i{i}" for i in range(N_ITEMS)]
        user_names = [f"u{u}" for u in range(N_USERS)]
        t0 = time.perf_counter()
        index = MatrixFactorizationIndex.from_numpy(
            user_factors, item_factors,
            {"names": user_names, "freqs": [1] * N_USERS},
            {"names": item_names, "freqs": [1] * N_ITEMS},
            [[f"c{i % N_CATEGORIES}"] for i in range(N_ITEMS)],
            timestamp=float(seed), device=dev,
        )
        blobs = BlobStore(Path(tmp) / "blobs")
        model_id = blobs.new_model_id()
        index.save(blobs.create(model_id))
        del index
        torch.cuda.empty_cache()
        result["index_save_s"] = time.perf_counter() - t0

        shard = user_names[:SHARD]
        data, cache = MemoryDataStore(), MemoryCacheStore()
        data.insert_users(User(u) for u in shard)
        now = time.time()
        data.insert_feedback(
            Feedback("like" if j % 2 else "read", u, item_names[j], 1.0, now - 3600.0)
            for u, hist in zip(shard, histories) for j in hist.tolist()
        )
        cfg = Config()
        cfg.recommend.collaborative.type = "mf"
        cfg.recommend.ranker.recommenders = ["collaborative"]

        worker = Worker(cfg, data, cache, blobs)
        t0 = time.perf_counter()
        worker.pull_models(model_id)
        torch.cuda.synchronize()
        result["pull_models_s"] = time.perf_counter() - t0
        check(worker.cf_index is not None and worker.cf_index.device.type == "cuda",
              "the worker loaded the index onto the card")

        # ---- the main path, with every launch count set to 0 just before
        wrappers = [getattr(topk, name) for name in KERNELS]
        for wrapper in wrappers:
            wrapper.launches = 0
        topk.dot_topk_xla.uses = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refreshed = worker.recommend(shard)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        f32_uses = topk.dot_topk_xla.uses
        # ----
        chunks = -(-SHARD // MatrixFactorizationIndex._SEARCH_CHUNK)
        log("  path launches:", json.dumps(launches), "f32 route uses:", f32_uses)
        check(refreshed == SHARD, f"recommend refreshed {refreshed} of {SHARD} users")
        check(all(v == chunks for v in launches.values()),
              f"every kernel launched once per chunk ({chunks} chunks)")
        check(f32_uses == 0, "the shard stayed on the kernel route")
        step = re.search(
            r'worker_offline_recommend_step_seconds\{step="collaborative_recommend"\} (\S+)',
            worker.metrics.render(),
        )
        cf_seconds = float(step.group(1))
        result.update(
            users=SHARD, chunks=chunks, recommend_s=wall, users_per_s=SHARD / wall,
            cf_step_s=cf_seconds, launches=launches,
        )
        # each 256-user chunk's search_users alone, histories gathered first
        # as the worker does (its results land on the host: host clock)
        chunk_ms = []
        size = MatrixFactorizationIndex._SEARCH_CHUNK
        for lo in range(0, SHARD, size):
            users = shard[lo : lo + size]
            exclude = [[fb.item_id for fb in data.get_user_feedback(u)] for u in users]
            t0 = time.perf_counter()
            worker.cf_index.search_users(users, cfg.recommend.cache_size, exclude)
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        result["ms_per_chunk"] = statistics.median(chunk_ms)

        # ---- the output: shape, finiteness, order, and a sample against
        # the plain version on the card: the kernels' fetched lists held
        # tie-aware, then the cache equal to the kernels' list after the
        # user's exclusions (the worker's chunk fetched a prefix of it)
        cf_index = worker.cf_index
        for u in shard:
            scores = cache.search_scores(ck.COLLABORATIVE, u)
            check(len(scores) == cfg.recommend.cache_size, f"{u}: a full list")
            vals = np.array([s.score for s in scores])
            check(bool(np.isfinite(vals).all()) and bool((np.diff(vals) <= 0).all()),
                  f"{u}: finite descending scores")
        rng = np.random.default_rng(seed + 1)
        sample = sorted(rng.choice(SHARD, size=SAMPLE_USERS, replace=False).tolist())
        q = torch.as_tensor(user_factors[sample], device=dev)
        fetch = cfg.recommend.cache_size + MAX_HISTORY
        items = cf_index._prepared_items
        got = topk.dot_topk(q, items, fetch, device=dev)
        qp = topk._pad_queries(q, items, topk._round_up(SAMPLE_USERS, topk.QUERY_TILE))
        hold_lists("sampled users' fetched lists", got, topk.dot_topk_plain(q, items, fetch), qp,
                   items.table)
        s_k, i_k = got[0].cpu().numpy(), got[1].cpu().numpy()
        for row, u_idx in enumerate(sample):
            banned = set(histories[u_idx].tolist())
            want = [(item_names[j], float(s)) for s, j in zip(s_k[row], i_k[row])
                    if j not in banned][: cfg.recommend.cache_size]
            got = [(s.id, s.score) for s in cache.search_scores(ck.COLLABORATIVE, shard[u_idx])]
            check(got == want, f"{shard[u_idx]}: cache equals the kernels' list after exclusions")
        log(f"  {SAMPLE_USERS} sampled users agree with the plain version on the card")

        # ---- REST on 127.0.0.1
        server = RestServer(cfg, data, cache)
        httpd = server.serve("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)

            def get(path):
                conn.request("GET", path)
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())

            n = cfg.server.default_n
            for u in shard[:REST_USERS]:
                status, body = get(f"/api/recommend/{u}")
                want = [s.id for s in cache.search_scores(ck.COLLABORATIVE, u)][:n]
                check(status == 200 and body == want, f"GET /api/recommend/{u} equals the cache")
                status, body = get(f"/api/recommend/{u}/c3")
                want = [s.id for s in cache.search_scores(ck.COLLABORATIVE, u, ["c3"])][:n]
                check(status == 200 and body == want, f"GET /api/recommend/{u}/c3 equals the cache")
            check(get("/api/health/ready") == (200, {"status": "ready"}), "ready")
            lat = []
            for r in range(REST_REQUESTS):
                t0 = time.perf_counter()
                status, _ = get(f"/api/recommend/{shard[r % SHARD]}")
                lat.append((time.perf_counter() - t0) * 1e3)
                check(status == 200, "GET /api/recommend answers 200")
            conn.close()
        finally:
            server.shutdown()
        lat.sort()
        result.update(rest_p50_ms=lat[len(lat) // 2], rest_p99_ms=lat[int(len(lat) * 0.99) - 1])
    return result


# ---------------------------------------------------------------- phase 4


def zero_counts() -> list:
    """Every kernel wrapper, its launch count set to 0."""
    from gorse_tpu_torch.ops import bpr_kernel, topk

    wrappers = [getattr(topk, n) for n in KERNELS + SQ_KERNELS]
    wrappers += [getattr(bpr_kernel, n) for n in BPR_KERNELS]
    for w in wrappers:
        w.launches = 0
    return wrappers


def make_training_data():
    """The bpr_ml20m_shape_k64 corpus, its leave-one-out split, and the
    fit's padded positives (same cap, same seed)."""
    from gorse_tpu_torch.data.loaders import synthetic_cf_access
    from gorse_tpu_torch.models.bpr import history_cap

    data = synthetic_cf_access(TRAIN_USERS, TRAIN_ITEMS, nnz=TRAIN_NNZ, seed=TRAIN_SEED)
    train, test = data.split_cf(seed=0)
    cap, _ = history_cap(train)
    return train, test, train.padded_user_positives(max_len=cap, seed=0)


def order_bound(p, q, pos, neg, active, mm_dtype):
    """Per element of delta, the most the kernel's and the plain version's
    sums of the same adds can differ: two orders of n terms differ by at
    most 2 (n - 1) u sum|x| (u = 2^-24; |x| <= lr (|p| + reg |q|) since
    |grad| <= 1); in bf16 a payload within an ulp of a rounding boundary may
    round the other way, one bf16 ulp (<= 2^-7 |x|) per add."""
    import torch

    act = active.bool()
    ip, ineg = pos.long()[act], neg.long()[act]
    pa = LR * (p[act].abs() + REG * q[ip].abs())
    na = LR * (p[act].abs() + REG * q[ineg].abs())
    s = torch.zeros_like(q).index_add_(0, ip, pa).index_add_(0, ineg, na)
    ones = torch.ones(ip.shape[0], device=q.device)
    n = torch.zeros(q.shape[0], device=q.device).index_add_(0, ip, ones).index_add_(0, ineg, ones)
    out = 2.0 * torch.clamp(n - 1, min=0)[:, None] * 2.0**-24 * s
    if mm_dtype == torch.bfloat16:
        out = out + 2.0**-7 * s
    return out


def within(name: str, got, want, extra=0.0) -> float:
    err = (got - want).abs()
    ok = bool((err <= BPR_ATOL + BPR_RTOL * want.abs() + extra).all())
    check(ok, f"{name}: max |diff| {float(err.max()):.3g} beyond the stated tolerance")
    return float(err.max())


def hold_bpr(name, p, q, padded, counts, step_key, mm_dtype, n_tries=4) -> dict:
    """Both sweep modes against their plain versions on the card. Returns
    the largest absolute difference seen per kernel."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel as bk

    dev, n_items = p.device, q.shape[0]
    active = (counts > 0).to(torch.int32)

    def fresh():
        return torch.zeros_like(q), torch.zeros((1,), device=dev)

    def cost_ok(what, got, want):
        tol = BPR_RTOL + 2.0 * int(active.sum()) * 2.0**-24
        check(abs(float(got) - float(want)) <= tol * abs(float(want)) + BPR_ATOL,
              f"{name}: {what} cost {float(got)} vs {float(want)}")

    dk, ck = fresh()
    dp, cp = fresh()
    pk, posk, negk = bk.bpr_sweep_sampled(p, q, dk, ck, padded, counts, step_key, n_items,
                                          LR, REG, n_tries, mm_dtype)
    pp, posp, negp = bk.bpr_sweep_sampled_plain(p, q, dp, cp, padded, counts, step_key,
                                                n_items, LR, REG, n_tries, mm_dtype)
    torch.cuda.synchronize()
    check(torch.equal(posk, posp) and torch.equal(negk, negp),
          f"{name}: sampled pos and neg equal their plain version")
    bnd = order_bound(p, q, posp, negp, active, mm_dtype)
    err = {"bpr_sweep_sampled": max(within(f"{name}: sampled p_new", pk, pp),
                                    within(f"{name}: sampled delta", dk, dp, bnd))}
    cost_ok("sampled", ck, cp)

    dk2, ck2 = fresh()
    dp2, cp2 = fresh()
    pk2 = bk.bpr_sweep_pairs(p, q, dk2, ck2, posk, negk, active, LR, REG, mm_dtype)
    pp2 = bk.bpr_sweep_pairs_plain(p, q, dp2, cp2, posp, negp, active, LR, REG, mm_dtype)
    torch.cuda.synchronize()
    err["bpr_sweep_pairs"] = max(within(f"{name}: pairs p_new", pk2, pp2),
                                 within(f"{name}: pairs delta", dk2, dp2, bnd))
    cost_ok("pairs", ck2, cp2)
    within(f"{name}: pairs p_new vs sampled", pk2, pk)
    within(f"{name}: pairs delta vs sampled", dk2, dk, bnd)
    cost_ok("pairs vs sampled", ck2, ck)
    return err


def hold_epoch(name, p, q, padded, counts, keys, mm_dtype, n_tries=4) -> float:
    """bpr_epoch against its plain version on the card: every step's pos
    and neg equal, delta zero after the fold. One step: p to the sweep's
    tolerance, q to it plus ``order_bound``, the cost as the sweep's. More
    steps: each table and the cost within EPOCH_TOL of its largest
    magnitude. Returns the largest absolute difference."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel as bk

    dev, n_items, n_steps = p.device, q.shape[0], len(keys)
    got = {}
    for side, fn in (("kernel", bk.bpr_epoch), ("plain", bk.bpr_epoch_plain)):
        qs, delta, cost = q.clone(), torch.zeros_like(q), torch.zeros((1,), device=dev)
        pairs = torch.full((2, n_steps, p.shape[0]), -7, dtype=torch.int32, device=dev)
        ps = fn(p, qs, delta, cost, padded, counts, keys, n_items, LR, REG, n_tries, mm_dtype,
                pairs=pairs)
        got[side] = (ps, qs, cost, pairs, delta)
    torch.cuda.synchronize()
    (pk, qk, ck, pairs_k, dk), (pp, qp, cp, pairs_p, _) = got["kernel"], got["plain"]
    check(torch.equal(pairs_k, pairs_p), f"{name}: every step's pos and neg equal the plain ones")
    check(not bool(dk.any()), f"{name}: delta is zero after the epoch")
    if n_steps == 1:
        active = (counts > 0).to(torch.int32)
        bnd = order_bound(p, q, pairs_p[0, 0], pairs_p[1, 0], active, mm_dtype)
        err = max(within(f"{name}: p", pk, pp), within(f"{name}: q", qk, qp,
                                                        bnd + BPR_RTOL * q.abs()))
        tol = BPR_RTOL + 2.0 * int(active.sum()) * 2.0**-24
    else:
        tol = EPOCH_TOL[str(mm_dtype)[6:]]
        err = 0.0
        for what, a, b in (("p", pk, pp), ("q", qk, qp)):
            diff = float((a - b).abs().max())
            check(diff <= tol * float(b.abs().max()),
                  f"{name}: {what} differs by {diff:.3g}, max |{what}| {float(b.abs().max()):.3g}")
            err = max(err, diff)
    check(abs(float(ck) - float(cp)) <= tol * abs(float(cp)) + BPR_ATOL,
          f"{name}: cost {float(ck)} vs {float(cp)}")
    return err


def bpr_small_cases(dev):
    """Tie-heavy shapes: 300 users over 40 items (every sweep repeats
    items), every 7th user with no positives, item 0 in every history."""
    import torch

    rng = np.random.default_rng(11)
    n_users, n_items, width = 300, 40, 12
    counts = rng.integers(1, width + 1, size=n_users).astype(np.int32)
    counts[::7] = 0
    padded = np.full((n_users, width), -1, np.int32)
    for u in range(n_users):
        if counts[u]:
            padded[u, 0] = 0
            padded[u, 1 : counts[u]] = rng.choice(np.arange(1, n_items), counts[u] - 1, False)
    cases = []
    for k in (8, 16, 64):
        p = rng.normal(scale=0.5, size=(n_users, k)).astype(np.float32)
        q = rng.normal(scale=0.5, size=(n_items, k)).astype(np.float32)
        cases.append((f"small k={k}", *(torch.as_tensor(x, device=dev)
                                        for x in (p, q, padded, counts))))
    return cases


def bpr_wide_case(dev, k: int):
    """Repeated items at width: more users than 32 x the most warps the card
    can hold (64 an SM), so on any grid some warp takes more than one
    32-user batch and prefetches across users; 4,000 items, more than the
    staged head, so both staged and unstaged rows take adds (about 120 a
    row a step); every 7th user with no positives. Few enough adds a row
    that the factors stay bounded over a few steps (300 items, about 1,800
    adds a row, grew p to 114 in 3 steps, and the steps' reordered sums with
    it)."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_users, n_items, width = 32 * 64 * sms + 4_097, 4_000, 24
    gen = torch.Generator(device=dev).manual_seed(12 + k)
    counts = torch.randint(1, width + 1, (n_users,), generator=gen, device=dev,
                           dtype=torch.int32)
    counts[::7] = 0
    # distinct items a row: a random start plus gaps of 1 to 149 (at most
    # 24 x 149 < 4,000 in all)
    start = torch.randint(0, n_items, (n_users, 1), generator=gen, device=dev)
    gaps = torch.randint(1, 150, (n_users, width), generator=gen, device=dev)
    rows = (start + gaps.cumsum(dim=1)) % n_items
    live = torch.arange(width, device=dev)[None, :] < counts[:, None]
    padded = torch.where(live, rows, -1).to(torch.int32).contiguous()
    p = 0.5 * torch.randn((n_users, k), generator=gen, device=dev)
    q = 0.5 * torch.randn((n_items, k), generator=gen, device=dev)
    return f"wide k={k}", p, q, padded, counts


def bpr_dense_case(dev):
    """Rows that hold most of a 16-item catalog (counts 10 to 16, some rows
    every item; every 9th user with none): the first SAMPLE_AHEAD
    candidates often all collide, so the sweep draws on one at a time."""
    import torch

    rng = np.random.default_rng(13)
    n_users, n_items, k = 2_000, 16, 64
    counts = rng.integers(10, n_items + 1, size=n_users).astype(np.int32)
    counts[::9] = 0
    padded = np.full((n_users, n_items), -1, np.int32)
    for u in range(n_users):
        padded[u, : counts[u]] = rng.permutation(n_items)[: counts[u]]
    p = rng.normal(scale=0.5, size=(n_users, k)).astype(np.float32)
    q = rng.normal(scale=0.5, size=(n_items, k)).astype(np.float32)
    return ("dense k=64", *(torch.as_tensor(x, device=dev) for x in (p, q, padded, counts)))


def late_draws(padded, counts, keys, n_items: int, n_tries: int) -> tuple[int, int]:
    """Over the step keys: the active users whose first SAMPLE_AHEAD
    candidates all lie in their rows (the sweep then draws one at a time),
    and of those the ones a later candidate freed."""
    import torch

    from gorse_tpu_torch.ops import sampling

    uids = torch.arange(padded.shape[0], device=padded.device)
    reached = freed = 0
    for step in keys:
        u = sampling.per_user_uniforms(step, uids, 1 + n_tries)[:, 1:]
        cand = (u * float(n_items)).to(torch.int32)
        hit = (padded[:, None, :] == cand[:, :, None]).any(dim=2) & (counts > 0)[:, None]
        late = hit[:, :SAMPLE_AHEAD].all(dim=1)
        reached += int(late.sum())
        freed += int((late & ~hit[:, SAMPLE_AHEAD:].all(dim=1)).sum())
    return reached, freed


def phase_bpr_kernels(csr, dev, n_steps: int) -> tuple[dict, dict]:
    """Returns (errors, timings) per BPR kernel; ``n_steps`` is the fit's
    steps an epoch at this shape."""
    import torch

    from gorse_tpu_torch.models.bpr import adaptive_neg_tries
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import sampling

    errors: dict[str, float] = {}

    def merge_err(e):
        for key_, v in e.items():
            errors[key_] = max(errors.get(key_, 0.0), v)

    key = sampling.raw_step_keys(sampling.prng_key(3), 2)
    dense = bpr_dense_case(dev)
    cases = [(c, 4, EPOCH_STEPS) for c in bpr_small_cases(dev)]
    cases += [(bpr_wide_case(dev, k), 4, (1, 3)) for k in (64, 128)]
    cases += [(dense, DENSE_TRIES, (1, 3))]
    for (name, p, q, padded, counts), n_tries, step_counts in cases:
        for mm in (torch.float32, torch.bfloat16):
            merge_err(hold_bpr(f"{name} {str(mm)[6:]}", p, q, padded, counts, key[0], mm,
                               n_tries))
            for steps in step_counts:
                keys = sampling.raw_step_keys(sampling.prng_key(8), steps)
                merge_err({"bpr_epoch": hold_epoch(f"{name} {str(mm)[6:]} epoch of {steps}",
                                                   p, q, padded, counts, keys, mm, n_tries)})
        log(f"  {name} ({p.shape[0]} users, {q.shape[0]} items, n_tries {n_tries}): every "
            f"kernel within tolerance; bpr_epoch over {step_counts} steps, samples equal")
    _, _, q, padded, counts = dense
    late = late_draws(padded, counts, [key[0], *sampling.raw_step_keys(sampling.prng_key(8), 3)],
                      q.shape[0], DENSE_TRIES)
    check(late[0] > late[1] > 0, f"dense case: {late} (users past the first {SAMPLE_AHEAD} "
          "candidates, freed by a later one): both kinds must occur")
    log(f"  dense case: {late[0]} draws past the first {SAMPLE_AHEAD} candidates, {late[1]} "
        "freed by a later one")

    rng = np.random.default_rng(5)
    n_users, n_items, k = TRAIN_USERS, TRAIN_ITEMS, TRAIN_DIM
    p = torch.as_tensor(rng.normal(scale=0.1, size=(n_users, k)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.normal(scale=0.1, size=(n_items, k)).astype(np.float32), device=dev)
    padded = torch.as_tensor(csr.padded, device=dev)
    counts = torch.as_tensor(csr.counts, device=dev)
    n_tries = adaptive_neg_tries(float(np.mean(csr.counts)) / n_items)
    merge_err(hold_bpr("full width", p, q, padded, counts, key[1], torch.float32, n_tries))
    for steps in (1, 3):
        keys = sampling.raw_step_keys(sampling.prng_key(10), steps)
        merge_err({"bpr_epoch": hold_epoch(f"full width epoch of {steps}", p, q, padded, counts,
                                           keys, torch.float32, n_tries)})
    log(f"  full width ({n_users} users, {n_items} items, k = {k}, L = {padded.shape[1]}, "
        f"n_tries = {n_tries}; the epoch over 1 and 3 steps): within tolerance; errors "
        f"{json.dumps(errors)}")

    # ---- times at the training shape
    delta, cost = torch.zeros_like(q), torch.zeros((1,), device=dev)
    _, pos, neg = bk.bpr_sweep_sampled(p, q, delta, cost, padded, counts, key[1], n_items,
                                       LR, REG, n_tries)
    active = (counts > 0).to(torch.int32)
    n_active = int(active.sum())
    touched = int(torch.unique(torch.cat([pos[active.bool()], neg[active.bool()]])).numel())
    hits = torch.bincount(torch.cat([pos[active.bool()], neg[active.bool()]]).long(),
                          minlength=n_items)
    user_bytes = 2 * n_users * k * 4  # p read, p_new written
    row_bytes = touched * 3 * k * 4  # q rows read once, delta rows read and written
    # the rows' items (the scan stops at each row's count) and the counts
    hist_bytes = int(counts.sum()) * 4 + n_users * 4
    flops = n_active * 16 * k
    out = {}
    s_bound = bound(user_bytes + row_bytes + hist_bytes + n_users * 8 + 4, flops, F32_FLOP_S)

    def sweep_sampled():
        bk.bpr_sweep_sampled(p, q, delta, cost, padded, counts, key[1], n_items, LR, REG,
                             n_tries)

    def sweep_pairs():
        bk.bpr_sweep_pairs(p, q, delta, cost, pos, neg, active, LR, REG)

    out["bpr_sweep_sampled"] = dict(
        ms=median_ms(sweep_sampled, 50), queued_ms=queued_ms(sweep_sampled),
        plain_ms=median_ms(lambda: bk.bpr_sweep_sampled_plain(
            p, q, delta, cost, padded, counts, key[1], n_items, LR, REG, n_tries), 5),
        bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=None,
    )
    p_bound = bound(user_bytes + row_bytes + n_users * 12 + 4, flops, F32_FLOP_S)
    out["bpr_sweep_pairs"] = dict(
        ms=median_ms(sweep_pairs, 50), queued_ms=queued_ms(sweep_pairs),
        plain_ms=median_ms(lambda: bk.bpr_sweep_pairs_plain(
            p, q, delta, cost, pos, neg, active, LR, REG), 5),
        bound_ms=p_bound[0], bound_by=p_bound[1], library_ms=None,
    )
    # the epoch: n_steps sweeps and folds. Its bound by the rule (each input
    # read once, each output written once: p and q read and written, the
    # rows' items, the counts, the keys) and, beside it, with p, q and delta
    # making a round trip through device memory every step
    keys = sampling.raw_step_keys(sampling.prng_key(5), n_steps)
    e_bound = bound(user_bytes + 2 * q.numel() * 4 + hist_bytes + n_steps * 8 + 4,
                    n_steps * flops, F32_FLOP_S)
    fold_bytes = 4 * q.numel() * 4  # q and delta read, both written
    trip_ms = n_steps * bound(user_bytes + row_bytes + hist_bytes + fold_bytes,
                              flops + q.numel(), F32_FLOP_S)[0]
    q_epoch = q.clone()  # the epochs below update it in place

    def epoch(ablate=""):
        return lambda: bk.bpr_epoch_fused(p, q_epoch, padded, counts, keys, n_items, LR, REG,
                                          mm_dtype=torch.float32, n_tries=n_tries,
                                          ablate=ablate)

    def plain_epoch():
        bk.bpr_epoch_plain(p, q_epoch, torch.zeros_like(q), cost, padded, counts, keys,
                           n_items, LR, REG, n_tries)

    out["bpr_epoch"] = dict(
        ms=median_ms(epoch(), 20), queued_ms=queued_ms(epoch(), 10),
        plain_ms=median_ms(plain_epoch, 2),
        bound_ms=e_bound[0], bound_by=e_bound[1], round_trip_bound_ms=trip_ms,
        n_steps=n_steps, library_ms=None,
    )
    # cost attribution (ablated epochs compute wrong results by design)
    out["bpr_epoch"]["ablation_ms"] = {v or "full": median_ms(epoch(v), 20) for v in ABLATIONS}
    top = torch.topk(hits, 5).values.tolist()
    log(f"  sweep: {n_active} active users, {touched} item rows touched, the hottest five "
        f"{top} adds of {2 * n_active}; {int(counts.sum())} history entries in "
        f"{n_users} x {padded.shape[1]} padded rows")
    for name, row in out.items():
        log(f"  time {name}: " + json.dumps(row))
    del p, q, delta, q_epoch
    torch.cuda.empty_cache()
    return errors, out


def phase_pairs_path(csr, dev) -> dict:
    """One epoch of explicit-pairs training (the reference's sharded-fused
    step, parallel/sharded.py:224-298, on one card): the counter sampler,
    then K3's sweep per step; then one epoch of K2's entry
    (``bpr_fully_fused_step`` and the fold by the caller). Returns each
    path's launches of its sweep."""
    import torch

    from gorse_tpu_torch.models.bpr import adaptive_neg_tries
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import sampling

    rng = np.random.default_rng(6)
    p = torch.as_tensor(rng.normal(scale=0.001, size=(TRAIN_USERS, TRAIN_DIM)).astype(np.float32),
                        device=dev)
    q = torch.as_tensor(rng.normal(scale=0.001, size=(TRAIN_ITEMS, TRAIN_DIM)).astype(np.float32),
                        device=dev)
    padded = torch.as_tensor(csr.padded, device=dev)
    counts = torch.as_tensor(csr.counts, device=dev)
    uids = torch.arange(TRAIN_USERS, device=dev)
    n_tries = adaptive_neg_tries(float(np.mean(csr.counts)) / TRAIN_ITEMS)
    n_steps = max(round(int(csr.counts.sum()) / max(int((csr.counts > 0).sum()), 1)), 1)
    keys = sampling.raw_step_keys(sampling.prng_key(4), n_steps)
    zero_counts()
    torch.cuda.synchronize()
    for step_key in keys:
        pos, neg = sampling.sample_pair(padded, counts, uids, step_key, TRAIN_ITEMS, n_tries)
        p, q_delta, _ = bk.bpr_fused_step(p, q, pos, neg, counts > 0, LR, REG)
        q.add_(q_delta)
    torch.cuda.synchronize()
    launches = {"bpr_sweep_pairs": bk.bpr_sweep_pairs.launches}
    check(launches["bpr_sweep_pairs"] == n_steps,
          f"pairs path: {launches} pairs sweeps for {n_steps} steps")
    check(bool(torch.isfinite(p).all() and torch.isfinite(q).all()), "pairs path: finite")

    zero_counts()
    torch.cuda.synchronize()
    for step_key in keys:
        p, q_delta, _, _, _ = bk.bpr_fully_fused_step(p, q, padded, counts, step_key,
                                                      TRAIN_ITEMS, LR, REG, n_tries=n_tries)
        q.add_(q_delta)
    torch.cuda.synchronize()
    launches["bpr_sweep_sampled"] = bk.bpr_sweep_sampled.launches
    check(launches["bpr_sweep_sampled"] == n_steps,
          f"sampled-step path: {launches} sampled sweeps for {n_steps} steps")
    log(f"  pairs and sampled-step paths: {n_steps} steps each, launches {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------- phase 5


def hold_first_epoch(train, csr, dev, n_steps: int) -> dict:
    """The fit's first epoch (its init, its keys) through the kernel against
    the plain version on the card: every step's pos and neg equal, p and q
    within 5e-3 of each table's largest magnitude. At this shape the Zipf
    head's rows grow about fourfold a step (the reference's dense sweep does
    the same), and the growth amplifies every reordered f32 sum: beside the
    hold, both are measured against the plain epoch evaluated in f64, which
    says how far any f32 order lies from the exact sums. Returns the
    relative errors."""
    import torch

    from gorse_tpu_torch.models import BPR, Params
    from gorse_tpu_torch.models.bpr import adaptive_neg_tries
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import sampling

    n_items = train.count_items()
    n_tries = adaptive_neg_tries(float(np.mean(csr.counts)) / n_items)
    init = BPR(Params(n_factors=TRAIN_DIM), device=dev)
    init.init(train, seed=0)
    padded = torch.as_tensor(csr.padded, device=dev)
    counts = torch.as_tensor(csr.counts, device=dev)
    _, epoch_key = sampling.split(sampling.prng_key(1))
    keys = sampling.raw_step_keys(epoch_key, n_steps)
    got = {}
    for side, fn, dt in (("kernel", bk.bpr_epoch, torch.float32),
                         ("plain", bk.bpr_epoch_plain, torch.float32),
                         ("f64", bk.bpr_epoch_plain, torch.float64)):
        q = init.item_factors.to(dt, copy=True)  # the epoch updates q in place
        pairs = torch.empty((2, n_steps, padded.shape[0]), dtype=torch.int32, device=dev)
        p = fn(init.user_factors.to(dt), q, torch.zeros_like(q), torch.zeros((1,), dtype=dt,
               device=dev), padded, counts, keys, n_items, LR, REG, n_tries, pairs=pairs)
        got[side] = (p.double(), q.double(), pairs)
    torch.cuda.synchronize()
    check(torch.equal(got["kernel"][2], got["plain"][2]),
          "first epoch: every step's pos and neg equal the plain ones")
    out = {}
    for a, b in (("kernel", "plain"), ("kernel", "f64"), ("plain", "f64")):
        for t, name in ((0, "p"), (1, "q")):
            want = got[b][t]
            rel = float((got[a][t] - want).abs().max()) / float(want.abs().max())
            out[f"{a} vs {b}"] = max(out.get(f"{a} vs {b}", 0.0), rel)
            if b == "plain":
                check(rel <= 5e-3,
                      f"first epoch: {name} differs by {rel:.3g} of its largest magnitude")
    p64, q64, _ = got["f64"]
    log(f"  first epoch against its plain version on the card, as shares of each table's "
        f"largest magnitude: {json.dumps(out)}; samples equal; max |p| "
        f"{float(p64.abs().max()):.4g}, max |q| {float(q64.abs().max()):.4g}")
    return out


def phase_training(train, test, csr, dev) -> dict:
    import torch

    from gorse_tpu_torch.data.loaders import load_built_in
    from gorse_tpu_torch.models import BPR, FitConfig, Params
    from gorse_tpu_torch.ops import bpr_kernel as bk

    n_active = sum(1 for fb in train.user_feedback if fb)
    n_steps = max(round(train.count_feedback() / n_active), 1)
    first_epoch_err = hold_first_epoch(train, csr, dev, n_steps)
    model = BPR(Params(n_factors=TRAIN_DIM, n_epochs=TRAIN_EPOCHS, lr=LR, reg=REG), device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = model.fit(train, test, FitConfig())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: getattr(bk, n).launches for n in BPR_KERNELS}
    want = dict(bpr_sweep_sampled=0, bpr_sweep_pairs=0, bpr_epoch=TRAIN_EPOCHS)
    check(launches == want, f"fit: {launches} launches, want {want} (one bpr_epoch an epoch)")
    check(len(model.epoch_seconds) == TRAIN_EPOCHS, "fit: every epoch ran")
    nnz = train.count_feedback()
    # not a check: at lr 0.05 the dense sweep diverges at this shape, in the
    # reference as here (PERF.md); whether the factors stayed finite is reported
    result = dict(
        users=train.count_users(), items=train.count_items(), nnz=nnz, k=TRAIN_DIM,
        n_steps=n_steps, epochs=TRAIN_EPOCHS, launches=launches, fit_s=fit_s,
        epoch_s=model.epoch_seconds,
        examples_per_s=[nnz / s for s in model.epoch_seconds],
        sweep_ms=[s / n_steps * 1e3 for s in model.epoch_seconds],
        first_epoch_rel_err=first_epoch_err["kernel vs plain"],
        first_epoch_f64_rel_err={k_: v for k_, v in first_epoch_err.items() if "f64" in k_},
        finite=bool(torch.isfinite(model.user_factors).all()
                    and torch.isfinite(model.item_factors).all()),
    )
    result["ndcg"] = score.ndcg if result["finite"] else None  # no ranking from inf/NaN

    # quality on the card, and against the fit's plain version on the CPU
    tr, te = load_built_in(QUALITY_SPEC)
    fits = {}
    for where in (dev, "cpu"):
        m = BPR(Params(n_factors=8, n_epochs=20), device=where)
        fits[str(where)] = (m.fit(tr, te, FitConfig(verbose=5)), m)
    card, cpu = fits[str(dev)], fits["cpu"]
    result.update(quality_ndcg=card[0].ndcg, quality_ndcg_cpu=cpu[0].ndcg,
                  quality_max_factor_diff=float(
                      (card[1].item_factors.cpu() - cpu[1].item_factors).abs().max()))
    check(card[0].ndcg >= QUALITY_NDCG, f"{QUALITY_SPEC}: NDCG@10 {card[0].ndcg} < {QUALITY_NDCG}")
    # the atomics reorder each sweep's item sums: trajectories differ by
    # rounding only
    check(abs(card[0].ndcg - cpu[0].ndcg) <= 5e-3,
          f"{QUALITY_SPEC}: card NDCG {card[0].ndcg} vs CPU {cpu[0].ndcg}")
    del model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 6


def route_launches(route: str, sq: bool) -> dict:
    """The launches of one query chunk on ``route`` (topk.kernel_route's
    "block", "group" or "none"; "f32" for the f32 route), the nonzero ones."""
    if route == "f32":
        return {}
    sfx = "_sq" if sq else ""
    names = ["block_topk" + sfx, "merge_topk"]
    if route != "none":
        names = ["block_max" + sfx, "block_seeds"] + names
    return dict.fromkeys(names, 1)


def worker_routes(index, users: list[str], data, n: int) -> list[str]:
    """The route of each 256-user chunk of ``search_users(users, n,
    exclude=histories)``, from its fetch as logics/cf.py computes it."""
    from gorse_tpu_torch.ops import topk

    n_serving = len(index._serving_rows)
    n_eff = min(n, n_serving)
    n_pad = index._prepared_items.table.shape[0]
    size = index._SEARCH_CHUNK
    routes = []
    for lo in range(0, len(users), size):
        width = max(len(data.get_user_feedback(u)) for u in users[lo : lo + size])
        if n_eff + width > index._KERNEL_FETCH_MAX:
            routes.append("f32")
        else:
            routes.append(topk.kernel_route(n_pad, min(n_eff + width, n_serving)))
    return routes


def phase_master(dev) -> dict:
    import torch

    from gorse_tpu_torch.data.loaders import synthetic_cf
    from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.rest import RestServer
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.storage.types import Feedback, Item, User
    from gorse_tpu_torch.storage.vectors import MemoryVectorStore
    from gorse_tpu_torch.utils.config import Config

    n_users, n_items, rank, density, seed = MASTER_SHAPE
    ds = synthetic_cf(n_users, n_items, rank, density, seed)
    data, cache = MemoryDataStore(), MemoryCacheStore()
    data.insert_items(Item(f"i{i}", categories=[f"c{i % N_CATEGORIES}"]) for i in range(n_items))
    data.insert_users(User(f"u{u}") for u in range(n_users))
    data.insert_feedback(
        Feedback("like", f"u{u}", f"i{i}", 1.0, ts)
        for u, (fb, stamps) in enumerate(zip(ds.user_feedback, ds.timestamps))
        for i, ts in zip(fb, stamps)
    )
    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.collaborative.fit_epoch = MASTER_EPOCHS
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.database.vector_quantization_type = "sq"
    vectors = MemoryVectorStore(device=dev)
    result = {}
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        blobs = BlobStore(Path(tmp) / "blobs")
        master = Master(cfg, data, cache, blobs, MetaStore(), device=dev, vector_store=vectors)
        # ---- the training path, with every launch count set to 0 just before
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = master.load_dataset()
        result["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        master.train_collaborative_filtering(loaded)
        torch.cuda.synchronize()
        result["train_s"] = time.perf_counter() - t0
        launches = {n: getattr(bk, n).launches for n in BPR_KERNELS}
        # ----
        train = loaded.train
        n_steps = max(round(train.count_feedback() / sum(1 for fb in train.user_feedback if fb)), 1)
        want = dict(bpr_sweep_sampled=0, bpr_sweep_pairs=0, bpr_epoch=MASTER_EPOCHS)
        check(launches == want, f"master: {launches} launches, want {want} (one bpr_epoch an "
              "epoch)")
        fit_s = re.search(r"^\w*master_collaborative_filtering_fit_seconds (\S+)$",
                          master.metrics.render(), re.M)
        model_meta = json.loads(master.meta.get("CF_MODEL_META"))
        meta = master.get_meta()
        check(meta["cf_model_id"] != "" and blobs.exists(meta["cf_model_id"]),
              "master: the index is in the blob store under the meta's model id")

        # ---- the vector store the fit synced: its own path's counts
        name = Master.CF_COLLECTION
        serving_ids, serving = master.cf_index.serving_items()
        check(vectors.describe_collection(name)["quantization"] == "sq"
              and list(vectors._collections[name].rows) == serving_ids
              and len(serving_ids) >= 1024,
              f"master: the sq collection holds the {len(serving_ids)} serving items")
        probe = serving[:: max(len(serving) // MASTER_SAMPLE_USERS, 1)][:MASTER_SAMPLE_USERS]
        # k = 10 takes the block gate; the cache size (100) exceeds the
        # collection's 15 blocks, so it takes the group gate (K6's function)
        n_pad = topk._round_up(len(serving_ids), topk.BLOCK_N)
        vec_launches, vec_routes = {}, {}
        for k in (SQ_K, cfg.recommend.cache_size):
            vec_routes[k] = topk.kernel_route(n_pad, k)
            want = route_launches(vec_routes[k], sq=True)
            lists, _, counts = query_counted(vectors, name, probe, k)
            check(counts == want, f"master's collection at k = {k}: launches {counts}, want "
                  f"{want} ({vec_routes[k]} gate)")
            hold_store(f"master's collection at k = {k}", vectors, name, probe, k,
                       vectors._collections[name].encoded["prepared"], "dot", lists)
            vec_launches[k] = counts
        result.update(vector_rows=len(serving_ids), vector_launches=vec_launches,
                      vector_routes=vec_routes)
        log(f"  master's sq collection: {len(serving_ids)} rows; {MASTER_SAMPLE_USERS} item "
            f"queries at k = {SQ_K} and {cfg.recommend.cache_size} (gates "
            f"{json.dumps(vec_routes)}) through the kernels equal the plain version")

        # ---- the worker serves the fresh index (its own path's counts)
        worker = Worker(cfg, data, cache, blobs, device=dev)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refreshed = worker.sync_and_recommend(meta)
        torch.cuda.synchronize()
        result["recommend_s"] = time.perf_counter() - t0
        topk_launches = {n: getattr(topk, n).launches for n in KERNELS}
        check(refreshed == n_users, f"worker refreshed {refreshed} of {n_users} users")
        check(worker.cf_model_id == meta["cf_model_id"] and worker.cf_index.device == dev,
              "worker: pulled the master's index onto the card")
        # each chunk's launches are those of the route its fetch (100 + the
        # chunk's widest history) takes: more than the catalog's 15 blocks,
        # so the group gate while 4 x fetch fits the padded catalog
        index = worker.cf_index
        routes = worker_routes(index, worker.pull_users([worker.node_id]), data,
                               cfg.recommend.cache_size)
        want = dict.fromkeys(KERNELS, 0)
        for route in routes:
            for kernel, c in route_launches(route, sq=False).items():
                want[kernel] += c
        log(f"  worker chunks by gate: "
            f"{json.dumps({r: routes.count(r) for r in sorted(set(routes))})}")
        check(topk_launches == want, f"worker: launches {topk_launches}, want {want}")
        check(torch.equal(index.item_factors, master.cf_index.item_factors),
              "worker: the index it pulled is the one the master trained")
        trained = {ds.user_dict.to_name(u) for u, fb in enumerate(train.user_feedback) if fb}
        for u in range(n_users):
            uid = f"u{u}"
            scores = cache.search_scores(ck.COLLABORATIVE, uid)
            want_len = cfg.recommend.cache_size if uid in trained else 0
            check(len(scores) == want_len, f"{uid}: {len(scores)} collaborative entries")
        rng = np.random.default_rng(2)
        sample = sorted(rng.choice(sorted(trained), size=MASTER_SAMPLE_USERS, replace=False))
        items = index._prepared_items
        for uid in sample:
            # the kernels' fetched list held tie-aware; the cache equal to it
            # after the exclusions (the worker's chunk fetched a longer list)
            seen = {fb.item_id for fb in data.get_user_feedback(uid)}
            row = index.user_index.to_number(uid)
            q = index.user_factors[row : row + 1]
            fetch = cfg.recommend.cache_size + len(seen)
            s_k, i_k = topk.dot_topk(q, items, fetch, device=dev)
            hold_lists(f"{uid}: fetched list", (s_k, i_k), topk.dot_topk_plain(q, items, fetch),
                       topk._pad_queries(q, items, topk.QUERY_TILE), items.table)
            ids = [index.item_index.to_name(int(index._serving_rows[j])) for j in i_k[0].tolist()]
            want = [(i, float(s)) for i, s in zip(ids, s_k[0].tolist()) if i not in seen]
            got = [(s.id, s.score) for s in cache.search_scores(ck.COLLABORATIVE, uid)]
            check(got == want[: cfg.recommend.cache_size],
                  f"{uid}: cache equals the kernels' list after exclusions")

        server = RestServer(cfg, data, cache)
        httpd = server.serve("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            for uid in sample[:REST_USERS]:
                conn.request("GET", f"/api/recommend/{uid}")
                resp = conn.getresponse()
                body = json.loads(resp.read())
                want = [s.id for s in cache.search_scores(ck.COLLABORATIVE, uid)]
                check(resp.status == 200 and body == want[: cfg.server.default_n],
                      f"GET /api/recommend/{uid} equals the cache")
            conn.close()
        finally:
            server.shutdown()
    result.update(
        users=n_users, items=n_items, feedback=train.count_feedback(), n_steps=n_steps,
        fit_s=float(fit_s.group(1)), ndcg=model_meta["score"], launches=launches,
        worker_topk_launches=topk_launches, refreshed=refreshed,
        worker_routes={r: routes.count(r) for r in sorted(set(routes))},
    )
    return result


# ---------------------------------------------------------------- phase 7


def sq_table(rows: np.ndarray):
    """Per-row affine uint8 codes of ``rows`` (the store's quantization) and
    norms2 of the dequantized rows."""
    from gorse_tpu_torch.storage.vectors import _quantize_sq_rows

    codes, scale, lo = _quantize_sq_rows(rows)
    scale = scale.astype(np.float32)
    approx = lo[:, None] + scale[:, None] * codes.astype(np.float32)
    return codes, scale, lo, (approx * approx).sum(1).astype(np.float32)


def sq_small_cases(dev):
    """Tie-heavy quantized tables, integer-valued (held equal): integer rows
    (many equal codes and scores), duplicate rows, constant rows (scale
    1.0), catalogs that are not a multiple of 256, k > n_blocks, k = n,
    and 128 dimensions over 300 queries."""
    import torch

    from gorse_tpu_torch.ops import topk

    rng = np.random.default_rng(17)
    cases = []
    for name, n, d, b, k in (("ties", 3000, 16, 40, 20), ("k_over_blocks", 1000, 16, 8, 7),
                             ("k_all", 300, 8, 4, 300), ("wide", 3000, 100, 300, 20)):
        rows = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        rows[10:30] = rows[3]  # duplicate rows
        rows[40:50] = 1.5  # constant rows
        codes, scale, lo, norms2 = sq_table(rows)
        q = torch.as_tensor(rng.integers(-2, 3, size=(b, d)).astype(np.float32), device=dev)
        prep = topk.prepare_sq_items(codes, scale, lo, norms2, device=dev)
        for metric in ("dot", "euclidean"):
            cases.append((f"{name} {metric}", q, prep, k, metric))
    return cases


def sq_rescored(queries, prep, metric: str, idx):
    """The SQ formula in f64 at the chosen items, and the magnitude of the
    terms it sums (an independent check of the plain version's scores)."""
    import torch

    q = queries[:, : prep.dim].double()
    qb = q.to(torch.bfloat16).double()
    rows = idx.long()
    codes = prep.table[:, : prep.dim].double()[rows]  # [b, k, d]
    scale, minv, n2 = (prep.affine[j].double()[rows] for j in range(3))
    qsum = q.sum(1, keepdim=True)
    dots = (codes * qb[:, None, :]).sum(2) * scale + qsum * minv
    mag = (codes * qb.abs()[:, None, :]).sum(2) * scale.abs() + (qsum * minv).abs()
    if metric == "euclidean":
        q2 = (q * q).sum(1, keepdim=True)
        return 2.0 * dots - n2 - q2, 2.0 * mag + n2.abs() + q2
    return dots, mag


def hold_sq_kernels(name: str, queries, prep, k: int, metric: str, exact=False) -> dict:
    """The SQ kernels against their plain versions on the card under every
    gate (hold_chain), then the sq_topk route. Returns the largest
    |difference| seen per kernel."""
    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    qp, aff = topk._sq_operands(queries, prep, topk._round_up(b, topk.QUERY_TILE), metric)
    err = hold_chain(f"{name} sq", qp, prep.table, b, prep.n_items, k, aff, exact)
    s, i = topk.sq_topk(queries, prep, k_top=k, metric=metric, device=prep.table.device)
    s_p, i_p = topk.sq_topk_plain(queries, prep, k, metric)
    hold_lists(f"{name}: sq_topk route", (s, i), (s_p, i_p), qp, prep.table, aff, exact)
    real = s_p > topk.NEG_INF / 2
    want, mag = sq_rescored(queries, prep, metric, i_p)
    check(bool(((want - s_p.double()).abs() <= 1e-5 * mag + 1e-6)[real].all()),
          f"{name}: plain scores equal the f64 formula to 1e-5 of their terms")
    return err


def time_sq_kernels(queries, prep, k: int, metric: str) -> dict:
    """Median times, bounds, plain and library times of the SQ kernels at
    one shape, and of the whole SQ top-k per chunk (the four kernels, and
    one ``sq_topk`` call with its host work)."""
    import torch

    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    qp, aff = topk._sq_operands(queries, prep, topk._round_up(b, topk.QUERY_TILE), metric)
    b_pad = qp.shape[0]
    table, n, d = prep.table, prep.n_items, prep.dim
    nb = table.shape[0] // topk.BLOCK_N
    aff_bytes = 12 if metric == "euclidean" else 8  # scale, minv (and norms2) per item
    in_bytes = qp.numel() * 2 + aff.qstats.numel() * 4
    flops = 2.0 * b * n * d
    out = {}
    bm = topk.block_max_sq(qp, table, aff, n)
    bms, by = bound(n * d + n * aff_bytes + in_bytes + b_pad * nb * 4, flops)
    out["block_max_sq"] = dict(
        ms=median_ms(lambda: topk.block_max_sq(qp, table, aff, n), 20),
        plain_ms=median_ms(lambda: topk.block_max_plain(qp, table, n, aff), 3),
        bound_ms=bms, bound_by=by, library_ms=None,
    )
    gate = topk.block_seeds(bm, b, k)
    seeds_ms = median_ms(lambda: topk.block_seeds(bm, b, k), 20)
    # the library's top-k, two ways: sq_library's; and the same function as
    # the kernels compute it, a bf16 matmul over the codes (exact in bf16),
    # the affine epilogue, torch.topk
    qstats = aff.qstats[:, :b]
    scale, minv, n2 = aff.affine[0, :n], aff.affine[1, :n], aff.affine[2, :n]
    codes_bf16 = table[:n].to(torch.bfloat16)

    def euclid(dots):
        return 2.0 * dots.float() - n2 - qstats[1][:, None] if metric == "euclidean" else dots

    lib = median_ms(sq_library(qp, prep, aff, b, k), 10)
    lib_exact = median_ms(lambda: torch.topk(euclid(
        torch.matmul(qp[:b], codes_bf16.T).float() * scale + qstats[0][:, None] * minv), k,
        dim=1), 10)
    del codes_bf16
    cand, count = topk.block_topk_sq(qp, table, aff, gate, b, n, k)
    fire = bm[:b] > gate.seeds[:, None]
    pairs, blocks = int(fire.sum()), int(fire.any(0).sum())
    bms, by = bound(blocks * topk.BLOCK_N * (d + aff_bytes) + in_bytes + b_pad * nb * 4 + b * 4
                    + int(count.sum()) * 8 + b_pad * 4, 2.0 * pairs * topk.BLOCK_N * d)
    ms = median_ms(lambda: topk.block_topk_sq(qp, table, aff, gate, b, n, k), 10)
    out["block_topk_sq"] = dict(
        ms=ms, plain_ms=median_ms(lambda: topk.block_topk_plain(qp, table, gate, b, n, k, aff), 3),
        bound_ms=bms, bound_by=by, library_ms=lib, fired_pairs=pairs,
        candidates=int(count.sum()),
    )
    out["merge_topk"] = merge_timing(cand, count, b, k)
    merge_ms = out["merge_topk"]["ms"]
    # K6's SQ body: every block fires, then the merge of all candidates
    cand_u, count_u = topk.block_topk_sq(qp, table, aff, None, b, n, k)
    bms, by = bound(n * (d + aff_bytes) + in_bytes + int(count_u.sum()) * 8 + b_pad * 4, flops)
    out["block_topk_sq_ungated"] = dict(
        ms=median_ms(lambda: topk.block_topk_sq(qp, table, aff, None, b, n, k), 10),
        plain_ms=median_ms(lambda: topk.block_topk_plain(qp, table, None, b, n, k, aff), 3),
        bound_ms=bms, bound_by=by, library_ms=lib, candidates=int(count_u.sum()),
    )
    out["merge_topk_ungated"] = merge_timing(cand_u, count_u, b, k)
    del cand_u, count_u
    fn_ms, fn_by = bound(n * d + n * aff_bytes + in_bytes + b * k * 8, flops)
    out["sq_topk_chunk"] = dict(
        ms=out["block_max_sq"]["ms"] + seeds_ms + ms + merge_ms,
        call_ms=median_ms(lambda: topk.sq_topk(queries, prep, k_top=k, metric=metric,
                                               device=prep.table.device), 10),
        plain_ms=median_ms(lambda: topk.sq_topk_plain(queries, prep, k, metric), 3),
        bound_ms=fn_ms, bound_by=fn_by, library_ms=lib, library_exact_ms=lib_exact,
        seeds_ms=seeds_ms, merge_ms=merge_ms,
    )
    return out


def hold_store(what: str, store, name: str, queries, k: int, prep, metric: str, lists) -> float:
    """The store's ``lists`` (from ``query``) against sq_topk_plain on its
    prepared table (the store's own cosine normalization applied to the
    queries first), by ``compare_lists``. Returns the largest |score
    difference|."""
    import torch

    from gorse_tpu_torch.ops import topk

    q = np.asarray(queries, np.float32)
    if metric == "cosine":
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.where(qn > 0, qn, 1.0)
    kind = "euclidean" if metric == "euclidean" else "dot"
    want = topk.sq_topk_plain(q, prep, k, kind)
    pos = {x: j for j, x in enumerate(store._collections[name].encoded["ids"])}
    dev = prep.table.device
    got = (torch.tensor([[x.score for x in row] for row in lists], dtype=torch.float32, device=dev),
           torch.tensor([[pos[x.id] for x in row] for row in lists], dtype=torch.int32, device=dev))
    qp, aff = topk._sq_operands(torch.as_tensor(q, device=dev), prep,
                                topk._round_up(len(q), topk.QUERY_TILE), kind)
    return hold_lists(what, got, want, qp, prep.table, aff)


def query_counted(store, name: str, queries, k: int):
    """One ``query`` with every launch count set to 0 just before and read
    just after."""
    import torch

    wrappers = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lists = store.query(name, queries, k)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers if w.launches}
    return lists, seconds, launches


def phase_vector_store(dev, seed: int) -> tuple[dict, dict, dict]:
    """Returns (errors, timings at 1M dot, store results)."""
    import torch

    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.storage.vectors import MemoryVectorStore

    errors: dict[str, float] = {}

    def merge_err(e):
        for key_, v in e.items():
            errors[key_] = max(errors.get(key_, 0.0), v)

    for name, q, prep, k, metric in sq_small_cases(dev):
        merge_err(hold_sq_kernels(name, q, prep, k, metric, exact=True))
    # K6's function where the dispatch sends it, as in phase 2, held and
    # its two routes timed
    route_rng = np.random.default_rng(seed + 8)
    q256 = torch.as_tensor(route_rng.standard_normal((256, DIM), dtype=np.float32), device=dev)
    preps, route_timings = {}, {}
    for n, k in ROUTE_SHAPES:
        if n not in preps:
            preps = {n: topk.prepare_sq_items(
                *sq_table(route_rng.standard_normal((n, DIM), dtype=np.float32)), device=dev)}
        merge_err(hold_sq_kernels(f"routes{n}", q256, preps[n], k, "dot"))
        route_timings[f"{n}x{k}"] = rows = time_routes(q256, preps[n], k, "dot")
        for label, row in rows.items():
            log(f"  time sq {n} items k={k} {label} route: " + json.dumps(row))
    del preps, q256

    rng = np.random.default_rng(seed + 7)
    rows = rng.standard_normal((SQ_ROWS, DIM), dtype=np.float32)
    t0 = time.perf_counter()
    codes, scale, lo, norms2 = sq_table(rows)
    log(f"  {SQ_ROWS} x {DIM} rows quantized in {time.perf_counter() - t0:.1f} s")
    prep = topk.prepare_sq_items(codes, scale, lo, norms2, device=dev)
    del codes
    chunk = torch.as_tensor(rng.standard_normal((256, DIM), dtype=np.float32), device=dev)
    timings = {}
    for metric in ("dot", "euclidean"):
        merge_err(hold_sq_kernels(f"sq{SQ_ROWS} {metric}", chunk, prep, SQ_K, metric))
        timings[metric] = time_sq_kernels(chunk, prep, SQ_K, metric)
        for name, row in timings[metric].items():
            log(f"  time {metric} {name}: " + json.dumps(row))
    del prep
    torch.cuda.empty_cache()

    # ---- (b) the store path: MemoryVectorStore.add -> query on the card
    result = {"routes": route_timings}
    store = MemoryVectorStore(device=dev)
    store.create_collection("sq1m", DIM, quantization="sq")
    ids = [f"v{i}" for i in range(SQ_ROWS)]
    t0 = time.perf_counter()
    store.add("sq1m", ids, rows)
    result["add_s"] = time.perf_counter() - t0
    queries = rng.standard_normal((SQ_QUERIES, DIM), dtype=np.float32)
    lists, first_s, launches = query_counted(store, "sq1m", queries, SQ_K)
    chunks = SQ_QUERIES // 256
    want = {"block_max_sq": chunks, "block_seeds": chunks, "block_topk_sq": chunks,
            "merge_topk": chunks}
    log("  store launches:", json.dumps(launches))
    check(launches == want, f"store query: launches {launches}, want {want}")
    enc = store._collections["sq1m"].encoded
    check(enc is not None and enc["kind"] == "sq" and enc["prepared"].table.device == dev,
          "store: the sq cache is built on the card")
    hold_store("store sq1m", store, "sq1m", queries, SQ_K, enc["prepared"], "dot", lists)
    t0 = time.perf_counter()
    for _ in range(SQ_WARM_REPS):
        store.query("sq1m", queries, SQ_K)
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / SQ_WARM_REPS
    result.update(rows=SQ_ROWS, queries=SQ_QUERIES, k=SQ_K, first_query_s=first_s,
                  warm_query_s=warm_s, warm_qps=SQ_QUERIES / warm_s, launches=launches)
    log(f"  store sq 1M: add {result['add_s']:.2f} s, first query {first_s:.2f} s, warm "
        f"{warm_s * 1e3:.1f} ms ({SQ_QUERIES / warm_s:.0f} q/s); lists equal the plain version")
    del store, rows
    torch.cuda.empty_cache()

    # pq, rq (decode -> 8-bit recompress) and euclidean, cosine sq at 100k
    small = rng.standard_normal((SQ_SMALL_ROWS, DIM), dtype=np.float32)
    small_ids = [f"v{i}" for i in range(SQ_SMALL_ROWS)]
    q256 = queries[:256]
    for quant, bits, metric in (("pq", 8, "dot"), ("rq", 4, "dot"), ("sq", 8, "euclidean"),
                                ("sq", 8, "cosine")):
        name = f"{quant}{bits}_{metric}"
        store = MemoryVectorStore(device=dev)
        store.create_collection(name, DIM, distance=metric, quantization=quant, bits=bits)
        store.add(name, small_ids, small)
        lists, seconds, launches = query_counted(store, name, q256, SQ_K)
        one = {"block_max_sq": 1, "block_seeds": 1, "block_topk_sq": 1, "merge_topk": 1}
        check(launches == one, f"{name}: launches {launches}, want {one}")
        enc = store._collections[name].encoded
        prep = enc["prepared" if quant == "sq" else "sq_prepared"]
        hold_store(name, store, name, q256, SQ_K, prep, metric, lists)
        result[name] = dict(first_query_s=seconds, launches=launches)
        log(f"  store {name} at {SQ_SMALL_ROWS}: {seconds:.2f} s (cache build included), "
            "kernel route, lists equal the plain version")
    return errors, timings, result


# ------------------------------------------------------ phases 2c and 7c


def phase_wide_catalog(dev, seed: int) -> dict:
    """A catalog of exactly WIDE_BLOCKS item blocks (16,777,216 x 64 bf16,
    2.1 GB, made on the card from ``seed``), WIDE_QUERIES queries, k = 10:
    ``dot_topk`` through the kernels (the block gate, one launch each)
    against ``dot_topk_plain`` by ``compare_lists``, its top score equal to
    the largest of ``block_max``'s maxima. Returns its numbers."""
    import torch

    from gorse_tpu_torch.ops import topk

    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    n = WIDE_BLOCKS * topk.BLOCK_N
    prep = topk.prepare_items(torch.randn((n, DIM), generator=gen, device=dev), device=dev)
    queries = torch.randn((WIDE_QUERIES, DIM), generator=gen, device=dev)
    qp = topk._pad_queries(queries, prep, WIDE_QUERIES)
    check(prep.table.shape[0] // topk.BLOCK_N == WIDE_BLOCKS, f"{WIDE_BLOCKS} blocks")
    wrappers = zero_counts()
    s, i = topk.dot_topk(queries, prep, WIDE_K, device=dev)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers if w.launches}
    check(launches == route_launches("block", sq=False), f"{n} items: launches {launches}")
    bm = topk.block_max(qp, prep.table, n)
    check(torch.equal(s[:, 0], bm.amax(dim=1)), f"{n} items: top score is the largest maximum")
    err = hold_lists(f"{n} items", (s, i), topk.dot_topk_plain(queries, prep, WIDE_K), qp,
                     prep.table)
    ms = median_ms(lambda: topk.dot_topk(queries, prep, WIDE_K, device=dev), 5)
    bm_ms = median_ms(lambda: topk.block_max(qp, prep.table, n), 5)
    del prep, bm
    torch.cuda.empty_cache()
    out = dict(items=n, blocks=WIDE_BLOCKS, queries=WIDE_QUERIES, k=WIDE_K, launches=launches,
               max_abs_err=err, dot_topk_ms=ms, block_max_ms=bm_ms)
    log(f"  {n} items ({WIDE_BLOCKS} blocks): the kernels' lists agree with the plain "
        "version; " + json.dumps(out))
    return out


def time_merge(qp, table, b: int, n: int, k: int, aff=None) -> dict:
    """``merge_timing`` at one shape, on the candidates of
    ``kernel_route``'s route."""
    from gorse_tpu_torch.ops import topk

    cand, count = topk._candidates(qp, table, b, n, k, topk.kernel_route(table.shape[0], k), aff)
    return merge_timing(cand, count, b, k, 5)


def phase_wide_k(dev, seed: int) -> dict:
    """Top-k above 2048 on the kernel route: a bf16 ``dot_topk`` at
    27,000 x 64, k = 4,096 (256 queries), and an sq ``MemoryVectorStore``
    of WIDE_K_ROWS rows queried at each of WIDE_KS, each held against the
    plain version by ``compare_lists``; ``merge_topk`` timed at each k.
    Returns their numbers."""
    import torch

    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.storage.vectors import MemoryVectorStore

    rng = np.random.default_rng(seed + 10)
    out = {}
    items = rng.standard_normal((ROUTE_SHAPES[0][0], DIM), dtype=np.float32)
    prep = topk.prepare_items(items, device=dev)
    queries = torch.as_tensor(rng.standard_normal((256, DIM), dtype=np.float32), device=dev)
    k = WIDE_KS[0]
    qp = topk._pad_queries(queries, prep, 256)
    err = hold_lists(f"bf16 {len(items)} items k={k}", topk.dot_topk(queries, prep, k, device=dev),
                     topk.dot_topk_plain(queries, prep, k), qp, prep.table)
    out[f"bf16_{len(items)}x{k}"] = dict(max_abs_err=err,
                                         merge=time_merge(qp, prep.table, 256, len(items), k))
    rows = rng.standard_normal((WIDE_K_ROWS, DIM), dtype=np.float32)
    store = MemoryVectorStore(device=dev)
    store.create_collection("wide", DIM, quantization="sq")
    store.add("wide", [f"v{j}" for j in range(WIDE_K_ROWS)], rows)
    q = rng.standard_normal((WIDE_K_QUERIES, DIM), dtype=np.float32)
    for k in WIDE_KS:
        lists, seconds, launches = query_counted(store, "wide", q, k)
        check(launches == route_launches(topk.kernel_route(topk._round_up(WIDE_K_ROWS, 256), k),
                                         sq=True), f"sq store k={k}: launches {launches}")
        prep = store._collections["wide"].encoded["prepared"]
        err = hold_store(f"sq store k={k}", store, "wide", q, k, prep, "dot", lists)
        qp, aff = topk._sq_operands(torch.as_tensor(q, device=dev), prep, WIDE_K_QUERIES, "dot")
        out[f"sq_{WIDE_K_ROWS}x{k}"] = dict(
            query_s=seconds, launches=launches, max_abs_err=err,
            merge=time_merge(qp, prep.table, WIDE_K_QUERIES, WIDE_K_ROWS, k, aff))
    for key, row in out.items():
        log(f"  {key}: the kernels' lists agree with the plain version; " + json.dumps(row))
    return out


# ---------------------------------------------------------------- phase 8


def neighbor_store(seed: int, embedding: bool = True, user_fields=()):
    """Phase 6's ml-1m-shaped feedback in a MemoryDataStore, its items with
    1-3 of 18 genres, a 16-float ``embedding`` label (with ``embedding``),
    a category and a timestamp, its users with one value of each of
    ``user_fields`` ((name, size) pairs), all from ``seed``."""
    from gorse_tpu_torch.data.loaders import synthetic_cf
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.types import Feedback, Item, User

    n_users, n_items, rank, density, data_seed = MASTER_SHAPE
    ds = synthetic_cf(n_users, n_items, rank, density, data_seed)
    rng = np.random.default_rng(seed)
    genres = [rng.choice(N_GENRES, size=rng.integers(1, GENRES_MAX + 1), replace=False)
              for _ in range(n_items)]
    embeddings = rng.standard_normal((n_items, EMBED_DIM), dtype=np.float32)
    stamps = rng.integers(0, 1_000_000, size=n_items)
    fields = [(name, rng.integers(size, size=n_users)) for name, size in user_fields]
    data = MemoryDataStore()
    data.insert_items(
        Item(f"i{i}", categories=[f"c{i % N_CATEGORIES}"], timestamp=float(stamps[i]),
             labels={"genre": [f"g{g}" for g in genres[i]],
                     **({"embedding": embeddings[i].tolist()} if embedding else {})})
        for i in range(n_items))
    data.insert_users(User(f"u{u}", labels={name: str(v[u]) for name, v in fields})
                      for u in range(n_users))
    data.insert_feedback(
        Feedback("like", f"u{u}", f"i{i}", 1.0, ts)
        for u, (fb, stamps) in enumerate(zip(ds.user_feedback, ds.timestamps))
        for i, ts in zip(fb, stamps)
    )
    return data


def hold_eals(train, dev, smi: str) -> dict:
    """One eALS epoch timed on the card (CUDA events), and the card's
    epochs 1 and 3 held against the port's on the CPU from the same
    factors."""
    import torch

    from gorse_tpu_torch.models import ALS

    card, cpu = ALS(device=dev), ALS(device="cpu")
    rng = np.random.default_rng(1)
    p0 = (card.init_stddev * rng.standard_normal((train.count_users(), card.n_factors))
          ).astype(np.float32)
    q0 = (card.init_stddev * rng.standard_normal((train.count_items(), card.n_factors))
          ).astype(np.float32)
    inputs, cpu_inputs = card.epoch_inputs(train), cpu.epoch_inputs(train)
    p, q = torch.as_tensor(p0, device=dev), torch.as_tensor(q0, device=dev)
    ms = median_ms(lambda: card.epoch(p, q, inputs), EALS_REPS)
    widths = [int(b.shape[1]) for b in inputs[0] + inputs[1]]
    # the epoch's factor-and-solve calls alone, on systems already formed
    k = card.n_factors
    a = torch.eye(k, device=dev) + torch.full((inputs[0][0].shape[0], k, k), 0.01, device=dev)
    rhs = torch.ones((a.shape[0], k, 1), device=dev)
    solve_ms = median_ms(lambda: [torch.cholesky_solve(rhs, torch.linalg.cholesky_ex(a)[0])
                                  for _ in widths], EALS_REPS)
    p_c, q_c = torch.as_tensor(p0), torch.as_tensor(q0)
    errors = {}
    for epoch in range(1, max(EALS_HOLD_EPOCHS) + 1):
        p, q = card.epoch(p, q, inputs)
        p_c, q_c = cpu.epoch(p_c, q_c, cpu_inputs)
        if epoch in EALS_HOLD_EPOCHS:
            for side, got, want in (("p", p, p_c), ("q", q, q_c)):
                share = float((got.cpu() - want).abs().max() / want.abs().max())
                errors[f"epoch{epoch}_{side}"] = share
                check(share <= EALS_TOL, f"eALS epoch {epoch}: {side} within {EALS_TOL} of its "
                      f"largest magnitude on the CPU (off by {share:.3g})")
    log(f"  eALS epoch {ms:.3f} ms on the card, its {len(widths)} blocks' cholesky_ex + "
        f"cholesky_solve alone {solve_ms:.3f} ms ({smi}); block widths "
        f"{min(widths)}-{max(widths)}; epochs {EALS_HOLD_EPOCHS} against the CPU, shares of "
        f"the largest magnitude: {json.dumps(errors)}")
    return {"epoch_ms": ms, "solve_ms": solve_ms, "hold": errors,
            "block_widths": [min(widths), max(widths)]}


def similarity_call(engine, dev):
    """The ops/similarity.py call of ``engine.pop_all`` on its pushed items,
    as a callable, and the most labels (or users, items) in one of its
    rows."""
    from gorse_tpu_torch.logics.item_to_item import AutoItemToItem, EmbeddingItemToItem
    from gorse_tpu_torch.ops import similarity as sim

    k = min(engine.n, len(engine.items) - 1)
    if isinstance(engine, EmbeddingItemToItem):
        x = np.stack(engine.vectors)
        return lambda: sim.embedding_neighbors(x, k, "euclidean", device=dev), 0
    if isinstance(engine, AutoItemToItem):
        halves = [(sim.incidence_matrix(e.label_lists, len(e.effective_idf())), e.effective_idf())
                  for e in (engine.tags, engine.users)]
        widest = max(int(inc.sum(1).max()) for inc, _ in halves)
        return lambda: sim.idf_neighbors_avg(*halves[0], *halves[1], k, device=dev), widest
    idf = engine.effective_idf()
    inc = sim.incidence_matrix(engine.label_lists, len(idf))
    return lambda: sim.idf_neighbors(inc, idf, k, device=dev), int(inc.sum(1).max())


def neighbor_lists(cache, collection: str, name: str, ids: list[str], index: dict):
    """Every entity's cached neighbours as (-distance, index) ``[n, k]``
    tensors (distance = 1 / score - 1), NEG_INF / 0 past a short list."""
    import torch

    from gorse_tpu_torch.ops.topk import NEG_INF
    from gorse_tpu_torch.storage.cache import key

    lists = [cache.search_scores(collection, key(name, e)) for e in ids]
    k = max(len(x) for x in lists)
    s = torch.full((len(ids), k), NEG_INF, dtype=torch.float64)
    i = torch.zeros((len(ids), k), dtype=torch.long)
    for row, scores in enumerate(lists):
        s[row, : len(scores)] = torch.tensor([1.0 - 1.0 / x.score for x in scores],
                                             dtype=torch.float64)
        i[row, : len(scores)] = torch.tensor([index[x.id] for x in scores])
    return s, i


def hold_neighbors(what, card, cpu, collection, name, ids, widest, sq=None) -> float:
    """The card master's lists of one entry against the CPU master's, by
    ``compare_lists`` on distances: IDF distances within ``(4 L + 16) 2^-24``
    (L = ``widest``), squared Euclidean ones within ``(4 d + 16) 2^-24
    (|x_i|^2 + |x_j|^2)`` (``sq`` = each row's |x|^2)."""
    import torch

    index = {e: n for n, e in enumerate(ids)}
    s, i = neighbor_lists(card.cache, collection, name, ids, index)
    s_p, i_p = neighbor_lists(cpu.cache, collection, name, ids, index)
    check(s.shape == s_p.shape, f"{what}: list lengths {tuple(s.shape)} and {tuple(s_p.shape)}")
    u = 2.0**-24
    if sq is None:
        tol = tol_p = torch.full(s.shape, (4 * widest + 16) * u, dtype=torch.float64)
    else:
        sq = torch.as_tensor(sq, dtype=torch.float64)
        tol, tol_p = ((4 * EMBED_DIM + 16) * u * (sq[:, None] + sq[j]) for j in (i, i_p))
    return compare_lists(what, s, i, s_p, i_p, tol, tol_p)


def phase_neighbors(dev, smi: str) -> dict:
    import torch

    from gorse_tpu_torch.logics.item_to_item import ItemToItemConfig, new_item_to_item
    from gorse_tpu_torch.logics.user_to_user import UserToUser, UserToUserConfig
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.rest import RestServer
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore, key
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.utils.config import (
        Config,
        ItemToItemConfigEntry,
        UserToUserConfigEntry,
    )

    t0 = time.perf_counter()
    data = neighbor_store(0)
    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.collaborative.model = "als"
    cfg.recommend.collaborative.fit_epoch = MASTER_EPOCHS
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.item_to_item = [
        ItemToItemConfigEntry(name=t, type=t, column="item.Labels.embedding" if t == "embedding"
                              else "") for t in I2I_TYPES]
    cfg.recommend.user_to_user = [UserToUserConfigEntry(name="items", type="items")]
    result = {"card": smi, "data_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        blobs = BlobStore(Path(tmp) / "blobs")
        master = Master(cfg, data, MemoryCacheStore(), blobs, MetaStore(), device=dev)
        t0 = time.perf_counter()
        loaded = master.load_dataset()
        result["load_s"] = time.perf_counter() - t0
        n_users, n_items = loaded.dataset.count_users(), loaded.dataset.count_items()

        # ---- eALS: one epoch timed, epochs held against the CPU, the master's fit
        result["eals"] = hold_eals(loaded.train, dev, smi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        master.train_collaborative_filtering(loaded)
        torch.cuda.synchronize()
        result["train_s"] = time.perf_counter() - t0
        fit_s = float(re.search(r"^\w*master_collaborative_filtering_fit_seconds (\S+)$",
                                master.metrics.render(), re.M).group(1))
        model_meta = json.loads(master.meta.get("CF_MODEL_META"))
        check(model_meta["type"] == "als" and type(master.cf_model).__name__ == "ALS",
              f"master: fitted {model_meta['type']}, want als")
        check(model_meta["score"] >= QUALITY_NDCG, f"master: eALS NDCG@10 {model_meta['score']}")
        result.update(fit_s=fit_s, ndcg=model_meta["score"])
        log(f"  master eALS fit ({MASTER_EPOCHS} epochs) {fit_s:.3f} s (gauge), NDCG@10 "
            f"{model_meta['score']:.4f} ({smi})")

        # ---- the worker serves its shard from the eALS index (its own counts)
        meta = master.get_meta()
        worker = Worker(cfg, data, master.cache, blobs, device=dev)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refreshed = worker.sync_and_recommend(meta)
        torch.cuda.synchronize()
        result["recommend_s"] = time.perf_counter() - t0
        launches = {n: getattr(topk, n).launches for n in KERNELS}
        check(refreshed == n_users, f"worker refreshed {refreshed} of {n_users} users")
        check(torch.equal(worker.cf_index.item_factors, master.cf_index.item_factors),
              "worker: serves the index of the master's eALS fit")
        check(all(c > 0 for c in launches.values()),
              f"worker on the eALS index: launches {launches}, each must be above 0")
        result["worker_topk_launches"] = launches
        log(f"  worker on the eALS index: {refreshed} users in {result['recommend_s']:.2f} s, "
            f"launches {json.dumps(launches)} ({smi})")

        # ---- the master's updates on the card, each timed, and its device share
        cpu = Master(cfg, data, MemoryCacheStore(), blobs, MetaStore(), device="cpu")
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        master.update_non_personalized(loaded)
        times["non_personalized"] = {"s": time.perf_counter() - t0, "device_ms": 0.0}
        cpu.update_non_personalized(loaded)
        entries = cfg.recommend.item_to_item
        tag_idf, user_idf = loaded.dataset.item_label_idf(), loaded.dataset.user_idf()
        widest = {}
        for entry in entries:
            cfg.recommend.item_to_item = [entry]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            master.update_item_to_item(loaded)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            engine = new_item_to_item(
                ItemToItemConfig(name=entry.name, type=entry.type, column=entry.column),
                cfg.recommend.cache_size, tag_idf=tag_idf, user_idf=user_idf,
                label_index=loaded.dataset.item_label_dict, device=dev)
            for item in loaded.items:
                engine.push(item, loaded.dataset.item_feedback[
                    loaded.dataset.item_dict.to_number(item.item_id)])
            call, widest[entry.name] = similarity_call(engine, dev)
            times[f"item_to_item/{entry.name}"] = {"s": took, "device_ms": median_ms(call, 3)}
            cpu.update_item_to_item(loaded)
        cfg.recommend.item_to_item = entries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        master.update_user_to_user(loaded)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        users = list(data.get_users())
        u2u = UserToUser(UserToUserConfig(name="items", type="items"), cfg.recommend.cache_size,
                         item_idf=loaded.dataset.item_idf(), device=dev)
        for user in users:
            u2u.push(user, loaded.dataset.user_feedback[
                loaded.dataset.user_dict.to_number(user.user_id)])
        call, widest["u2u"] = similarity_call(u2u._engine, dev)
        times["user_to_user/items"] = {"s": took, "device_ms": median_ms(call, 3)}
        cpu.update_user_to_user(loaded)
        for row in times.values():
            row["host_share"] = 1.0 - row["device_ms"] / 1e3 / row["s"]
        result["updates"] = times
        log(f"  updates on the card, s (similarity op ms by CUDA events, host share) ({smi}): "
            + json.dumps({k: [round(v["s"], 4), round(v["device_ms"], 3),
                              round(v["host_share"], 4)] for k, v in times.items()}))

        # ---- each cache held against the same update on the CPU
        np_names = sorted(master.cache.scan_score_subsets(ck.NON_PERSONALIZED))
        check(np_names == ["latest", "popular"], f"non-personalized caches {np_names}")
        for name in np_names:
            got, want = (m.cache.search_scores(ck.NON_PERSONALIZED, name) for m in (master, cpu))
            check([(s.id, s.score, s.categories) for s in got]
                  == [(s.id, s.score, s.categories) for s in want] and len(got) > 0,
                  f"non-personalized/{name}: the card's cache equals the CPU's")
        item_ids = [item.item_id for item in loaded.items]
        sq = np.square(np.stack([item.labels["embedding"] for item in loaded.items])).sum(1)
        worst = {}
        for entry in entries:
            worst[entry.name] = hold_neighbors(
                f"item-to-item/{entry.name}", master, cpu, ck.ITEM_TO_ITEM, entry.name, item_ids,
                widest[entry.name], sq if entry.type == "embedding" else None)
        worst["u2u/items"] = hold_neighbors("user-to-user/items", master, cpu, ck.USER_TO_USER,
                                            "items", [u.user_id for u in users], widest["u2u"])
        for k, v in master.cache._kv.items():
            if "item-to-item" in k or "user-to-user" in k or "non-personalized" in k:
                check(k in cpu.cache._kv and ("update_time" in k or cpu.cache._kv[k] == v),
                      f"{k}: the card's digest equals the CPU's")
        result["hold_worst"] = worst
        log(f"  caches equal to the CPU run's (ids exact where apart, distances within "
            f"tolerance; largest |d - d_cpu| / tol): {json.dumps(worst)}")

        # ---- REST: the chain reaches an item-to-item cache, then popular
        cfg.recommend.ranker.recommenders = ["item-to-item/users"]
        cfg.recommend.fallback.recommenders = ["non-personalized/popular"]
        uid = "u1"
        history = sorted(data.get_user_feedback(uid), key=lambda f: -f.timestamp)
        seen = {f.item_id for f in history}
        agg = {}
        for fb in history[: cfg.recommend.context_size]:
            for s in master.cache.search_scores(ck.ITEM_TO_ITEM, key("users", fb.item_id), [],
                                                0, cfg.recommend.cache_size):
                if s.id not in seen:
                    agg[s.id] = agg.get(s.id, 0.0) + s.score
        want = [i for i, _ in sorted(agg.items(), key=lambda kv: -kv[1])][: cfg.recommend.cache_size]
        popular = [s.id for s in master.cache.search_scores(
            ck.NON_PERSONALIZED, "popular", [""], 0, cfg.recommend.cache_size)
            if s.id not in seen and s.id not in want]
        n = len(want) + min(len(popular), 20)
        want = (want + popular)[:n]
        server = RestServer(cfg, data, master.cache)
        httpd = server.serve("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", f"/api/recommend/{uid}?n={n}")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
        finally:
            server.shutdown()
        check(resp.status == 200 and body == want and len(popular) > 0,
              f"GET /api/recommend/{uid}?n={n}: the item-to-item aggregate, then popular")
        log(f"  GET /api/recommend/{uid}?n={n}: {len(want) - min(len(popular), 20)} from "
            f"item-to-item/users, {min(len(popular), 20)} from non-personalized/popular")
    result.update(users=n_users, items=n_items, feedback=loaded.train.count_feedback(),
                  refreshed=refreshed)
    return result


# ---------------------------------------------------------------- phase 9


def table_shares(got, want) -> dict:
    """Each AFM table's largest difference as a share of its largest
    magnitude (``got`` on any device, ``want`` on the CPU)."""
    a, b = got.to_numpy(), want.to_numpy()
    return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}


def step_launches(fn) -> tuple[int | None, float | None]:
    """CUDA kernels launched by ``fn`` and their summed device ms, from a
    ``torch.profiler`` trace; (None, None) when it recorded no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None
    return len(kernels), sum(e.device_time for e in kernels) / 1e3


def hold_afm(dev, smi: str) -> dict:
    """The AFM at stage_afm's shape: its first epoch on the card held
    against the same epoch on the CPU, epochs timed (CUDA events, and the
    host clock ending on a synchronise), kernels a step; then the accuracy
    gate of tests/test_fm.py on the card."""
    import torch

    from gorse_tpu_torch.data.ctr import synthetic_ctr
    from gorse_tpu_torch.models.fm import AFM, make_optimizer, train_epoch
    from gorse_tpu_torch.models.params import FitConfig, Params

    t0 = time.perf_counter()
    data = synthetic_ctr(**AFM_SHAPE)
    data_s = time.perf_counter() - t0
    hp = Params(n_factors=AFM_K, batch_size=AFM_BATCH)
    card, cpu = AFM(hp, device=dev), AFM(hp, device="cpu")
    pad = data.padded(data.max_dimension())
    batches, cpu_batches = card._batch(pad, AFM_BATCH), cpu._batch(pad, AFM_BATCH)
    n_steps, n_padded = batches[0].shape[0], batches[0].shape[0] * AFM_BATCH
    params = card._init_params(data.num_features(), [], 0)
    cpu_params = cpu._init_params(data.num_features(), [], 0)
    opt = make_optimizer(card.optimizer_name, params.parameters(), card.lr, card.reg)
    cpu_opt = make_optimizer(cpu.optimizer_name, cpu_params.parameters(), cpu.lr, cpu.reg)
    cost = float(train_epoch(params, opt, batches))
    cpu_cost = float(train_epoch(cpu_params, cpu_opt, cpu_batches))
    shares = table_shares(params, cpu_params)
    for name, share in shares.items():
        check(share <= AFM_TOL, f"AFM first epoch: {name} within {AFM_TOL} of its largest "
              f"magnitude on the CPU (off by {share:.3g})")
    check(abs(cost - cpu_cost) <= AFM_TOL * abs(cpu_cost),
          f"AFM first epoch: loss {cost} against the CPU's {cpu_cost}")
    epoch_ms = median_ms(lambda: train_epoch(params, opt, batches), AFM_REPS)
    host = []
    for _ in range(AFM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_epoch(params, opt, batches)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    host_s = statistics.median(host)
    n_kernels, device_ms = step_launches(lambda: train_epoch(params, opt, batches))
    result = {
        "card": smi, "data_s": data_s, "features": data.num_features(),
        "slots": int(pad.indices.shape[1]), "steps": n_steps, "padded_examples": n_padded,
        "first_epoch_shares": shares, "epoch_ms": epoch_ms, "epoch_host_s": host_s,
        "examples_per_s": n_padded / host_s, "ms_per_step": epoch_ms / n_steps,
        "kernels_per_step": None if n_kernels is None else n_kernels / n_steps,
        "device_busy_share": None if device_ms is None else device_ms / epoch_ms,
    }
    log(f"  AFM epoch at stage_afm's shape ({data.num_features()} features, "
        f"{pad.indices.shape[1]} slots, k = {AFM_K}, {n_steps} steps of {AFM_BATCH}): "
        f"{epoch_ms:.2f} ms by CUDA events, {1e3 * host_s:.2f} ms on the host clock, "
        f"{n_padded / host_s:,.0f} padded examples/s, {epoch_ms / n_steps:.3f} ms a step, "
        f"kernels a step {result['kernels_per_step']}, device busy share "
        f"{result['device_busy_share']} ({smi}); first epoch against the CPU, shares of the "
        f"largest magnitude: {json.dumps(shares)}")

    gate = synthetic_ctr(n_samples=4000, seed=0)
    train, test = gate.split(0.2, seed=1)
    model = AFM(Params(n_factors=8, n_epochs=60, lr=0.01, reg=1e-4, batch_size=512), device=dev)
    t0 = time.perf_counter()
    score = model.fit(train, test, FitConfig(verbose=20))
    result["gate"] = {"auc": score.auc, "fit_s": time.perf_counter() - t0}
    check(score.auc > AFM_GATE_AUC, f"test_fm's gate on the card: AUC {score.auc}")
    log(f"  tests/test_fm.py's gate on the card: AUC {score.auc:.4f} (> {AFM_GATE_AUC}) in "
        f"{result['gate']['fit_s']:.2f} s ({smi})")
    return result


def gauge(registry, name: str, labels: str = "") -> float:
    """A gauge's value from the registry's text rendering."""
    found = re.search(rf"^\w*{name}{re.escape(labels)} (\S+)$", registry.render(), re.M)
    check(found is not None, f"gauge {name}{labels} was set")
    return float(found.group(1))


def phase_ctr(dev, smi: str) -> dict:
    import torch

    from gorse_tpu_torch.models.fm import AFM, afm_params_from_numpy, make_optimizer, train_epoch
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.rest import RestServer
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.meta import CLICK_THROUGH_RATE_MODEL, MetaStore
    from gorse_tpu_torch.storage.types import Score
    from gorse_tpu_torch.utils.config import Config

    result = {"afm": hold_afm(dev, smi)}
    t0 = time.perf_counter()
    data = neighbor_store(0, embedding=False, user_fields=USER_FIELDS)
    result["data_s"] = time.perf_counter() - t0
    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.collaborative.fit_epoch = MASTER_EPOCHS
    cfg.recommend.ranker.type = "fm"
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.ranker.fit_epoch = CTR_EPOCHS
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        blobs = BlobStore(Path(tmp) / "blobs")
        master = Master(cfg, data, MemoryCacheStore(), blobs, MetaStore(), device=dev)
        # ---- the master's whole cycle on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = master.run_tasks_once()
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        while master._sizeof_busy and time.perf_counter() - t0 < 300:
            time.sleep(0.1)
        check(not master._sizeof_busy, "the master's memory accounting finished")
        accounting_s = time.perf_counter() - t0
        ctr = loaded.ctr
        steps = {step: gauge(master.metrics, "master_load_dataset_step_seconds",
                             f'{{step="{step}"}}')
                 for step in ("load_items", "load_users", "load_positive_feedback",
                              "split_ranking_dataset", "create_ranking_dataset")}
        fit_s = gauge(master.metrics, "master_ranking_fit_seconds")
        auc = gauge(master.metrics, "master_ranking_model_auc")
        ctr_id, cf_id = master.meta.get(CLICK_THROUGH_RATE_MODEL), master.get_meta()["cf_model_id"]
        check(blobs.list() == sorted([cf_id, ctr_id]),
              f"collect_garbage left the two live blobs: {blobs.list()}")
        check(master.ctr_model.n_epochs == CTR_EPOCHS and 0.5 < auc <= 1.0,
              f"master: the AFM fit {CTR_EPOCHS} epochs, AUC {auc}")
        memory = {k: gauge(master.metrics, "master_memory_inuse_bytes", f'{{data="{k}"}}')
                  for k in ("dataset", "cf_index", "ctr_model")}
        result.update(
            cycle_s=cycle_s, load_steps=steps, ctr_rows=len(ctr),
            ctr_features=ctr.num_features(), ctr_slots=ctr.max_dimension(),
            ctr_positive=ctr.count_positive(), ranking_fit_s=fit_s, ranking_auc=auc,
            cf_fit_s=gauge(master.metrics, "master_collaborative_filtering_fit_seconds"),
            accounting_s=accounting_s, memory_inuse_bytes=memory, blobs=blobs.list())
        log(f"  master cycle on the card {cycle_s:.2f} s ({smi}): load steps "
            f"{json.dumps({k: round(v, 3) for k, v in steps.items()})}; CTR dataset "
            f"{len(ctr)} rows ({ctr.count_positive()} positive), {ctr.num_features()} features, "
            f"at most {ctr.max_dimension()} slots; CTR fit ({CTR_EPOCHS} epochs) {fit_s:.2f} s "
            f"(gauge), AUC {auc:.4f}; BPR fit {result['cf_fit_s']:.3f} s; memory accounting "
            f"{accounting_s:.1f} s after the cycle; blobs {blobs.list()}")

        # ---- one epoch of the master's AFM by CUDA events, and the first
        # epoch of a card master's fit against a CPU master's
        model = master.ctr_model
        train, test = ctr.split(0.2, seed=0)
        batches = model._batch(train.padded(model.num_dimension), model.batch_size)
        params = afm_params_from_numpy(model.model_params.to_numpy(), dev)
        opt = make_optimizer(model.optimizer_name, params.parameters(), model.lr, model.reg)
        result["ctr_epoch_ms"] = median_ms(lambda: train_epoch(params, opt, batches), 1)
        result["ctr_steps"] = int(batches[0].shape[0])
        del batches, params, opt
        cfg.recommend.ranker.fit_epoch = 1
        fits = {}
        for device in (dev, "cpu"):
            m = Master(cfg, data, MemoryCacheStore(), BlobStore(Path(tmp) / f"hold_{device}"),
                       MetaStore(), device=device)
            m.train_click_through_rate(loaded)
            fits[str(device)] = m.ctr_model
        cfg.recommend.ranker.fit_epoch = CTR_EPOCHS
        card_fit, cpu_fit = fits[str(dev)], fits["cpu"]
        shares = table_shares(card_fit.model_params, cpu_fit.model_params)
        for name, share in shares.items():
            check(share <= AFM_TOL, f"master's CTR fit, one epoch: {name} within {AFM_TOL} of its "
                  f"largest magnitude on the CPU master's (off by {share:.3g})")
        result["ctr_hold_shares"] = shares
        log(f"  the master's AFM epoch {result['ctr_epoch_ms']:.1f} ms by CUDA events "
            f"({result['ctr_steps']} steps, {result['ctr_epoch_ms'] / result['ctr_steps']:.3f} "
            f"ms a step) ({smi}); one-epoch fit against a CPU master's, shares of the largest "
            f"magnitude: {json.dumps(shares)}")
        del fits, card_fit, cpu_fit

        # ---- the worker re-ranks its shard with the AFM (its own counts)
        worker = Worker(cfg, data, master.cache, blobs, device=dev)
        predict_ms = []

        def timed_predict(*args, _inner=None, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = _inner(*args, **kwargs)
            end.record()
            end.synchronize()
            predict_ms.append(start.elapsed_time(end))
            return out

        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        worker.pull_models(cf_id, ctr_id)
        inner = worker.ctr_model.predict_padded
        worker.ctr_model.predict_padded = lambda *a, **k: timed_predict(*a, _inner=inner, **k)
        refreshed = worker.sync_and_recommend(master.get_meta())
        torch.cuda.synchronize()
        recommend_s = time.perf_counter() - t0
        launches = {n: getattr(topk, n).launches for n in KERNELS}
        n_users = loaded.dataset.count_users()
        check(refreshed == n_users, f"worker refreshed {refreshed} of {n_users} users")
        check(worker.ctr_model_id == ctr_id and worker.ctr_model.device == dev,
              "worker: pulled the master's AFM onto the card")
        check(all(c > 0 for c in launches.values()),
              f"worker's CF recall: launches {launches}, each must be above 0")
        ranking_s = gauge(worker.metrics, "worker_offline_recommend_step_seconds",
                          '{step="ranking"}')
        device_s = sum(predict_ms) / 1e3
        result.update(recommend_s=recommend_s, worker_topk_launches=launches,
                      ranking_s=ranking_s, batch_predict_ms=sum(predict_ms),
                      ranking_host_share=1.0 - device_s / ranking_s, refreshed=refreshed)
        log(f"  worker with the fm ranker: {refreshed} users in {recommend_s:.2f} s; ranking "
            f"step {ranking_s:.3f} s, its batch_predict {sum(predict_ms):.1f} ms by CUDA events "
            f"(host share {result['ranking_host_share']:.4f}); CF recall launches "
            f"{json.dumps(launches)} ({smi})")

        # ---- a sample of caches against a CPU batch_predict of the same
        # candidates by the same saved model, tie-aware
        cpu_worker = Worker(cfg, data, MemoryCacheStore(), blobs, device="cpu")
        cpu_worker.pull_models("", ctr_id)
        rng = np.random.default_rng(3)
        users = [f"u{u}" for u in sorted(rng.choice(n_users, MASTER_SAMPLE_USERS, replace=False))]
        worst = 0.0
        for uid in users:
            got = master.cache.search_scores(ck.RECOMMEND, uid)
            check(len(got) == cfg.recommend.cache_size, f"{uid}: {len(got)} ranked candidates")
            want = cpu_worker._rank({uid: [Score(s.id, 0.0, s.categories) for s in got]})[uid]
            s = torch.tensor([[x.score for x in got]], dtype=torch.float64)
            s_p = torch.tensor([[x.score for x in want]], dtype=torch.float64)
            index = {x.id: n for n, x in enumerate(want)}
            i = torch.tensor([[index[x.id] for x in got]])
            i_p = torch.arange(len(want))[None, :]
            tol = RANK_TOL * (1.0 + s_p.abs())
            worst = max(worst, compare_lists(f"{uid}: fm ranking", s, i, s_p, i_p,
                                             RANK_TOL * (1.0 + s.abs()), tol))
        result["rank_hold_worst"] = worst
        log(f"  {len(users)} users' recommend caches equal a CPU batch_predict of the same "
            f"candidates (tie-aware; largest |s - s_cpu| / tol {worst:.3g})")

        server = RestServer(cfg, data, master.cache)
        httpd = server.serve("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", "/api/recommend/u1")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
        finally:
            server.shutdown()
        want = [s.id for s in master.cache.search_scores(ck.RECOMMEND, "u1")]
        check(resp.status == 200 and body == want[: cfg.server.default_n] and body,
              "GET /api/recommend/u1 equals the recommend cache")
    return result


# ---------------------------------------------------------------- main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run after phase 1 (default: all); "
                             "a partial run prints its numbers and no result line")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if any(x not in PHASES for x in phases):
        parser.error(f"--phases: choose from {','.join(PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import gorse_tpu_torch

    if Path(gorse_tpu_torch.__file__).resolve().parent != ROOT / "gorse_tpu_torch":
        print(f"chip_smoke: gorse_tpu_torch is not this checkout's ({gorse_tpu_torch.__file__})",
              file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "no JAX loaded")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    out = {}

    log("== phase 1: environment")
    smi = phase_environment()

    if "2" in phases or "3" in phases:
        t0 = time.perf_counter()
        user_factors, item_factors, histories = make_data(args.seed)
        log(f"  data made in {time.perf_counter() - t0:.1f} s")
    if "2" in phases:
        log("== phase 2: kernels")
        prep, out["errors"], out["timings"], out["k_path"] = phase_kernels(
            user_factors, item_factors, histories, dev)
        del prep
        torch.cuda.empty_cache()
    if "2b" in phases:
        log("== phase 2b: K6's function at 27,000 and 500,000 items, both routes")
        route_errors, out["routes"] = phase_routes(dev, args.seed)
        errors = out.setdefault("errors", {})
        for key, v in route_errors.items():
            errors[key] = max(errors.get(key, 0.0), v)
        torch.cuda.empty_cache()
    if "2c" in phases:
        log(f"== phase 2c: a catalog of {WIDE_BLOCKS} item blocks")
        out["wide_catalog"] = phase_wide_catalog(dev, args.seed)
    if "3" in phases:
        log("== phase 3: path")
        out["path"] = phase_path(user_factors, item_factors, histories, dev, args.seed)
        log("  path: " + json.dumps(out["path"]))
    if "2" in phases or "3" in phases:
        del user_factors, item_factors, histories
        torch.cuda.empty_cache()

    if "4" in phases or "5" in phases:
        t0 = time.perf_counter()
        train, test, csr = make_training_data()
        log(f"  training data made in {time.perf_counter() - t0:.1f} s: {train.count_users()} "
            f"users, {train.count_items()} items, {train.count_feedback()} train feedback, "
            f"padded width {csr.padded.shape[1]}")
    if "4" in phases:
        log("== phase 4: BPR kernels")
        n_active = max(int((csr.counts > 0).sum()), 1)
        out["bpr_errors"], out["bpr_timings"] = phase_bpr_kernels(
            csr, dev, max(round(train.count_feedback() / n_active), 1))
        out["path_launches"] = phase_pairs_path(csr, dev)
    if "5" in phases:
        log("== phase 5: training")
        out["training"] = phase_training(train, test, csr, dev)
        log("  training: " + json.dumps(out["training"]))
    if "4" in phases or "5" in phases:
        del train, test, csr

    if "6" in phases:
        log("== phase 6: master")
        out["master"] = phase_master(dev)
        log("  master: " + json.dumps(out["master"]))
    if "7" in phases:
        log("== phase 7: vector store")
        out["sq_errors"], out["sq_timings"], out["store"] = phase_vector_store(dev, args.seed)
        log("  store: " + json.dumps(out["store"]))
    if "7c" in phases:
        log("== phase 7c: top-k above 2048")
        out["wide_k"] = phase_wide_k(dev, args.seed)
    if "8" in phases:
        log("== phase 8: eALS and neighbours")
        out["neighbors"] = phase_neighbors(dev, smi)
        log("  neighbors: " + json.dumps(out["neighbors"]))
    if "9" in phases:
        log("== phase 9: CTR ranker and the master's cycle")
        out["ctr"] = phase_ctr(dev, smi)
        log("  ctr: " + json.dumps(out["ctr"]))
    check("jax" not in sys.modules and "gorse_tpu" not in sys.modules,
          "neither JAX nor gorse_tpu was imported")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    if len(phases) < len(PHASES):
        print(json.dumps({"partial": phases, **{key: out[key] for key in out if key != "errors"}},
                         default=str))
        print(smi)
        return 0
    print(json.dumps({"kernels": kernel_rows(out)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def kernel_rows(out: dict) -> list[dict]:
    """The kernels' JSON rows: launches from each kernel's path, times at
    the main path's shapes."""
    rows = out["timings"][out["k_path"]]
    path = out["path"]
    log(f"  kernel time per chunk {rows['topk_gated']['ms']:.3f} ms = "
        f"{100 * rows['topk_gated']['ms'] / path['ms_per_chunk']:.1f}% of a chunk's search_users")

    def row(name, source, replaces, launches, err, timing):
        return {"name": name, "route": "cuda", "source": f"gorse_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                **{key: timing[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")}}

    # the serving path's launches (phase 3) with the fm worker's recall (phase 9)
    kernels = [row(name, "topk.cu", REPLACES[name],
                   path["launches"][name] + out["ctr"]["worker_topk_launches"][name],
                   out["errors"][name], rows[name]) for name in KERNELS]
    # the training path's launches of bpr_epoch (phase 5); the sweeps' from
    # their own paths (phase 4). No single PyTorch call computes a sweep or
    # an epoch, so library_ms is null.
    bpr_launches = dict(out["training"]["launches"], **out["path_launches"])
    kernels += [row(name, "bpr.cu", BPR_REPLACES[name], bpr_launches[name],
                    out["bpr_errors"][name], out["bpr_timings"][name]) for name in BPR_KERNELS]
    # the SQ kernels: launches from the store path (phase 7b), times at the
    # 1M x 64 dot shape (phase 7a)
    kernels += [row(name, "topk.cu", SQ_REPLACES[name], out["store"]["launches"][name],
                    out["sq_errors"][name], out["sq_timings"]["dot"][name]) for name in SQ_KERNELS]
    log("  K6 routes (ms old -> new, library, candidates new): " + json.dumps({
        shape: [r["old"]["ms"], r["new"]["ms"], r["new"]["library_ms"], r["new"]["candidates"]]
        for shape, r in out["routes"].items()}))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
