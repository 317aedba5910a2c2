#!/usr/bin/env python3
"""Smoke run of gorse_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda`` or ``CUDA_HOME``) and ``nvidia-smi``. Phases, in order;
any failure ends the run with a non-zero exit code:

1. Environment: the card's name and power limit, the torch version, and the
   build of ``gorse_tpu_torch/csrc/topk.cu`` and ``bpr.cu`` (one nvcc each,
   started together) with its seconds.
2. Kernels: every kernel of the serving path (``block_max``, ``block_seeds``,
   ``block_topk`` gated and ungated, ``merge_topk``) held against its plain
   PyTorch version
   on the card, on small tie-heavy inputs and at the serving shape (1M x 64
   bf16 items, a 256-user chunk, k = 10 and the path's k = 100 + widest
   history). Indices must be equal and scores equal (tolerance 0: kernel and
   plain version sum in the same order). Then each kernel's median time
   (CUDA events), bound, plain time and library time, and the whole top-k
   per chunk, gated (K4 + K5) and ungated (K6), against the bound of the
   top-k itself.
3. Path: a 1,000,000 x 64 item index and 50,000 users, made from ``--seed``,
   saved in gorse_tpu's index format to a blob store; a 4,096-user shard with
   feedback histories of up to 200 items in a MemoryDataStore;
   ``Worker.pull_models`` + ``Worker.recommend`` on the card, with every
   kernel launched and the f32 route unused; a sample of users' lists held
   against the plain version on the card; ``GET /api/recommend/...`` through
   ``RestServer`` on 127.0.0.1, equal to the cache.
4. BPR kernels: ``bpr_sweep`` in both modes (sampled, explicit pairs) and
   ``bpr_fold`` held against their plain PyTorch versions on the card, on
   small tie-heavy inputs (repeated items in a sweep, users with no
   positives, one item in every history; k = 8, 16, 64; f32 and bf16) and
   at the training shape below. Sampled pos and neg must be equal and the
   fold exact; p_new and the cost agree to 1e-5 relative + 1e-7 absolute
   (the dot products sum in another order and expf/log1pf differ from
   torch's by ulps), delta to that plus the most two summation orders of a
   row's adds can differ (atomics add in any order). The pairs mode fed the
   sampled mode's pairs must give its p_new and delta. Then each kernel's
   median time, bound and plain time, and one epoch of the explicit-pairs
   path (the reference's sharded-fused step on one card).
5. Training: ``BPR.fit`` at k = 64 on ``synthetic_cf_access(138000, 27000,
   nnz=2000000, seed=1)`` (the repo's bpr_ml20m_shape_k64) for a few epochs,
   every epoch launching ``n_steps`` sweeps and folds, the first epoch held
   against its plain version on the card; examples/s per epoch. Quality: ``synthetic://400,300,8,0.08,1`` at k = 8 for 20 epochs
   reaches NDCG@10 >= 0.35 and agrees with the fit's plain version on the
   CPU.
6. Master: feedback rows of the ml-1m-shaped ``synthetic_cf`` in a
   MemoryDataStore; ``Master.load_dataset`` and
   ``train_collaborative_filtering`` (fit_epoch cut to 10) on the card;
   the index saved to a blob store; ``Worker.sync_and_recommend`` of the
   master's meta fills every user's cache; a sample of lists equals the
   plain top-k and ``GET /api/recommend`` equals the cache.

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
# block_topk and merge_topk ungated replace K6.
REPLACES = {
    "block_max": "gorse_tpu/ops/topk.py:361",
    "block_seeds": "gorse_tpu/ops/topk.py:442",
    "block_topk": "gorse_tpu/ops/topk.py:442",
    "merge_topk": "gorse_tpu/ops/topk.py:442",
}
KERNELS = ("block_max", "block_seeds", "block_topk", "merge_topk")

# BPR: the sampled sweep replaces K2 (and is K1's body per step), the pairs
# sweep K3, the fold K1's sweep boundary (bpr_kernel.py:392)
BPR_KERNELS = ("bpr_sweep_sampled", "bpr_sweep_pairs", "bpr_fold")
BPR_REPLACES = {
    "bpr_sweep_sampled": "gorse_tpu/ops/bpr_kernel.py:285",
    "bpr_sweep_pairs": "gorse_tpu/ops/bpr_kernel.py:206",
    "bpr_fold": "gorse_tpu/ops/bpr_kernel.py:329",
}
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


def bound(bytes_moved: float, flops: float, flop_s: float = BF16_FLOP_S) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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
            if "Used" in line or "spill" in line:
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


def hold_kernels(name: str, queries, prep, k: int) -> dict:
    """Each kernel against its plain version on the card: equal outputs.
    Returns the largest absolute score difference seen per kernel."""
    import torch

    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    qp = topk._pad_queries(queries, prep, topk._round_up(b, topk.QUERY_TILE))
    err = {}
    bm = topk.block_max(qp, prep.table, prep.n_items)
    bm_plain = topk.block_max_plain(qp, prep.table, prep.n_items)
    check(torch.equal(bm, bm_plain), f"{name}: block_max equals its plain version")
    err["block_max"] = float((bm - bm_plain).abs().max())
    gate = topk.block_seeds(bm_plain, b, k)
    gate_p = topk.block_seeds_plain(bm_plain, b, k)
    check(torch.equal(gate.seeds, gate_p.seeds) and torch.equal(gate.fired, gate_p.fired),
          f"{name}: block_seeds equals its plain version")
    err["block_seeds"] = float((gate.seeds - gate_p.seeds).abs().max())
    err["block_topk"] = err["merge_topk"] = 0.0
    for gated in (True, False):
        cand, count = topk.block_topk(qp, prep.table, gate if gated else None, b,
                                      prep.n_items, k)
        cand_p, count_p = topk.block_topk_plain(qp, prep.table, gate_p if gated else None, b,
                                                prep.n_items, k)
        check(torch.equal(count, count_p), f"{name} gated={gated}: block_topk counts")
        live, live_p = _sorted_live(cand, count), _sorted_live(cand_p, count_p)
        width = live_p.shape[1]
        check(torch.equal(live[:, :width], live_p), f"{name} gated={gated}: block_topk keys")
        filled = live_p[:b] != topk._INT64_MIN
        if bool(filled.any()):
            diff = (topk._decode(live[:b, :width])[0] - topk._decode(live_p[:b])[0]).abs()
            err["block_topk"] = max(err["block_topk"], float(diff[filled].max()))
        s, i = topk.merge_topk(cand, count, b, k)
        s_p, i_p = topk.merge_topk_plain(cand_p, count_p, b, k)
        check(torch.equal(i, i_p) and torch.equal(s, s_p), f"{name} gated={gated}: merge_topk")
        err["merge_topk"] = max(err["merge_topk"], float((s - s_p).abs().max()))
        log(f"  {name} k={k} gated={gated}: equal; candidates per query "
            f"{int(count[:b].min())}..{int(count[:b].max())} in a buffer of {cand.shape[1]}")
    s, i = topk.dot_topk(queries, prep, k)
    s_p, i_p = topk.dot_topk_plain(queries, prep, k)
    check(torch.equal(i, i_p) and torch.equal(s, s_p), f"{name}: dot_topk route")
    # the plain version itself against an independent f32 product of the
    # bf16-rounded operands (summation order differs: 1e-4 relative)
    qb = queries[:, : prep.dim].to(torch.bfloat16).float()
    rescored = (qb @ prep.table[:, : prep.dim].float().T).gather(1, i_p.long())
    real = s_p > topk.NEG_INF / 2
    check(torch.allclose(rescored[real], s_p[real], rtol=1e-4, atol=1e-4),
          f"{name}: plain scores equal an f32 product to 1e-4")
    return err


def small_cases(dev):
    """Tie-heavy shapes: integer factors, all-equal scores, one hot block."""
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
    return [
        (name, torch.as_tensor(q, device=dev), topk.prepare_items(items, device=dev), k)
        for name, q, items, k in cases
    ]


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
    out["block_max"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)

    gate = topk.block_seeds(bm, b, k)
    ms = median_ms(lambda: topk.block_seeds(bm, b, k), 20)
    plain = median_ms(lambda: topk.block_seeds_plain(bm, b, k), 3)
    lib = None  # the k-th largest block maximum: no seed when k > n_blocks
    if k <= nb:
        lib = median_ms(lambda: torch.kthvalue(bm[:b], nb - k + 1, dim=1), 20)
    bms, by = bound(b * nb * 4 + b * 8, 0.0)
    out["block_seeds"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)

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
        live = torch.arange(cand.shape[1], device=qp.device)[None] < count[:, None]
        keys = torch.where(live, cand, topk._INT64_MIN)[:b]
        m_ms = median_ms(lambda: topk.merge_topk(cand, count, b, k), 20)
        m_plain = median_ms(lambda: topk.merge_topk_plain(cand, count, b, k), 3)
        m_lib = median_ms(lambda: torch.topk(keys, k, dim=1), 20)
        bms, by = bound(int(count[:b].sum()) * 8 + b * 4 + b * k * 8, 0.0)
        out["merge_topk" + suffix] = dict(ms=m_ms, plain_ms=m_plain, bound_ms=bms, bound_by=by,
                                          library_ms=m_lib)
        del cand, count, keys, live
        torch.cuda.empty_cache()
        first = ("block_max", "block_seeds") if gated else ()
        out["topk" + ("_gated" if gated else "_ungated")] = dict(
            ms=sum(out[x]["ms"] for x in first) + ms + m_ms,
            plain_ms=sum(out[x]["plain_ms"] for x in first) + plain + m_plain,
            bound_ms=fn_ms, bound_by=fn_by, library_ms=lib_topk,
            candidate_bytes=cand_bytes - b_pad * 4,
        )
    return out


def phase_kernels(user_factors, item_factors, histories, dev):
    """Returns (prep, errors, timings, main-path k)."""
    import torch

    from gorse_tpu_torch.ops import topk

    errors: dict[str, float] = {}

    def merge_err(e):
        for key, v in e.items():
            errors[key] = max(errors.get(key, 0.0), v)

    for name, q, prep, k in small_cases(dev):
        merge_err(hold_kernels(name, q, prep, k))

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
        # the plain version on the card
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
        s_p, i_p = topk.dot_topk_plain(q, cf_index._prepared_items, fetch)
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        for row, u_idx in enumerate(sample):
            banned = set(histories[u_idx].tolist())
            want = [(item_names[j], float(s)) for s, j in zip(s_p[row], i_p[row])
                    if j not in banned][: cfg.recommend.cache_size]
            got = [(s.id, s.score) for s in cache.search_scores(ck.COLLABORATIVE, shard[u_idx])]
            check(got == want, f"{shard[u_idx]}: cache equals the plain version")
        log(f"  {SAMPLE_USERS} sampled users equal the plain version on the card")

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
    """Every kernel wrapper of both slices, its launch count set to 0."""
    from gorse_tpu_torch.ops import bpr_kernel, topk

    wrappers = [getattr(topk, n) for n in KERNELS] + [getattr(bpr_kernel, n) for n in BPR_KERNELS]
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
    """Both sweep modes and the fold against their plain versions on the
    card. Returns the largest absolute difference seen per kernel."""
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

    qk, qp = q.clone(), q.clone()
    dfk, dfp = dk.clone(), dk.clone()
    bk.bpr_fold(qk, dfk)
    bk.bpr_fold_plain(qp, dfp)
    torch.cuda.synchronize()
    check(torch.equal(qk, qp) and not bool(dfk.any()), f"{name}: fold equals its plain version")
    err["bpr_fold"] = float((qk - qp).abs().max())
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


def phase_bpr_kernels(csr, dev) -> tuple[dict, dict]:
    """Returns (errors, timings) per BPR kernel."""
    import torch

    from gorse_tpu_torch.models.bpr import adaptive_neg_tries
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import sampling

    errors: dict[str, float] = {}

    def merge_err(e):
        for key_, v in e.items():
            errors[key_] = max(errors.get(key_, 0.0), v)

    key = sampling.raw_step_keys(sampling.prng_key(3), 2)
    for name, p, q, padded, counts in bpr_small_cases(dev):
        for mm in (torch.float32, torch.bfloat16):
            merge_err(hold_bpr(f"{name} {str(mm)[6:]}", p, q, padded, counts, key[0], mm))
    log("  small cases: every kernel within tolerance of its plain version")

    rng = np.random.default_rng(5)
    n_users, n_items, k = TRAIN_USERS, TRAIN_ITEMS, TRAIN_DIM
    p = torch.as_tensor(rng.normal(scale=0.1, size=(n_users, k)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.normal(scale=0.1, size=(n_items, k)).astype(np.float32), device=dev)
    padded = torch.as_tensor(csr.padded, device=dev)
    counts = torch.as_tensor(csr.counts, device=dev)
    n_tries = adaptive_neg_tries(float(np.mean(csr.counts)) / n_items)
    merge_err(hold_bpr("full width", p, q, padded, counts, key[1], torch.float32, n_tries))
    log(f"  full width ({n_users} users, {n_items} items, k = {k}, L = {padded.shape[1]}, "
        f"n_tries = {n_tries}): within tolerance; errors {json.dumps(errors)}")

    # ---- times at the training shape
    delta, cost = torch.zeros_like(q), torch.zeros((1,), device=dev)
    _, pos, neg = bk.bpr_sweep_sampled(p, q, delta, cost, padded, counts, key[1], n_items,
                                       LR, REG, n_tries)
    active = (counts > 0).to(torch.int32)
    n_active = int(active.sum())
    touched = int(torch.unique(torch.cat([pos[active.bool()], neg[active.bool()]])).numel())
    hits = torch.bincount(torch.cat([pos[active.bool()], neg[active.bool()]]).long(),
                          minlength=n_items)
    L = padded.shape[1]
    user_bytes = 2 * n_users * k * 4  # p read, p_new written
    row_bytes = touched * 3 * k * 4  # q rows read once, delta rows read and written
    flops = n_active * 16 * k
    out = {}
    s_bound = bound(user_bytes + row_bytes + n_users * (L * 4 + 4 + 8) + 4, flops, F32_FLOP_S)
    out["bpr_sweep_sampled"] = dict(
        ms=median_ms(lambda: bk.bpr_sweep_sampled(p, q, delta, cost, padded, counts, key[1],
                                                  n_items, LR, REG, n_tries), 50),
        plain_ms=median_ms(lambda: bk.bpr_sweep_sampled_plain(
            p, q, delta, cost, padded, counts, key[1], n_items, LR, REG, n_tries), 5),
        bound_ms=s_bound[0], bound_by=s_bound[1], library_ms=None,
    )
    p_bound = bound(user_bytes + row_bytes + n_users * 12 + 4, flops, F32_FLOP_S)
    out["bpr_sweep_pairs"] = dict(
        ms=median_ms(lambda: bk.bpr_sweep_pairs(p, q, delta, cost, pos, neg, active, LR, REG),
                     50),
        plain_ms=median_ms(lambda: bk.bpr_sweep_pairs_plain(
            p, q, delta, cost, pos, neg, active, LR, REG), 5),
        bound_ms=p_bound[0], bound_by=p_bound[1], library_ms=None,
    )
    q2 = q.clone()
    f_bound = bound(4 * q.numel() * 4, q.numel(), F32_FLOP_S)
    out["bpr_fold"] = dict(
        ms=median_ms(lambda: bk.bpr_fold(q2, delta), 50),
        plain_ms=median_ms(lambda: bk.bpr_fold_plain(q2, delta), 20),
        bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
    )
    log(f"  sweep: {n_active} active users, {touched} item rows touched, the hottest "
        f"{int(hits.max())} adds of {2 * n_active}")
    for name, row in out.items():
        log(f"  time {name}: " + json.dumps(row))
    del p, q, delta, q2
    torch.cuda.empty_cache()
    return errors, out


def phase_pairs_path(csr, dev) -> int:
    """One epoch of explicit-pairs training (the reference's sharded-fused
    step, parallel/sharded.py:224-298, on one card): the counter sampler,
    then K3's sweep per step. Returns the pairs sweep's launches."""
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
    launches = bk.bpr_sweep_pairs.launches
    check(launches == n_steps, f"pairs path: {launches} pairs sweeps for {n_steps} steps")
    check(bool(torch.isfinite(p).all() and torch.isfinite(q).all()), "pairs path: finite")
    log(f"  pairs path: {n_steps} steps, {launches} launches of bpr_sweep (pairs)")
    return launches


# ---------------------------------------------------------------- phase 5


def hold_first_epoch(train, csr, dev, n_steps: int) -> float:
    """The fit's first epoch (its init, its keys) through the kernels
    against the plain versions on the card. At this shape the Zipf head's
    rows grow about fourfold a sweep (the reference's dense sweep does the
    same), and the growth amplifies the atomics' reordered sums: held to
    5e-3 of each table's largest magnitude (two runs measured 4.3e-5 and
    2.2e-4). Returns the larger relative error."""
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
    p_k, q_k, _ = bk.bpr_epoch_fused(init.user_factors, init.item_factors.clone(), padded,
                                     counts, keys, n_items, LR, REG, mm_dtype=torch.float32,
                                     n_tries=n_tries)
    p, q = init.user_factors, init.item_factors.clone()
    delta, cost = torch.zeros_like(q), torch.zeros((1,), device=dev)
    for step_key in keys:
        p, _, _ = bk.bpr_sweep_sampled_plain(p, q, delta, cost, padded, counts, step_key,
                                             n_items, LR, REG, n_tries)
        bk.bpr_fold_plain(q, delta)
    worst = 0.0
    for name, got, want in (("p", p_k, p), ("q", q_k, q)):
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= 5e-3, f"first epoch: {name} differs by {rel:.3g} of its largest magnitude")
        worst = max(worst, rel)
    log(f"  first epoch equals its plain version on the card: {worst:.3g} of the largest "
        f"magnitude; max |p| {float(p.abs().max()):.4g}, max |q| {float(q.abs().max()):.4g}")
    return worst


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
    want = TRAIN_EPOCHS * n_steps
    check(launches["bpr_sweep_sampled"] == want and launches["bpr_fold"] == want,
          f"fit: {launches} launches, want {want} sampled sweeps and folds")
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
        first_epoch_rel_err=first_epoch_err,
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
    result = {}
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        blobs = BlobStore(Path(tmp) / "blobs")
        master = Master(cfg, data, cache, blobs, MetaStore(), device=dev)
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
        want = MASTER_EPOCHS * n_steps
        check(launches["bpr_sweep_sampled"] == want and launches["bpr_fold"] == want,
              f"master: {launches} launches, want {want} sampled sweeps and folds")
        fit_s = re.search(r"^\w*master_collaborative_filtering_fit_seconds (\S+)$",
                          master.metrics.render(), re.M)
        model_meta = json.loads(master.meta.get("CF_MODEL_META"))
        meta = master.get_meta()
        check(meta["cf_model_id"] != "" and blobs.exists(meta["cf_model_id"]),
              "master: the index is in the blob store under the meta's model id")

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
        # 3,706 items are 15 blocks of 256, fewer than any fetch (100 + the
        # widest history): every chunk takes the ungated route (K6)
        chunks = -(-n_users // MatrixFactorizationIndex._SEARCH_CHUNK)
        check(topk_launches == {"block_max": 0, "block_seeds": 0, "block_topk": chunks,
                                "merge_topk": chunks}, f"worker: {topk_launches}")
        index = worker.cf_index
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
        for uid in sample:
            seen = {fb.item_id for fb in data.get_user_feedback(uid)}
            row = index.user_index.to_number(uid)
            s_p, i_p = topk.dot_topk_plain(index.user_factors[row : row + 1],
                                           index._prepared_items,
                                           cfg.recommend.cache_size + len(seen))
            ids = [index.item_index.to_name(int(index._serving_rows[j])) for j in i_p[0].tolist()]
            want = [(i, float(s)) for i, s in zip(ids, s_p[0].tolist()) if i not in seen]
            got = [(s.id, s.score) for s in cache.search_scores(ck.COLLABORATIVE, uid)]
            check(got == want[: cfg.recommend.cache_size], f"{uid}: cache equals the plain top-k")

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
    )
    return result


# ---------------------------------------------------------------- main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

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

    log("== phase 1: environment")
    smi = phase_environment()

    log("== phase 2: kernels")
    t0 = time.perf_counter()
    user_factors, item_factors, histories = make_data(args.seed)
    log(f"  data made in {time.perf_counter() - t0:.1f} s")
    prep, errors, timings, k_path = phase_kernels(user_factors, item_factors, histories, dev)
    del prep
    torch.cuda.empty_cache()

    log("== phase 3: path")
    path = phase_path(user_factors, item_factors, histories, dev, args.seed)
    log("  path: " + json.dumps(path))
    del user_factors, item_factors, histories
    torch.cuda.empty_cache()

    log("== phase 4: BPR kernels")
    t0 = time.perf_counter()
    train, test, csr = make_training_data()
    log(f"  training data made in {time.perf_counter() - t0:.1f} s: {train.count_users()} users, "
        f"{train.count_items()} items, {train.count_feedback()} train feedback, "
        f"padded width {csr.padded.shape[1]}")
    bpr_errors, bpr_timings = phase_bpr_kernels(csr, dev)
    pairs_launches = phase_pairs_path(csr, dev)

    log("== phase 5: training")
    training = phase_training(train, test, csr, dev)
    log("  training: " + json.dumps(training))
    del train, test, csr

    log("== phase 6: master")
    master = phase_master(dev)
    log("  master: " + json.dumps(master))
    check("jax" not in sys.modules and "gorse_tpu" not in sys.modules,
          "neither JAX nor gorse_tpu was imported")

    rows = timings[k_path]
    device_ms = rows["topk_gated"]["ms"]
    log(f"  kernel time per chunk {device_ms:.3f} ms = "
        f"{100 * device_ms / path['ms_per_chunk']:.1f}% of a chunk's search_users")
    kernels = []
    for name in KERNELS:
        row = rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "gorse_tpu_torch/csrc/topk.cu",
            "replaces": REPLACES[name],
            "launches": path["launches"][name],
            "max_abs_err": errors[name],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # the training path's launches (phase 5); the pairs sweep's from its
    # own path (phase 4). No single PyTorch call computes a sweep or the
    # fold (q += delta and delta = 0 are two), so library_ms is null.
    bpr_launches = dict(training["launches"], bpr_sweep_pairs=pairs_launches)
    for name in BPR_KERNELS:
        row = bpr_timings[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "gorse_tpu_torch/csrc/bpr.cu",
            "replaces": BPR_REPLACES[name],
            "launches": bpr_launches[name],
            "max_abs_err": bpr_errors[name],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s; path k = {k_path}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
