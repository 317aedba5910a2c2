#!/usr/bin/env python3
"""Smoke run of gorse_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda`` or ``CUDA_HOME``) and ``nvidia-smi``. Phases, in order;
any failure ends the run with a non-zero exit code:

1. Environment: the card's name and power limit, the torch version, and the
   build of ``gorse_tpu_torch/csrc/*.cu`` with its seconds.
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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / BF16_FLOP_S
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
    _build.build(["topk"])
    log(f"build_seconds {time.perf_counter() - t0:.2f}")
    for line in _build.build_log.get("topk", "").splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())
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
