"""Offline evaluation harness (port of gorse_tpu/cmd/bench.py).

gorse's cmd/gorse-bench (main.go:125, 209, 322) without a running cluster:
the CF models' NDCG (BPR, eALS), the AFM ranker's AUC, embedding
similarity quality against the embedded fake-OpenAI server, and retrieval
throughput. The subcommands, flags and defaults are the reference's.
``cf``, ``ctr``, ``embedding`` and ``retrieval`` run on the card unless
``--device cpu`` is given. ``retrieval --kernel pallas`` runs the port's
CUDA chain (``dot_topk``: block_max, block_seeds, block_topk, merge_topk
over a bf16 table) and ``--kernel xla`` its library route
(``dot_topk_xla``: an f32 product and a sort); a chain of ``--batches``
query batches is timed by CUDA events. ``reranker`` ranks each test
user's held-out item among sampled negatives through ``LLMReranker``
against the mock or a real OpenAI endpoint (no device work). ``cf`` and
``ctr`` take the registry's built-in datasets (data/registry.py) as well as
``synthetic`` ones.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _device(args):
    from .. import resolve_device

    return resolve_device(args.device)


def evaluate_cf(args) -> dict:
    from ..data.loaders import load_built_in
    from ..models import FitConfig, Params, create_mf_model

    train, test = load_built_in(args.dataset)
    model = create_mf_model(
        args.model,
        Params(n_factors=args.factors, n_epochs=args.epochs, lr=args.lr, reg=args.reg),
        device=_device(args),
    )
    t0 = time.time()
    score = model.fit(
        train, test, FitConfig(verbose=args.verbose, candidates=args.candidates)
    )
    return {
        "model": args.model,
        "dataset": args.dataset,
        "NDCG@10": round(score.ndcg, 4),
        "Precision@10": round(score.precision, 4),
        "Recall@10": round(score.recall, 4),
        "fit_seconds": round(time.time() - t0, 2),
        "examples": train.count_feedback() * args.epochs,
        "device": str(model.device),
    }


def evaluate_ctr(args) -> dict:
    from ..data.ctr import synthetic_ctr
    from ..data.loaders import load_built_in_ctr
    from ..models import FitConfig, Params
    from ..models.fm import AFM

    if args.dataset.startswith("synthetic"):
        data = synthetic_ctr(n_samples=args.samples, seed=0)
        train, test = data.split(0.2, seed=1)
    else:
        # the registry's libFM datasets (frappe, ml-tag, criteo), from the
        # dataset directory or its mirror
        train, test = load_built_in_ctr(args.dataset)
    model = AFM(Params(n_factors=args.factors, n_epochs=args.epochs, lr=args.lr, reg=args.reg),
                device=_device(args))
    t0 = time.time()
    score = model.fit(train, test, FitConfig(verbose=args.verbose))
    return {
        "model": "afm",
        "dataset": args.dataset,
        "AUC": round(score.auc, 4),
        "Accuracy": round(score.accuracy, 4),
        "fit_seconds": round(time.time() - t0, 2),
        "device": str(model.device),
    }


def evaluate_retrieval(args) -> dict:
    """Queries per second of one route over ``--items`` random rows: a chain
    of ``--batches`` batches of ``--batch`` queries, between two CUDA events
    after a warm-up chain (on the CPU, the host clock). The kernel chain
    scores a bf16 table whatever ``--dtype`` says; the library route takes
    the rows in f32, or rounded to bf16 with ``--dtype bf16``."""
    import numpy as np
    import torch

    from ..ops.topk import dot_topk, dot_topk_xla, prepare_items

    dev = _device(args)
    rng = np.random.default_rng(0)
    items = torch.as_tensor(rng.normal(size=(args.items, args.dim)).astype(np.float32)).to(dev)
    qs = torch.as_tensor(
        rng.normal(size=(args.batches, args.batch, args.dim)).astype(np.float32)
    ).to(dev)
    if args.kernel == "pallas":
        prep = prepare_items(items, device=dev)
        dtype = "bf16"

        def one(q):
            return dot_topk(q, prep, args.k, device=dev)
    else:
        table = items.bfloat16().float() if args.dtype == "bf16" else items
        dtype = args.dtype

        def one(q):
            return dot_topk_xla(q, table, args.k, device=dev)

    def chain():
        for q in qs:
            one(q)

    chain()  # warm-up: the kernels' build and first launches
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        chain()
        end.record()
        torch.cuda.synchronize(dev)
        per_batch = start.elapsed_time(end) / 1e3 / args.batches
        timer = "cuda_events"
    else:
        t0 = time.perf_counter()
        chain()
        per_batch = (time.perf_counter() - t0) / args.batches
        timer = "host_clock"
    return {
        "kernel": args.kernel,
        "dtype": dtype,
        "items": args.items,
        "batch": args.batch,
        "k": args.k,
        "batches_chained": args.batches,
        "queries_per_s": round(args.batch / per_batch),
        "per_batch_ms": round(per_batch * 1e3, 3),
        "timer": timer,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }


def evaluate_reranker(args) -> dict:
    """LLM-reranker offline evaluation (reference: EvaluateReranker,
    cmd/gorse-bench/main.go:209): per test user, candidates = the held-out
    positive + sampled negatives; AUC of the reranked position vs random.
    Defaults to the embedded deterministic fake-OpenAI server; point
    --api-url at a real OpenAI-compatible endpoint to benchmark a model."""
    import numpy as np

    from ..data.loaders import load_built_in
    from ..llm.client import OpenAIClient
    from ..logics.chat import LLMReranker
    from ..storage.types import Item, Score, User

    train, test = load_built_in(args.dataset)
    mock = None
    if args.api_url:
        client = OpenAIClient(args.api_url, args.api_key, chat_model=args.model)
    else:
        from ..llm.mock import MockOpenAIServer

        mock = MockOpenAIServer().start()
        client = OpenAIClient(mock.base_url, mock.auth_token)
    reranker = LLMReranker(client, prompt=args.prompt)
    rng = np.random.default_rng(0)
    aucs = []
    users = [u for u in range(test.count_users()) if test.user_feedback[u]][: args.users]
    for u in users:
        pos = test.user_feedback[u][0]
        negs = [
            int(i) for i in rng.choice(train.count_items(), size=args.candidates)
            if i not in set(train.user_feedback[u])
        ][: args.candidates - 1]
        cand_ids = [pos] + negs
        rng.shuffle(cand_ids)
        candidates = [Score(train.item_dict.to_name(int(i)), 0.0) for i in cand_ids]
        items = {s.id: Item(s.id) for s in candidates}
        feedback = [
            ("like", Item(train.item_dict.to_name(int(i))))
            for i in train.user_feedback[u][: args.context]
        ]
        ranked = reranker.rank(User(train.user_dict.to_name(u)), feedback, candidates, items)
        ranked_ids = [s.id for s in ranked]
        pos_name = train.item_dict.to_name(int(pos))
        if pos_name in ranked_ids:
            rank = ranked_ids.index(pos_name)
            aucs.append(1.0 - rank / max(len(ranked_ids) - 1, 1))
    if mock is not None:
        mock.close()
    return {
        "dataset": args.dataset,
        "api": args.api_url or "mock://deterministic",
        "users": len(users),
        "AUC": round(float(np.mean(aucs)) if aucs else 0.0, 4),
        "note": "AUC 0.5 = random ordering",
    }


def evaluate_embedding(args) -> dict:
    """Embedding-similarity quality (gorse's EvaluateEmbedding,
    cmd/gorse-bench/main.go:322): each item's text embedded through the
    (mock or real) embedding API, its top-k embedding neighbours against its
    co-consumption neighbours (the users-IDF similarity)."""
    import numpy as np

    from ..data.loaders import load_built_in
    from ..llm.client import OpenAIClient
    from ..ops.similarity import embedding_neighbors, idf_neighbors, incidence_matrix

    dev = _device(args)
    train, _ = load_built_in(args.dataset)
    mock = None
    if args.api_url:
        client = OpenAIClient(args.api_url, args.api_key, embedding_model=args.model)
    else:
        from ..llm.mock import MockOpenAIServer

        mock = MockOpenAIServer(dimensions=args.dim).start()
        client = OpenAIClient(mock.base_url, mock.auth_token)
    try:
        n_items = train.count_items()
        vecs = np.stack(
            [client.embedding(f"item {train.item_dict.to_name(i)}") for i in range(n_items)]
        ).astype(np.float32)
    finally:
        if mock is not None:
            mock.close()
    _, emb_idx = embedding_neighbors(vecs, k_top=args.k, metric="euclidean", device=dev)
    inc = incidence_matrix(
        [train.item_feedback[i] for i in range(n_items)], train.count_users()
    )
    _, gt_idx = idf_neighbors(inc, train.user_idf(), k_top=args.k, device=dev)
    emb_idx, gt_idx = emb_idx.cpu().numpy(), gt_idx.cpu().numpy()
    recalls = [
        len(set(emb_idx[i]) & set(gt_idx[i])) / args.k for i in range(n_items)
    ]
    return {
        "dataset": args.dataset,
        "api": args.api_url or "mock://hash-embeddings",
        "items": n_items,
        "k": args.k,
        "recall_vs_coconsumption": round(float(np.mean(recalls)), 4),
        "note": "mock embeddings are content hashes; real models score higher",
        "device": str(dev),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="gorse-tpu-torch-bench")
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default: the current CUDA device)"

    p = sub.add_parser("cf", help="evaluate a CF model")
    p.add_argument("--dataset", default="synthetic://1000,800,8,0.05,0")
    p.add_argument("--model", choices=["bpr", "als"], default="bpr")
    p.add_argument("--factors", type=int, default=16)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--reg", type=float, default=0.01)
    p.add_argument("--candidates", type=int, default=100)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser("ctr", help="evaluate the AFM ranker")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--samples", type=int, default=5000)
    p.add_argument("--factors", type=int, default=8)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--reg", type=float, default=1e-4)
    p.add_argument("--verbose", type=int, default=10)
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser("reranker", help="evaluate an LLM reranker")
    p.add_argument("--dataset", default="synthetic://200,150,8,0.08,0")
    p.add_argument("--api-url", default="", help="OpenAI-compatible endpoint (default: embedded mock)")
    p.add_argument("--api-key", default="")
    p.add_argument("--model", default="")
    p.add_argument("--prompt", default="")
    p.add_argument("--users", type=int, default=20)
    p.add_argument("--candidates", type=int, default=10)
    p.add_argument("--context", type=int, default=5)

    p = sub.add_parser("embedding", help="evaluate embedding similarity quality")
    p.add_argument("--dataset", default="synthetic://200,150,8,0.08,0")
    p.add_argument("--api-url", default="", help="OpenAI-compatible endpoint (default: embedded mock)")
    p.add_argument("--api-key", default="")
    p.add_argument("--model", default="")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--device", default=None, help=device_help)

    p = sub.add_parser("retrieval", help="benchmark exact top-k retrieval")
    p.add_argument("--items", type=int, default=100000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--kernel", choices=["pallas", "xla"], default="pallas",
                   help="pallas: the CUDA kernel chain; xla: the library route")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--batches", type=int, default=32, help="query batches timed as one chain")
    p.add_argument("--device", default=None, help=device_help)

    args = parser.parse_args(argv)
    evals = {
        "cf": evaluate_cf,
        "ctr": evaluate_ctr,
        "reranker": evaluate_reranker,
        "embedding": evaluate_embedding,
        "retrieval": evaluate_retrieval,
    }
    out = evals[args.cmd](args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
