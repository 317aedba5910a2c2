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
   ``RestServer`` on 127.0.0.1, equal to the cache; REST p50/p99 under each
   front end in turn on the same requests (async, threaded, threaded,
   async).
4. BPR kernels: ``bpr_sweep`` in both modes (sampled, explicit pairs) and
   ``bpr_epoch`` (K1: a whole epoch in one cooperative launch), both
   sampling as the reference's one-device epoch (``jax.random.randint``
   under each step key), held against
   their plain PyTorch versions on the card, on small tie-heavy inputs
   (repeated items in a sweep, users with no positives, one item in every
   history; k = 8, 16, 64; f32 and bf16; the epoch over 1, 3 and 5 steps),
   on a wide case (more users than 32 x the most warps the card holds, so
   warps take several 32-user batches; 4,000 items, so staged and unstaged
   rows; k = 64 and 128), on a dense case whose rows collide with
   the first 8 candidates (12 tries: the one-at-a-time draws), on the
   first small case against a full-set bitset that holds more than its
   rows, and at the
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
   master fills every user's cache; a sample of fetched lists agrees
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
   steps an epoch) on the card against the CPU from the same init:
   ``afm_holds`` (Adam in lockstep, each step from the CPU's state: the
   gradients within an f32 summation bound, the moments and the update
   within what the gradients' difference allows; the SGD epoch within
   ``AFM_TOL`` of each table's largest move), the free-running Adam epoch
   (each table's share and worst entry printed; its loss within
   ``AFM_TOL`` and its entries past ``AFM_TOL`` within one row's held by
   ``hold_adam_epoch``), then epochs timed by CUDA events and by the
   host clock ending on a synchronise (padded examples/s, ms a step), the
   kernels of an epoch and their device time from a ``torch.profiler``
   trace; ``tests/test_fm.py``'s accuracy gate on the card (AUC > 0.75).
   Then phase 8's ml-1m data without the embedding label, its first 2,000
   users (``CTR_USERS``; phase 10 runs the cycle on ``IN_ONE_USERS``) and their
   rows, each user with a gender (2), an age (7) and an occupation (21)
   from the seed;
   ``ranker.type = "fm"`` over the ``collaborative`` candidates, the AFM's
   ``fit_epoch`` cut to 3. One ``Master.run_tasks_once`` on the card: each
   load step's gauge, the CTR dataset's size, the CTR fit's gauge and AUC,
   the memory accounting's seconds, ``collect_garbage`` leaving only the
   two live blobs; one epoch of the master's AFM by CUDA events; a card
   master's one-epoch CTR fit against a CPU master's on the same rows
   (``hold_adam_epoch``), and ``afm_holds`` over the first
   ``CTR_HOLD_STEPS`` steps on the masters' split and hyper-parameters. ``Worker.sync_and_recommend`` re-ranks the whole shard on
   the card (``block_max``, ``block_seeds``, ``block_topk`` and
   ``merge_topk`` each launch in the CF recall); the ranking step's seconds
   beside its ``batch_predict`` time by CUDA events (the rest is the
   host's share); 16 users' ``recommend`` caches held tie-aware against a
   CPU worker's ranking of the same candidates by the same saved model
   (``RANK_TOL``); ``GET /api/recommend/u1`` equals the cache.

10. The in-one node from ``config.toml.example``. Phase 9's ml-1m rows
   for its first ``IN_ONE_USERS`` users (each feedback a star, a like or a read of value
   3-5, the example's positive types, from the seed) through ``SQLiteDataStore`` into a
   temporary directory, its counts read back from a fresh ``sqlite://``
   store. A copy of the example with its four stores and blob directory
   there and only the cuts of ``IN_ONE_CUTS`` (the loaded config equal to
   the example's in every other value). ``InOneNode`` on the card and one
   ``run_once``: the master's whole cycle, the CF search (10 trials) and
   the CTR search that the example's ``optimize_period`` makes due, the
   worker's shard; ``bpr_epoch``, ``block_max``, ``block_seeds``,
   ``block_topk`` and ``merge_topk`` each launch. Held: ``meta.sqlite``
   names both models and their blobs exist; the search keys and gauges;
   every user's list in ``cache.sqlite`` only catalog ids, none the user
   likes, at most ``cache_size``; 16 users' REST answers equal the cache and
   their lists a CPU worker's ranking (``RANK_TOL``); a second node on the
   same files resumes both models and its worker writes the same lists;
   ``python -m gorse_tpu_torch.serve.in_one`` as a subprocess answers
   ``/api/health/ready`` and ``/api/recommend/u1`` and ends on SIGINT with
   exit code 0. Printed: the insert's seconds and each file's size, the
   load steps beside phase 9's memory store, each task's seconds, both
   searches, the BPR fit, the worker's steps, REST p50/p99 beside phase 3's.

11. The master, server and worker as processes on the card
   (``python -m gorse_tpu_torch.cmd._spawn master|server|worker``, their
   logs in one file whose tail is printed on a failure). Phase 10's rows
   for the first ``CLUSTER_USERS`` users and all items, less the rows of
   ``CLUSTER_HELD`` users, in ``data.sqlite``; tests/test_integration_
   cluster.py's config (BPR, no ranker over the collaborative lists, the
   ``latest`` fallback) with CF switched on, phase 10's positive types and
   the master's admin key; the nodes reach data.sqlite and cache.sqlite
   through the master's storage proxy (``proxy://``: a ``sqlite://`` data
   store is node-local, as the reference rules). The held-back users and their rows go in through
   the server (``POST /api/users``, then ``PUT /api/feedback`` by the
   port's ``GorseClient`` in batches of ``CLUSTER_BATCH``, each timed).
   Held, in order: the master's admin routes answer 401 without the key;
   the server returns every row sent for ``CLUSTER_READBACK`` held-back
   users (``GET /api/user/{id}/feedback``: the same type, user, item and
   value); after ``POST /api/dashboard/schedule``
   the meta names a new CF model whose blob exists; the worker, started
   then (a worker refreshes a list only when it is stale, never for a new
   model, so a worker started earlier would keep the first model's lists),
   registers beside the server (``/api/dashboard/cluster``) and its span
   for every user reaches the master; every list in ``cache.sqlite`` holds
   only catalog ids, at most ``cache_size``, none of the user's items; 16
   users (8 held back) get the cache from the server; a ``Worker`` here on
   the card, over a copy of ``cache.sqlite`` and the model the meta names,
   recomputes them equal to the worker process's lists (``same_ranking``,
   ``RANK_TOL``) with ``block_max``, ``block_seeds``, ``block_topk`` and
   ``merge_topk`` launched, and a CPU ``Worker`` too; a cold user gets
   ``latest``; the worker's health and ``/metrics``; the logs of the master
   and the worker name the card; SIGTERM ends each process within
   ``CLUSTER_STOP_S``. Printed: the ingest's rows/s and batch p50/p99, the
   seconds from schedule to the model and to the sample served, the
   master's fit gauge and the worker's step gauges, REST p50/p99 on the
   server process beside phase 10's, ``nvidia-smi --query-compute-apps``.

12. Sharded training (``gorse_tpu_torch/parallel/``) on a mesh of
   ``SHARDS`` shards of the card. The user-sharded BPR epoch on phase 5's
   data from its first epoch's init and key: every step's pairs equal
   those of the same epoch on a one-shard mesh of the card (the counter
   sampler on one card: ``bpr_epoch`` draws the one-device sampler),
   ``bpr_sweep_pairs`` (K3)
   launched n_steps x shards times; two timed epochs (host clock ending on
   a synchronise, the psums by CUDA events), examples/s beside phase 5's.
   At ``HOLD_INITS`` inits and keys (``--hold-inits``): p and q within
   ``SHARDED_EPOCH_TOL`` of the one-shard epoch's factors, ``sync_every =
   4`` through K3 within ``SYNC4_TOL`` of the same epoch through
   ``bpr_sweep_pairs_plain``, the one-shard epoch's own spread from run to run
   logged beside them. The catalog-sharded epoch: its drops equal to
   those the recorded pairs give (each owner's requests past the cap),
   its factors within ``FIRST_EPOCH_TOL`` of the user-sharded epoch's. The
   sharded top-k (``SHARDED_TOPK``: 1M x 64 in the shards, 256 queries, k =
   100) equal to ``dot_topk`` on the whole table, tie order included. The
   master with the mesh patched into ``training_mesh``, phase 9's setup on
   its 2,000 users (fits cut to ``SHARDED_MASTER_EPOCHS`` BPR epochs and
   one AFM epoch): ``run_tasks_once`` (BPR through K3, the data-parallel
   AFM), a single-card master's fits of the same loaded data, then both
   fit eALS; BPR within ``FIRST_EPOCH_TOL`` of a master's fit through the
   user-sharded epoch on a one-shard mesh, eALS within ``EALS_TOL``, the
   masters' AFM tables by ``hold_adam_epoch``, the AFM on their split by
   ``afm_holds`` over ``CTR_HOLD_STEPS`` steps (sharded against one card),
   NDCG and AUC within 0.01; each fit's gauge beside the single card's; on
   every run, a line for each AFM table with the masters' Adam epochs'
   share, worst entry and entries past ``AFM_TOL``. ``init_multihost`` at world size 1 over NCCL and the
   epoch on its ``global_mesh``. With more than one card visible, the
   epoch and the master again on the mesh over every card (the master's
   own ``training_mesh``), and one process a card over NCCL against it.
13. The approximate tier, external sources, the bench and the CLI. (a)
   ``bin_max`` and ``bin_max_sq`` equal to ``bin_max_plain`` at
   ``BIN_EDGES`` (integer-valued, so exact): keys stored and merged, more
   units than SMs, 300 queries (two launches, one on a single consumer
   warpgroup), 128 and 192 dimensions, L = n = 101, L = 37, bins without
   items; dot and euclidean. On
   phase 3's 1M x 64 bf16 table and 256 of its users, at k = 10 and the
   worker's fetch, at recall targets 0.9, 0.95 and 0.99: ``bin_max`` held
   against ``bin_max_plain`` (``hold_bins``: the same bins empty; where the
   two pick the same item the scores within ``score_tol``; where they pick
   different items a tie within 2 T), ``merge_topk`` on its keys equal to
   the plain merge, the lists tie-aware against the plain route, the entry
   point ``dot_topk_approx`` equal to the kernels' lists, mean recall@k
   against the exact ``dot_topk`` at or above the target; at 0.99 the
   times (median and queued), the bound (one table stream plus the keys),
   the plain time, the yardstick (``bin_library``: a bf16 ``torch.matmul``
   into a score matrix padded to whole rows of L and ``.max(dim=1)`` over
   its ``[b, rows, L]`` view; for SQ the affine epilogue between), the
   work plan, the extra device memory (no ``[B, N]`` matrix), the
   route's time beside the exact chain's on the same chunk. The same for
   ``bin_max_sq`` on the table's codes at k = 10 (dot at each target,
   euclidean at 0.99), and ``sq_topk_approx``'s launches from 0. (b) Phase
   3's shard through the worker at ``index_recall = 0.99``: only
   ``bin_max`` and ``merge_topk`` launched, once a chunk; users/s beside
   phase 3's; every list catalog ids only, none of the user's, at most
   ``cache_size``; its recall against the exact route's lists. (c) A js
   source (with ``fetch``) and an http source, served from 127.0.0.1, in a
   card worker's chain: the lists equal the sources' ids less the user's;
   ``/api/dashboard/external`` on a card master answers the same. (d) The
   bench: ``cf`` (bpr with ``bpr_epoch`` launched, then als) and ``ctr`` on
   the card within ``BENCH_NDCG_TOL`` / ``BENCH_AUC_TOL`` of the same
   command on the CPU, ``retrieval`` at 1M through K4-K6 beside the
   library route, ``embedding`` and ``reranker`` against the mock server;
   the CLI's ``health``, ``get user``, ``pipeline show`` and
   ``recommend`` against an in-one node on the card.
14. The in-one node over the remote stores. ``native/fastdata.cpp`` and
   ``native/hnsw.cpp`` must build with ``g++``. The port's MiniMySQL,
   MiniPostgres, MiniClickHouse, MiniS3 and MiniRedis start on 127.0.0.1.
   Phase 10's rows for the first ``REMOTE_USERS`` users go into
   ``mysql://`` and every user, item and feedback row reads back equal; the
   first ``REMOTE_COPY_USERS`` users' rows likewise through ``postgres://``
   and ``clickhouse://``. A copy of config.toml.example with ``mysql://``
   data, ``redis://`` cache, ``hnsw://`` vectors and an ``s3://`` blob
   store; ``InOneNode`` on the card and one ``run_once`` (``bpr_epoch``,
   ``block_max``, ``block_seeds``, ``block_topk`` and ``merge_topk`` each
   launch). Held: every blob the master saved reads back from S3 byte for
   byte; 16 users' collaborative lists in Redis equal ``search_users`` on
   the card; ``GET /api/recommend`` equals the Redis cache. ``hnsw://`` on
   the fitted item table (the users' factors as queries) and on a
   synthetic f32 table (``HNSW_SYNTH``, cut where its build would pass
   ``HNSW_BUILD_S``): recall@10 against a ``memory://`` store on the card
   and against ``dot_topk`` (K4-K6) at least 0.9, build s and q/s. Phase
   9's CTR rows as a libFM file: ``load_libfm_file`` native and in Python
   equal the rows. Printed: rows/s of the ingest, ``run_once`` s, the
   cache writes over Redis and their s (beside phase 10's SQLite commits),
   REST p50/p99 from Redis, each step's s; the phase within
   ``REMOTE_PHASE_S``.
15. The gRPC plane. Phase 11's rows for the first ``GRPC_USERS`` users in
   data.sqlite, less ``GRPC_HELD`` users who come in through the server's
   REST API; phase 11's config with the cache in the master's memory
   (``memory://``), ``master.ssl_mode`` with the test-only certificates of
   tests/data/tls, and ``tracing`` exported over OTLP/gRPC to a collector
   that this script runs on the port's grpcwire server. The master, server
   and worker as processes (the nodes with the client certificate): the
   nodes open the ``proxy://`` URLs the master's meta names, over mutual
   TLS. Held: the meta and both nodes' logs name the master's proxy for
   the data and the cache; after a scheduled cycle (``bpr_epoch`` in the
   master) the worker's span for every user reaches the master; every list
   in the master's memory cache (read through the proxy) holds only
   catalog ids, at most ``cache_size``, none of the user's items; 16 users
   served by the server equal those lists, each request in a trace the
   script starts (``traceparent``); ``BlobStoreClient`` downloads the
   published model equal to its blob directory byte for byte; clients
   without TLS or without a certificate are refused (UNAVAILABLE); after
   SIGTERM (each process within ``CLUSTER_STOP_S``, exit code 0) every
   held user's rows are in data.sqlite, the worker's log counts K4-K6
   launches and the master's ``bpr_epoch``, and the collector holds the
   server's recommend spans in the script's traces and the master's span
   that only its flush at SIGTERM exports. Printed: p50/p99 of
   ``GRPC_CALLS`` unary ``get_user`` calls over mTLS, the ``get_feedback``
   stream's rows/s, the download's MB/s, schedule -> served, REST p50/p99
   through the proxied cache; the phase within ``GRPC_PHASE_S``.
16. The rest of the surface. Phase 10's rows for the first ``LLM_USERS``
   users in data.sqlite; a master fits BPR (``bpr_epoch``); a worker with
   ``ranker.type = "none"`` gives each user's recall list (K4-K6; 16 users
   held against the plain top-k); a worker with ``ranker.type = "llm"``
   asks the port's MockOpenAIServer, which echoes ``LLM_PROMPT`` (the
   candidates' ids reversed, rendered by utils/template.py): each list
   must be the recall list reversed and the completions as many as the
   users; ``LLM_API_USERS`` users through a reranker API in this script
   that answers in reverse, held the same. (c) ``ChatItemToItem`` with a
   client over ``CHAT_ITEMS`` items with the mock's 128-float hash
   embeddings, on the card and on the CPU (the same answers): neighbour
   ids equal except within ``CHAT_TIE``, scores within ``CHAT_RTOL``. (d)
   ``GET /api/dump`` of that master, ``POST /api/restore`` into a second
   over an empty SQLite file: every row equal, a second dump byte-equal,
   the CSV and JSONL round trips byte-equal; the second master's fit and
   worker launch K1 and K4-K6 and its lists are held against its index's
   plain top-k. (e) OIDC against the port's MockOIDCProvider: /login ->
   the provider -> /callback/oauth2 -> the session -> userinfo with the
   provider's claims; tokens signed by another key or past their exp
   refused; ``GET /`` the port's dashboard.html. (f) The in-one node over
   ``mongodb://`` (the port's MiniMongo) for ``MONGO_USERS`` users' rows,
   its lists equal ``search_users``; ``qdrant://``, ``weaviate://`` and
   ``milvus://`` (the port's servers) synced with the serving items, their
   top-10 equal to the card's exact ``MemoryVectorStore`` (recall 1.0).
   Printed: each step's s, LLM-ranked users/s, dump MB/s, restore rows/s;
   the phase within ``SURFACE_PHASE_S``.
17. Full-set negative rejection in the single-card fit:
   ``synthetic_cf_access(120000, 4000, nnz=2000000, seed=1)`` at k = 64,
   where the reference's gate holds (the history cap binds, the bitset of
   every user's positives within 64 MiB). The sampled ``bpr_sweep`` with
   the bitset: its pairs equal the plain version's for every user, p_new
   and delta within tolerance; ``bpr_epoch`` with it over 1, 3 and 5 steps
   within ``EPOCH_TOL``, a whole epoch of the fit's init within
   ``FIRST_EPOCH_TOL``. ``BPR.fit`` for 2 epochs: one ``bpr_epoch`` launch
   an epoch, each with the bitset (its launch count and the fit's log
   line). Over one epoch's pairs, the capped users' negatives that lie in
   their full positive sets: with the bitset only the draws whose every
   candidate does, against the capped rows more. K1's CUDA-event medians
   at this shape with and without the bitset, in turns, beside their
   bounds; the phase within ``BITSET_PHASE_S``.
18. The reference's ml-1m-scale quality gate (tests/test_oracle.py):
   ``synthetic_cf_powerlaw(seed=42)`` at its defaults (6,040 x 3,706, 1M
   ratings), ``split_cf(seed=0)``, then on the card ``BPR`` (k = 8, 30
   epochs, lr 0.05, reg 0.01) and ``ALS`` (k = 8, 15 epochs, reg 0.015,
   alpha 0.05). Held: each NDCG@10 at least 0.55; BPR's fit one
   ``bpr_epoch`` launch an epoch, with the full-set bitset exactly when the
   reference's gate (``rejection_bitset``) takes it; ``evaluate_model`` on
   each model's factors equal, within 1e-6 a metric, to the same on their
   copy on the CPU. Printed: both NDCGs and their difference, which gate
   decided the bitset, each fit's seconds, the generator's and the split's
   seconds on the host. Then K1 at this shape from the fit's init against
   the rows and against the full-set bitset, which reject alike here (cap
   = widest: every step's pairs equal), timed in turns beside the epoch's
   bound; the phase within ``POWERLAW_PHASE_S``.

The last three lines of standard output are the kernels' JSON record, the
card's ``name, power.limit`` as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``gorse_tpu_torch`` beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import functools
import http.client
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

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
# a whole epoch at the 138k x 27k shape, the kernel against a plain f32
# order: the Zipf head's rows grow about fourfold a step, which amplifies
# every reordered sum (phase 5)
FIRST_EPOCH_TOL = 5e-3
# the sweep's candidates drawn ahead of the scan (csrc/bpr.cu MAXC); more
# tries are drawn one at a time, so the dense case asks for more
SAMPLE_AHEAD = 8
DENSE_TRIES = 12
ABLATIONS = ("", "nosample", "samp_nopos", "samp_norej", "nogather", "noscatter")
F32_FLOP_S = 67e12  # f32 outside the tensor cores
# INT32: 64 lanes an SM a clock against f32's 128 FMA lanes (two flops
# each); the data sheet gives no INT32 rate
INT32_OP_S = F32_FLOP_S / 4
# the integer operations of one jax.random.randint draw in K1 and K2 (csrc/bpr.cu
# RANDINT): two threefry-2x32 blocks of 72 (20 rounds of add, rotate and xor,
# 12 key adds), three remainders and a multiply-add counted as one each
RANDINT_OPS = 2 * 72 + 4


def draw_ops(n_users: int, n_tries: int) -> int:
    """A sampled sweep's draws: every row's slot and its first
    min(n_tries, SAMPLE_AHEAD) candidates."""
    return n_users * (1 + min(n_tries, SAMPLE_AHEAD)) * RANDINT_OPS

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
# phase 9's cycle keeps the first 2,000 of ml-1m's 6,040 users and their
# rows (time)
CTR_USERS = 2000
# two AFM fits that sum their gradients in another order (the card's gather
# backward adds by atomics, the CPU in sequence, shards in parts): under SGD
# each table within this share of its largest move from the init (SGD's
# step is linear in the gradient). Two free-running Adam epochs are held
# only in the count of entries past it (`hold_adam_epoch`): where one side's
# f32 logit of a row is exactly 0.0 and the other's is not, the loss's own
# slope jumps by 0.5 (the reference's -t against sigmoid(0) - t), and Adam
# carries that row's entries apart (on an H100, 2 of 200 data orders of
# phase 12's pair: v 1.25e-3 and 4.81e-3 of its largest, 5 and 30 entries
# past). Adam is held step by step in lockstep instead (`hold_afm_lockstep`)
AFM_TOL = 1e-3
# the master's AFM pairs (phases 9 and 12): the lockstep's and the SGD
# epoch's steps, the first of the epoch's 507 (time: the CPU side's 507
# steps took 52 s, the sharded pair's 34 s, of a whole run that must end
# within 1,200 s); the masters' whole Adam fits are held by
# `hold_adam_epoch`
CTR_HOLD_STEPS = 128
# the worker's fm scores against a CPU batch_predict: a logit sums at most
# 8 x 8 products in another order
RANK_TOL = 2.0**-14
# phase 10: the in-one node from a copy of config.toml.example, its stores
# in a temporary directory; only these values are cut (section, key,
# value, why)
IN_ONE_CUTS = (
    ("recommend.ranker", "fit_epoch", "3", "time: an AFM epoch at ml-1m takes 5-7 s"),
    ("recommend.ranker", "optimize_trials", "1", "time: each AFM search trial is a fit"),
    ("recommend.collaborative", "model_search_epoch", "2",
     "time: the epochs of every CF and every AFM search trial"),
)
# phase 10 keeps the first 600 of ml-1m's 6,040 users and their rows
# (time: at 6,040 its run_once took 281-409 s, the worker's refresh and the
# neighbours per user, and the whole run must end within 1,200 s; at 2,000
# it took 143.3 s on one card's host and 231.1 s on another, whose whole
# run took 1,279 s; at 1,000 123.8-158.9 s, and one run whose host was
# slow in every phase took 1,166.7 s)
IN_ONE_USERS = 600
# the example's positive types: "read" rows carry a value of at least 3
IN_ONE_TYPES = ("star", "like", "read")
IN_ONE_START_S = 300  # the entry point's subprocess answers within this
IN_ONE_STOP_S = 60  # and ends on SIGINT within this
# phase 11: the master, server and worker as processes on the card over
# phase 10's rows for the first CLUSTER_USERS users, CLUSTER_HELD of them
# held back and sent through the server's REST API in batches of
# CLUSTER_BATCH. Cut from 2,000 and 200 users (time: at that width the
# REST ingest took 86 s and the phase 230 s of its 150 s), then the held
# users from 100 to 20 and the users from 1,000 to 400 (time: since the
# nodes reach data.sqlite through the master's proxy the ingest ran at
# 121-155 rows/s and the worker's cycle took 52.9-99.6 s; the phase took
# 220.6 s, and 241.7 s with 40 held users on a slower host)
CLUSTER_USERS, CLUSTER_HELD, CLUSTER_BATCH, CLUSTER_SAMPLE = 400, 20, 1000, 16
CLUSTER_READBACK = 8  # held-back users whose rows are read back from the server
CLUSTER_ADMIN_KEY = "chip-smoke-admin"
CLUSTER_START_S = 120  # each process answers /api/health/live within this
CLUSTER_CYCLE_S = 300  # from schedule: the model named, the worker's span arrived
CLUSTER_STOP_S = 10  # SIGTERM ends each process within this
# how a node process is started (a CPU rehearsal swaps in a prelude that
# maps the device to the CPU)
SPAWN = [sys.executable, "-m", "gorse_tpu_torch.cmd._spawn"]
# phase 12: sharded training on SHARDS shards of one card (a mesh of every
# card as well when more than one is visible); the sharded top-k at the
# serving shape (items, dim, queries, k); the master's fits cut to this
# many epochs (time: a sharded epoch at ml-1m takes about 150 steps, each
# SHARDS samplings and K3 launches)
SHARDS = 4
SHARDED_TOPK = (1_000_000, 64, 256, 100)
SHARDED_MASTER_EPOCHS = 2
# the user-sharded epoch is held at this many inits and keys (seed 0 is
# phase 5's first epoch); --hold-inits sets it
HOLD_INITS = 4
# the user-sharded epoch against bpr_epoch, one epoch at phase 5's shape,
# as a share of each table's largest magnitude: both sum each step's item
# deltas by atomics, in an order that changes from run to run, and the Zipf
# head amplifies a reordered sum step by step (bpr_epoch against itself
# reads up to 3.6e-4 in p). Two runs over inits 0-23 on 4 shards of one
# card read p 3.1e-5 to 1.02e-3 (inits 0-3 at most 1.3e-4), q 9.1e-6 to
# 3.2e-5; p gets phase 5's whole-epoch limit, five times its largest
# reading, q six times its largest
SHARDED_EPOCH_TOL = {"p": FIRST_EPOCH_TOL, "q": 2e-4}
# sync_every = 4 through K3 against the same pairs through the plain sweep
# (one sweep's rounding a step, no atomics between the two): the same two
# runs read at most 1.6e-6, twelve times under this limit
SYNC4_TOL = 2e-5
PHASES = ("2", "2b", "2c", "3", "4", "5", "6", "7", "7c", "8", "9", "10", "11", "12", "13",
          "14", "15", "16", "17", "18")
# phase 18: the reference's ml-1m-scale quality gate (tests/test_oracle.py):
# synthetic_cf_powerlaw at its defaults (6,040 x 3,706, 1M ratings, rank 16)
# from seed 42, split_cf(seed=0), each fit's NDCG@10 at least 0.55
POWERLAW_SEED, POWERLAW_NDCG = 42, 0.55
POWERLAW_BPR = dict(n_factors=8, n_epochs=30, lr=0.05, reg=0.01)
POWERLAW_ALS = dict(n_factors=8, n_epochs=15, reg=0.015, alpha=0.05)
POWERLAW_EVAL_TOL = 1e-6  # evaluate_model on the card against the same factors on the CPU
POWERLAW_PHASE_S = 90  # the phase's own limit
# phase 17: full-set negative rejection in the single-card fit, at the main
# path's BPR width on a corpus where the reference's gate holds: 120k users
# over 4k items, so the padded rows (120k x widest) pass 96 MB and the
# history cap binds, while the bitset (120k x 125 words) stays within 64 MiB
BITSET_USERS, BITSET_ITEMS, BITSET_NNZ, BITSET_SEED = 120_000, 4_000, 2_000_000, 1
BITSET_EPOCHS = 2
BITSET_PHASE_S = 60  # the phase's own limit
# phase 14: the in-one node over the remote stores (the port's MiniMySQL,
# MiniRedis and MiniS3 on 127.0.0.1, and hnsw://) on phase 10's rows for the
# first REMOTE_USERS users. Cut from phase 10's 2,000 (time: the phase must
# end within 150 s. At 150 users it took 205.7 s: each feedback row goes
# in as three MySQL statements, 822 rows/s on the card's host, and
# run_once took 94.8 s, nearly half of it the cache's writes through a
# Python Redis server; at 40 users 114.3 s)
REMOTE_USERS = 40
REMOTE_COPY_USERS = 3  # the smaller copy through postgres:// and clickhouse://
REMOTE_PHASE_S = 150  # the phase's own limit
# hnsw:// on a synthetic f32 table of HNSW_SYNTH rows (low rank plus noise,
# as item embeddings are), added in chunks of HNSW_CHUNK while the build
# stays within HNSW_BUILD_S (time: the whole build takes over 45 s on the
# card's host, 60,000 rows in 37.5 s, and the phase has 150 s);
# HNSW_QUERIES held-out queries at k = HNSW_K, recall held at
# tests/test_hnsw.py:36's floor
HNSW_SYNTH = (100_000, 64)
HNSW_CHUNK = 10_000
HNSW_BUILD_S = 35.0
HNSW_QUERIES = 1024
HNSW_K = 10
HNSW_RECALL = 0.9
# the cache store's writes, counted and timed over redis://
CACHE_WRITES = ("set", "delete", "push", "pop", "add_scores", "delete_scores", "update_scores",
                "add_time_series_points")
# phase 13: the approximate tier on phase 3's table, external sources, bench and CLI
APPROX_KERNELS = ("bin_max", "bin_max_sq")
APPROX_REPLACES = {  # jax.lax.approx_max_k inside these functions; no pallas_call
    "bin_max": "gorse_tpu/ops/topk.py:860",
    "bin_max_sq": "gorse_tpu/ops/topk.py:903",
}
APPROX_TARGETS = (0.9, 0.95, 0.99)
APPROX_RECALL = 0.99  # the worker's index_recall; the kernel rows are timed at it
APPROX_QUERIES = 256  # one serving chunk
EXTERNAL_USERS = 16
BENCH_BATCHES = 32  # the bench's default chain
# the same bench command on the card and on the CPU: the same initial values
# and samples (CPU generators), sums in another order on the card
BENCH_NDCG_TOL = 0.05
BENCH_AUC_TOL = 0.05
# phase 15: the master's gRPC plane. Phase 11's rows for the first GRPC_USERS
# users in data.sqlite, GRPC_HELD of them held back and sent through the
# server's REST API, the cache in the master's memory (memory://); the nodes
# on its proxy over mutual TLS with tests/data/tls (test-only certificates
# valid for 100 years); GRPC_SAMPLE users served in traces of the phase's
# own; GRPC_CALLS unary calls timed
GRPC_USERS, GRPC_HELD, GRPC_SAMPLE, GRPC_CALLS = 300, 30, 16, 1000
GRPC_PHASE_S = 120  # the phase's own limit
# phase 16: the rest of the surface on phase 10's rows for the first
# LLM_USERS users: the LLM ranker through the chat completions (and
# LLM_API_USERS through a reranker API), chat item-to-item, dump and
# restore, OIDC, MiniMongo and the vector databases
SURFACE_PHASE_S = 120  # the phase's own limit
LLM_USERS = 200
LLM_API_USERS = 20
LLM_PROMPT = ('[{% for item in items|reverse %}"{{ item.item_id }}"{% if not loop.last %},'
              '{% endif %}{% endfor %}]')
CHAT_ITEMS, CHAT_DIM, CHAT_N = 2000, 128, 10
CHAT_PROMPT = "{{ item.item_id }} sequel"
CHAT_TIE = 1e-6  # card and CPU neighbours may swap where distances lie this close
CHAT_RTOL = 1e-5  # relative, card against CPU
MONGO_USERS = 3
VECTOR_QUERIES, VECTOR_K = 16, 10
TLS_DIR = ROOT / "tests" / "data" / "tls"
SQ_REPLACES = {
    "block_max_sq": "gorse_tpu/ops/topk.py:361",
    "block_topk_sq": "gorse_tpu/ops/topk.py:442",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_T_START = time.perf_counter()


def log(*parts) -> None:
    """Print a line; a phase's header also says how far into the run it
    starts."""
    if parts and str(parts[0]).startswith("== phase"):
        parts = (*parts, f"[{time.perf_counter() - _T_START:.1f} s into the run]")
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


def bound(bytes_moved: float, flops: float, flop_s: float = BF16_FLOP_S,
          int_ops: float = 0) -> tuple[float, str]:
    """The least time in ms and what bounds it: bytes over the memory rate,
    or the operations over their peak, the floating-point and the integer
    ones each on their own lanes (which run side by side)."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = max(flops / flop_s, int_ops / INT32_OP_S)
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
            conn.close()
        finally:
            server.shutdown()
        # ---- REST latency: both front ends on the same requests, in turn
        rounds: dict[str, list] = {"async": [], "threaded": []}
        for backend in ("async", "threaded", "threaded", "async"):
            httpd = server.serve("127.0.0.1", 0, backend=backend)
            try:
                rounds[backend].append(rest_latency(
                    httpd.server_address[1], lambda r: f"/api/recommend/{shard[r % SHARD]}"))
            finally:
                server.shutdown()
        result["rest_p50_ms"], result["rest_p99_ms"] = rounds["async"][0]
        result["rest_by_backend"] = rounds
        log("  REST p50 / p99 ms, the front ends in turn (async, threaded, threaded, async): "
            + "; ".join(f"{b} " + ", ".join(f"{p50:.3f} / {p99:.3f}" for p50, p99 in v)
                        for b, v in rounds.items()))
    return result


# ---------------------------------------------------------------- phase 4


def zero_counts() -> list:
    """Every kernel wrapper, its launch count set to 0."""
    from gorse_tpu_torch.ops import bpr_kernel, topk

    wrappers = [getattr(topk, n) for n in KERNELS + SQ_KERNELS + APPROX_KERNELS]
    wrappers += [getattr(bpr_kernel, n) for n in BPR_KERNELS]
    for w in wrappers:
        w.launches = 0
    bpr_kernel.bpr_epoch.bits_launches = 0
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


def hold_bpr(name, p, q, padded, counts, step_key, mm_dtype, n_tries=4, bits=None) -> dict:
    """Both sweep modes against their plain versions on the card (the
    sampled one against ``bits`` when given). Returns the largest absolute
    difference seen per kernel."""
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
                                          LR, REG, n_tries, mm_dtype, bits)
    pp, posp, negp = bk.bpr_sweep_sampled_plain(p, q, dp, cp, padded, counts, step_key,
                                                n_items, LR, REG, n_tries, mm_dtype, bits)
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


def hold_epoch(name, p, q, padded, counts, keys, mm_dtype, n_tries=4, bits=None) -> float:
    """bpr_epoch against its plain version on the card (both against
    ``bits`` when given): every step's pos and neg equal, delta zero after
    the fold. One step: p to the sweep's
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
                pairs=pairs, bits=bits)
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


def step_candidates(step, n_users: int, n_tries: int, n_items: int, device):
    """A step's rejection candidates ``[U, n_tries]`` as the one-device
    sampler draws them: ``randint(kn, (U, n_tries), 0, n_items)``, ``kn``
    the second half of the step key's split."""
    from gorse_tpu_torch.ops import prng, sampling

    inner = sampling.randint_keys([step])[:, 2:4]
    return prng.randint_batch(inner, (n_users, n_tries), 0, n_items, device)[0]


def late_draws(padded, counts, keys, n_items: int, n_tries: int) -> tuple[int, int]:
    """Over the step keys: the active users whose first SAMPLE_AHEAD
    candidates all lie in their rows (the sweep then draws one at a time),
    and of those the ones a later candidate freed."""
    reached = freed = 0
    for step in keys:
        cand = step_candidates(step, padded.shape[0], n_tries, n_items, padded.device)
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
    # K2 and K1 against a full-set bitset: the first small case's rows and,
    # for every active user, items past them (rows a cap would have cut),
    # so the bitset rejects candidates the rows would not
    name, p, q, padded, counts = bpr_small_cases(dev)[0]
    n_items = q.shape[0]
    full = torch.zeros((padded.shape[0], n_items), dtype=torch.bool, device=dev)
    rows_of = torch.arange(padded.shape[0], device=dev)[:, None].expand_as(padded)
    full[rows_of[padded >= 0], padded[padded >= 0].long()] = True
    extra = torch.rand(full.shape, generator=torch.Generator(device=dev).manual_seed(4),
                       device=dev) < 0.3
    full |= extra & (counts > 0)[:, None]
    words = -(-n_items // 32)
    member = torch.zeros((padded.shape[0], words * 32), dtype=torch.int64, device=dev)
    member[:, :n_items] = full.to(torch.int64)
    bits = (member.view(padded.shape[0], words, 32)
            << torch.arange(32, device=dev)).sum(dim=2)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).contiguous()
    for mm in (torch.float32, torch.bfloat16):
        merge_err(hold_bpr(f"{name} {str(mm)[6:]} bitset", p, q, padded, counts, key[0], mm, 4,
                           bits))
        for steps in (1, 3):
            keys = sampling.raw_step_keys(sampling.prng_key(8), steps)
            merge_err({"bpr_epoch": hold_epoch(f"{name} {str(mm)[6:]} bitset epoch of {steps}",
                                               p, q, padded, counts, keys, mm, 4, bits)})
    log(f"  {name} against a full-set bitset ({int(full.sum())} positives, "
        f"{int((padded >= 0).sum())} in the rows): pairs equal, within tolerance")

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
    s_bound = bound(user_bytes + row_bytes + hist_bytes + n_users * 8 + 4, flops, F32_FLOP_S,
                    draw_ops(n_users, n_tries))

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
                    n_steps * flops, F32_FLOP_S, n_steps * draw_ops(n_users, n_tries))
    fold_bytes = 4 * q.numel() * 4  # q and delta read, both written
    trip_ms = n_steps * bound(user_bytes + row_bytes + hist_bytes + fold_bytes,
                              flops + q.numel(), F32_FLOP_S, draw_ops(n_users, n_tries))[0]
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


def hold_first_epoch(train, csr, dev, n_steps: int, bits=None) -> dict:
    """The fit's first epoch (its init, its keys; against ``bits`` when
    given) through the kernel against the plain version on the card: every
    step's pos and neg equal, p and q within 5e-3 of each table's largest
    magnitude. At this shape the Zipf
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
               device=dev), padded, counts, keys, n_items, LR, REG, n_tries, pairs=pairs,
               bits=bits)
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
                check(rel <= FIRST_EPOCH_TOL,
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
        refreshed = worker.sync_and_recommend(master)
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


def neighbor_store(seed: int, embedding: bool = True, user_fields=(), data=None,
                   feedback_type=None, n_users=None):
    """Phase 6's ml-1m-shaped feedback in ``data`` (a new MemoryDataStore by
    default), its items with 1-3 of 18 genres, a 16-float ``embedding``
    label (with ``embedding``), a category and a timestamp, its users with
    one value of each of ``user_fields`` ((name, size) pairs), all from
    ``seed``. Each row is a ``like`` of value 1, or with ``feedback_type``
    the (type, value) it gives the row's number. With ``n_users``, only the
    first that many users and their rows."""
    from gorse_tpu_torch.data.loaders import synthetic_cf
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.types import Feedback, Item, User

    keep_users = n_users
    n_users, n_items, rank, density, data_seed = MASTER_SHAPE
    ds = synthetic_cf(n_users, n_items, rank, density, data_seed)
    rng = np.random.default_rng(seed)
    genres = [rng.choice(N_GENRES, size=rng.integers(1, GENRES_MAX + 1), replace=False)
              for _ in range(n_items)]
    embeddings = rng.standard_normal((n_items, EMBED_DIM), dtype=np.float32)
    stamps = rng.integers(0, 1_000_000, size=n_items)
    fields = [(name, rng.integers(size, size=n_users)) for name, size in user_fields]
    data = MemoryDataStore() if data is None else data
    feedback_type = feedback_type or (lambda n: ("like", 1.0))
    data.insert_items(
        Item(f"i{i}", categories=[f"c{i % N_CATEGORIES}"], timestamp=float(stamps[i]),
             labels={"genre": [f"g{g}" for g in genres[i]],
                     **({"embedding": embeddings[i].tolist()} if embedding else {})})
        for i in range(n_items))
    kept = n_users if keep_users is None else keep_users
    data.insert_users(User(f"u{u}", labels={name: str(v[u]) for name, v in fields})
                      for u in range(kept))
    rows = ((f"u{u}", f"i{i}", ts)
            for u, (fb, stamps) in enumerate(zip(ds.user_feedback[:kept], ds.timestamps[:kept]))
            for i, ts in zip(fb, stamps))
    data.insert_feedback(Feedback(t, user, item, value, ts)
                         for n, (user, item, ts) in enumerate(rows)
                         for t, value in (feedback_type(n),))
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
        refreshed = worker.sync_and_recommend(master)
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


def worst_entry(got, want, name: str, tol: float) -> str:
    """Where AFM table ``name`` of ``got`` and ``want`` differ most (its
    index and both values) and how many entries differ by more than ``tol``
    of the table's largest magnitude."""
    a, b = got.to_numpy()[name], want.to_numpy()[name]
    d = np.abs(a - b)
    i = np.unravel_index(int(d.argmax()), d.shape)
    n = int((d > tol * np.abs(b).max()).sum())
    return (f"worst entry {tuple(int(x) for x in i)}: {a[i]:.7g} against {b[i]:.7g}, "
            f"{n} entries past the tolerance")


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


class AfmSide:
    """One side of an AFM comparison: an AFM on ``device`` (over ``mesh``'s
    shards when it has more than one) set up for ``train`` as its fit does,
    or, with ``test`` None, as ``hold_afm`` runs stage_afm's epoch (the rows
    padded to their widest, unscaled, the init of seed 0). Gradients and
    epochs are the port's own."""

    def __init__(self, device, mesh, hp: dict, train, test) -> None:
        from gorse_tpu_torch.models.fm import AFM
        from gorse_tpu_torch.models.params import FitConfig, Params
        from gorse_tpu_torch.parallel.sharded import shard_afm_batches

        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.model = AFM(Params(hp), device=device)
        if test is None:
            pad = train.padded(train.max_dimension())
            self.batches = self.model._batch(pad, self.model.batch_size)
            self.model.model_params = self.model._init_params(train.num_features(), [], 0)
        else:
            self.batches = self.model._setup(train, test, FitConfig(mesh=self.mesh))[0]
        self.init = self.model.model_params.to_numpy()
        self.n_steps = int(self.batches[0].shape[0])
        if self.mesh is not None:
            self.shards = shard_afm_batches(self.mesh, self.batches)

    def fresh(self):
        """The init as a new ``AFMParams`` on the model's device."""
        from gorse_tpu_torch.models.fm import afm_params_from_numpy

        return afm_params_from_numpy(self.init, self.model.device)

    def optimizer(self, name: str, params):
        from gorse_tpu_torch.models.fm import make_optimizer

        return make_optimizer(name, params.parameters(), self.model.lr, self.model.reg)

    def gradients(self, params):
        """``step -> loss``: that step's gradients into ``params``' grad."""
        from gorse_tpu_torch.models.fm import afm_gradients
        from gorse_tpu_torch.parallel.sharded import Replicas, make_data_parallel_afm_gradients

        if self.mesh is None:
            return lambda s: afm_gradients(params, self.batches, s)
        self.replicas = Replicas(self.mesh, params)
        grads = make_data_parallel_afm_gradients(self.mesh)
        return lambda s: grads(params, self.replicas, *self.shards, s)

    def logits(self, params, s: int):
        """Step ``s``'s f32 logits as the side's gradients computed them
        (shard by shard on the replicas, in the batch's row order), on
        ``params``' device; after ``gradients(params)(s)``."""
        import torch

        from gorse_tpu_torch.models.fm import afm_forward

        with torch.no_grad():
            if self.mesh is None:
                bi, bv, _, _, be = self.batches
                return afm_forward(params, bi[s], bv[s], [e[s] for e in be])
            bi, bv, _, _, be = self.shards
            return torch.cat([afm_forward(self.replicas[j], bi[j][s], bv[j][s],
                                          [e[j][s] for e in be]).to(params.v.device)
                              for j in range(self.mesh.local_size)])

    def epoch(self, params, optimizer, n_steps: int | None = None):
        """One epoch from ``params`` (its first ``n_steps`` steps when
        given): ``train_epoch`` or the data-parallel epoch; its summed
        loss."""
        from gorse_tpu_torch.models.fm import train_epoch
        from gorse_tpu_torch.parallel.sharded import make_data_parallel_afm_epoch

        if self.mesh is None:
            *tensors, embeddings = self.batches
            return train_epoch(params, optimizer, (*(x[:n_steps] for x in tensors),
                                                   tuple(e[:n_steps] for e in embeddings)))
        *per_shard, embeddings = self.shards
        shards = [[x[:n_steps] for x in xs] for xs in per_shard]
        shards.append(tuple([x[:n_steps] for x in xs] for xs in embeddings))
        return make_data_parallel_afm_epoch(self.mesh)(params, optimizer, *shards)


U32 = 2.0**-24


def afm_grad_bound(p0: dict, batch, zero=None) -> tuple[dict, dict]:
    """One AFM step's gradients (``v``, ``w``, ``b``; no embedding columns)
    in f64, and how far an f32 evaluation that sums in another order may
    lie from them, entry by entry: ``p0`` the parameters (f64, on the
    batch's device), ``batch`` the step's indices, values, targets and weights.
    Returns ``(gradients, bounds)``.

    Each gradient entry sums a term ``c_r x (vx - v x)`` (``w``: ``c_r x``,
    ``b``: ``c_r``) over the ``n`` slots that carry it, ``c_r = (sigmoid(out)
    - t) w_r / sum w`` the loss's slope at row r. Two orders of a sum of
    ``n`` f32 terms differ by at most ``2 n u`` of the sum of their absolute
    values (u = 2^-24, Higham's bound), and each term's own chain (``vx`` a
    sum over D slots, its products) by ``2 (D + k + 8) u`` of its paths'
    absolute values. ``out`` itself may differ by ``2 (D + k + 8) u`` of the
    forward over absolute values, which moves ``c_r`` by at most a quarter
    of that (sigmoid's slope) plus 8 u of ``w_r / sum w``; that term is
    summed over the slots as well. The shards' partial sums add 16 to
    ``n``. Where ``zero`` (a row mask) says an evaluation's f32 logit was
    exactly zero, the slope is the reference's there, ``-t`` (jax's
    ``maximum`` splits its tie, its ``abs`` takes 1 at zero), not
    ``sigmoid(0) - t``: the loss's gradient jumps at zero."""
    import torch

    idx, val, tgt, wgt = batch
    idx, x, tgt, wgt = idx.long(), val.double(), tgt.double(), wgt.double()
    v, w, b = p0["v"][idx], p0["w"][idx][..., 0], p0["b"]
    n_rows, n_slots = idx.shape
    k = v.shape[2]
    ax = x.abs()
    vx = (v * x[..., None]).sum(1)
    v_abs = (v.abs() * ax[..., None]).sum(1)
    sq = (v * v * (x * x)[..., None]).sum(1)
    out = (w * x).sum(1) + 0.5 * (vx * vx - sq).sum(1) + b
    mag = (w.abs() * ax).sum(1) + 0.5 * (v_abs * v_abs + sq).sum(1) + b.abs()
    scale = wgt / wgt.sum().clamp(min=1.0)
    c = (torch.sigmoid(out) - tgt) * scale
    chain = 2 * (n_slots + k + 8) * U32
    dc = 0.25 * chain * mag * scale + 8 * U32 * scale
    if zero is not None:
        c = torch.where(zero, -tgt * scale, c)
        dc = torch.where(zero, 8 * U32 * scale, dc)
    term = ax[..., None] * (v_abs[:, None, :] + v.abs() * ax[..., None])
    flat = idx.reshape(-1)

    def per_feature(t):
        width = t.shape[-1]
        out = torch.zeros(p0["v"].shape[0], width, dtype=torch.float64, device=idx.device)
        return out.index_add_(0, flat, t.reshape(-1, width))

    n = per_feature((x != 0).double()[..., None])
    a_v = per_feature(c.abs()[:, None, None] * term)
    e_v = per_feature(dc[:, None, None] * term)
    a_w = per_feature((c.abs()[:, None] * ax)[..., None])
    e_w = per_feature((dc[:, None] * ax)[..., None])
    grads = {"v": per_feature(c[:, None, None] * x[..., None] * (vx[:, None, :] - v * x[..., None])),
             "w": per_feature((c[:, None] * x)[..., None]), "b": c.sum()}
    return grads, {"v": (2 * n + 16) * U32 * a_v + chain * a_v + e_v,
                   "w": (2 * n + 16) * U32 * a_w + chain * a_w + e_w,
                   "b": (2 * n_rows + 16) * U32 * c.abs().sum() + chain * c.abs().sum() + dc.sum()}


def _f64(t, dev):
    """``t`` as a new f64 tensor on ``dev``."""
    import torch

    return t.detach().to(dev, torch.float64, copy=True)


def hold_afm_lockstep(a: AfmSide, b: AfmSide, what: str, n_steps: int | None = None) -> dict:
    """Adam in lockstep: at every step of one epoch side ``a`` starts from
    side ``b``'s parameters and Adam state (copied), both take their own
    gradients and their own optimizer step. Held, entry by entry (f64 on the
    host, ``p0``, ``m0``, ``v0`` the state the step starts from, ``g`` each
    side's gradient plus ``reg p0``):
    - each side's gradient within :func:`afm_grad_bound` of its f64 one;
    - the moments within what that gradient bound ``d`` allows:
      ``c1 d + 8 u (b1 |m0| + c1 |g|)`` and ``c2 d (2 |g| + d) + 8 u (b2
      v0 + c2 g^2)``, ``c1 = 1 - b1`` and ``c2 = 1 - b2`` and every other
      constant as the optimizer rounds it to f32, ``d`` with the f32
      rounding of each ``g`` (each rounding term here twice its bound: a
      side rounds each once, ``4 u`` covers both sides' results);
    - each side's update within its f32 rounding of ``U(g)``, Adam's update
      of its own gradient from the step's state in f64 (``-lr m / (bc1
      (sqrt(v / bc2) + eps))``, the port's f32 bias corrections): the
      moments' rounding through the quotient, 8 u of the update and an ulp
      of the parameter. So the two updates differ by at most ``|U(g_a) -
      U(g_b)|`` and both roundings.
    A rounding difference between the gradients cannot fail these: the
    update's bound is Adam's own response to it. Each side's gradient is
    held against its own f64 gradient (the reference's slope where that
    side's f32 logit was exactly zero), which names the side at fault;
    ``d`` is the two f64 gradients' difference plus both bounds. Printed:
    each hold's worst ratio to its bound, and the steps that moved an entry
    of the two sides the opposite way by more than lr / 10 (flips)."""
    import torch

    from gorse_tpu_torch.models.fm import bias_correction

    pa, pb = a.fresh(), b.fresh()
    opt_a, opt_b = a.optimizer("adam", pa), b.optimizer("adam", pb)
    grad_a, grad_b = a.gradients(pa), b.gradients(pb)
    # the optimizer's constants as it rounds them to f32 (a decayed gradient
    # near zero moves with reg's last bits)
    group = opt_b.param_groups[0]
    lr, reg, b1, b2, eps = (float(np.float32(group[x])) for x in ("lr", "reg", "b1", "b2", "eps"))
    c1, c2 = float(np.float32(1 - group["b1"])), float(np.float32(1 - group["b2"]))
    names = [n for n, _ in pb.named_parameters()]
    check(set(names) == {"v", "w", "b"}, f"{what}: the lockstep holds an AFM without towers")
    la, lb = dict(pa.named_parameters()), dict(pb.named_parameters())
    dev = lb["v"].device  # the holds' arithmetic, in f64, on side b's device
    worst = {n: {"grad": 0.0, "mu": 0.0, "nu": 0.0, "update": 0.0} for n in names}
    flips, most_apart = 0, 0.0

    def ratio(diff, bound):
        return float((diff / bound.clamp(min=1e-300)).max())

    n_steps = b.n_steps if n_steps is None else min(n_steps, b.n_steps)
    for s in range(n_steps):
        with torch.no_grad():
            for n in names:
                la[n].copy_(lb[n])
                opt_a.state[la[n]]["mu"].copy_(opt_b.state[lb[n]]["mu"])
                opt_a.state[la[n]]["nu"].copy_(opt_b.state[lb[n]]["nu"])
        opt_a.count = opt_b.count
        p0 = {n: _f64(lb[n], dev) for n in names}
        m0 = {n: _f64(opt_b.state[lb[n]]["mu"], dev) for n in names}
        v0 = {n: _f64(opt_b.state[lb[n]]["nu"], dev) for n in names}
        grad_a(s)
        grad_b(s)
        batch = tuple(x[s] for x in b.batches[:4])  # on side b's device
        exact, bound = {}, {}
        for side, x, params in (("a", a, pa), ("b", b, pb)):
            exact[side], bound[side] = afm_grad_bound(p0, batch,
                                                      (x.logits(params, s) == 0).to(dev))
        g = {}
        for side, params in (("a", la), ("b", lb)):
            g[side] = {n: (_f64(params[n].grad, dev) if params[n].grad is not None
                           else torch.zeros_like(p0[n])) + reg * p0[n] for n in names}
        opt_a.step()
        opt_b.step()
        count = opt_b.count
        bc1, bc2 = bias_correction(group["b1"], count), bias_correction(group["b2"], count)
        for n in names:
            ga, gb = g["a"][n], g["b"][n]
            for side, x in (("a", ga), ("b", gb)):
                off = (x - reg * p0[n] - exact[side][n]).abs()
                r = ratio(off, bound[side][n])
                worst[n]["grad"] = max(worst[n]["grad"], r)
                if r > 1.0:
                    e = tuple(int(i) for i in np.unravel_index(int((off / bound[side][n].clamp(
                        min=1e-300)).argmax()), off.shape)) if off.dim() else ()
                    check(False, f"{what}, Adam in lockstep: step {s}, side {side}'s {n} gradient "
                          f"at {e}: {float(x[e] - reg * p0[n][e])} against f64's "
                          f"{float(exact[side][n][e])} (bound {float(bound[side][n][e]):.3g}, the "
                          f"other side {float(g['b' if side == 'a' else 'a'][n][e] - reg * p0[n][e])})")
            # each rounding term counted twice: the bounds' second-order
            # terms (a constant's own rounding, f64's) are left out
            g_round = 2 * U32 * (ga.abs() + gb.abs())
            dg_max = ((exact["a"][n] - exact["b"][n]).abs() + bound["a"][n] + bound["b"][n]
                      + g_round)
            m_bound = c1 * dg_max + 8 * U32 * (b1 * m0[n].abs() + c1 * gb.abs())
            v_bound = (c2 * dg_max * (2 * gb.abs() + dg_max)
                       + 8 * U32 * (b2 * v0[n] + c2 * gb * gb))
            mu_a, mu_b = _f64(opt_a.state[la[n]]["mu"], dev), _f64(opt_b.state[lb[n]]["mu"], dev)
            nu_a, nu_b = _f64(opt_a.state[la[n]]["nu"], dev), _f64(opt_b.state[lb[n]]["nu"], dev)
            worst[n]["mu"] = max(worst[n]["mu"], ratio((mu_a - mu_b).abs(), m_bound))
            worst[n]["nu"] = max(worst[n]["nu"], ratio((nu_a - nu_b).abs(), v_bound))

            def update(gd):
                m = b1 * m0[n] + c1 * gd
                v = b2 * v0[n] + c2 * gd * gd
                return -lr * m / (bc1 * ((v / bc2).sqrt() + eps)), m, v

            after = {"a": _f64(la[n], dev), "b": _f64(lb[n], dev)}
            for side, gd in (("a", ga), ("b", gb)):
                u, m, v = update(gd)
                den = bc1 * ((v / bc2).sqrt() + eps)
                gd_round = 2 * U32 * gd.abs()
                dm = 8 * U32 * (b1 * m0[n].abs() + c1 * gd.abs()) + c1 * gd_round
                dv = 8 * U32 * (b2 * v0[n] + c2 * gd * gd) + c2 * 2 * gd_round * gd.abs()
                dv_hat = dv / bc2
                droot = torch.minimum(dv_hat.sqrt(), dv_hat / (v / bc2).sqrt().clamp(min=1e-300))
                dden = bc1 * (droot + 8 * U32 * ((v / bc2).sqrt() + eps))
                rounding = (lr * (dm / den + m.abs() * dden / (den * den)) + 8 * U32 * u.abs()
                            + 2 * U32 * after[side].abs())
                worst[n]["update"] = max(worst[n]["update"],
                                         ratio((after[side] - p0[n] - u).abs(), rounding))
            step_a, step_b = after["a"] - p0[n], after["b"] - p0[n]
            apart = (step_a - step_b).abs()
            flips += int(((step_a.sign() != step_b.sign())
                          & (torch.maximum(step_a.abs(), step_b.abs()) > lr / 10)).sum())
            most_apart = max(most_apart, float(apart.max()) / lr)
    for n, r in worst.items():
        for kind, x in r.items():
            check(x <= 1.0, f"{what}, Adam in lockstep: table {n}'s {kind} at {x:.3g} of its "
                  f"bound (1)")
    return {"steps": n_steps, "worst_ratio": worst, "flips": flips,
            "largest_update_gap_over_lr": most_apart}


def hold_afm_sgd(a: AfmSide, b: AfmSide, what: str, n_steps: int | None = None) -> dict:
    """One epoch of each side under SGD (the port's epochs) from the same
    init: each table within ``AFM_TOL`` of its largest move from the init.
    SGD's step is linear in the gradient, so summation order moves a table
    by rounding, not by a flipped step."""
    pa, pb = a.fresh(), b.fresh()
    a.epoch(pa, a.optimizer("sgd", pa), n_steps)
    b.epoch(pb, b.optimizer("sgd", pb), n_steps)
    got, want = pa.to_numpy(), pb.to_numpy()
    shares = {}
    for n, x in want.items():
        moved = float(np.abs(x - b.init[n]).max())
        shares[n] = float(np.abs(got[n] - x).max() / max(moved, 1e-30))
        check(shares[n] <= AFM_TOL, f"{what}, SGD epoch: table {n} off by {shares[n]:.3g} of its "
              f"largest move from the init (AFM_TOL {AFM_TOL})")
    return shares


def afm_holds(kind: str, a: AfmSide, b: AfmSide, n_steps: int | None = None) -> dict:
    """The restated AFM holds, side ``a`` against side ``b``: the lockstep
    under Adam and the epoch under SGD (over its first ``n_steps`` steps
    when given)."""
    return {"lockstep": hold_afm_lockstep(a, b, kind, n_steps),
            "sgd_shares": hold_afm_sgd(a, b, kind, n_steps)}


def adam_epoch_shares(got, want) -> dict:
    """Two free-running Adam fits' tables, printed beside the holds: each
    table's share of its largest magnitude, its worst entry and the count
    of entries past ``AFM_TOL``."""
    return {name: {"share": share, "worst": worst_entry(got, want, name, AFM_TOL)}
            for name, share in table_shares(got, want).items()}


def hold_adam_epoch(what: str, got, want, slots: int) -> dict:
    """Two free-running Adam fits of the same rows (``got`` against
    ``want``, ``AFMParams``), printed by :func:`adam_epoch_shares`; held:
    each table's count of entries past ``AFM_TOL`` of its largest
    magnitude within one row's entries (``slots`` rows of ``v`` and of
    ``w``, and ``b``). A row whose f32 logit is exactly 0.0 on one side
    only takes another slope there, and Adam carries that row's entries
    apart (``AFM_TOL``'s comment); a fault of the fit (another scale, a
    shard's gradients lost, other rows, another optimizer) moves most
    entries."""
    got_np, want_np = got.to_numpy(), want.to_numpy()
    allowed = {"v": slots * want_np["v"].shape[1], "w": slots, "b": 1}
    shares = adam_epoch_shares(got, want)
    for name, x in shares.items():
        past = int((np.abs(got_np[name] - want_np[name])
                    > AFM_TOL * np.abs(want_np[name]).max()).sum())
        x["past"], x["allowed"] = past, allowed.get(name, 0)
        check(past <= x["allowed"], f"{what}, Adam epoch: table {name} has {past} entries past "
              f"AFM_TOL {AFM_TOL} of its largest (one row's {x['allowed']} allowed); "
              f"{x['worst']}")
    return shares


def hold_afm(dev, smi: str) -> dict:
    """The AFM at stage_afm's shape on the card against the CPU: the holds
    of :func:`afm_holds`, then the first Adam epoch of each side (its
    summed loss held within ``AFM_TOL``, its tables by
    :func:`hold_adam_epoch`), epochs timed (CUDA events,
    and the host clock ending on a synchronise), kernels a step; then the
    accuracy gate of tests/test_fm.py on the card."""
    import torch

    from gorse_tpu_torch.data.ctr import synthetic_ctr
    from gorse_tpu_torch.models.fm import AFM
    from gorse_tpu_torch.models.params import FitConfig, Params

    t0 = time.perf_counter()
    data = afm_rows()
    data_s = time.perf_counter() - t0
    hp = {"n_factors": AFM_K, "batch_size": AFM_BATCH}
    card, cpu = AfmSide(dev, None, hp, data, None), AfmSide("cpu", None, hp, data, None)
    t0 = time.perf_counter()
    holds = afm_holds("AFM first epoch", card, cpu)
    holds_s = time.perf_counter() - t0
    n_steps, n_padded = card.n_steps, card.n_steps * AFM_BATCH
    params, cpu_params = card.fresh(), cpu.fresh()
    opt, cpu_opt = card.optimizer("adam", params), cpu.optimizer("adam", cpu_params)
    cost = float(card.epoch(params, opt))
    cpu_cost = float(cpu.epoch(cpu_params, cpu_opt))
    adam = hold_adam_epoch("AFM first epoch", params, cpu_params, int(card.batches[0].shape[2]))
    check(abs(cost - cpu_cost) <= AFM_TOL * abs(cpu_cost),
          f"AFM first epoch: loss {cost} against the CPU's {cpu_cost}")
    epoch_ms = median_ms(lambda: card.epoch(params, opt), AFM_REPS)
    host = []
    for _ in range(AFM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.epoch(params, opt)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    host_s = statistics.median(host)
    n_kernels, device_ms = step_launches(lambda: card.epoch(params, opt))
    result = {
        "card": smi, "data_s": data_s, "features": data.num_features(),
        "slots": int(card.batches[0].shape[2]), "steps": n_steps, "padded_examples": n_padded,
        "holds": holds, "holds_s": holds_s, "first_epoch_adam": adam,
        "epoch_ms": epoch_ms, "epoch_host_s": host_s,
        "examples_per_s": n_padded / host_s, "ms_per_step": epoch_ms / n_steps,
        "kernels_per_step": None if n_kernels is None else n_kernels / n_steps,
        "device_busy_share": None if device_ms is None else device_ms / epoch_ms,
    }
    log(f"  AFM epoch at stage_afm's shape ({data.num_features()} features, "
        f"{result['slots']} slots, k = {AFM_K}, {n_steps} steps of {AFM_BATCH}): "
        f"{epoch_ms:.2f} ms by CUDA events, {1e3 * host_s:.2f} ms on the host clock, "
        f"{n_padded / host_s:,.0f} padded examples/s, {epoch_ms / n_steps:.3f} ms a step, "
        f"kernels a step {result['kernels_per_step']}, device busy share "
        f"{result['device_busy_share']} ({smi})")
    log(f"  AFM first epoch, card against the CPU: holds ({holds_s:.1f} s) "
        f"{json.dumps(holds)}; Adam epoch: {json.dumps(adam)}")

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


def same_ranking(what: str, got, want) -> float:
    """Two ranked lists of Scores held tie-aware within ``RANK_TOL`` by
    ``compare_lists`` (ids by position in ``want``); the largest
    |s - s_want| / tol."""
    import torch

    s = torch.tensor([[x.score for x in got]], dtype=torch.float64)
    s_p = torch.tensor([[x.score for x in want]], dtype=torch.float64)
    index = {x.id: n for n, x in enumerate(want)}
    check(len(got) == len(want) and set(index) == {x.id for x in got},
          f"{what}: the same {len(want)} ids")
    i = torch.tensor([[index[x.id] for x in got]])
    i_p = torch.arange(len(want))[None, :]
    return compare_lists(what, s, i, s_p, i_p, RANK_TOL * (1.0 + s.abs()),
                         RANK_TOL * (1.0 + s_p.abs()))


def hold_ranking(lists: dict, cpu_worker) -> float:
    """Each user's ranked list from the card (``lists``: user -> Scores)
    against ``cpu_worker``'s ranking of the same candidates by the same
    saved model, tie-aware; the largest |s - s_cpu| / tol."""
    from gorse_tpu_torch.storage.types import Score

    worst = 0.0
    for uid, got in lists.items():
        want = cpu_worker._rank({uid: [Score(s.id, 0.0, s.categories) for s in got]})[uid]
        worst = max(worst, same_ranking(f"{uid}: fm ranking", got, want))
    return worst


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
    from gorse_tpu_torch.utils.config import Config

    result = {"afm": hold_afm(dev, smi)}
    t0 = time.perf_counter()
    data = neighbor_store(0, embedding=False, user_fields=USER_FIELDS, n_users=CTR_USERS)
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
        adam = hold_adam_epoch("the masters' one-epoch CTR fits, card against the CPU",
                               card_fit.model_params, cpu_fit.model_params, ctr.max_dimension())
        # the step holds on the same split and the master's hyper-parameters
        hp = {"n_epochs": 1}
        t0 = time.perf_counter()
        holds = afm_holds("master's CTR fit, one epoch", AfmSide(dev, None, hp, train, test),
                          AfmSide("cpu", None, hp, train, test), CTR_HOLD_STEPS)
        result["ctr_holds"], result["ctr_adam_epoch"] = holds, adam
        log(f"  the master's AFM epoch {result['ctr_epoch_ms']:.1f} ms by CUDA events "
            f"({result['ctr_steps']} steps, {result['ctr_epoch_ms'] / result['ctr_steps']:.3f} "
            f"ms a step) ({smi}); the master's one-epoch fit, card against the CPU: holds "
            f"({time.perf_counter() - t0:.1f} s) {json.dumps(holds)}; the masters' Adam epochs: "
            f"{json.dumps(adam)}")
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
        refreshed = worker.sync_and_recommend(master)
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
        lists = {uid: master.cache.search_scores(ck.RECOMMEND, uid) for uid in users}
        for uid, got in lists.items():
            check(len(got) == cfg.recommend.cache_size, f"{uid}: {len(got)} ranked candidates")
        worst = hold_ranking(lists, cpu_worker)
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


# ---------------------------------------------------------------- phase 10


def toml_set(text: str, section: str, key: str, value: str) -> str:
    """``key = value`` in ``[section]`` of a TOML text: the existing line
    replaced, or a new line after the header."""
    lines = text.split("\n")
    start = lines.index(f"[{section}]")
    end = next((n for n in range(start + 1, len(lines)) if lines[n].startswith("[")), len(lines))
    for n in range(start + 1, end):
        if re.match(rf"{re.escape(key)}\s*=", lines[n]):
            lines[n] = f"{key} = {value}"
            return "\n".join(lines)
    lines.insert(start + 1, f"{key} = {value}")
    return "\n".join(lines)


def in_one_config(tmp: Path, stores: dict | None = None) -> tuple[Path, dict]:
    """A copy of config.toml.example in ``tmp``: the four stores and the
    blob directory in ``tmp`` (absolute paths), or the URLs ``stores``
    gives by (section, key), and ``IN_ONE_CUTS``; the changes made, as
    (section, key) -> value."""
    text = (ROOT / "config.toml.example").read_text()
    changes = {("database", "data_store"): f'"sqlite://{tmp}/data.sqlite"',
               ("database", "cache_store"): f'"sqlite://{tmp}/cache.sqlite"',
               ("database", "vector_store"): f'"sqlite://{tmp}/vector.sqlite"',
               ("database", "meta_store"): f'"{tmp}/meta.sqlite"',
               ("blob", "uri"): f'"{tmp}/blob"'}
    changes.update({k: f'"{v}"' for k, v in (stores or {}).items()})
    changes.update({(section, k): v for section, k, v, _ in IN_ONE_CUTS})
    for (section, k), v in changes.items():
        text = toml_set(text, section, k, v)
    path = tmp / "config.toml"
    path.write_text(text)
    return path, changes


def hold_config(cfg, changes: dict) -> None:
    """The loaded copy equals the example, loaded the same way, in every
    value but the changed ones."""
    import dataclasses
    import tomllib

    from gorse_tpu_torch.utils.config import load_config

    want = dataclasses.asdict(load_config(ROOT / "config.toml.example"))
    got = dataclasses.asdict(cfg)
    for (section, k), v in changes.items():
        node_got, node_want = got, want
        for part in section.split("."):
            node_got, node_want = node_got[part], node_want[part]
        check(node_got[k] == tomllib.loads(f"v = {v}")["v"], f"config: {section}.{k} = {v}")
        node_want[k] = node_got[k]
    check(got == want, "config: every other value is the example's")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get_json(port: int, path: str, timeout: float = 30) -> tuple[int, object]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_entry_point(config: Path, workdir: Path, catalog: set, log_path: Path) -> dict:
    """``python -m gorse_tpu_torch.serve.in_one --config ...`` as a
    subprocess: ready and a recommendation of catalog ids within
    ``IN_ONE_START_S``, then SIGINT ends it with exit code 0."""
    import signal

    port = free_port()
    cmd = [sys.executable, "-m", "gorse_tpu_torch.serve.in_one", "--config", str(config),
           "--port", str(port), "--workdir", str(workdir)]
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            ready_s = None
            while time.perf_counter() - t0 < IN_ONE_START_S and proc.poll() is None:
                try:
                    if get_json(port, "/api/health/ready", timeout=5)[0] == 200:
                        ready_s = time.perf_counter() - t0
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            check(ready_s is not None, f"the entry point answered /api/health/ready within "
                  f"{IN_ONE_START_S} s (exit code {proc.poll()})")
            status, body = get_json(port, "/api/recommend/u1")
            answer_s = time.perf_counter() - t0
            check(status == 200 and bool(body) and set(body) <= catalog,
                  f"the entry point's /api/recommend/u1 gives catalog ids: {status} {body}")
            proc.send_signal(signal.SIGINT)
            t1 = time.perf_counter()
            code = proc.wait(timeout=IN_ONE_STOP_S)
            stop_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if proc.returncode != 0:
        log(log_path.read_text()[-4000:])
    check(code == 0, f"the entry point ends on SIGINT with exit code 0, not {code}")
    return {"ready_s": ready_s, "answer_s": answer_s, "stop_s": stop_s, "u1": body}


class CommitClock:
    """Stands in for a SQLite store's connection: counts its commits and
    their seconds on the host clock, and passes every other call on."""

    def __init__(self, conn) -> None:
        self._conn, self.commits, self.seconds = conn, 0, 0.0

    def commit(self) -> None:
        t0 = time.perf_counter()
        self._conn.commit()
        self.seconds += time.perf_counter() - t0
        self.commits += 1

    def __getattr__(self, name):
        return getattr(self._conn, name)


def phase_in_one(dev, smi: str, seed: int, earlier: dict) -> dict:
    """The in-one node from a copy of config.toml.example on the card: phase
    9's ml-1m data into data.sqlite, one ``run_once`` (the master's whole
    cycle with both searches due, the worker's shard), REST, a second node
    resuming from the files, and the entry point as a subprocess."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel, topk
    from gorse_tpu_torch.serve.in_one import InOneNode
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.cache import MemoryCacheStore, open_cache_store
    from gorse_tpu_torch.storage.data import SQLiteDataStore, open_data_store
    from gorse_tpu_torch.storage.meta import (
        CLICK_THROUGH_RATE_MODEL,
        COLLABORATIVE_FILTERING_MODEL,
        MetaStore,
    )
    from gorse_tpu_torch.utils.config import load_config

    result = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="gorse_in_one_") as tmp_name:
        tmp = Path(tmp_name)
        # ---- the data through the port's SQLite store
        rng = np.random.default_rng(seed + 10)
        picks = rng.integers(len(IN_ONE_TYPES), size=1 << 21)
        reads = rng.integers(3, 6, size=1 << 21)

        def feedback_type(n):
            t = IN_ONE_TYPES[picks[n]]
            return t, float(reads[n]) if t == "read" else 1.0

        t0 = time.perf_counter()
        store = SQLiteDataStore(str(tmp / "data.sqlite"))
        neighbor_store(0, embedding=False, user_fields=USER_FIELDS, data=store,
                       feedback_type=feedback_type, n_users=IN_ONE_USERS)
        insert_s = time.perf_counter() - t0
        written = (store.count_users(), store.count_items(), store.count_feedback())
        catalog = {i.item_id for i in store.get_items()}
        liked: dict[str, set] = {}
        for fb in store.get_feedback():
            liked.setdefault(fb.user_id, set()).add(fb.item_id)
        store.close()
        check(written[2] < len(picks), "the types cover every feedback row")
        fresh = open_data_store(f"sqlite://{tmp / 'data.sqlite'}")
        read_back = (fresh.count_users(), fresh.count_items(), fresh.count_feedback())
        fresh.close()
        check(read_back == written, f"data.sqlite read back {read_back}, written {written}")
        result.update(insert_s=insert_s, users=written[0], items=written[1], feedback=written[2])
        log(f"  {written[2]:,} feedback rows ({'/'.join(IN_ONE_TYPES)}), {written[0]} users, "
            f"{written[1]} items inserted through SQLiteDataStore in {insert_s:.1f} s; a fresh "
            f"sqlite:// store reads the same counts")

        # ---- the config: the example with the stores in tmp and the cuts
        config_path, changes = in_one_config(tmp)
        cfg = load_config(config_path)
        hold_config(cfg, changes)
        for section, k, v, why in IN_ONE_CUTS:
            log(f"  cut: [{section}] {k} = {v} ({why})")

        # ---- one cycle through the node, every launch count at 0 before
        node = InOneNode(cfg, workdir=str(tmp))
        check(node.device == dev, f"the in-one node runs on {node.device}")
        clocks = {"cache": CommitClock(node.cache._conn), "data": CommitClock(node.data._conn)}
        node.cache._conn, node.data._conn = clocks["cache"], clocks["data"]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = node.run_once()
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches = {n: getattr(topk, n).launches for n in KERNELS}
        launches["bpr_epoch"] = bpr_kernel.bpr_epoch.launches
        commits = {k: {"commits": c.commits, "seconds": c.seconds} for k, c in clocks.items()}
        master, worker = node.master, node.worker
        t0 = time.perf_counter()
        while master._sizeof_busy and time.perf_counter() - t0 < 300:
            time.sleep(0.1)
        check(not master._sizeof_busy, "the master's memory accounting finished")
        accounting_s = time.perf_counter() - t0
        check(all(c > 0 for c in launches.values()),
              f"the in-one cycle launches {launches}, each must be above 0")
        spans = {}
        for span in master.progress.list():
            if span.get("FinishTime"):
                spans[span["Name"]] = span["FinishTime"] - span["StartTime"]
        steps = {step: gauge(master.metrics, "master_load_dataset_step_seconds",
                             f'{{step="{step}"}}')
                 for step in ("load_items", "load_users", "load_positive_feedback",
                              "split_ranking_dataset", "create_ranking_dataset")}
        searches = {
            "cf_s": gauge(master.metrics, "master_collaborative_filtering_search_seconds"),
            "cf_ndcg": gauge(master.metrics, "master_collaborative_filtering_search_precision_10"),
            "ctr_s": gauge(master.metrics, "master_ranking_search_seconds"),
            "ctr_auc": gauge(master.metrics, "master_ranking_search_precision"),
        }
        check(all(v > 0 for v in searches.values()), f"search gauges {searches}")
        worker_steps = {step: float(v) for step, v in re.findall(
            r'^\w*worker_offline_recommend_step_seconds\{step="([^"]+)"\} (\S+)$',
            worker.metrics.render(), re.M)}
        check({"collaborative_recommend", "ranking"} <= set(worker_steps),
              f"worker step gauges {worker_steps}")
        n_users = written[0]
        check(summary["users_refreshed"] == n_users,
              f"the worker refreshed {summary['users_refreshed']} of {n_users} users")
        result.update(
            cycle_s=cycle_s, launches=launches, commits=commits, accounting_s=accounting_s,
            spans=spans,
            load_steps=steps, searches=searches, worker_steps=worker_steps,
            cf_fit_s=gauge(master.metrics, "master_collaborative_filtering_fit_seconds"),
            ctr_fit_s=gauge(master.metrics, "master_ranking_fit_seconds"),
            ctr_auc=gauge(master.metrics, "master_ranking_model_auc"),
            sizes_bytes={p.name: p.stat().st_size for p in sorted(tmp.glob("*.sqlite"))})
        phase9 = earlier.get("load_steps")
        log(f"  run_once {cycle_s:.1f} s ({smi}); memory accounting {accounting_s:.1f} s after "
            f"it; launches {json.dumps(launches)}; SQLite commits in the cycle "
            f"{json.dumps(commits)}")
        log(f"  load steps (s), SQLite: {json.dumps({k: round(v, 3) for k, v in steps.items()})}"
            + (f"; phase 9's memory store: {json.dumps({k: round(v, 3) for k, v in phase9.items()})}"
               if phase9 else ""))
        log(f"  tasks (s): {json.dumps({k: round(v, 3) for k, v in spans.items()})}")
        log(f"  CF search {searches['cf_s']:.2f} s, best NDCG@10 {searches['cf_ndcg']:.4f}; CTR "
            f"search {searches['ctr_s']:.2f} s, best AUC {searches['ctr_auc']:.4f}; BPR fit "
            f"{result['cf_fit_s']:.3f} s; CTR fit {result['ctr_fit_s']:.2f} s, AUC "
            f"{result['ctr_auc']:.4f}; worker steps (s) {json.dumps(worker_steps)}")
        log(f"  SQLite files (bytes): {json.dumps(result['sizes_bytes'])}")

        # ---- the files as a fresh process would read them
        meta = MetaStore(str(tmp / "meta.sqlite"))
        cf_id, ctr_id = meta.get(COLLABORATIVE_FILTERING_MODEL), meta.get(CLICK_THROUGH_RATE_MODEL)
        for name in ("BEST_PARAMS_CF", "CF_SEARCH_TARGET", "BEST_PARAMS_CTR"):
            check(bool(meta.get(name)), f"meta.sqlite holds {name}")
        result["search_meta"] = {n: json.loads(meta.get(n)) for n in
                                 ("BEST_PARAMS_CF", "CF_SEARCH_TARGET", "BEST_PARAMS_CTR")}
        meta.close()
        check(bool(cf_id and ctr_id) and (tmp / "blob" / cf_id).is_dir()
              and (tmp / "blob" / ctr_id).is_dir(),
              f"meta.sqlite names a CF model {cf_id} and a CTR model {ctr_id} with blobs")
        cache = open_cache_store(f"sqlite://{tmp / 'cache.sqlite'}")
        lists: dict[str, list] = {}
        for subset, score in cache.scan_scores(ck.RECOMMEND):
            lists.setdefault(subset, []).append(score)
        check(len(lists) == n_users, f"cache.sqlite holds {len(lists)} users' lists of {n_users}")
        for uid, scores in lists.items():
            ids = [x.id for x in scores]
            check(0 < len(ids) <= cfg.recommend.cache_size and set(ids) <= catalog
                  and not set(ids) & liked.get(uid, set()),
                  f"{uid}: {len(ids)} catalog ids, none liked")
        rng = np.random.default_rng(3)
        users = [f"u{u}" for u in sorted(rng.choice(n_users, MASTER_SAMPLE_USERS, replace=False))]
        sample = {uid: cache.search_scores(ck.RECOMMEND, uid) for uid in users}

        # ---- REST from the SQLite cache
        httpd = node.serve("127.0.0.1", 0, background_loop=False)
        port = httpd.server_address[1]
        try:
            for uid in users:
                status, body = get_json(port, f"/api/recommend/{uid}")
                want = [x.id for x in sample[uid]][: cfg.server.default_n]
                check(status == 200 and body == want, f"GET /api/recommend/{uid} equals the cache")
            result["rest_p50_ms"], result["rest_p99_ms"] = rest_latency(
                port, lambda r: f"/api/recommend/u{r % n_users}")
        finally:
            node.shutdown()
        phase3 = earlier.get("path", {})
        log(f"  REST from cache.sqlite: p50 {result['rest_p50_ms']:.3f} ms, p99 "
            f"{result['rest_p99_ms']:.3f} ms over {REST_REQUESTS} requests"
            + (f" (phase 3, memory store: p50 {phase3['rest_p50_ms']:.3f}, p99 "
               f"{phase3['rest_p99_ms']:.3f})" if phase3 else ""))

        # ---- the sample against a CPU worker's ranking by the saved models
        cpu_worker = Worker(cfg, node.data, MemoryCacheStore(), node.blob, device="cpu")
        cpu_worker.pull_models("", ctr_id)
        result["rank_hold_worst"] = hold_ranking(sample, cpu_worker)
        log(f"  {len(users)} users' lists equal a CPU ranking of their candidates (tie-aware; "
            f"largest |s - s_cpu| / tol {result['rank_hold_worst']:.3g})")
        del cpu_worker

        # ---- a second node on the same files resumes both models
        again = InOneNode(load_config(config_path), workdir=str(tmp))
        check(again.master.cf_index is not None and again.master.ctr_model is not None,
              "the second node resumed the CF index and the CTR model from meta.sqlite")
        meta2 = again.master.get_meta()
        check((meta2["cf_model_id"], meta2["ctr_model_id"]) == (cf_id, ctr_id),
              "the second node serves the first node's models")
        again.worker.pull_models(meta2["cf_model_id"], meta2["ctr_model_id"])
        check(again.worker.recommend(users, force=True) == len(users),
              "the resumed worker refreshed the sample")
        worst = 0.0
        for uid in users:
            worst = max(worst, same_ranking(f"{uid}: resumed node", again.cache.search_scores(
                ck.RECOMMEND, uid), sample[uid]))
        result["resume_worst"] = worst
        log(f"  a second node resumed {cf_id} and {ctr_id}; its worker wrote the same lists "
            f"(tie-aware; largest |s - s_first| / tol {worst:.3g})")
        del again, node, master, worker
        cache.close()
        torch.cuda.empty_cache()

        # ---- the entry point itself
        result["entry_point"] = phase_entry_point(config_path, tmp, catalog, tmp / "in_one.log")
        log(f"  python -m gorse_tpu_torch.serve.in_one: ready in "
            f"{result['entry_point']['ready_s']:.1f} s, /api/recommend/u1 at "
            f"{result['entry_point']['answer_s']:.1f} s, ended on SIGINT with exit code 0 in "
            f"{result['entry_point']['stop_s']:.1f} s")
    return result


def cluster_config(tmp: Path, http_port: int) -> Path:
    """tests/test_integration_cluster.py's config: BPR, no ranker over the
    collaborative lists, the ``latest`` fallback, the four stores and the
    blobs in ``tmp``; with CF switched on (``type = "mf"``; it is opt-in),
    phase 10's positive feedback types and the master's admin key."""
    path = tmp / "config.toml"
    path.write_text(f"""
[database]
data_store = "sqlite://{tmp}/data.sqlite"
cache_store = "sqlite://{tmp}/cache.sqlite"
blob_store = "{tmp}/blobs"
meta_store = "sqlite://{tmp}/meta.sqlite"

[master]
host = "127.0.0.1"
port = {free_port()}
http_host = "127.0.0.1"
http_port = {http_port}
admin_api_key = "{CLUSTER_ADMIN_KEY}"

[recommend.data_source]
positive_feedback_types = ["star", "like", "read>=3"]

[recommend.collaborative]
type = "mf"
model = "bpr"

[recommend.ranker]
type = "none"
recommenders = ["collaborative"]

[recommend.fallback]
recommenders = ["latest"]
""")
    return path


def http_json(port: int, method: str, path: str, body=None, key: str = "",
              timeout: float = 60) -> tuple[int, object]:
    """One request to 127.0.0.1:``port``; (status, decoded JSON)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        headers = {"Content-Type": "application/json"}
        if key:
            headers["X-API-Key"] = key
        conn.request(method, path, None if body is None else json.dumps(body), headers)
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        return resp.status, json.loads(raw) if "json" in ctype else raw.decode()
    finally:
        conn.close()


def rest_latency(port: int, path_of) -> tuple[float, float]:
    """p50 and p99 ms of ``REST_REQUESTS`` keep-alive ``GET path_of(r)`` on
    127.0.0.1:``port``, each answered 200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    lat = []
    try:
        for r in range(REST_REQUESTS):
            t0 = time.perf_counter()
            conn.request("GET", path_of(r))
            resp = conn.getresponse()
            resp.read()
            lat.append((time.perf_counter() - t0) * 1e3)
            check(resp.status == 200, f"GET {path_of(r)} answers 200")
    finally:
        conn.close()
    lat.sort()
    return lat[len(lat) // 2], lat[int(len(lat) * 0.99) - 1]


def poll(what: str, fn, deadline: float, every: float = 0.5):
    """``fn()`` until it returns something true, before ``deadline``
    (perf_counter seconds); the first true value."""
    while time.perf_counter() < deadline:
        try:
            value = fn()
        except (OSError, http.client.HTTPException):
            value = None
        if value:
            return value
        time.sleep(every)
    raise RuntimeError(f"check failed: {what} before the deadline")


def sqlite_copy(src: Path, dst: Path) -> None:
    """A consistent copy of a SQLite file another process has open."""
    import sqlite3

    with sqlite3.connect(src) as a, sqlite3.connect(dst) as b:
        a.backup(b)


def cluster_rows(seed: int, n_users: int, n_held: int, path: Path) -> SimpleNamespace:
    """Phase 10's rows for the first ``n_users`` users in a SQLite data
    store at ``path``, less the rows of ``n_held`` users drawn from the
    seed (held back for a REST ingest): the users, the held ids and rows,
    the catalog, each user's items, the counts and the insert's seconds."""
    from gorse_tpu_torch.storage.data import SQLiteDataStore

    rng = np.random.default_rng(seed + 10)
    picks = rng.integers(len(IN_ONE_TYPES), size=1 << 21)
    reads = rng.integers(3, 6, size=1 << 21)

    def feedback_type(n):
        t = IN_ONE_TYPES[picks[n]]
        return t, float(reads[n]) if t == "read" else 1.0

    mem = neighbor_store(0, embedding=False, user_fields=USER_FIELDS,
                         feedback_type=feedback_type, n_users=n_users)
    users, items, rows = list(mem.get_users()), list(mem.get_items()), list(mem.get_feedback())
    del mem
    held = {f"u{u}" for u in np.random.default_rng(seed + 11).choice(
        n_users, n_held, replace=False)}
    held_rows = [fb for fb in rows if fb.user_id in held]
    t0 = time.perf_counter()
    store = SQLiteDataStore(str(path))
    store.insert_items(items)
    store.insert_users(u for u in users if u.user_id not in held)
    store.insert_feedback(fb for fb in rows if fb.user_id not in held)
    store.close()
    insert_s = time.perf_counter() - t0
    seen: dict[str, set] = {}
    for fb in rows:
        seen.setdefault(fb.user_id, set()).add(fb.item_id)
    log(f"  {len(rows) - len(held_rows):,} feedback rows of {len(users) - len(held)} users "
        f"and {len(items)} items into {path.name} in {insert_s:.1f} s; {len(held_rows):,} "
        f"rows of {len(held)} users held back for the REST ingest")
    return SimpleNamespace(users=users, held=held, held_rows=held_rows, n_rows=len(rows),
                           n_items=len(items), catalog={i.item_id for i in items}, seen=seen,
                           insert_s=insert_s)


def phase_cluster(dev, smi: str, seed: int, earlier: dict) -> dict:
    """The master, server and worker as processes on the card: phase 10's
    rows for the first ``CLUSTER_USERS`` users in data.sqlite less
    ``CLUSTER_HELD`` users, who come in through the server's REST API; a
    scheduled cycle on the master; the worker's shard; the holds of the
    module docstring; every process ended by SIGTERM."""
    import signal

    import torch

    t_phase = time.perf_counter()
    result = {"card": smi}
    key = CLUSTER_ADMIN_KEY
    with tempfile.TemporaryDirectory(prefix="gorse_cluster_") as tmp_name:
        tmp = Path(tmp_name)
        rows = cluster_rows(seed, CLUSTER_USERS, CLUSTER_HELD, tmp / "data.sqlite")
        users, held, held_rows = rows.users, rows.held, rows.held_rows
        catalog, seen = rows.catalog, rows.seen
        result.update(users=len(users), items=rows.n_items, rows=rows.n_rows,
                      held_rows=len(held_rows), insert_s=rows.insert_s)

        ports = {role: free_port() for role in ("master", "server", "worker")}
        config_path = cluster_config(tmp, ports["master"])
        log_path = tmp / "cluster.log"
        procs: dict[str, subprocess.Popen] = {}
        t_start = time.perf_counter()
        with open(log_path, "wb") as log_file:
            def spawn(role: str, *args) -> None:
                t0 = time.perf_counter()
                procs[role] = subprocess.Popen(
                    SPAWN + [role, *args], cwd=ROOT, stdout=log_file,
                    stderr=subprocess.STDOUT, start_new_session=True)
                live = poll(f"the {role} answers /api/health/live", lambda: http_json(
                    ports[role], "GET", "/api/health/live", timeout=5)[0] == 200
                    and time.perf_counter(), t0 + CLUSTER_START_S)
                result.setdefault("live_s", {})[role] = live - t0

            try:
                master_url = f"http://127.0.0.1:{ports['master']}"
                spawn("master", "--config", str(config_path))
                spawn("server", "--master", master_url, "--api-key", key,
                      "--port", str(ports["server"]))
                run = SimpleNamespace(tmp=tmp, ports=ports, spawn=spawn, procs=procs, held=held,
                                      held_rows=held_rows, users=users, catalog=catalog,
                                      seen=seen, key=key)
                result.update(_cluster_run(dev, run, earlier))
                # ---- SIGTERM ends each process
                stop = {}
                for role, proc in procs.items():
                    t0 = time.perf_counter()
                    os.killpg(proc.pid, signal.SIGTERM)
                    try:
                        proc.wait(timeout=CLUSTER_STOP_S)
                    except subprocess.TimeoutExpired:
                        raise RuntimeError(f"check failed: SIGTERM ended the {role} within "
                                           f"{CLUSTER_STOP_S} s")
                    stop[role] = time.perf_counter() - t0
                result["stop_s"] = stop
                log(f"  SIGTERM ended each process (s): {json.dumps(stop)}")
            except Exception:
                log_file.flush()
                log("  the cluster's log, its tail:\n" + log_path.read_text()[-6000:])
                raise
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        os.killpg(proc.pid, signal.SIGKILL)
                        proc.wait()
        result["cluster_s"] = time.perf_counter() - t_start
        log(f"  each process live after (s): {json.dumps(result['live_s'])}; the processes ran "
            f"{result['cluster_s']:.1f} s")
        text = log_path.read_text()
        # ---- the nodes name the card they resolved
        check(f"master on device {dev}" in text, f"the master's log names {dev}")
        check(re.search(rf"worker \S+ on device {re.escape(str(dev))}", text) is not None,
              f"the worker's log names {dev}")
        result["locked"] = text.count("database is locked")
        log(f"  the logs name {dev} for the master and the worker; 'database is locked' "
            f"{result['locked']} times")
        torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11 took {result['phase_s']:.1f} s ({smi})")
    return result


def _cluster_run(dev, run, earlier: dict) -> dict:
    """Phase 11 once the master and the server answer: the ingest, the
    holds in order, the timings. ``run``: what the phase set up (``tmp``,
    ``ports``, ``spawn``, ``procs``, ``held``, ``held_rows``, ``users``,
    ``catalog``, ``seen``, ``key``)."""
    import torch

    from gorse_tpu_torch.client import GorseClient
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import open_cache_store
    from gorse_tpu_torch.storage.data import open_data_store
    from gorse_tpu_torch.utils.config import Config

    out = {}
    master, server, worker = run.ports["master"], run.ports["server"], run.ports["worker"]
    master_url = f"http://127.0.0.1:{master}"
    client = GorseClient(f"http://127.0.0.1:{server}", timeout=60)
    # ---- ingest: the held-back users (POST /api/users, which the client
    # does not wrap) and their rows (PUT /api/feedback) through the server
    t0 = time.perf_counter()
    status, body = http_json(server, "POST", "/api/users",
                             [u.to_dict() for u in run.users if u.user_id in run.held])
    check(status == 200 and body == {"RowAffected": len(run.held)}, f"POST /api/users: {body}")
    users_s = time.perf_counter() - t0
    lat = []
    for n in range(0, len(run.held_rows), CLUSTER_BATCH):
        batch = run.held_rows[n:n + CLUSTER_BATCH]
        t0 = time.perf_counter()
        body = client.insert_feedback(batch, overwrite=True)
        lat.append(time.perf_counter() - t0)
        check(body == {"RowAffected": len(batch)}, f"PUT /api/feedback: {body}")
    ingest_s = sum(lat)
    lat.sort()
    out["ingest"] = {"users_s": users_s, "batches": len(lat), "seconds": ingest_s,
                     "rows_per_s": len(run.held_rows) / ingest_s,
                     "batch_p50_ms": 1e3 * lat[len(lat) // 2],
                     "batch_p99_ms": 1e3 * lat[max(int(len(lat) * 0.99) - 1, 0)]}
    log(f"  ingest through the server: {len(run.held)} users in {users_s:.2f} s; "
        f"{len(run.held_rows):,} rows in {len(lat)} batches of {CLUSTER_BATCH} in "
        f"{ingest_s:.1f} s = {out['ingest']['rows_per_s']:.0f} rows/s, a batch p50 "
        f"{out['ingest']['batch_p50_ms']:.0f} ms, p99 {out['ingest']['batch_p99_ms']:.0f} ms")

    # ---- hold 1: the admin gate
    status, _ = http_json(master, "POST", "/api/admin/meta", {})
    check(status == 401, f"POST /api/admin/meta without the key gives 401, not {status}")

    # ---- hold 2: the server reads every sent row back
    readback = sorted(str(u) for u in np.random.default_rng(2).choice(
        sorted(run.held), CLUSTER_READBACK, replace=False))
    for uid in readback:
        sent = {fb.key(): fb.value for fb in run.held_rows if fb.user_id == uid}
        got = {fb.key(): fb.value for fb in client.get_user_feedback(uid)}
        check(got == sent, f"GET /api/user/{uid}/feedback returns the {len(sent)} rows sent "
              f"({len(got)} back, {len(sent.keys() - got.keys())} missing)")
    log(f"  the master's admin routes answer 401 without the key; the server returns every "
        f"row sent for {len(readback)} held-back users")

    def meta():
        status, body = http_json(master, "POST", "/api/admin/meta", {}, run.key)
        check(status == 200, f"POST /api/admin/meta with the key: {status}")
        return body

    # ---- hold 3: the scheduled cycle names a new CF model with its blob
    first = poll("the master's first cycle names a CF model", lambda: meta()["cf_model_id"],
                 time.perf_counter() + CLUSTER_CYCLE_S)
    t_sched = time.perf_counter()
    check(http_json(master, "POST", "/api/dashboard/schedule", {}, run.key)
          == (200, {"status": "scheduled"}), "POST /api/dashboard/schedule")
    deadline = t_sched + CLUSTER_CYCLE_S
    cf_id = poll("the scheduled cycle names a new CF model",
                 lambda: (m := meta()["cf_model_id"]) != first and m, deadline)
    out["schedule_to_model_s"] = time.perf_counter() - t_sched
    check((run.tmp / "blobs" / cf_id).is_dir(), f"the model {cf_id} has its blob")
    log(f"  schedule -> {cf_id} in the meta: {out['schedule_to_model_s']:.1f} s (the first "
        f"cycle's model: {first})")
    # the worker starts now: its lists come from the model that saw the
    # ingested rows (a worker refreshes a user only when the user's list is
    # stale, never for a new model, as the reference's does)
    run.spawn("worker", "--master", master_url, "--api-key", run.key, "--meta-timeout", "1",
          "--http-port", str(worker))
    nodes = poll("/api/dashboard/cluster lists one server and one worker", lambda: (
        body := http_json(master, "GET", "/api/dashboard/cluster", None, run.key)[1],
        sorted(n["Type"] for n in body) == ["server", "worker"] and body)[1],
        time.perf_counter() + CLUSTER_START_S)
    worker_id = next(n["UUID"] for n in nodes if n["Type"] == "worker")

    steps = {}

    def span_arrived():
        # the worker's step gauges hold for about a second after its cycle
        _, text = http_json(worker, "GET", "/metrics")
        if re.search(rf"^\w*worker_update_user_recommend_total {len(run.users)}\.0$", text, re.M):
            steps.update({k: float(v) for k, v in re.findall(
                r'^\w*worker_offline_recommend_step_seconds\{step="([^"]+)"\} (\S+)$', text,
                re.M)})
            steps["total"] = float(re.search(
                r"^\w*worker_offline_recommend_total_seconds (\S+)$", text, re.M).group(1))
        status, tasks = http_json(master, "GET", "/api/dashboard/tasks", None, run.key)
        return status == 200 and next(
            (t for t in tasks if t.get("Node") == worker_id and t["Name"] == "recommend"
             and t["Status"] == "complete" and t["Count"] == len(run.users)), None)

    span = poll(f"the worker's span for {len(run.users)} users at the master", span_arrived,
                deadline, every=0.25)
    out["worker_span_s"] = span["FinishTime"] - span["StartTime"]
    out["worker_steps"] = steps or "not measured"
    log(f"  worker {worker_id}: its span for {len(run.users)} users arrived "
        f"{time.perf_counter() - t_sched:.1f} s after schedule; the cycle "
        f"{out['worker_span_s']:.1f} s; its steps (s): {json.dumps(steps) or 'not caught'}")

    # ---- hold 4: every list in cache.sqlite
    cache = open_cache_store(f"sqlite://{run.tmp / 'cache.sqlite'}")
    lists: dict[str, list] = {}
    for subset, score in cache.scan_scores(ck.RECOMMEND):
        lists.setdefault(subset, []).append(score)
    cfg = Config.from_json(meta()["config"])
    check(len(lists) == len(run.users),
          f"cache.sqlite holds {len(lists)} lists of {len(run.users)}")
    for uid, scores in lists.items():
        ids = [x.id for x in scores]
        check(0 < len(ids) <= cfg.recommend.cache_size and set(ids) <= run.catalog
              and not set(ids) & run.seen.get(uid, set()),
              f"{uid}: {len(ids)} catalog ids, none of the user's items")
    # ---- hold 5: the server answers from the cache
    rng = np.random.default_rng(5)
    others = sorted(u.user_id for u in run.users if u.user_id not in run.held)
    sample = ([str(u) for u in rng.choice(sorted(run.held), CLUSTER_SAMPLE // 2, replace=False)]
              + [str(u) for u in rng.choice(others, CLUSTER_SAMPLE // 2, replace=False)])
    want = {uid: cache.search_scores(ck.RECOMMEND, uid) for uid in sample}
    for uid in sample:
        status, body = http_json(server, "GET", f"/api/recommend/{uid}")
        check(status == 200 and body == [x.id for x in want[uid]][: cfg.server.default_n],
              f"GET /api/recommend/{uid} on the server equals the cache")
    out["schedule_to_served_s"] = time.perf_counter() - t_sched
    cache.close()
    log(f"  every list in cache.sqlite: catalog ids, at most {cfg.recommend.cache_size}, none of "
        f"the user's items; {len(sample)} users ({CLUSTER_SAMPLE // 2} held back) served equal "
        f"to the cache, {out['schedule_to_served_s']:.1f} s after schedule")

    # ---- holds 6 and 7: a worker here, on the card and on the CPU
    m = meta()
    cfg = Config.from_json(m["config"])
    lists_out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        copy = run.tmp / f"check_{where}.sqlite"
        sqlite_copy(run.tmp / "cache.sqlite", copy)
        check_worker = Worker(cfg, open_data_store(cfg.database.data_store),
                              open_cache_store(f"sqlite://{copy}"),
                              BlobStore(cfg.database.blob_store), node_id=f"check-{where}",
                              device=device)
        check_worker.pull_models(m["cf_model_id"], m["ctr_model_id"])
        check(check_worker.cf_model_id == cf_id, f"the {where} worker pulled {cf_id}")
        if where == "card":
            zero_counts()
        check(check_worker.recommend(sample, force=True) == len(sample),
              f"the {where} worker refreshed the sample")
        if where == "card":
            torch.cuda.synchronize()
            out["launches"] = {n: getattr(topk, n).launches for n in KERNELS}
            check(all(v > 0 for v in out["launches"].values()),
                  f"the card worker's recall launches {out['launches']}")
        worst = 0.0
        for uid in sample:
            worst = max(worst, same_ranking(f"{uid}: the {where} worker", [
                x for x in check_worker.cache.search_scores(ck.RECOMMEND, uid)], want[uid]))
        lists_out[where] = worst
        del check_worker
    out["hold_worst"] = lists_out
    log(f"  a card worker here on {cf_id} gives the worker process's lists (tie-aware, largest "
        f"|s - s_process| / tol {lists_out['card']:.3g}; launches {json.dumps(out['launches'])});"
        f" a CPU worker too ({lists_out['cpu']:.3g})")

    # ---- hold 8: a cold user gets latest
    status, cold = http_json(server, "GET", "/api/recommend/brand-new-user?n=3")
    _, latest = http_json(server, "GET", "/api/latest?n=3")
    check(status == 200 and cold == [x["Id"] for x in latest] and len(cold) == 3,
          f"a cold user gets latest: {cold} against {latest}")
    # ---- hold 9: the worker's health and metrics
    status, body = http_json(worker, "GET", "/api/health/ready")
    check(status == 200 and body == {"status": "ready"}, f"the worker is ready: {body}")
    _, text = http_json(worker, "GET", "/metrics")
    check("gorse_worker_update_user_recommend_total" in text, "the worker's /metrics")
    _, text = http_json(master, "GET", "/metrics")
    fit = re.search(r"^\w*master_collaborative_filtering_fit_seconds (\S+)$", text, re.M)
    check(fit is not None, "the master's fit gauge")
    out["master_fit_s"] = float(fit.group(1))
    log(f"  a cold user gets latest; the worker is ready; the master's "
        f"master_collaborative_filtering_fit_seconds {out['master_fit_s']:.3f}")

    # ---- REST latency on the server process (the async front end)
    out["rest_p50_ms"], out["rest_p99_ms"] = rest_latency(
        server, lambda r: f"/api/recommend/u{r % len(run.users)}")
    phase10 = earlier.get("in_one") or {}
    log(f"  REST on the server process: p50 {out['rest_p50_ms']:.3f} ms, p99 "
        f"{out['rest_p99_ms']:.3f} ms over {REST_REQUESTS} keep-alive requests"
        + (f" (phase 10, in-process: p50 {phase10['rest_p50_ms']:.3f}, p99 "
           f"{phase10['rest_p99_ms']:.3f})" if phase10 else ""))
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv"], capture_output=True, text=True)
    out["compute_apps"] = apps.stdout.strip() or apps.stderr.strip()
    log(f"  nvidia-smi --query-compute-apps (pids: "
        f"{json.dumps({r: p.pid for r, p in run.procs.items()})}):\n{out['compute_apps']}")
    return out


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 12


def share(got, want) -> float:
    """The largest difference as a share of ``want``'s largest magnitude."""
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-30)


class PsumClock:
    """Times each ``mesh.psum`` by CUDA events while installed: the
    collective's span on the stream (the gather, the ordered sum, the
    copies)."""

    def __init__(self, mesh) -> None:
        self.mesh, self.spans = mesh, []

    def __enter__(self):
        import torch

        inner = self.mesh.psum

        def timed(parts):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(parts)
            end.record()
            self.spans.append((start, end))
            return out

        self.mesh.psum = timed
        return self

    def __exit__(self, *exc):
        del self.mesh.psum  # the class's method again
        return False

    def ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.spans)


def sharded_inputs(train, csr, dev, seed: int = 0):
    """An epoch at phase 5's shape: its init and key (seed 0: phase 5's
    first epoch), its steps and tries."""
    from gorse_tpu_torch.models import BPR, Params
    from gorse_tpu_torch.models.bpr import adaptive_neg_tries
    from gorse_tpu_torch.ops import sampling

    n_items = train.count_items()
    init = BPR(Params(n_factors=TRAIN_DIM), device=dev)
    init.init(train, seed=seed)
    _, epoch_key = sampling.split(sampling.prng_key(1 + seed))
    n_active = max(int((csr.counts > 0).sum()), 1)
    n_steps = max(round(train.count_feedback() / n_active), 1)
    return init, epoch_key, n_steps, adaptive_neg_tries(float(np.mean(csr.counts)) / n_items)


def one_shard_bpr_fit(loaded, params, dev) -> tuple:
    """The master's BPR fit (``BPR.fit`` under the master's seed 0, every
    epoch) through the user-sharded epoch on a one-shard mesh of the card:
    the counter sampler on one card, which the sharded fit draws (``BPR.fit``
    on one card draws the reference's one-device sampler). Returns ``(p, q,
    NDCG@10)``."""
    from gorse_tpu_torch.models import BPR, FitConfig
    from gorse_tpu_torch.models.base import build_eval_candidates, evaluate_mf
    from gorse_tpu_torch.models.bpr import adaptive_neg_tries, history_cap
    from gorse_tpu_torch.ops import sampling
    from gorse_tpu_torch.parallel.mesh import make_mesh
    from gorse_tpu_torch.parallel.sharded import make_sharded_bpr_epoch, shard_bpr_inputs

    train = loaded.train
    model = BPR(params, device=dev)
    model.init(train, seed=0)
    cap, _ = history_cap(train)
    csr = train.padded_user_positives(max_len=cap, seed=0)
    n_items, n_users = train.count_items(), train.count_users()
    n_steps = max(round(train.count_feedback() / max(int((csr.counts > 0).sum()), 1)), 1)
    one = make_mesh(1, devices=[dev])
    epoch = make_sharded_bpr_epoch(one, n_steps, n_items, model.lr, model.reg,
                                   adaptive_neg_tries(float(np.mean(csr.counts)) / n_items))
    p, q, *rows, _ = shard_bpr_inputs(one, model.user_factors, model.item_factors, csr.padded,
                                      csr.counts)
    key = sampling.prng_key(1)
    for _ in range(model.n_epochs):
        key, epoch_key = sampling.split(key)
        p, q, _ = epoch(p, q, *rows, epoch_key)
    p, q = p[0][:n_users].to(dev), q[0].to(dev)
    config = FitConfig()  # the evaluation the master's fit ends with
    ndcg = evaluate_mf(p, q, *build_eval_candidates(loaded.test, train, config.candidates),
                       config.top_k)["NDCG"]
    return p, q, ndcg


def hold_sharded_epoch(train, csr, dev, mesh, smi: str, phase5: dict | None,
                       n_inits: int) -> dict:
    """The user-sharded epoch on ``mesh`` against the same epoch on a
    one-shard mesh of the card (the counter sampler on one card: the
    single-card ``bpr_epoch`` draws the reference's one-device sampler
    instead) from the same init and key: every step's pairs equal, K3
    launched n_steps x shards times; then timed (host clock ending on a
    synchronise; the psums by CUDA events). At ``n_inits`` inits and
    keys: p and q within ``SHARDED_EPOCH_TOL`` of each table's largest
    magnitude from the one-shard epoch's, that epoch run twice (its own
    spread, logged), ``sync_every = 4`` through K3 against the same epoch through
    ``bpr_sweep_pairs_plain`` within ``SYNC4_TOL``; every reading is logged
    before any is checked. The catalog-sharded epoch: its drops equal to
    those the recorded pairs give by counting each owner's requests past
    the cap, its factors within ``FIRST_EPOCH_TOL`` of the user-sharded
    epoch's (plain ops against K3)."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.parallel.catalog import (
        make_catalog_sharded_bpr_epoch,
        request_cap,
        shard_catalog_bpr_inputs,
        unpack_catalog,
    )
    from gorse_tpu_torch.parallel.mesh import make_mesh
    from gorse_tpu_torch.parallel.sharded import make_sharded_bpr_epoch, shard_bpr_inputs

    init, key, n_steps, n_tries = sharded_inputs(train, csr, dev)
    n_items, n_users, d = train.count_items(), train.count_users(), mesh.size
    one = make_mesh(1, devices=[dev])
    one_epoch = make_sharded_bpr_epoch(one, n_steps, n_items, LR, REG, n_tries)

    def single(init, key, pairs=None):
        p1, q1, pp1, pc1, uids1, _ = shard_bpr_inputs(one, init.user_factors, init.item_factors,
                                                      csr.padded, csr.counts)
        got = None if pairs is None else [torch.empty((2, n_steps, p1[0].shape[0]),
                                                      dtype=torch.int32, device=dev)]
        p1, q1, _ = one_epoch(p1, q1, pp1, pc1, uids1, key, pairs=got)
        if pairs is not None:
            pairs.copy_(got[0][:, :, :n_users])
        return p1[0][:n_users].to(dev), q1[0].to(dev)

    def place(init):
        return shard_bpr_inputs(mesh, init.user_factors, init.item_factors, csr.padded, csr.counts)

    def dense(p, q):
        return mesh.all_gather(p)[0][:n_users].to(dev), q[0].to(dev)

    def shares(a, b):
        return {"p": share(a[0], b[0]), "q": share(a[1], b[1])}

    pairs1 = torch.empty((2, n_steps, n_users), dtype=torch.int32, device=dev)
    p1, q1 = single(init, key, pairs1)
    epoch = make_sharded_bpr_epoch(mesh, n_steps, n_items, LR, REG, n_tries)
    p, q, pp, pc, uids, _ = place(init)
    pairs = [torch.empty((2, n_steps, t.shape[0]), dtype=torch.int32, device=t.device) for t in p]
    zero_counts()
    for device in mesh.devices:
        torch.cuda.synchronize(device)
    p, q, cost = epoch(p, q, pp, pc, uids, key, pairs=pairs)
    for device in mesh.devices:
        torch.cuda.synchronize(device)
    launches = bk.bpr_sweep_pairs.launches
    check(launches == n_steps * d, f"sharded epoch: {launches} K3 launches, want {n_steps} x {d}")
    got_pairs = torch.cat([t.to(dev) for t in pairs], dim=2)[:, :, :n_users]
    check(torch.equal(got_pairs, pairs1),
          "sharded epoch: every step's pairs equal the one-shard epoch's")
    p_s, q_s = dense(p, q)

    times, psum_ms = [], []
    for _ in range(2):
        args = place(init)
        for device in mesh.devices:
            torch.cuda.synchronize(device)
        with PsumClock(mesh) as clock:
            t0 = time.perf_counter()
            epoch(*args[:5], key)
            for device in mesh.devices:
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        psum_ms.append(clock.ms())
    nnz = train.count_feedback()
    result = dict(shards=d, n_steps=n_steps, k3_launches_per_epoch=launches,
                  epoch_ms=times, psum_ms=psum_ms,
                  psum_share=[a / b for a, b in zip(psum_ms, times)],
                  examples_per_s=[nnz / (t / 1e3) for t in times])
    single_rate = (phase5 or {}).get("examples_per_s")
    log(f"  user-sharded epoch on {d} shards ({[str(x) for x in mesh.devices]}): {n_steps} steps, "
        f"K3 launched {launches} times; pairs equal the one-shard epoch's; epoch {times} ms, "
        f"examples/s "
        f"{result['examples_per_s']} (phase 5's single-card fit: {single_rate}); psums "
        f"{psum_ms} ms by CUDA events ({smi})")

    # the holds at n_inits inits and keys, sync_every = 4 (K3 against its
    # plain version on the same pairs) among them
    steps4 = -(-n_steps // 4) * 4
    readings = {"sharded_vs_one_shard": [], "one_shard_rerun": [], "sync4_vs_plain": []}
    for seed in range(n_inits):
        if seed == 0:
            s_init, s_key, one_card, sharded = init, key, (p1, q1), (p_s, q_s)
        else:
            s_init, s_key, _, _ = sharded_inputs(train, csr, dev, seed)
            one_card = single(s_init, s_key)
            sharded = dense(*epoch(*place(s_init)[:5], s_key)[:2])
        readings["sharded_vs_one_shard"].append(shares(sharded, one_card))
        readings["one_shard_rerun"].append(shares(single(s_init, s_key), one_card))
        got = {}
        for name, sweep in (("kernel", bk.bpr_sweep_pairs), ("plain", bk.bpr_sweep_pairs_plain)):
            p4, q4, _ = make_sharded_bpr_epoch(mesh, steps4, n_items, LR, REG, n_tries, 4,
                                               sweep)(*place(s_init)[:5], s_key)
            got[name] = dense(p4, q4)
        readings["sync4_vs_plain"].append(shares(got["kernel"], got["plain"]))
    most = {name: max(max(r.values()) for r in rs) for name, rs in readings.items()}
    result.update(inits=n_inits, hold_readings=readings, hold_most=most)
    log(f"  at {n_inits} inits and keys, shares of each table's largest magnitude: "
        f"{json.dumps(readings)}; the largest {json.dumps(most)} (limits: sharded "
        f"{json.dumps(SHARDED_EPOCH_TOL)}, sync_every 4 {SYNC4_TOL}; the one-shard epoch's spread "
        f"logged) ({smi})")
    for seed, r in enumerate(readings["sharded_vs_one_shard"]):
        for name, s in r.items():
            check(s <= SHARDED_EPOCH_TOL[name], f"sharded epoch, seed {seed}: {name} off by "
                  f"{s:.3g} of its largest magnitude from the one-shard epoch's (SHARDED_EPOCH_TOL "
                  f"{SHARDED_EPOCH_TOL[name]})")
    for seed, r in enumerate(readings["sync4_vs_plain"]):
        for name, s in r.items():
            check(s <= SYNC4_TOL, f"sync_every 4, seed {seed}: {name} off by {s:.3g} from the "
                  f"plain sweep's (SYNC4_TOL {SYNC4_TOL})")

    # the catalog-sharded epoch: drops from the recorded pairs, factors
    cat = make_catalog_sharded_bpr_epoch(mesh, n_steps, n_items, LR, REG, n_tries)
    cp, cq, cpp, cpc, cuids, _, _ = shard_catalog_bpr_inputs(
        mesh, init.user_factors, init.item_factors, csr.padded, csr.counts)
    for device in mesh.devices:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cp, cq, stats = cat(cp, cq, cpp, cpc, cuids, key)
    for device in mesh.devices:
        torch.cuda.synchronize(device)
    cat_ms = (time.perf_counter() - t0) * 1e3
    cap = request_cap(2 * pp[0].shape[0], d)
    want_drops = 0
    for j, t in enumerate(pairs):
        active = (pc[j] > 0).to(t.device)
        for s in range(n_steps):
            ids = torch.cat([t[0, s][active], t[1, s][active]]).long()
            per_owner = torch.bincount(ids % d, minlength=d)
            want_drops += int((per_owner - cap).clamp(min=0).sum())
    drops = int(stats[1])
    check(drops == want_drops, f"catalog epoch: {drops} drops, the pairs give {want_drops}")
    cat_p = mesh.all_gather(cp)[0][:n_users].to(dev)
    cat_q = torch.from_numpy(unpack_catalog(mesh.all_gather(cq)[0], n_items, d)).to(dev)
    result["catalog"] = dict(drops=drops, cap=cap, epoch_ms=cat_ms,
                             shares={"p": share(cat_p, p_s), "q": share(cat_q, q_s)},
                             cost=float(stats[0]), sharded_cost=float(cost))
    for name, s in result["catalog"]["shares"].items():
        check(s <= FIRST_EPOCH_TOL, f"catalog epoch: {name} off by {s:.3g} from the "
              f"user-sharded epoch's")
    log(f"  catalog epoch {cat_ms:.1f} ms, {drops} drops (the pairs give {want_drops}, cap {cap}), "
        f"against the user-sharded epoch {json.dumps(result['catalog']['shares'])} ({smi})")
    return result


def hold_sharded_topk(dev, mesh, seed: int, smi: str) -> dict:
    """``make_sharded_topk`` over SHARDED_TOPK's items in the mesh's shards
    against ``dot_topk`` on the whole table: ids and scores equal, tie order
    included (the same bf16 operands and tensor-core scores in each shard)."""
    import torch

    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.parallel.sharded import make_sharded_topk, shard_items

    n, dim, b, k = SHARDED_TOPK
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    items = torch.randn((n, dim), generator=gen, device=dev)
    queries = torch.randn((b, dim), generator=gen, device=dev)
    whole = topk.prepare_items(items, device=dev)
    shards = shard_items(mesh, items)
    run = make_sharded_topk(mesh, k)
    zero_counts()
    s, i = run(queries, shards)
    torch.cuda.synchronize()
    launches = {name: getattr(topk, name).launches for name in KERNELS}
    ds, di = topk.dot_topk(queries, whole, k, device=dev)
    torch.cuda.synchronize()
    check(torch.equal(i, di.to(i.device)) and torch.equal(s, ds.to(s.device)),
          "sharded top-k: ids and scores equal dot_topk on the whole table")
    check(all(launches[name] >= mesh.size for name in KERNELS)
          and launches["merge_topk"] >= mesh.size + 1,
          f"sharded top-k: {launches}: each shard's chain and the merge across shards")
    result = dict(items=n, shards=mesh.size, queries=b, k=k, launches=launches,
                  ms=median_ms(lambda: run(queries, shards), 5),
                  whole_ms=median_ms(lambda: topk.dot_topk(queries, whole, k, device=dev), 5))
    log(f"  sharded top-k {n} x {dim} in {mesh.size} shards, {b} queries, k = {k}: equal to "
        f"dot_topk; {result['ms']:.3f} ms against {result['whole_ms']:.3f} ms whole; launches "
        f"{json.dumps(launches)} ({smi})")
    return result


def hold_sharded_master(dev, mesh, smi: str, patch: bool) -> dict:
    """Phase 9's setup on its CTR_USERS users, the fits' epochs cut to
    SHARDED_MASTER_EPOCHS: a master on ``mesh`` (patched into
    ``training_mesh``, or its own when ``patch`` is false) runs
    ``run_tasks_once`` (BPR, the fm ranker), a single-card master fits the
    same loaded data; then both fit eALS. The BPR tables are held against
    :func:`one_shard_bpr_fit` (the counter sampler on one card, as the
    sharded fit draws; the single card's fit draws the reference's
    one-device sampler). Held: BPR and
    eALS factors within ``FIRST_EPOCH_TOL`` and ``EALS_TOL`` of each table's
    largest magnitude, NDCG (against the single card's) and AUC within
    0.01, the masters' AFM tables by :func:`hold_adam_epoch`, and the AFM
    on the masters' split by :func:`afm_holds` over ``CTR_HOLD_STEPS``
    steps (sharded against one card). Printed: each fit's gauge beside the
    single card's, and on a line of its own each AFM table's share of the
    masters' Adam epochs with its worst entry."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.utils.config import Config

    data = neighbor_store(0, embedding=False, user_fields=USER_FIELDS, n_users=CTR_USERS)
    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.collaborative.fit_epoch = SHARDED_MASTER_EPOCHS
    cfg.recommend.ranker.type = "fm"
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.ranker.fit_epoch = 1
    result = {}
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        def master(name, model="bpr"):
            cfg.recommend.collaborative.model = model
            m = Master(cfg, data, MemoryCacheStore(), BlobStore(Path(tmp) / name), MetaStore(),
                       device=dev)
            if name.startswith("single"):
                m.training_mesh = lambda: None
            elif patch:
                m.training_mesh = lambda: mesh
            return m

        sharded = master("sharded")
        check(sharded.training_mesh() is mesh or not patch, "the patched training_mesh")
        used = sharded.training_mesh()
        check(used is not None and used.size == mesh.size,
              f"the master shards over {mesh.size}: {used}")
        sharded._sizeof_ts = time.perf_counter()  # no memory accounting thread here
        zero_counts()
        loaded = sharded.run_tasks_once()
        for device in used.devices:
            torch.cuda.synchronize(device)
        launches = bk.bpr_sweep_pairs.launches
        check(launches > 0 and bk.bpr_epoch.launches == 0,
              f"sharded master: K3 launched {launches}, bpr_epoch {bk.bpr_epoch.launches}")
        single = master("single")
        single.train_collaborative_filtering(loaded)
        single.train_click_through_rate(loaded)
        # the BPR tables' baseline: the master's fit through the user-sharded
        # epoch on a one-shard mesh
        one_p, one_q, one_ndcg = one_shard_bpr_fit(loaded, sharded.cf_model.params, dev)
        gauges = {"one_shard": {"master_collaborative_filtering_ndcg_10": one_ndcg}}
        for who, m in (("sharded", sharded), ("single", single)):
            gauges[who] = {g: gauge(m.metrics, g) for g in (
                "master_collaborative_filtering_fit_seconds", "master_collaborative_filtering_ndcg_10",
                "master_ranking_fit_seconds", "master_ranking_model_auc")}
        shares = {"bpr_p": share(sharded.cf_model.user_factors, one_p),
                  "bpr_q": share(sharded.cf_model.item_factors, one_q)}
        for name, s in shares.items():
            check(s <= FIRST_EPOCH_TOL, f"sharded master: {name} off by {s:.3g} of the "
                  f"one-shard fit's")
        # the masters' Adam epochs (entries past AFM_TOL held to one row's);
        # the lockstep under Adam and the SGD epoch, sharded against one
        # card, on the masters' split and hyper-parameters
        adam = hold_adam_epoch("sharded master's AFM", sharded.ctr_model.model_params,
                               single.ctr_model.model_params, loaded.ctr.max_dimension())
        for name, x in adam.items():
            log(f"  AFM Adam epoch {name}: {x['share']:.3g} of the single card's largest, "
                f"{x['worst']} ({x['allowed']} allowed)")
        train, test = loaded.ctr.split(0.2, seed=0)
        hp = {"n_epochs": 1}
        t0 = time.perf_counter()
        afm = afm_holds("sharded master's AFM", AfmSide(dev, used, hp, train, test),
                        AfmSide(dev, None, hp, train, test), CTR_HOLD_STEPS)
        log(f"  AFM holds, {used.size} shards against one card "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(afm)}")
        for g in ("master_collaborative_filtering_ndcg_10", "master_ranking_model_auc"):
            check(abs(gauges["sharded"][g] - gauges["single"][g]) <= 0.01,
                  f"sharded master: {g} {gauges['sharded'][g]} vs {gauges['single'][g]}")

        als = {}
        for name in ("sharded_als", "single_als"):
            m = master(name, "als")
            m.train_collaborative_filtering(loaded)
            check(type(m.cf_model).__name__ == "ALS", f"{name}: an eALS fit")
            als[name] = (m, gauge(m.metrics, "master_collaborative_filtering_fit_seconds"),
                         gauge(m.metrics, "master_collaborative_filtering_ndcg_10"))
        (ma, fa, na), (mb, fb, nb) = als["sharded_als"], als["single_als"]
        for name, s in (("als_p", share(ma.cf_model.user_factors, mb.cf_model.user_factors)),
                        ("als_q", share(ma.cf_model.item_factors, mb.cf_model.item_factors))):
            shares[name] = s
            check(s <= EALS_TOL, f"sharded master: {name} off by {s:.3g} of the single card's")
        check(abs(na - nb) <= 0.01, f"sharded master: eALS NDCG {na} vs {nb}")
        gauges["sharded"]["als_fit_seconds"], gauges["single"]["als_fit_seconds"] = fa, fb
        gauges["sharded"]["als_ndcg_10"], gauges["single"]["als_ndcg_10"] = na, nb
    result.update(shards=used.size, k3_launches=launches, shares=shares, gauges=gauges,
                  epochs=SHARDED_MASTER_EPOCHS, afm_adam_epoch=adam, afm_holds=afm)
    log(f"  master on {used.size} shards ({[str(x) for x in used.devices]}): K3 launched "
        f"{launches}; shares (BPR against the one-shard fit, the rest against the single "
        f"card) {json.dumps(shares)}; gauges sharded {json.dumps(gauges['sharded'])}, single "
        f"{json.dumps(gauges['single'])}, one shard {json.dumps(gauges['one_shard'])} ({smi})")
    return result


def hold_multihost(train, csr, dev) -> dict:
    """``init_multihost`` at world size 1 over NCCL, then the user-sharded
    epoch on ``global_mesh`` (SHARDS shards of this card) against the same
    epoch on a mesh of no process group: its collectives cross NCCL."""
    import torch
    import torch.distributed as dist

    from gorse_tpu_torch.parallel.mesh import make_mesh
    from gorse_tpu_torch.parallel.multihost import global_mesh, init_multihost
    from gorse_tpu_torch.parallel.sharded import make_sharded_bpr_epoch, shard_bpr_inputs

    info = init_multihost(f"127.0.0.1:{free_port()}", 1, 0, devices=[dev])
    try:
        check(dist.get_backend() == "nccl" and info["process_count"] == 1,
              f"init_multihost over NCCL: {info}, backend {dist.get_backend()}")
        init, key, n_steps, n_tries = sharded_inputs(train, csr, dev)
        out = {}
        for name, mesh in (("group", global_mesh(devices=[dev] * SHARDS)),
                           ("local", make_mesh(SHARDS, devices=[dev]))):
            p, q, pp, pc, uids, n_users = shard_bpr_inputs(
                mesh, init.user_factors, init.item_factors, csr.padded, csr.counts)
            p, q, cost = make_sharded_bpr_epoch(mesh, n_steps, train.count_items(), LR, REG,
                                                n_tries)(p, q, pp, pc, uids, key)
            out[name] = (mesh.all_gather(p)[0], q[0])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    shares = {"p": share(out["group"][0], out["local"][0]),
              "q": share(out["group"][1], out["local"][1])}
    for name, s in shares.items():
        check(s <= SHARDED_EPOCH_TOL[name], f"NCCL mesh: {name} off by {s:.3g}")
    log(f"  init_multihost {json.dumps(info)} over NCCL; the epoch on its mesh against a local "
        f"mesh: {json.dumps(shares)}")
    return dict(info=info, shares=shares)


MULTIPROCESS_CHILD = """
import sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[5])
import chip_smoke as cs
from gorse_tpu_torch.parallel.multihost import global_mesh, init_multihost
from gorse_tpu_torch.parallel.sharded import make_sharded_bpr_epoch, shard_bpr_inputs

address, world, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dev = torch.device("cuda", rank)
info = init_multihost(address, world, rank, devices=[dev])
mesh = global_mesh(devices=[dev])
train, _, csr = cs.make_training_data()
init, key, n_steps, n_tries = cs.sharded_inputs(train, csr, dev)
p, q, pp, pc, uids, n_users = shard_bpr_inputs(mesh, init.user_factors, init.item_factors,
                                               csr.padded, csr.counts)
p, q, cost = make_sharded_bpr_epoch(mesh, n_steps, train.count_items(), cs.LR, cs.REG,
                                    n_tries)(p, q, pp, pc, uids, key)
p = mesh.all_gather(p)[0][:n_users]
torch.cuda.synchronize(dev)
if rank == 0:
    np.savez(out, p=p.cpu().numpy(), q=q[0].cpu().numpy(), info=np.array(list(info.values())))
dist.destroy_process_group()
print("child done", rank, info, flush=True)
"""


def hold_multiprocess(train, csr, dev, cards) -> dict:
    """With several cards: one process a card joined by ``init_multihost``
    over NCCL, the user-sharded epoch on their ``global_mesh``, against the
    same epoch in this process on the mesh over all the cards (within
    ``EPOCH_TOL``: K3's item sums are atomics)."""
    import torch

    from gorse_tpu_torch.parallel.sharded import make_sharded_bpr_epoch, shard_bpr_inputs

    n = cards.size
    address = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        out = Path(tmp) / "rank0.npz"
        procs = [subprocess.Popen([sys.executable, "-c", MULTIPROCESS_CHILD, address, str(n),
                                   str(r), str(out), str(ROOT)], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(n)]
        try:
            logs = [p.communicate(timeout=300)[0].decode() for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"process {r} of {n}: exit {p.returncode}\n{text[-3000:]}")
        got = dict(np.load(out))
    init, key, n_steps, n_tries = sharded_inputs(train, csr, dev)
    p, q, pp, pc, uids, n_users = shard_bpr_inputs(cards, init.user_factors, init.item_factors,
                                                   csr.padded, csr.counts)
    p, q, _ = make_sharded_bpr_epoch(cards, n_steps, train.count_items(), LR, REG,
                                     n_tries)(p, q, pp, pc, uids, key)
    want_p = cards.all_gather(p)[0][:n_users].cpu()
    shares = {"p": share(torch.from_numpy(got["p"]), want_p),
              "q": share(torch.from_numpy(got["q"]), q[0].cpu())}
    for name, s in shares.items():
        check(s <= SHARDED_EPOCH_TOL[name], f"{n} NCCL processes: {name} off by {s:.3g} from "
              f"one process over the {n} cards")
    log(f"  {n} processes over NCCL, a card each, against one process over the {n} cards: "
        f"{json.dumps(shares)}")
    return {"processes": n, "shares": shares}


def phase_sharded(train, test, csr, dev, smi: str, seed: int, phase5: dict | None,
                  n_inits: int = HOLD_INITS) -> dict:
    """Phase 12: sharded training on a SHARDS-shard mesh of this card, and
    on a mesh of every card when more than one is visible."""
    import torch

    from gorse_tpu_torch.parallel.mesh import make_mesh
    from gorse_tpu_torch.serve.master import Master

    mesh = make_mesh(SHARDS, devices=[dev])
    result = {"epoch": hold_sharded_epoch(train, csr, dev, mesh, smi, phase5, n_inits)}
    torch.cuda.empty_cache()
    result["topk"] = hold_sharded_topk(dev, mesh, seed, smi)
    torch.cuda.empty_cache()
    result["master"] = hold_sharded_master(dev, mesh, smi, patch=True)
    result["multihost"] = hold_multihost(train, csr, dev)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = make_mesh()
        check(cards.size == n_cards, f"make_mesh spans the {n_cards} cards")
        result["cards"] = {"epoch": hold_sharded_epoch(train, csr, dev, cards, smi, phase5,
                                                       n_inits),
                           "master": hold_sharded_master(dev, cards, smi, patch=False),
                           "processes": hold_multiprocess(train, csr, dev, cards)}
    else:
        log("  one card visible: the mesh over several cards is not run")
    result["launches"] = {"bpr_sweep_pairs": result["epoch"]["k3_launches_per_epoch"]
                          + result["master"]["k3_launches"]}
    return result


# ---------------------------------------------------------------- phase 13
#
# The approximate serving tier, the external sources, the bench and the
# CLI. bin_max's hold: where kernel and plain version pick the same item
# of a bin, the scores within the score tolerance; where they pick
# different items, both lie in that bin and the kernel's item's plain
# score is within 2 T of the plain maximum (a tie within the summation
# order). The final lists are then held, tie-aware, against the plain
# route (bin_max_plain and merge_topk_plain) with those tied bins resolved
# to the kernel's item.


def hold_bins(what: str, keys, keys_p, scores_p, tol, b: int, n_bins: int):
    """``bin_max`` keys ``[b_pad, L]`` against the plain version's on the
    first ``b`` queries. Returns (the plain keys with tied bins resolved to
    the kernel's item, largest |score difference|, tied bins)."""
    import torch

    from gorse_tpu_torch.ops import topk

    keys, keys_p = keys[:b], keys_p[:b]
    empty, empty_p = keys == topk._INT64_MIN, keys_p == topk._INT64_MIN
    check(torch.equal(empty, empty_p), f"{what}: the same bins are empty")
    live = ~empty
    s, i = topk._decode(keys)
    s_p, i_p = topk._decode(keys_p)
    i, i_p = torch.where(live, i, 0).long(), torch.where(live, i_p, 0).long()
    bins = torch.arange(n_bins, device=keys.device)[None, :]
    check(bool(((i % n_bins == bins) & (i < scores_p.shape[1]))[live].all()),
          f"{what}: every kernel key's item lies in its bin and in the catalog")
    t = torch.maximum(tol[:b].gather(1, i), tol[:b].gather(1, i_p))
    own_p = scores_p[:b].gather(1, i)
    check(bool(((s - own_p).abs() <= tol[:b].gather(1, i))[live].all()),
          f"{what}: each bin's kernel score within tolerance of its plain score")
    check(bool(((s - s_p).abs() <= t)[live].all()), f"{what}: bin maxima within tolerance")
    tied = live & (i != i_p)
    check(bool((own_p >= s_p - 2 * t)[tied].all()),
          f"{what}: where the picks differ, the kernel's item ties the plain maximum")
    resolved = torch.where(tied, topk._keys(own_p.contiguous(), i), keys_p)
    err = float((s - s_p).abs()[live].max()) if bool(live.any()) else 0.0
    return resolved, err, int(tied.sum())


# bin_max's edge shapes: (name, n_items, dim, b, n_bins, sq metric or None).
# Integer-valued inputs, so every partial sum is exact and the kernel is held
# equal to its plain version, tie order included. Together they reach every
# path of the kernel's plan: keys stored (one unit owns its bins) and merged
# (rows split), more units than SMs (the persistent grid's second round), a
# second 256-query slice and a slice on one consumer warpgroup, 128
# dimensions (two resident passes) and 192 (the queries streamed in the
# stages), L = n <= 128 odd, L below a unit's 64 bins.
BIN_EDGES = (
    ("d128 split", 5000, 100, 200, 1024, None),
    ("d128 split sq", 5000, 100, 200, 1024, "dot"),
    ("d128 split sq euclidean", 5000, 100, 200, 1024, "euclidean"),
    ("L = n = 101", 101, 16, 300, 101, None),
    ("L = n = 101 sq euclidean", 101, 16, 300, 101, "euclidean"),
    ("L = 37", 3000, 16, 40, 37, None),
    ("L = 128 over 100 items", 100, 16, 40, 128, None),
    ("unsplit, two rounds", 100_000, 16, 300, 9000, None),
    ("unsplit, two rounds sq", 100_000, 16, 300, 9000, "dot"),
    ("unsplit, two rounds sq euclidean", 100_000, 16, 200, 9000, "euclidean"),
    ("d192 streamed", 20_000, 150, 200, 1024, None),
    ("d192 streamed sq", 20_000, 150, 300, 1024, "euclidean"),
)


def hold_bin_edges(dev) -> list:
    """``bin_max`` / ``bin_max_sq`` equal to ``bin_max_plain`` on the card at
    ``BIN_EDGES``; fails unless the cases reach the plan's every path."""
    import torch

    from gorse_tpu_torch.ops import topk

    rng = np.random.default_rng(23)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, reached = [], set()
    for name, n, d, b, n_bins, metric in BIN_EDGES:
        items = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        q = torch.as_tensor(rng.integers(-2, 3, size=(b, d)).astype(np.float32), device=dev)
        b_pad = topk._round_up(b, topk.QUERY_TILE)
        if metric is None:
            table = topk.prepare_items(items, device=dev).table
            qp, aff = topk._pad_queries(q, topk.PreparedItems(table, n, d), b_pad), None
            keys = topk.bin_max(qp, table, n, n_bins)
        else:
            codes, scale, lo, norms2 = sq_table(items)
            prep = topk.prepare_sq_items(codes, scale, lo, norms2, device=dev)
            table = prep.table
            qp, aff = topk._sq_operands(q, prep, b_pad, metric)
            keys = topk.bin_max_sq(qp, table, aff, n, n_bins)
        want = topk.bin_max_plain(qp, table, n, n_bins, aff)
        torch.cuda.synchronize()
        check(torch.equal(keys, want), f"bin_max edge {name}: equal to bin_max_plain")
        plan = topk.bin_plan(n, n_bins, b_pad, n_sm)
        reached |= {"merged" if plan.merge else "stored",
                    "two rounds" if len(plan.units) > plan.grid else "one round",
                    "two slices" if len(plan.slices) > 1 else "one slice",
                    "resident" if table.shape[1] <= 128 else "streamed"}
        reached |= {"one warpgroup" for _, nq in plan.slices if nq <= 128}
        reached |= {f"d_pad {table.shape[1]}", "sq" if aff is not None else "bf16"}
        rows.append({"case": name, "units": len(plan.units), "grid": plan.grid,
                     "merge": plan.merge, "slices": len(plan.slices),
                     "empty_bins": int((keys[:b] == topk._INT64_MIN).sum())})
    log("  bin_max edges: " + json.dumps(rows))
    need = {"merged", "stored", "two rounds", "one round", "two slices", "one slice",
            "resident", "streamed", "one warpgroup", "d_pad 128", "sq", "bf16"}
    check(need <= reached, f"bin_max edges reach every path: missing {sorted(need - reached)}")
    return rows


def bin_library(qp, table, n: int, n_bins: int, aff=None):
    """``bin_max``'s yardstick, timed and never called by the port: one bf16
    ``torch.matmul`` of the chunk against the table (the codes as bf16 for
    SQ, then the affine epilogue in f32) into a score matrix padded to whole
    rows of ``n_bins`` (pad items score ``-inf``), and ``.max(dim=1)`` over
    its ``[b, rows, n_bins]`` view. Returns the call; the padded table is
    made here, outside it."""
    import torch

    rows = -(-n // n_bins)
    t_pad = torch.zeros((rows * n_bins, table.shape[1]), dtype=torch.bfloat16,
                        device=table.device)
    t_pad[:n] = table[:n].to(torch.bfloat16)
    mask = torch.zeros(rows * n_bins, device=table.device,
                       dtype=torch.bfloat16 if aff is None else torch.float32)
    mask[n:] = float("-inf")
    if aff is not None:
        scale, minv = torch.zeros_like(mask), torch.zeros_like(mask)
        scale[:n], minv[:n] = aff.affine[0, :n], aff.affine[1, :n]
        qsum = aff.qstats[0][:, None]

    def call():
        s = torch.matmul(qp, t_pad.T)
        if aff is not None:
            s = s.float() * scale + qsum * minv
        return (s + mask).view(qp.shape[0], rows, n_bins).max(dim=1)

    return call


def approx_recall(got, want) -> float:
    """Mean share of each exact list's ids that the approximate list holds."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    return float(np.mean([len(set(a) & set(e)) / len(e) for a, e in zip(g, w)]))


def hold_approx(name: str, queries, table, n: int, k: int, target: float, operands, exact_fn,
                approx_fn, scores_p, tol, time_it: bool) -> dict:
    """One (k, recall target) of the approximate tier on one query chunk:
    ``bin_max`` (``_sq``) held against its plain version, the final lists
    against the plain route, the entry point against the kernels' merge,
    mean recall@k against the exact chain at or above the target; with
    ``time_it`` the times, bound and extra memory."""
    import torch

    from gorse_tpu_torch.ops import topk

    b = queries.shape[0]
    n_bins = topk.approx_bins(topk._round_up(max(n, topk.REF_LANES), topk.REF_LANES), k, target)
    qp, aff = operands(queries, topk._round_up(b, topk.QUERY_TILE))

    def bins():
        if aff is None:
            return topk.bin_max(qp, table, n, n_bins)
        return topk.bin_max_sq(qp, table, aff, n, n_bins)

    keys = bins()
    keys_p = topk.bin_max_plain(qp, table, n, n_bins, aff)
    resolved, err, tied = hold_bins(f"{name} k={k} L={n_bins}", keys, keys_p, scores_p, tol, b,
                                    n_bins)
    count = torch.full((qp.shape[0],), n_bins, dtype=torch.int32, device=qp.device)
    s, i = topk.merge_topk(keys, count, b, k)
    s_m, i_m = topk.merge_topk_plain(keys, count, b, k)
    check(torch.equal(s, s_m) and torch.equal(i, i_m),
          f"{name} k={k}: merge_topk equals its plain version on the bins' keys")
    hold_lists(f"{name} k={k} target {target}: lists against the plain route", (s, i),
               topk.merge_topk_plain(resolved, count[:b], b, k), qp, table, aff)
    s_e, i_e = approx_fn(queries, k, target)
    check(torch.equal(s_e, s) and torch.equal(i_e, i),
          f"{name} k={k}: the entry point returns the kernels' lists")
    exact = exact_fn(queries, k)
    recall = approx_recall(i, exact[1])
    check(recall >= target, f"{name} k={k}: mean recall@k {recall:.4f} >= target {target}")
    row = {"k": k, "target": target, "bins": n_bins, "recall": recall, "tied_bins": tied,
           "max_abs_err": err}
    if time_it:
        b_pad = qp.shape[0]
        q_bytes = qp.numel() * 2 + (0 if aff is None else aff.qstats.numel() * 4)
        t_bytes = n * table.shape[1] * table.element_size()
        if aff is not None:
            t_bytes += n * (12 if aff.euclidean else 8)
        bms, by = bound(t_bytes + q_bytes + b_pad * n_bins * 8, 2.0 * b * n * (table.shape[1]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        approx_fn(queries, k, target)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        check(extra < b_pad * table.shape[0] * 4 // 4,
              f"{name} k={k}: no [B, N] score matrix ({extra} bytes above the inputs)")
        lib = bin_library(qp, table, n, n_bins, aff)
        plan = topk.bin_plan(n, n_bins, b_pad, torch.cuda.get_device_properties(
            qp.device).multi_processor_count)
        row.update(
            ms=median_ms(bins, 20), queued_ms=queued_ms(bins),
            plain_ms=median_ms(lambda: topk.bin_max_plain(qp, table, n, n_bins, aff), 3),
            bound_ms=bms, bound_by=by, library_ms=median_ms(lib, 10),
            library_queued_ms=queued_ms(lib, 10), extra_bytes=extra,
            plan={"units": len(plan.units), "grid": plan.grid, "merge": plan.merge},
            keys_bytes=b_pad * n_bins * 8,
            merge=merge_timing(keys, count, b, k),
            route_ms=median_ms(lambda: approx_fn(queries, k, target), 10),
            route_queued_ms=queued_ms(lambda: approx_fn(queries, k, target)),
            exact_ms=median_ms(lambda: exact_fn(queries, k), 10),
            exact_queued_ms=queued_ms(lambda: exact_fn(queries, k)),
        )
    log(f"  {name}: " + json.dumps(row))
    del keys, keys_p, resolved
    return row


def phase_approx_tier(user_factors, item_factors, histories, dev) -> dict:
    """13a: bin_max on phase 3's 1M x 64 bf16 table and bin_max_sq on its
    codes, 256 queries, every recall target at k = 10 and the worker's
    fetch (bf16) or k = 10 and a euclidean case (sq)."""
    import torch

    from gorse_tpu_torch.ops import topk

    out = {"bf16": [], "sq": [], "edges": hold_bin_edges(dev)}
    chunk = torch.as_tensor(user_factors[:APPROX_QUERIES], device=dev)
    fetch = min(100 + max(len(h) for h in histories[:APPROX_QUERIES]), N_ITEMS)
    prep = topk.prepare_items(torch.as_tensor(item_factors, device=dev), device=dev)
    qp = topk._pad_queries(chunk, prep, topk._round_up(APPROX_QUERIES, topk.QUERY_TILE))
    scores_p = topk._scores_plain(qp, prep.table)[:, :N_ITEMS]
    tol = score_tol(qp, prep.table)[:, :N_ITEMS]
    for k in (10, fetch):
        for target in APPROX_TARGETS:
            out["bf16"].append(hold_approx(
                "bin_max", chunk, prep.table, N_ITEMS, k, target,
                lambda q, b_pad: (topk._pad_queries(q, prep, b_pad), None),
                lambda q, k_: topk.dot_topk(q, prep, k_, device=dev),
                lambda q, k_, t: topk.dot_topk_approx(q, prep, k_, t, device=dev),
                scores_p, tol, time_it=target == APPROX_RECALL))
    out["fetch"] = fetch
    del scores_p, tol, prep, qp
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    codes, scale, lo, norms2 = sq_table(item_factors)
    log(f"  {N_ITEMS} x {DIM} items quantized in {time.perf_counter() - t0:.1f} s")
    sq = topk.prepare_sq_items(codes, scale, lo, norms2, device=dev)
    for metric, targets in (("dot", APPROX_TARGETS), ("euclidean", (APPROX_RECALL,))):
        qp, aff = topk._sq_operands(chunk, sq, topk._round_up(APPROX_QUERIES, topk.QUERY_TILE),
                                    metric)
        scores_p = topk._scores_plain(qp, sq.table, aff)[:, :N_ITEMS]
        tol = score_tol(qp, sq.table, aff)[:, :N_ITEMS]
        for target in targets:
            out["sq"].append(dict(metric=metric, **hold_approx(
                f"bin_max_sq {metric}", chunk, sq.table, N_ITEMS, 10, target,
                lambda q, b_pad, m=metric: topk._sq_operands(q, sq, b_pad, m),
                lambda q, k_, m=metric: topk.sq_topk(q, sq, k_top=k_, metric=m, device=dev),
                lambda q, k_, t, m=metric: topk.sq_topk_approx(q, sq, k_, t, metric=m,
                                                               device=dev),
                scores_p, tol, time_it=metric == "dot" and target == APPROX_RECALL)))
        del scores_p, tol, qp, aff
        torch.cuda.empty_cache()
    # the launches of sq_topk_approx, its entry point, from 0
    wrappers = zero_counts()
    topk.sq_topk_approx(chunk, sq, 10, APPROX_RECALL, device=dev)
    torch.cuda.synchronize()
    out["sq_launches"] = {w.__name__: w.launches for w in wrappers if w.launches}
    check(out["sq_launches"] == {"bin_max_sq": 1, "merge_topk": 1},
          f"sq_topk_approx launched bin_max_sq and merge_topk once: {out['sq_launches']}")
    del sq
    torch.cuda.empty_cache()
    return out


def phase_approx_worker(user_factors, item_factors, histories, dev, exact_users_s) -> dict:
    """13b: phase 3's shard through the worker at index_recall =
    APPROX_RECALL: bin_max and merge_topk launched once a chunk and no
    other kernel; users/s beside phase 3's; the lists' ids and their
    recall against the exact route's lists."""
    import torch

    from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.types import Feedback, User
    from gorse_tpu_torch.utils.config import Config

    item_names = [f"i{i}" for i in range(N_ITEMS)]
    user_names = [f"u{u}" for u in range(N_USERS)]
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
    cfg.recommend.collaborative.index_recall = APPROX_RECALL
    cfg.recommend.ranker.recommenders = ["collaborative"]
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        worker = Worker(cfg, data, cache, BlobStore(Path(tmp) / "blobs"))
        worker.cf_index = MatrixFactorizationIndex.from_numpy(
            user_factors, item_factors,
            {"names": user_names, "freqs": [1] * N_USERS},
            {"names": item_names, "freqs": [1] * N_ITEMS},
            [[f"c{i % N_CATEGORIES}"] for i in range(N_ITEMS)], timestamp=1.0, device=dev)
        worker.cf_model_id = "approx"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        # ---- the main path, with every launch count set to 0 just before
        wrappers = zero_counts()
        topk.dot_topk_xla.uses = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refreshed = worker.recommend(shard)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        # ----
        extra = torch.cuda.max_memory_allocated() - base
    chunks = -(-SHARD // MatrixFactorizationIndex._SEARCH_CHUNK)
    log("  approximate worker launches:", json.dumps(launches))
    check(refreshed == SHARD, f"recommend refreshed {refreshed} of {SHARD} users")
    check(launches == {"bin_max": chunks, "merge_topk": chunks},
          f"bin_max and merge_topk once per chunk ({chunks}) and nothing else")
    check(topk.dot_topk_xla.uses == 0, "the shard stayed off the f32 route")
    check(extra < APPROX_QUERIES * topk._round_up(N_ITEMS, topk.BLOCK_N) * 4 // 4,
          f"no [B, N] score matrix on the path ({extra} bytes above the index)")
    catalog, size = set(item_names), cfg.recommend.cache_size
    exclude = [[fb.item_id for fb in data.get_user_feedback(u)] for u in shard]
    exact = []
    for lo in range(0, SHARD, MatrixFactorizationIndex._SEARCH_CHUNK):
        exact += worker.cf_index.search_users(shard[lo:lo + 256], size, exclude[lo:lo + 256])
    recalls = []
    for u, ex, want in zip(shard, exclude, exact):
        got = [s.id for s in cache.search_scores(ck.COLLABORATIVE, u)]
        check(0 < len(got) <= size and set(got) <= catalog and not set(got) & set(ex),
              f"{u}: catalog ids only, none of the user's, at most cache_size")
        recalls.append(len(set(got) & {s.id for s in want}) / len(want))
    recall = float(np.mean(recalls))
    check(recall >= APPROX_RECALL, f"worker recall {recall:.4f} >= {APPROX_RECALL}")
    result = dict(users=SHARD, chunks=chunks, recommend_s=wall, users_per_s=SHARD / wall,
                  exact_users_per_s=exact_users_s, launches=launches, recall=recall,
                  extra_bytes=extra)
    log("  approximate worker: " + json.dumps(result))
    return result


def serve_ids(state: dict):
    """A stdlib HTTP server on 127.0.0.1: ``/recs`` answers an object of
    scored items, ``/ids`` a bare array of ids; returns (server, base URL)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            state["requests"] += 1
            body = json.dumps(EXTERNAL_IDS if self.path.startswith("/ids") else {
                "items": [{"id": i, "score": float(s)} for s, i in EXTERNAL_SCORED]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


EXTERNAL_IDS = ["i3", "i1", "i4", "i0", "i9"]
EXTERNAL_SCORED = ((1.0, "i2"), (9.0, "i7"), (4.0, "i5"), (7.0, "i1"))
EXTERNAL_JS = ("var r = fetch('{url}/recs?user_id=' + encodeURIComponent(user_id));"
               "var items = JSON.parse(r.body).items;"
               "items.sort((a, b) => b.score - a.score);"
               "JSON.stringify(items.map(it => it.id))")


def phase_external(dev) -> dict:
    """13c: a js source (with fetch) and an http source in a card worker's
    chain; its lists equal the sources' ids less the user's; the master's
    /api/dashboard/external preview on the card answers the same."""
    import base64

    from gorse_tpu_torch.serve.dashboard import MasterRestServer
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.meta import MetaStore
    from gorse_tpu_torch.storage.types import Feedback, Item, User
    from gorse_tpu_torch.utils.config import Config, ExternalConfigEntry

    state = {"requests": 0}
    server, url = serve_ids(state)
    try:
        with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
            data, cache = MemoryDataStore(), MemoryCacheStore()
            data.insert_items(Item(f"i{k}", timestamp=float(k)) for k in range(10))
            users = [f"u{u}" for u in range(EXTERNAL_USERS)]
            data.insert_users(User(u) for u in users)
            data.insert_feedback(Feedback("like", u, f"i{n % 10}", 1.0, 1.0)
                                 for n, u in enumerate(users))
            cfg = Config()
            cfg.recommend.cache_size = 10
            cfg.recommend.collaborative.type = "none"
            cfg.recommend.ranker.type = "none"
            cfg.recommend.external = [
                ExternalConfigEntry(name="js", script=EXTERNAL_JS.format(url=url)),
                ExternalConfigEntry(name="ids", type="http", url=f"{url}/ids"),
            ]
            cfg.recommend.ranker.recommenders = ["external/js", "external/ids"]
            worker = Worker(cfg, data, cache, BlobStore(Path(tmp) / "blobs"), device=dev)
            t0 = time.perf_counter()
            check(worker.recommend(users, force=True) == len(users), "every user refreshed")
            wall = time.perf_counter() - t0
            js_ids = [i for _, i in sorted(EXTERNAL_SCORED, key=lambda x: -x[0])]
            for n, u in enumerate(users):
                mine = {f"i{n % 10}"}
                want = [i for i in dict.fromkeys(js_ids + EXTERNAL_IDS) if i not in mine]
                got = [s.id for s in cache.search_scores(ck.RECOMMEND, u)]
                check(got == want[: cfg.recommend.cache_size],
                      f"{u}: the sources' ids less the user's ({got} vs {want})")
            master = Master(cfg, data, cache, BlobStore(Path(tmp) / "master"), MetaStore(),
                            device=dev)
            rest = MasterRestServer(master)
            answers = {}
            for label, spec, user in (("js", EXTERNAL_JS.format(url=url), "u1"),
                                      ("url", f"{url}/ids", "u2"), ("none", "", "u1")):
                query = {"user-id": user}
                if spec:
                    query["script"] = base64.b64encode(spec.encode()).decode()
                answers[label] = rest.dispatch("GET", "/api/dashboard/external", query, None, {})
            check(answers["js"] == (200, js_ids), f"preview of the js source: {answers['js']}")
            check(answers["url"] == (200, EXTERNAL_IDS), f"preview of a URL: {answers['url']}")
            check(answers["none"][0] == 400, "preview without a script: 400")
    finally:
        server.shutdown()
    result = {"users": len(users), "recommend_s": wall, "requests": state["requests"]}
    log("  external: " + json.dumps(result))
    return result


def run_main(main_fn, argv: list[str]) -> str:
    """Run a command's ``main(argv)`` and return what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(main_fn(argv) == 0, f"{' '.join(argv)}: exit code 0")
    return buf.getvalue()


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def phase_bench_cli(dev, smi: str) -> dict:
    """13d: the bench's cf (bpr, then als) and ctr on the card against the
    same command on the CPU, retrieval at 1M through the kernels beside the
    library route, embedding against the mock server; the CLI against an
    in-one node on the card."""
    import torch

    from gorse_tpu_torch.cmd import bench, cli
    from gorse_tpu_torch.ops import topk

    out = {}
    for model in ("bpr", "als"):
        wrappers = zero_counts()
        t0 = time.perf_counter()
        card = last_json(run_main(bench.main, ["cf", "--model", model]))
        card_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        cpu = last_json(run_main(bench.main, ["cf", "--model", model, "--device", "cpu"]))
        check(card["device"].startswith("cuda") and cpu["device"] == "cpu", "bench cf devices")
        if model == "bpr":
            check(launches.get("bpr_epoch", 0) >= 1, f"bench cf bpr launched bpr_epoch: {launches}")
        check(abs(card["NDCG@10"] - cpu["NDCG@10"]) <= BENCH_NDCG_TOL,
              f"bench cf {model}: NDCG@10 {card['NDCG@10']} within {BENCH_NDCG_TOL} of the "
              f"CPU's {cpu['NDCG@10']}")
        out[f"cf_{model}"] = dict(card=card, cpu=cpu, seconds=card_s, launches=launches)
    card = last_json(run_main(bench.main, ["ctr"]))
    cpu = last_json(run_main(bench.main, ["ctr", "--device", "cpu"]))
    check(abs(card["AUC"] - cpu["AUC"]) <= BENCH_AUC_TOL,
          f"bench ctr: AUC {card['AUC']} within {BENCH_AUC_TOL} of the CPU's {cpu['AUC']}")
    out["ctr"] = dict(card=card, cpu=cpu)
    retrieval = ["retrieval", "--items", str(N_ITEMS), "--dim", str(DIM), "--batch", "256",
                 "--k", "10", "--batches", str(BENCH_BATCHES)]
    for kernel in ("pallas", "xla"):
        wrappers = zero_counts()
        topk.dot_topk_xla.uses = 0
        row = last_json(run_main(bench.main, retrieval + ["--kernel", kernel]))
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        if kernel == "pallas":
            want = {name: 2 * BENCH_BATCHES for name in KERNELS}  # warm-up chain + timed chain
            check(launches == want, f"bench retrieval --kernel pallas launched K4-K6: {launches}")
        else:
            check(not launches and topk.dot_topk_xla.uses == 2 * BENCH_BATCHES,
                  "bench retrieval --kernel xla took the library route only")
        check(row["timer"] == "cuda_events" and row["device"] == torch.cuda.get_device_name(0),
              "bench retrieval timed on the card")
        out[f"retrieval_{kernel}"] = dict(row, launches=launches)
    emb = last_json(run_main(bench.main, ["embedding"]))
    check(emb["device"].startswith("cuda") and 0.0 <= emb["recall_vs_coconsumption"] <= 1.0,
          "bench embedding on the card")
    out["embedding"] = emb
    reranker = last_json(run_main(bench.main, ["reranker"]))
    check(reranker["users"] > 0 and 0.0 <= reranker["AUC"] <= 1.0,
          "bench reranker ranks through the mock's chat completions")
    out["reranker"] = reranker
    out["cli"] = cli_on_in_one(cli)
    log("  bench and CLI: " + json.dumps(out) + " | " + smi)
    return out


def cli_on_in_one(cli) -> dict:
    """The CLI's health, get and pipeline show against an in-one node on the
    card (a few users, one cycle)."""
    from gorse_tpu_torch.serve.in_one import InOneNode
    from gorse_tpu_torch.storage.types import Feedback, Item
    from gorse_tpu_torch.utils.config import Config

    config = Config()
    config.recommend.collaborative.type = "mf"
    config.recommend.ranker.type = "none"
    with tempfile.TemporaryDirectory(prefix="gorse_smoke_") as tmp:
        node = InOneNode(config, workdir=tmp)
        check(node.device.type == "cuda", "the in-one node is on the card")
        rng = np.random.default_rng(0)
        node.data.insert_items([Item(f"i{k}", timestamp=float(k), categories=["c"])
                                for k in range(12)])
        pairs = [(u, i) for u in range(6) for i in range(12)]
        rng.shuffle(pairs)
        node.data.insert_feedback([Feedback("like", f"u{u}", f"i{i}", timestamp=float(t))
                                   for t, (u, i) in enumerate(pairs[:40])])
        t0 = time.perf_counter()
        node.run_once()
        cycle_s = time.perf_counter() - t0
        httpd = node.serve("127.0.0.1", 0, background_loop=False)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            health = json.loads(run_main(cli.main, ["--url", base, "health"]))
            user = json.loads(run_main(cli.main, ["--url", base, "get", "user", "u1"]))
            pipeline = json.loads(run_main(cli.main, ["--url", base, "pipeline", "show"]))
            recs = json.loads(run_main(cli.main, ["--url", base, "recommend", "u1", "-n", "3"]))
        finally:
            node.shutdown()
    check(health.get("Ready", health.get("status")) in (True, "ready"), f"cli health: {health}")
    check(user.get("UserId") == "u1", f"cli get user: {user}")
    check("recommend" in pipeline, "cli pipeline show")
    check(len(recs) == 3, f"cli recommend: {recs}")
    return {"cycle_s": cycle_s, "health": health, "recommend": recs}


def phase_approx(dev, smi: str, seed: int, earlier: dict) -> dict:
    """Phase 13: the approximate tier (a, b), external sources (c), the
    bench and the CLI (d)."""
    import torch

    t0 = time.perf_counter()
    user_factors, item_factors, histories = make_data(seed)
    out = {"tier": phase_approx_tier(user_factors, item_factors, histories, dev)}
    torch.cuda.empty_cache()
    out["worker"] = phase_approx_worker(user_factors, item_factors, histories, dev,
                                        (earlier.get("path") or {}).get("users_per_s"))
    del user_factors, item_factors, histories
    torch.cuda.empty_cache()
    out["external"] = phase_external(dev)
    out["bench"] = phase_bench_cli(dev, smi)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = smi
    log(f"  phase 13 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 14


def rows_of(store) -> list:
    """Every user, item and feedback row of a data store, as dicts, each
    table in key order."""
    import dataclasses

    return [sorted((dataclasses.asdict(u) for u in store.get_users()),
                   key=lambda r: r["user_id"]),
            sorted((dataclasses.asdict(i) for i in store.get_items()),
                   key=lambda r: r["item_id"]),
            sorted((dataclasses.asdict(f) for f in store.get_feedback()),
                   key=lambda r: (r["feedback_type"], r["user_id"], r["item_id"]))]


def first_users(rows: list, n_users: int) -> list:
    """The first ``n_users`` users of ``rows`` (``rows_of``'s form), their
    feedback and the items it names, in the same form."""
    users = rows[0][:n_users]
    keep = {u["user_id"] for u in users}
    feedback = [f for f in rows[2] if f["user_id"] in keep]
    named = {f["item_id"] for f in feedback}
    return [users, [i for i in rows[1] if i["item_id"] in named], feedback]


def insert_rows(store, rows: list) -> None:
    """``rows`` (``rows_of``'s form) into ``store``: users, items, feedback."""
    from gorse_tpu_torch.storage.types import Feedback, Item, User

    store.insert_users([User(**u) for u in rows[0]])
    store.insert_items([Item(**i) for i in rows[1]])
    store.insert_feedback([Feedback(**f) for f in rows[2]])


class WriteClock:
    """Counts one cache store's writes (its ``CACHE_WRITES`` methods) and
    their seconds on the host clock, each call timed where it is made."""

    def __init__(self, store) -> None:
        self.writes, self.seconds = 0, 0.0
        for name in CACHE_WRITES:
            setattr(store, name, self._timed(getattr(store, name)))

    def _timed(self, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.writes += 1
        return call


def hold_hnsw(what: str, store, name: str, ids: list, rows, queries, dev) -> dict:
    """recall@HNSW_K of the ``hnsw://`` store's lists for ``queries``
    against the exact route of a ``memory://`` store holding the same rows
    on the card (f32), and against the kernels' route (``dot_topk``: K4-K6,
    their launches counted from 0); both at least ``HNSW_RECALL``. The q/s
    of each store, the second call of the exact one (warm)."""
    import torch

    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.storage.vectors import MemoryVectorStore

    exact = MemoryVectorStore(dev)
    exact.create_collection(name, rows.shape[1], "dot")
    exact.add(name, ids, rows)
    t0 = time.perf_counter()
    got = store.query(name, queries, HNSW_K)
    hnsw_s = time.perf_counter() - t0
    exact.query(name, queries[:1], HNSW_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = exact.query(name, queries, HNSW_K)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    prep = topk.prepare_items(rows, device=dev)
    zero_counts()
    _, idx = topk.dot_topk(queries, prep, HNSW_K, device=dev)
    launches = {n: getattr(topk, n).launches for n in KERNELS}
    check(all(launches[n] > 0 for n in KERNELS), f"{what}: dot_topk launches {launches}")
    kernel = [[ids[int(j)] for j in row] for row in idx.cpu().tolist()]

    def recall(lists) -> float:
        return float(np.mean([len({s.id for s in g} & set(w)) / HNSW_K
                              for g, w in zip(got, lists)]))

    out = {"rows": len(ids), "dim": int(rows.shape[1]), "queries": len(queries),
           "recall_exact": recall([[s.id for s in w] for w in want]),
           "recall_kernels": recall(kernel), "hnsw_q_per_s": len(queries) / hnsw_s,
           "exact_q_per_s": len(queries) / exact_s, "kernel_launches": launches}
    check(out["recall_exact"] >= HNSW_RECALL and out["recall_kernels"] >= HNSW_RECALL,
          f"{what}: hnsw:// recall@{HNSW_K} {out['recall_exact']:.4f} against the exact "
          f"store, {out['recall_kernels']:.4f} against the kernels, each >= {HNSW_RECALL}")
    return out


def hnsw_synthetic(seed: int, dev) -> dict:
    """``hnsw://`` on a synthetic f32 table: rows of rank 16 plus noise,
    added HNSW_CHUNK at a time up to HNSW_SYNTH rows while the build stays
    within HNSW_BUILD_S (the next chunk is not added when the last one's
    time would take it over); held-out queries from the same law."""
    from gorse_tpu_torch.storage.vectors import open_vector_store

    n_max, dim = HNSW_SYNTH
    rng = np.random.default_rng(seed + 14)
    basis = rng.standard_normal((16, dim), dtype=np.float32) / 4

    def draw(m: int) -> np.ndarray:
        return (rng.standard_normal((m, 16), dtype=np.float32) @ basis
                + 0.3 * rng.standard_normal((m, dim), dtype=np.float32)).astype(np.float32)

    store = open_vector_store("hnsw://", device=dev)
    store.create_collection("synthetic", dim, "dot")
    chunks, build_s, last_s = [], 0.0, 0.0
    while len(chunks) * HNSW_CHUNK < n_max and build_s + last_s <= HNSW_BUILD_S:
        rows = draw(HNSW_CHUNK)
        lo = len(chunks) * HNSW_CHUNK
        t0 = time.perf_counter()
        store.add("synthetic", [f"s{lo + j}" for j in range(HNSW_CHUNK)], rows)
        last_s = time.perf_counter() - t0
        build_s += last_s
        chunks.append(rows)
    table = np.concatenate(chunks)
    out = hold_hnsw("synthetic table", store, "synthetic",
                    [f"s{j}" for j in range(len(table))], table, draw(HNSW_QUERIES), dev)
    out.update(build_s=build_s, cut=len(table) < n_max)
    return out


@functools.lru_cache(maxsize=1)
def afm_rows():
    """Phase 9's CTR rows, ``synthetic_ctr`` at ``AFM_SHAPE``, made once a
    run (phases 9 and 14 read them)."""
    from gorse_tpu_torch.data.ctr import synthetic_ctr

    return synthetic_ctr(**AFM_SHAPE)


def hold_libfm(tmp: Path) -> dict:
    """Phase 9's CTR rows (``synthetic_ctr`` at ``AFM_SHAPE``) written as a
    libFM file, parsed by ``load_libfm_file`` natively and with the Python
    parser (the native library set aside): both datasets equal the rows."""
    import gorse_tpu_torch.native as native
    from gorse_tpu_torch.data.ctr import load_libfm_file

    data = afm_rows()
    path = tmp / "ctr.libfm"
    path.write_text("".join(
        f"{int(t)} " + " ".join(f"{k}:{v!r}" for k, v in zip(idx, val)) + "\n"
        for (idx, val), t in zip(data.features, data.targets)))
    t0 = time.perf_counter()
    parsed = load_libfm_file(str(path))
    native_s = time.perf_counter() - t0
    lib, native._lib = native._lib, None
    try:
        t0 = time.perf_counter()
        python = load_libfm_file(str(path))
        python_s = time.perf_counter() - t0
    finally:
        native._lib = lib
    for name, got in (("native", parsed), ("Python", python)):
        check(len(got) == len(data) and got.targets == data.targets
              and [(list(i), [float(x) for x in v]) for i, v in got.features]
              == [(list(i), list(v)) for i, v in data.features],
              f"libFM: the {name} parse equals phase 9's rows")
    check(len(parsed.index) == len(python.index), "libFM: both parses size the index alike")
    return {"rows": len(data), "bytes": path.stat().st_size, "native_s": native_s,
            "python_s": python_s}


def phase_remote(dev, smi: str, seed: int, earlier: dict) -> dict:
    """Phase 14: the in-one node over ``mysql://``, ``redis://``,
    ``s3://`` and ``hnsw://`` on the card."""
    from gorse_tpu_torch.native import load_native
    from gorse_tpu_torch.native.hnsw import native_available
    from gorse_tpu_torch.storage.miniobj import MiniS3
    from gorse_tpu_torch.storage.minisql import MiniClickHouse, MiniMySQL, MiniPostgres
    from gorse_tpu_torch.storage.resp import MiniRedis

    t_phase = time.perf_counter()
    check(load_native() is not None, "native/fastdata.cpp built by g++ and loaded")
    check(native_available(), "native/hnsw.cpp built by g++ and loaded")
    servers = {"mysql": MiniMySQL().start(), "postgres": MiniPostgres().start(),
               "clickhouse": MiniClickHouse().start(), "s3": MiniS3().start()}
    redis = MiniRedis()
    try:
        with tempfile.TemporaryDirectory(prefix="gorse_remote_") as tmp_name:
            result = remote_node(dev, smi, seed, Path(tmp_name), servers, redis, earlier)
            t0 = time.perf_counter()
            result["hnsw_synthetic"] = hnsw_synthetic(seed, dev)
            result["steps_s"]["hnsw_synthetic"] = time.perf_counter() - t0
            syn = result["hnsw_synthetic"]
            log(f"  hnsw:// on a synthetic {syn['rows']:,} x {syn['dim']} f32 table"
                + (f" (cut from {HNSW_SYNTH[0]:,}: the build reached {HNSW_BUILD_S} s)"
                   if syn["cut"] else "")
                + f": build {syn['build_s']:.1f} s, {syn['hnsw_q_per_s']:.0f} q/s against "
                f"the card's exact store's {syn['exact_q_per_s']:.0f}, recall@{HNSW_K} "
                f"{syn['recall_exact']:.4f} (exact) / {syn['recall_kernels']:.4f} (kernels)")
            t0 = time.perf_counter()
            result["libfm"] = hold_libfm(Path(tmp_name))
            result["steps_s"]["libfm"] = time.perf_counter() - t0
            lf = result["libfm"]
            log(f"  libFM: {lf['rows']:,} rows ({lf['bytes']:,} bytes) through load_libfm_file: "
                f"native {lf['native_s']:.2f} s, Python {lf['python_s']:.2f} s, equal")
    finally:
        for server in servers.values():
            server.stop()
        redis.close()
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 in {result['seconds']:.1f} s ({smi}); steps (s): "
        f"{json.dumps({k: round(v, 1) for k, v in result['steps_s'].items()})}")
    check(result["seconds"] <= REMOTE_PHASE_S,
          f"phase 14 took {result['seconds']:.1f} s of its {REMOTE_PHASE_S} s")
    return result


def remote_node(dev, smi: str, seed: int, tmp: Path, servers: dict, redis, earlier: dict) -> dict:
    """Phase 10's rows into ``mysql://`` (a smaller copy into
    ``postgres://`` and ``clickhouse://``), each read back; the node from a
    copy of config.toml.example over ``mysql://``, ``redis://``, ``s3://``
    and ``hnsw://``; one ``run_once`` with every count at 0 before; the
    blobs from S3, the worker's lists, REST, ``hnsw://`` on the item
    table."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel, topk
    from gorse_tpu_torch.serve.in_one import InOneNode
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.data import open_data_store
    from gorse_tpu_torch.storage.meta import COLLABORATIVE_FILTERING_MODEL
    from gorse_tpu_torch.storage.object import ObjectBlobStore, open_blob_store
    from gorse_tpu_torch.storage.vectors import HNSWVectorStore
    from gorse_tpu_torch.utils.config import load_config

    result = {"card": smi, "users": REMOTE_USERS}
    steps = result["steps_s"] = {}
    t_step = time.perf_counter()

    def step(name: str) -> None:
        nonlocal t_step
        steps[name] = time.perf_counter() - t_step
        t_step = time.perf_counter()

    # ---- the rows through mysql://, read back; the smaller copies
    want = phase10_rows(seed, REMOTE_USERS)
    mysql_url = servers["mysql"].url()
    store = open_data_store(mysql_url)
    t0 = time.perf_counter()
    insert_rows(store, want)
    ingest_s = time.perf_counter() - t0
    store.close()
    n_rows = sum(len(t) for t in want)
    fresh = open_data_store(mysql_url)
    check(rows_of(fresh) == want, f"mysql://: every one of the {n_rows:,} rows reads back")
    fresh.close()
    copies = {}
    for scheme in ("postgres", "clickhouse"):
        store = open_data_store(servers[scheme].url())
        wrote = first_users(want, REMOTE_COPY_USERS)
        t0 = time.perf_counter()
        insert_rows(store, wrote)
        copy_s = time.perf_counter() - t0
        store.close()
        fresh = open_data_store(servers[scheme].url())
        check(rows_of(fresh) == wrote, f"{scheme}://: every row of the copy reads back")
        fresh.close()
        copies[scheme] = {"rows": sum(len(t) for t in wrote), "s": copy_s}
    step("rows")
    result.update(rows=n_rows, users_items_feedback=[len(t) for t in want], ingest_s=ingest_s,
                  ingest_rows_per_s=n_rows / ingest_s, copies=copies)
    log(f"  {len(want[2]):,} feedback rows, {len(want[0])} users, {len(want[1])} items into "
        f"mysql:// in {ingest_s:.1f} s ({n_rows / ingest_s:,.0f} rows/s), every row read back; "
        + "; ".join(f"{k}:// a copy of {v['rows']:,} rows in {v['s']:.1f} s, read back"
                    for k, v in copies.items()))

    # ---- the node from config.toml.example over the remote stores
    blob_url = servers["s3"].url(prefix="models")
    config_path, changes = in_one_config(tmp, {
        ("database", "data_store"): mysql_url, ("database", "cache_store"): redis.url,
        ("database", "vector_store"): "hnsw://",
        ("blob", "uri"): f"{blob_url}&spool={tmp / 'blob_spool'}"})
    cfg = load_config(config_path)
    hold_config(cfg, changes)
    node = InOneNode(cfg, workdir=str(tmp), device=dev)
    check(type(node.data).__name__ == "GenericSQLDataStore"
          and type(node.cache).__name__ == "RedisCacheStore"
          and isinstance(node.blob, ObjectBlobStore) and isinstance(node.vectors, HNSWVectorStore),
          "the node opened mysql://, redis://, s3:// and hnsw://")
    clock = WriteClock(node.cache)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = node.run_once()
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    launches = {n: getattr(topk, n).launches for n in KERNELS}
    launches["bpr_epoch"] = bpr_kernel.bpr_epoch.launches
    writes = {"writes": clock.writes, "seconds": clock.seconds}
    check(all(c > 0 for c in launches.values()),
          f"the cycle over the remote stores launches {launches}, each must be above 0")
    check(summary["users_refreshed"] == REMOTE_USERS,
          f"the worker refreshed {summary['users_refreshed']} of {REMOTE_USERS} users")
    step("node")
    master, worker = node.master, node.worker
    t0 = time.perf_counter()
    while master._sizeof_busy and time.perf_counter() - t0 < 60:
        time.sleep(0.1)
    result.update(cycle_s=cycle_s, launches=launches, cache_writes=writes)
    phase10 = earlier.get("in_one") or {}
    log(f"  run_once {cycle_s:.1f} s ({smi}); launches {json.dumps(launches)}; redis:// "
        f"{writes['writes']:,} cache writes in {writes['seconds']:.2f} s"
        + (f"; phase 10 over SQLite: {phase10['users']} users, ingest "
           f"{sum((phase10['users'], phase10['items'], phase10['feedback'])) / phase10['insert_s']:,.0f}"
           f" rows/s, run_once {phase10['cycle_s']:.1f} s, "
           f"{phase10['commits']['cache']['commits']:,} cache commits in "
           f"{phase10['commits']['cache']['seconds']:.2f} s" if phase10 else ""))

    # ---- the blobs the master saved, read back from S3 by a fresh store
    cf_id = node.meta.get(COLLABORATIVE_FILTERING_MODEL)
    names = sorted(node.blob.list())
    check(cf_id in names, f"s3:// lists the CF model {cf_id} among {names}")
    reader = open_blob_store(f"{blob_url}&spool={tmp / 'spool'}")
    blob_bytes = 0
    try:
        for name in names:
            saved, read = node.blob.path(name), reader.open(name)
            files = sorted(p.relative_to(saved) for p in saved.rglob("*") if p.is_file())
            check(bool(files) and files == sorted(p.relative_to(read) for p in read.rglob("*")
                                                  if p.is_file())
                  and all((saved / f).read_bytes() == (read / f).read_bytes() for f in files),
                  f"s3://: blob {name} reads back byte for byte")
            blob_bytes += sum((saved / f).stat().st_size for f in files)
    finally:
        reader.close()
    result["blob_bytes"] = blob_bytes

    step("blobs")
    # ---- the worker's lists in redis:// against search_users on the card
    index = worker.cf_index
    check(index is not None and index.device == dev, "the worker's index is on the card")
    users = [f"u{u}" for u in sorted(np.random.default_rng(3).choice(
        REMOTE_USERS, min(MASTER_SAMPLE_USERS, REMOTE_USERS), replace=False))]
    for uid in users:
        seen = [fb.item_id for fb in node.data.get_user_feedback(uid)]
        want_list = index.search_users([uid], cfg.recommend.cache_size, exclude=[seen])[0]
        got = node.cache.search_scores(ck.COLLABORATIVE, uid)
        check(sorted((-s.score, s.id) for s in got) == sorted((-s.score, s.id)
                                                              for s in want_list),
              f"{uid}: redis://'s collaborative list equals search_users on the card")
    sample = {uid: node.cache.search_scores(ck.RECOMMEND, uid) for uid in users}
    httpd = node.serve("127.0.0.1", 0, background_loop=False)
    port = httpd.server_address[1]
    try:
        for uid in users:
            status, body = get_json(port, f"/api/recommend/{uid}")
            check(status == 200 and bool(body)
                  and body == [x.id for x in sample[uid]][: cfg.server.default_n],
                  f"GET /api/recommend/{uid} equals the redis:// cache")
        result["rest_p50_ms"], result["rest_p99_ms"] = rest_latency(
            port, lambda r: f"/api/recommend/u{r % REMOTE_USERS}")
    finally:
        node.shutdown()
        node.data.close()
        node.blob.close()
    log(f"  {len(names)} blobs ({blob_bytes:,} bytes) read back from s3:// byte for byte; "
        f"{len(users)} users' collaborative lists in redis:// equal search_users on the card; "
        f"REST from redis:// p50 {result['rest_p50_ms']:.3f} ms, p99 "
        f"{result['rest_p99_ms']:.3f} ms")

    step("lists_rest")
    # ---- hnsw:// on the fitted item table, synced by the master
    ids, rows = index.serving_items()
    name = Master.CF_COLLECTION
    check(node.vectors.describe_collection(name)["dimension"] == rows.shape[1]
          and set(node.vectors._collections[name].rows) == set(ids),
          "hnsw:// holds the master's serving items")
    trained = np.flatnonzero(index.user_predictable)
    queries = index.user_factors[torch.as_tensor(trained[:HNSW_QUERIES],
                                                 device=dev)].cpu().numpy()
    result["hnsw_fitted"] = fitted = hold_hnsw("fitted item table", node.vectors, name, ids,
                                               np.asarray(rows, np.float32), queries, dev)
    log(f"  hnsw:// on the fitted {fitted['rows']:,} x {fitted['dim']} item table, "
        f"{fitted['queries']} users' queries: {fitted['hnsw_q_per_s']:.0f} q/s against the "
        f"card's exact store's {fitted['exact_q_per_s']:.0f}, recall@{HNSW_K} "
        f"{fitted['recall_exact']:.4f} (exact) / {fitted['recall_kernels']:.4f} (kernels)")
    step("hnsw_fitted")
    node.cache.close()
    del node, master, worker, index
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 15


def pb_fields(data: bytes) -> list:
    """[(field, wire type, value), ...] of one protobuf message."""
    out, i = [], 0

    def varint():
        nonlocal i
        value = shift = 0
        while True:
            b = data[i]
            i += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return value

    while i < len(data):
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            out.append((field, wire, varint()))
        elif wire == 1:
            out.append((field, wire, data[i:i + 8]))
            i += 8
        elif wire == 5:
            out.append((field, wire, data[i:i + 4]))
            i += 4
        else:
            n = varint()
            out.append((field, wire, data[i:i + n]))
            i += n
    return out


class OTLPCollector:
    """An OTLP/gRPC TraceService in this process, on the port's grpcwire
    server: each exported span as (name, trace id, parent span id), in the
    order they arrived."""

    def __init__(self) -> None:
        import threading

        from gorse_tpu_torch.protocol import grpcwire

        self.spans: list[tuple[str, str, str]] = []
        self.requests = 0
        self._lock = threading.Lock()

        def export(request: bytes, context) -> bytes:
            spans = []
            for f1, _, rs in pb_fields(request):  # ExportTraceServiceRequest.resource_spans
                for f2, _, ss in pb_fields(rs):  # ResourceSpans.scope_spans
                    if f1 != 1 or f2 != 2:
                        continue
                    for f3, _, span in pb_fields(ss):  # ScopeSpans.spans
                        if f3 == 2:
                            fields = {f: v for f, _, v in pb_fields(span)}
                            spans.append((fields[5].decode(), fields[1].hex(),
                                          fields.get(4, b"").hex()))
            with self._lock:
                self.requests += 1
                self.spans += spans
            return b""

        handler = grpcwire.method_handlers_generic_handler(
            "opentelemetry.proto.collector.trace.v1.TraceService",
            {"Export": grpcwire.unary_unary_rpc_method_handler(export)})
        self.server = grpcwire.Server(max_workers=2)
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def traces(self) -> dict:
        """trace id -> [(name, parent span id), ...]."""
        with self._lock:
            out: dict = {}
            for name, trace, parent in self.spans:
                out.setdefault(trace, []).append((name, parent))
            return out


def grpc_config(tmp: Path, http_port: int, grpc_port: int, collector_port: int) -> Path:
    """Phase 11's config with the data in data.sqlite and the cache in the
    master's memory, the master's gRPC plane on ``grpc_port`` over mutual
    TLS (tests/data/tls), and tracing exported over OTLP/gRPC."""
    text = cluster_config(tmp, http_port).read_text()
    text = text.replace(f'cache_store = "sqlite://{tmp}/cache.sqlite"', 'cache_store = "memory://"')
    text = re.sub(r"(?m)^port = \d+$", f"port = {grpc_port}", text)
    text = text.replace("[recommend.data_source]", f"""ssl_mode = true
ssl_ca = "{TLS_DIR / 'ca.pem'}"
ssl_cert = "{TLS_DIR / 'server.pem'}"
ssl_key = "{TLS_DIR / 'server.key'}"

[tracing]
enable_tracing = true
exporter = "otlp"
collector_endpoint = "127.0.0.1:{collector_port}"

[recommend.data_source]""")
    path = tmp / "config.toml"
    path.write_text(text)
    return path


def traced_get(port: int, path: str, traceparent: str) -> tuple[int, object]:
    """``GET path`` on 127.0.0.1:``port`` with a ``traceparent`` header."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers={"traceparent": traceparent})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def percentiles(lat: list) -> tuple[float, float]:
    lat = sorted(lat)
    return lat[len(lat) // 2], lat[max(int(len(lat) * 0.99) - 1, 0)]


def phase_grpc(dev, smi: str, seed: int) -> dict:
    """Phase 15: the master's gRPC plane on the card. Phase 11's rows for
    the first ``GRPC_USERS`` users in data.sqlite less ``GRPC_HELD``, the
    cache in the master's memory; the master, server and worker as
    processes, the nodes on the ``proxy://`` URLs the master hands out,
    over mutual TLS; spans to a collector here; the holds of the module
    docstring, each process ended by SIGTERM."""
    import signal

    import torch

    from gorse_tpu_torch.storage.data import SQLiteDataStore
    from gorse_tpu_torch.utils.tls import TLSConfig

    t_phase = time.perf_counter()
    result = {"card": smi}
    client_tls = TLSConfig(str(TLS_DIR / "ca.pem"), str(TLS_DIR / "client.pem"),
                           str(TLS_DIR / "client.key"))
    tls_flags = ["--ssl-mode", "--ssl-ca", client_tls.ssl_ca, "--ssl-cert", client_tls.ssl_cert,
                 "--ssl-key", client_tls.ssl_key]
    collector = OTLPCollector()
    with tempfile.TemporaryDirectory(prefix="gorse_grpc_") as tmp_name:
        tmp = Path(tmp_name)
        rows = cluster_rows(seed, GRPC_USERS, GRPC_HELD, tmp / "data.sqlite")
        result.update(users=len(rows.users), items=rows.n_items, rows=rows.n_rows,
                      held_rows=len(rows.held_rows))
        ports = {role: free_port() for role in ("master", "grpc", "server", "worker")}
        config_path = grpc_config(tmp, ports["master"], ports["grpc"], collector.port)
        procs: dict[str, subprocess.Popen] = {}
        logs: dict[str, Path] = {}

        def spawn(role: str, *args) -> None:
            t0 = time.perf_counter()
            logs[role] = tmp / f"{role}.log"
            with open(logs[role], "wb") as out:
                procs[role] = subprocess.Popen(SPAWN + [role, *args], cwd=ROOT, stdout=out,
                                               stderr=subprocess.STDOUT, start_new_session=True)
            live = poll(f"the {role} answers /api/health/live", lambda: http_json(
                ports[role], "GET", "/api/health/live", timeout=5)[0] == 200
                and time.perf_counter(), t0 + CLUSTER_START_S)
            result.setdefault("live_s", {})[role] = live - t0

        master_url = f"http://127.0.0.1:{ports['master']}"
        trailing = "00-" + "f" * 32 + "-" + "e" * 16 + "-01"
        try:
            spawn("master", "--config", str(config_path))
            spawn("server", "--master", master_url, "--api-key", CLUSTER_ADMIN_KEY, "--port",
                  str(ports["server"]), *tls_flags)
            run = SimpleNamespace(tmp=tmp, ports=ports, rows=rows, tls=client_tls,
                                  spawn=lambda: spawn(
                                      "worker", "--master", master_url, "--api-key",
                                      CLUSTER_ADMIN_KEY, "--meta-timeout", "1", "--http-port",
                                      str(ports["worker"]), *tls_flags))
            result.update(_grpc_run(run))
            # one request to the master in a trace of its own: a span that
            # only the flush at SIGTERM is sure to export
            check(traced_get(ports["master"], "/api/health/live", trailing)[0] == 200,
                  "GET /api/health/live on the master")
            stop = {}
            for role in ("worker", "server", "master"):
                t0 = time.perf_counter()
                os.killpg(procs[role].pid, signal.SIGTERM)
                try:
                    procs[role].wait(timeout=CLUSTER_STOP_S)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"check failed: SIGTERM ended the {role} within "
                                       f"{CLUSTER_STOP_S} s")
                stop[role] = time.perf_counter() - t0
                check(procs[role].returncode == 0,
                      f"the {role} exited 0 on SIGTERM, not {procs[role].returncode}")
            result["stop_s"] = stop
        except Exception:
            for role, path in logs.items():
                log(f"  the {role}'s log, its tail:\n" + path.read_text()[-4000:])
            raise
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            collector.server.stop(None)
        text = {role: path.read_text() for role, path in logs.items()}
        # ---- the nodes received proxy:// for both stores and ran on the card
        proxy = f"proxy://127.0.0.1:{ports['grpc']}"
        for role in ("server", "worker"):
            check(f"{role} config synced from master: data {proxy}, cache {proxy}" in text[role],
                  f"the {role} synced data and cache as {proxy}")
        check(f"master on device {dev}" in text["master"], f"the master's log names {dev}")
        check(re.search(rf"worker \S+ on device {re.escape(str(dev))}", text["worker"])
              is not None, f"the worker's log names {dev}")
        launches = {}
        for role in ("master", "worker"):
            found = re.findall(r"kernel launches (\{.*\})", text[role])
            check(len(found) == 1, f"the {role} logged its kernels' launches at SIGTERM")
            launches[role] = json.loads(found[0])
        result["launches"] = {n: launches["worker"][n] for n in KERNELS}
        result["master_launches"] = {n: launches["master"][n] for n in BPR_KERNELS}
        check(all(v > 0 for v in result["launches"].values()),
              f"the worker process launched K4-K6: {result['launches']}")
        check(launches["master"]["bpr_epoch"] > 0,
              f"the master process launched bpr_epoch: {result['master_launches']}")
        log(f"  the nodes synced {proxy} for the data and the cache; launches: the worker "
            f"{json.dumps(result['launches'])}, the master {json.dumps(result['master_launches'])}"
            f"; SIGTERM ended each in (s) {json.dumps(stop)}")
        # ---- every held user's rows are in data.sqlite after the master stopped
        store = SQLiteDataStore(str(tmp / "data.sqlite"))
        for uid in sorted(rows.held):
            sent = {fb.key(): fb.value for fb in rows.held_rows if fb.user_id == uid}
            got = {fb.key(): fb.value for fb in store.get_user_feedback(uid)}
            check(got == sent, f"data.sqlite holds {uid}'s {len(sent)} rows ({len(got)})")
        check(store.count_feedback() == rows.n_rows, "data.sqlite holds every row")
        store.close()
    # ---- the spans at the collector
    traces = collector.traces()
    for trace, parent in result.pop("traceparents"):
        check(("GET /api/recommend/{user-id}", parent) in traces.get(trace, []),
              f"the collector holds the server's span of trace {trace}")
    check(("GET /api/health/live", "e" * 16) in traces.get("f" * 32, []),
          "the collector holds the master's trailing span, flushed at SIGTERM")
    result["spans"] = len(collector.spans)
    result["exports"] = collector.requests
    log(f"  the collector received {result['spans']} spans in {result['exports']} exports: the "
        f"server's GET /api/recommend/{{user-id}} spans in the phase's traces and the master's "
        f"trailing span")
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {result['phase_s']:.1f} s ({smi})")
    check(result["phase_s"] <= GRPC_PHASE_S,
          f"phase 15 took {result['phase_s']:.1f} s of its {GRPC_PHASE_S} s")
    return result


def _grpc_run(run) -> dict:
    """Phase 15 once the master and the server answer: the ingest, the
    meta, the scheduled cycle, the worker, the served lists in traces of
    the phase's own, the proxy's and the blob's timings over mutual TLS,
    the refused clients, REST latency."""
    from gorse_tpu_torch.client import GorseClient
    from gorse_tpu_torch.protocol import grpcwire, rpc
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.proxy import ProxyCacheStore, ProxyDataStore
    from gorse_tpu_torch.utils.config import Config

    out = {}
    master, server, grpc_port = run.ports["master"], run.ports["server"], run.ports["grpc"]
    target = f"127.0.0.1:{grpc_port}"
    rows = run.rows
    # ---- the held users and their rows through the server, into data.sqlite by the proxy
    t0 = time.perf_counter()
    status, body = http_json(server, "POST", "/api/users",
                             [u.to_dict() for u in rows.users if u.user_id in rows.held])
    check(status == 200 and body == {"RowAffected": len(rows.held)}, f"POST /api/users: {body}")
    client = GorseClient(f"http://127.0.0.1:{server}", timeout=60)
    for n in range(0, len(rows.held_rows), CLUSTER_BATCH):
        batch = rows.held_rows[n:n + CLUSTER_BATCH]
        body = client.insert_feedback(batch, overwrite=True)
        check(body == {"RowAffected": len(batch)}, f"PUT /api/feedback: {body}")
    out["ingest_rows_per_s"] = len(rows.held_rows) / (time.perf_counter() - t0)

    def meta():
        status, body = http_json(master, "POST", "/api/admin/meta", {}, CLUSTER_ADMIN_KEY)
        check(status == 200, f"POST /api/admin/meta with the key: {status}")
        return body

    # ---- the meta names the master's proxy for the data and the cache
    proxy = f"proxy://{target}"
    db = json.loads(meta()["config"])["database"]
    check(db["data_store"] == proxy and db["cache_store"] == proxy,
          f"the meta names {proxy} for data and cache: {db['data_store']}, {db['cache_store']}")
    # ---- the scheduled cycle, then the worker over the proxy
    first = poll("the master's first cycle names a CF model", lambda: meta()["cf_model_id"],
                 time.perf_counter() + CLUSTER_CYCLE_S)
    t_sched = time.perf_counter()
    check(http_json(master, "POST", "/api/dashboard/schedule", {}, CLUSTER_ADMIN_KEY)
          == (200, {"status": "scheduled"}), "POST /api/dashboard/schedule")
    deadline = t_sched + CLUSTER_CYCLE_S
    cf_id = poll("the scheduled cycle names a new CF model",
                 lambda: (m := meta()["cf_model_id"]) != first and m, deadline)
    out["schedule_to_model_s"] = time.perf_counter() - t_sched
    run.spawn()

    def span_arrived():
        status, tasks = http_json(master, "GET", "/api/dashboard/tasks", None, CLUSTER_ADMIN_KEY)
        return status == 200 and any(
            t.get("Node", "").startswith("worker-") and t["Name"] == "recommend"
            and t["Status"] == "complete" and t["Count"] == len(rows.users) for t in tasks)

    poll(f"the worker's span for {len(rows.users)} users at the master", span_arrived, deadline,
         every=0.25)
    # ---- every list in the master's memory cache, and the server's answers
    cache = ProxyCacheStore(target, tls=run.tls)
    cfg = Config.from_json(meta()["config"])
    lists: dict[str, list] = {}
    for subset, score in cache.scan_scores(ck.RECOMMEND):
        lists.setdefault(subset, []).append(score.id)
    check(len(lists) == len(rows.users),
          f"the master's cache holds {len(lists)} lists of {len(rows.users)}")
    for uid, ids in lists.items():
        check(0 < len(ids) <= cfg.recommend.cache_size and set(ids) <= rows.catalog
              and not set(ids) & rows.seen.get(uid, set()),
              f"{uid}: {len(ids)} catalog ids, none of the user's items")
    rng = np.random.default_rng(15)
    others = sorted(u.user_id for u in rows.users if u.user_id not in rows.held)
    sample = ([str(u) for u in rng.choice(sorted(rows.held), GRPC_SAMPLE // 2, replace=False)]
              + [str(u) for u in rng.choice(others, GRPC_SAMPLE // 2, replace=False)])
    out["traceparents"] = []
    for n, uid in enumerate(sample):
        trace, parent = f"{15:08x}{n:024x}", f"{n + 1:016x}"
        status, body = traced_get(server, f"/api/recommend/{uid}", f"00-{trace}-{parent}-01")
        want = [x.id for x in cache.search_scores(ck.RECOMMEND, uid)][: cfg.server.default_n]
        check(status == 200 and body == want, f"GET /api/recommend/{uid} equals the cache")
        out["traceparents"].append((trace, parent))
    out["schedule_to_served_s"] = time.perf_counter() - t_sched
    log(f"  schedule -> {cf_id} in {out['schedule_to_model_s']:.1f} s; the worker's lists for "
        f"{len(rows.users)} users in the master's memory through {proxy}; {len(sample)} served "
        f"equal to them {out['schedule_to_served_s']:.1f} s after schedule")
    # ---- the proxy over mutual TLS: unary calls, a row stream
    data = ProxyDataStore(target, tls=run.tls)
    lat = []
    for n in range(GRPC_CALLS):
        t0 = time.perf_counter()
        user = data.get_user(f"u{n % len(rows.users)}")
        lat.append((time.perf_counter() - t0) * 1e3)
        check(user is not None, f"get_user(u{n % len(rows.users)}) through the proxy")
    out["get_user_p50_ms"], out["get_user_p99_ms"] = percentiles(lat)
    t0 = time.perf_counter()
    streamed = sum(1 for _ in data.get_feedback())
    out["stream_rows_per_s"] = streamed / (time.perf_counter() - t0)
    check(streamed == rows.n_rows, f"get_feedback streamed {streamed} of {rows.n_rows} rows")
    # ---- the published model, downloaded with the client's certificate
    blobs = rpc.BlobStoreClient(target, tls=run.tls)
    check(cf_id in blobs.list(), f"the BlobStore lists {cf_id}")
    t0 = time.perf_counter()
    dst = blobs.download(cf_id, run.tmp / "download")
    seconds = time.perf_counter() - t0
    src = run.tmp / "blobs" / cf_id
    files = sorted(p.relative_to(src) for p in src.rglob("*") if p.is_file())
    check(files and files == sorted(p.relative_to(dst) for p in dst.rglob("*") if p.is_file())
          and all((src / f).read_bytes() == (dst / f).read_bytes() for f in files),
          f"the download of {cf_id} equals its blob directory byte for byte")
    size = sum((src / f).stat().st_size for f in files)
    out["blob_bytes"], out["blob_mb_per_s"] = size, size / seconds / 1e6
    # ---- clients without a certificate are refused
    import ssl

    bare = rpc.MasterGrpcClient(target, "worker", node_id="intruder")
    context = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    context.load_verify_locations(run.tls.ssl_ca)
    context.set_alpn_protocols(["h2"])
    channel = grpcwire.Channel(target, context)
    no_cert = channel.unary_unary("/gorse_tpu.Master/GetMeta")
    for what, call in (("without TLS", bare.get_meta), ("without a certificate",
                                                         lambda: no_cert(b"", timeout=30))):
        try:
            call()
            check(False, f"a client {what} is refused")
        except grpcwire.RpcError as e:
            check(e.code() is grpcwire.StatusCode.UNAVAILABLE,
                  f"a client {what} is refused: {e.code().name}")
    for c in (cache, data, blobs, bare, channel):
        c.close()
    # ---- REST latency through the proxied cache
    out["rest_p50_ms"], out["rest_p99_ms"] = rest_latency(
        server, lambda r: f"/api/recommend/u{r % len(rows.users)}")
    log(f"  over mutual TLS: get_user p50 {out['get_user_p50_ms']:.3f} ms, p99 "
        f"{out['get_user_p99_ms']:.3f} ms ({GRPC_CALLS} calls); get_feedback {streamed:,} rows "
        f"at {out['stream_rows_per_s']:,.0f} rows/s; {cf_id} ({size:,} bytes) downloaded at "
        f"{out['blob_mb_per_s']:.1f} MB/s; refused without TLS and without a certificate; REST "
        f"through the proxied cache p50 {out['rest_p50_ms']:.3f} ms, p99 "
        f"{out['rest_p99_ms']:.3f} ms; ingest {out['ingest_rows_per_s']:.0f} rows/s")
    return out


# ---------------------------------------------------------------- phase 16


def phase10_rows(seed: int, n_users: int) -> list:
    """Phase 10's rows (its feedback types drawn from ``seed``) for the
    first ``n_users`` users, in ``rows_of``'s form."""
    rng = np.random.default_rng(seed + 10)
    picks = rng.integers(len(IN_ONE_TYPES), size=1 << 21)
    reads = rng.integers(3, 6, size=1 << 21)

    def feedback_type(n):
        t = IN_ONE_TYPES[picks[n]]
        return t, float(reads[n]) if t == "read" else 1.0

    return rows_of(neighbor_store(0, embedding=False, user_fields=USER_FIELDS,
                                  feedback_type=feedback_type, n_users=n_users))


def hold_recall(what: str, index, data, cache, users: list, n: int, dev) -> None:
    """Each user's collaborative list in ``cache``: the kernels' list of
    its fetch (``n`` + its history) held tie-aware against the plain top-k
    of the same index, and the cache equal to it after the user's items."""
    from gorse_tpu_torch.ops import topk
    from gorse_tpu_torch.storage import cache as ck

    items = index._prepared_items
    for uid in users:
        seen = {fb.item_id for fb in data.get_user_feedback(uid)}
        row = index.user_index.to_number(uid)
        q = index.user_factors[row : row + 1]
        fetch = n + len(seen)
        s_k, i_k = topk.dot_topk(q, items, fetch, device=dev)
        hold_lists(f"{what} {uid}: fetched list", (s_k, i_k), topk.dot_topk_plain(q, items, fetch),
                   topk._pad_queries(q, items, topk.QUERY_TILE), items.table)
        ids = [index.item_index.to_name(int(index._serving_rows[j])) for j in i_k[0].tolist()]
        want = [(i, float(s)) for i, s in zip(ids, s_k[0].tolist()) if i not in seen]
        got = [(s.id, s.score) for s in cache.search_scores(ck.COLLABORATIVE, uid)]
        check(got == want[:n], f"{what} {uid}: the cache equals the kernels' list less the "
              "user's items")


def surface_config(mock=None, ranker: str = "none"):
    """The phase's config: BPR (``MASTER_EPOCHS`` epochs) and collaborative
    candidates only, no fallback, ranked by ``ranker`` with the reversing
    prompt; with ``mock``, its OpenAI endpoint without rate limits."""
    from gorse_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.recommend.collaborative.type = "mf"
    cfg.recommend.collaborative.fit_epoch = MASTER_EPOCHS
    cfg.recommend.ranker.type = ranker
    cfg.recommend.ranker.recommenders = ["collaborative"]
    cfg.recommend.ranker.prompt = LLM_PROMPT
    cfg.recommend.fallback.recommenders = []
    if mock is not None:
        cfg.openai.base_url, cfg.openai.auth_token = mock.base_url, mock.auth_token
        cfg.openai.chat_completion_model = "mock"
        cfg.openai.chat_completion_rpm = cfg.openai.embedding_rpm = 10**9
        cfg.openai.chat_completion_tpm = cfg.openai.embedding_tpm = 10**12
    return cfg


class ReverseReranker:
    """A reranker API: each request's document indices in reverse order,
    scores descending; it counts its requests."""

    def __init__(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        owner = self
        self.calls = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                owner.calls += 1
                n = len(body["documents"])
                out = json.dumps({"results": [{"index": i, "relevance_score": float(i + 1)}
                                              for i in range(n - 1, -1, -1)]}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/rerank"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def topk_launches() -> dict:
    from gorse_tpu_torch.ops import topk

    return {n: getattr(topk, n).launches for n in KERNELS}


def want_launches(index, users: list, data, n: int) -> dict:
    """K4-K6's launches that ``search_users(users, n, exclude=histories)``
    makes: each 256-user chunk's route's (``worker_routes``)."""
    want = dict.fromkeys(KERNELS, 0)
    for route in worker_routes(index, users, data, n):
        for kernel, c in route_launches(route, sq=False).items():
            want[kernel] += c
    return want


def surface_llm(dev, seed: int, tmp: Path, mock) -> tuple[dict, object, object]:
    """(a) and (b): the master's fit, the recall lists (``ranker.type =
    "none"``), then the LLM ranking through the chat completions and
    through the reranker API. Returns the result, the master and its
    SQLite data store."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import SQLiteDataStore
    from gorse_tpu_torch.storage.meta import MetaStore

    rows = phase10_rows(seed, LLM_USERS)
    data = SQLiteDataStore(str(tmp / "data.sqlite"))
    insert_rows(data, rows)
    users = [u["user_id"] for u in rows[0]]
    out = {"users_items_feedback": [len(t) for t in rows]}
    cfg = surface_config(mock)
    master = Master(cfg, data, MemoryCacheStore(), BlobStore(tmp / "blob"), MetaStore(),
                    device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    master.train_collaborative_filtering(master.load_dataset())
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["fit_launches"] = {"bpr_epoch": bpr_kernel.bpr_epoch.launches}
    check(out["fit_launches"]["bpr_epoch"] == MASTER_EPOCHS,
          f"the master's fit launched bpr_epoch {out['fit_launches']['bpr_epoch']} times")

    # ---- the recall lists: the same index with ranker.type = "none"
    recall_cache = MemoryCacheStore()
    plain = Worker(cfg, data, recall_cache, master.blob, node_id="recall", device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(plain.sync_and_recommend(master) == len(users), "the recall worker served every user")
    torch.cuda.synchronize()
    out["recall_s"] = time.perf_counter() - t0
    out["recall_launches"] = topk_launches()
    want = want_launches(plain.cf_index, users, data, cfg.recommend.cache_size)
    check(out["recall_launches"] == want and want["block_max"] > 0,
          f"the recall worker launched {out['recall_launches']}, want {want}")
    recall = {u: [s.id for s in recall_cache.search_scores(ck.RECOMMEND, u)] for u in users}
    check(all(recall.values()), "every user has a recall list")
    sample = [str(u) for u in sorted(np.random.default_rng(5).choice(
        users, min(MASTER_SAMPLE_USERS, len(users)), replace=False))]
    hold_recall("recall", plain.cf_index, data, recall_cache, sample, cfg.recommend.cache_size,
                dev)

    # ---- (a) ranker.type = "llm" through the chat completions
    llm_cache = MemoryCacheStore()
    worker = Worker(surface_config(mock, "llm"), data, llm_cache, master.blob, node_id="llm",
                    device=dev)
    check(worker.openai_client is not None, "the llm worker built its client from [openai]")
    mock.requests.clear()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = worker.sync_and_recommend(master)
    torch.cuda.synchronize()
    out["llm_s"] = time.perf_counter() - t0
    out["llm_launches"] = topk_launches()
    completions = sum(1 for r in mock.requests if r["path"].endswith("/chat/completions"))
    check(served == len(users) and completions == served,
          f"the llm worker served {served} users with {completions} completions")
    check(out["llm_launches"] == want,
          f"the llm worker's recall launched {out['llm_launches']}, want {want}")
    for u in users:
        got = [s.id for s in llm_cache.search_scores(ck.RECOMMEND, u)]
        check(got == recall[u][::-1], f"{u}: the LLM-ranked list is its recall list reversed")
    out.update(llm_users=served, completions=completions, llm_users_per_s=served / out["llm_s"])

    # ---- (b) the reranker-API route
    reranker = ReverseReranker()
    try:
        api_cfg = surface_config(mock, "llm")
        api_cfg.recommend.ranker.reranker_api.url = reranker.url
        api_cfg.recommend.ranker.query_template = "{{ user.user_id }}"
        api_cfg.recommend.ranker.document_template = "{{ item.item_id }}"
        api_cache = MemoryCacheStore()
        api = Worker(api_cfg, data, api_cache, master.blob, node_id="api", device=dev)
        api.pull_models(master.get_meta()["cf_model_id"])
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_api = api.recommend(users[:LLM_API_USERS])
        torch.cuda.synchronize()
        out["api_s"] = time.perf_counter() - t0
        out["api_launches"] = topk_launches()
        check(n_api == LLM_API_USERS and reranker.calls == LLM_API_USERS,
              f"the reranker API ranked {n_api} users in {reranker.calls} requests")
        api_want = want_launches(api.cf_index, users[:LLM_API_USERS], data,
                                 cfg.recommend.cache_size)
        check(out["api_launches"] == api_want and api_want["block_max"] > 0,
              f"the reranker worker's recall launched {out['api_launches']}, want {api_want}")
        for u in users[:LLM_API_USERS]:
            got = [s.id for s in api_cache.search_scores(ck.RECOMMEND, u)]
            check(got == recall[u][::-1], f"{u}: the reranker's list is its recall list reversed")
    finally:
        reranker.close()
    log(f"  (a) fit {out['fit_s']:.1f} s ({out['fit_launches']['bpr_epoch']} bpr_epoch "
        f"launches); recall of "
        f"{len(users)} users {out['recall_s']:.2f} s, {len(sample)} held against the plain "
        f"top-k; ranker.type = llm: {served} users, {completions} completions in "
        f"{out['llm_s']:.2f} s ({out['llm_users_per_s']:.1f} users/s), launches "
        f"{json.dumps(out['llm_launches'])}, every list its recall reversed; (b) the reranker "
        f"API: {LLM_API_USERS} users in {out['api_s']:.2f} s, reversed")
    return out, master, data


class MemoClient:
    """An OpenAI client's chat completions and embeddings, each input asked
    once: the CPU run of (c) reuses the card run's answers of the
    deterministic mock."""

    def __init__(self, client) -> None:
        self.client, self.memo, self.calls = client, {}, 0

    def enabled(self) -> bool:
        return self.client.enabled()

    def _ask(self, kind: str, text: str):
        if (kind, text) not in self.memo:
            self.calls += 1
            fn = self.client.chat_completion if kind == "chat" else self.client.embedding
            self.memo[kind, text] = fn(text)
        return self.memo[kind, text]

    def chat_completion(self, prompt: str) -> str:
        return self._ask("chat", prompt)

    def embedding(self, text: str):
        return self._ask("embedding", text)


def hold_chat(card: list, cpu: list) -> float:
    """Chat item-to-item lists from the card and the CPU: the same items;
    each neighbour id equal except where two distances lie within
    ``CHAT_TIE`` of each other; scores within ``CHAT_RTOL`` (relative).
    Returns the largest relative score difference."""
    check([i for i, _ in card] == [i for i, _ in cpu], "chat item-to-item: the same items")
    worst = 0.0
    for (item, got), (_, want) in zip(card, cpu):
        check(len(got) == len(want) > 0, f"chat item-to-item {item}: {len(got)} neighbours")
        dist = [1.0 / s.score - 1.0 for s in want]
        for r, (a, b) in enumerate(zip(got, want)):
            rel = abs(a.score - b.score) / abs(b.score)
            worst = max(worst, rel)
            check(rel <= CHAT_RTOL, f"chat item-to-item {item} #{r}: score within {CHAT_RTOL}")
            if a.id != b.id:
                check(any(abs(dist[r] - dist[j]) <= CHAT_TIE for j in (r - 1, r + 1)
                          if 0 <= j < len(dist)),
                      f"chat item-to-item {item} #{r}: {a.id} != {b.id} outside a tie")
    return worst


def surface_chat(dev, mock) -> dict:
    """(c) ``ChatItemToItem`` with a client over ``CHAT_ITEMS`` items with
    the mock's hash embeddings, on the card and on the CPU."""
    import torch

    from gorse_tpu_torch.llm.client import OpenAIClient
    from gorse_tpu_torch.llm.mock import hash_embedding
    from gorse_tpu_torch.logics.chat import ChatItemToItem
    from gorse_tpu_torch.logics.item_to_item import ItemToItemConfig
    from gorse_tpu_torch.parallel.ratelimit import RateLimiters
    from gorse_tpu_torch.storage.types import Item

    client = MemoClient(OpenAIClient(mock.base_url, mock.auth_token, chat_model="mock",
                                     embedding_dimensions=CHAT_DIM,
                                     limiters=RateLimiters(10**9, 10**12, 10**9, 10**12)))
    items = [Item(f"i{k}", labels={"embedding": hash_embedding(f"item {k}", CHAT_DIM)})
             for k in range(CHAT_ITEMS)]
    cfg = ItemToItemConfig(name="chat", type="chat", column="embedding", prompt=CHAT_PROMPT)
    lists, seconds = {}, {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        engine = ChatItemToItem(cfg, CHAT_N, timestamp=0.0, openai_client=client, device=device)
        for item in items:
            engine.push(item, [])
        t0 = time.perf_counter()
        lists[where] = engine.pop_all()
        torch.cuda.synchronize()
        seconds[where] = time.perf_counter() - t0
    worst = hold_chat(lists["card"], lists["cpu"])
    out = {"items": CHAT_ITEMS, "dim": CHAT_DIM, "neighbours": CHAT_N, "card_s": seconds["card"],
           "cpu_s": seconds["cpu"], "llm_calls": client.calls, "max_rel_score_diff": worst}
    log(f"  (c) chat item-to-item over {CHAT_ITEMS} items x {CHAT_DIM}: card {seconds['card']:.2f} s"
        f" ({client.calls} completions and embeddings asked), CPU {seconds['cpu']:.2f} s on the "
        f"same answers; ids equal outside {CHAT_TIE} ties, scores within {worst:.2e} relative")
    return out


def http_raw(port: int, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None, timeout: float = 120) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def surface_dump(dev, tmp: Path, master, data) -> dict:
    """(d) ``/api/dump`` of (a)'s master, ``/api/restore`` into a second
    master over an empty SQLite file, the CSV and JSONL round trips, and
    the second master's fit and worker on the restored rows."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel
    from gorse_tpu_torch.serve.dashboard import MasterRestServer
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.worker import Worker
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import SQLiteDataStore
    from gorse_tpu_torch.storage.meta import MetaStore

    cfg = surface_config()
    masters = [master] + [
        Master(cfg, SQLiteDataStore(str(tmp / f"{name}.sqlite")), MemoryCacheStore(),
               BlobStore(tmp / f"blob_{name}"), MetaStore(), device=dev)
        for name in ("restored", "csv", "jsonl")]
    rests = [MasterRestServer(m) for m in masters]
    ports = [rest.serve("127.0.0.1", 0).server_address[1] for rest in rests]
    out = {}
    try:
        t0 = time.perf_counter()
        status, stream = http_raw(ports[0], "GET", "/api/dump")
        out["dump_s"] = time.perf_counter() - t0
        check(status == 200 and stream.startswith(b"GTPU1"), f"GET /api/dump: {status}")
        rows = rows_of(data)
        n_rows = sum(len(t) for t in rows)
        t0 = time.perf_counter()
        status, body = http_raw(ports[1], "POST", "/api/restore", stream,
                                {"Content-Type": "application/octet-stream"})
        out["restore_s"] = time.perf_counter() - t0
        counts = json.loads(body)
        check(status == 200 and counts == dict(zip(("users", "items", "feedback"),
                                                   map(len, rows))),
              f"POST /api/restore: {status} {counts}")
        check(rows_of(masters[1].data) == rows, "every restored user, item and feedback row equal")
        status, again = http_raw(ports[1], "GET", "/api/dump")
        check(status == 200 and again == stream, "the restored master dumps the same bytes")
        # the CSV and JSONL round trips: export, import into an empty store,
        # export again
        trips = {}
        for fmt, port, get, post in (("csv", ports[2], "/api/export/", "/api/import/"),
                                     ("jsonl", ports[3], "/api/bulk/", "/api/bulk/")):
            for what in ("users", "items", "feedback"):
                t0 = time.perf_counter()
                status, first = http_raw(ports[0], "GET", get + what)
                check(status == 200 and first.count(b"\n") > len(rows[0]) // 2 - 1,
                      f"GET {get}{what}: {status}")
                status, body = http_raw(port, "POST", post + what, first,
                                        {"Content-Type": "application/octet-stream"})
                check(status == 200, f"POST {post}{what}: {status} {body[:200]!r}")
                status, second = http_raw(port, "GET", get + what)
                check(status == 200 and second == first, f"{fmt} {what}: the round trip is "
                      "byte-equal")
                trips[f"{fmt}_{what}"] = {"bytes": len(first), "s": time.perf_counter() - t0}
        out["round_trips"] = trips
    finally:
        for rest in rests:
            rest.shutdown()
    # ---- the restored master's fit and a worker on it
    restored = masters[1]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored.train_collaborative_filtering(restored.load_dataset())
    worker = Worker(cfg, restored.data, restored.cache, restored.blob, node_id="restored",
                    device=dev)
    refreshed = worker.sync_and_recommend(restored)
    torch.cuda.synchronize()
    out["cycle_s"] = time.perf_counter() - t0
    out["launches"] = dict(topk_launches(), bpr_epoch=bpr_kernel.bpr_epoch.launches)
    users = [u["user_id"] for u in rows[0]]
    want = dict(want_launches(worker.cf_index, users, restored.data, cfg.recommend.cache_size),
                bpr_epoch=MASTER_EPOCHS)
    check(out["launches"] == want and want["block_max"] > 0,
          f"the restored master's fit and worker launched {out['launches']}, want {want}")
    check(refreshed == len(rows[0]), f"the restored worker refreshed {refreshed} users")
    sample = [str(u) for u in sorted(np.random.default_rng(6).choice(
        users, min(MASTER_SAMPLE_USERS, len(users)), replace=False))]
    hold_recall("restored", worker.cf_index, restored.data, restored.cache, sample,
                cfg.recommend.cache_size, dev)
    check(all(restored.cache.search_scores(ck.RECOMMEND, u) for u in users),
          "every restored user has a list")
    for m in masters[1:]:
        m.data.close()
    out.update(bytes=len(stream), rows=n_rows, dump_mb_per_s=len(stream) / out["dump_s"] / 1e6,
               restore_rows_per_s=n_rows / out["restore_s"])
    log(f"  (d) /api/dump {len(stream):,} bytes ({n_rows:,} rows) in {out['dump_s']:.2f} s "
        f"({out['dump_mb_per_s']:.1f} MB/s); /api/restore into an empty SQLite file in "
        f"{out['restore_s']:.2f} s ({out['restore_rows_per_s']:,.0f} rows/s); every row equal, "
        f"the second dump byte-equal; CSV and JSONL round trips byte-equal; the restored "
        f"master's fit and worker {out['cycle_s']:.1f} s, launches {json.dumps(out['launches'])}")
    return out


def get_raw(url: str, cookie: str = "") -> tuple[int, dict, bytes]:
    """GET without following a redirect: (status, headers, body)."""
    import urllib.error
    import urllib.request

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *args, **kwargs):
            return None

    req = urllib.request.Request(url, headers={"Cookie": cookie} if cookie else {})
    try:
        with urllib.request.build_opener(NoRedirect()).open(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def surface_oidc(dev, seed: int, tmp: Path) -> dict:
    """(e) The sign-on against the port's MockOIDCProvider, refused tokens,
    and the dashboard's page."""
    import random

    from gorse_tpu_torch.serve.dashboard import MasterRestServer
    from gorse_tpu_torch.serve.master import Master
    from gorse_tpu_torch.serve.oidc import MockOIDCProvider, generate_rsa_key
    from gorse_tpu_torch.storage.blob import BlobStore
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore
    from gorse_tpu_torch.storage.meta import MetaStore

    t0 = time.perf_counter()
    provider = MockOIDCProvider(client_id="gorse", client_secret="s3cret", seed=seed)
    out = {"provider_key_s": time.perf_counter() - t0}
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    cfg = surface_config()
    cfg.oidc.enable = True
    cfg.oidc.issuer, cfg.oidc.client_id, cfg.oidc.client_secret = provider.issuer, "gorse", "s3cret"
    cfg.oidc.redirect_url = base + "/callback/oauth2"
    rest = MasterRestServer(Master(cfg, MemoryDataStore(), MemoryCacheStore(),
                                   BlobStore(tmp / "blob_oidc"), MetaStore(), device=dev))
    rest.serve("127.0.0.1", port)
    try:
        t0 = time.perf_counter()
        check(get_raw(base + "/api/dashboard/stats")[0] == 401, "the dashboard wants a session")
        status, headers, _ = get_raw(base + "/login")
        check(status == 302 and headers["Location"].startswith(provider.issuer + "/auth"),
              f"/login redirects to the provider: {status}")
        status, headers, _ = get_raw(headers["Location"])
        check(status == 302 and headers["Location"].startswith(base + "/callback/oauth2"),
              f"the provider redirects to /callback/oauth2: {status}")
        status, headers, _ = get_raw(headers["Location"])
        check(status == 302 and "Set-Cookie" in headers, f"the callback sets a session: {status}")
        cookie = headers["Set-Cookie"].split(";")[0]
        status, _, body = get_raw(base + "/api/dashboard/userinfo", cookie)
        info = json.loads(body)
        check(status == 200 and info["Email"] == provider.user["email"]
              and info["Name"] == provider.user["name"] and info["AuthType"] == "oidc",
              f"/api/dashboard/userinfo returns the provider's claims: {info}")
        check(get_raw(base + "/api/dashboard/stats", cookie)[0] == 200, "the session passes")
        out["flow_s"] = time.perf_counter() - t0
        other = generate_rsa_key(rng=random.Random(seed + 1))
        for what, token in (("signed by another key", provider.sign_id_token(key=other)),
                            ("past its exp", provider.sign_id_token({"exp": time.time() - 60}))):
            try:
                rest.oidc.verify_id_token(token)
                check(False, f"a token {what} is refused")
            except ValueError:
                pass
        status, headers, page = get_raw(base + "/")
        check(status == 200 and page == (ROOT / "gorse_tpu_torch" / "serve"
                                         / "dashboard.html").read_bytes(),
              "GET / returns the port's dashboard.html")
        out["page_bytes"] = len(page)
    finally:
        rest.shutdown()
        provider.close()
    log(f"  (e) OIDC: the provider's 2048-bit key in {out['provider_key_s']:.1f} s, /login -> "
        f"provider -> /callback/oauth2 -> session -> userinfo in {out['flow_s']:.2f} s; tokens "
        f"signed by another key or past exp refused; GET / {out['page_bytes']:,} bytes")
    return out


def hold_vector_rows(engine: str, got: list, want: list, queries, table: dict) -> float:
    """A vector database's top-k against the card's exact store: recall 1.0
    and the same order, except where two items' exact (f64) scores lie
    within a relative 1e-6. Returns the recall."""
    hits = total = 0
    for q, g, w in zip(queries, got, want):
        exact = {i: float(np.dot(q.astype(np.float64), table[i].astype(np.float64)))
                 for i in {s.id for s in g} | {s.id for s in w}}
        tol = 1e-6 * max(abs(v) for v in exact.values())
        hits += len({s.id for s in g} & {s.id for s in w})
        total += len(w)
        check(len(g) == len(w), f"{engine}: {len(g)} hits, want {len(w)}")
        for a, b in zip(g, w):
            check(a.id == b.id or abs(exact[a.id] - exact[b.id]) <= tol,
                  f"{engine}: {a.id} where the exact store has {b.id}, outside a tie")
    return hits / max(total, 1)


def surface_mocks(dev, seed: int, tmp: Path, master) -> dict:
    """(f) The in-one node over ``mongodb://`` (the port's MiniMongo), and
    ``qdrant://``, ``weaviate://``, ``milvus://`` against the card's exact
    store."""
    import torch

    from gorse_tpu_torch.ops import bpr_kernel
    from gorse_tpu_torch.serve.in_one import InOneNode
    from gorse_tpu_torch.storage import cache as ck
    from gorse_tpu_torch.storage.data import open_data_store
    from gorse_tpu_torch.storage.minimongo import MiniMongo
    from gorse_tpu_torch.storage.minivector import MiniMilvus, MiniQdrant, MiniWeaviate
    from gorse_tpu_torch.storage.vectors import MemoryVectorStore, open_vector_store

    out = {}
    mongo = MiniMongo().start()
    minis = {"qdrant": MiniQdrant().start(), "weaviate": MiniWeaviate().start(),
             "milvus": MiniMilvus().start()}
    try:
        # ---- the in-one node over mongodb://
        rows = first_users(phase10_rows(seed, MONGO_USERS), MONGO_USERS)
        data_url, cache_url = mongo.url(database="gorse_data"), mongo.url(database="gorse_cache")
        store = open_data_store(data_url)
        t0 = time.perf_counter()
        insert_rows(store, rows)
        out["mongo_insert_s"] = time.perf_counter() - t0
        store.close()
        fresh = open_data_store(data_url)
        check(rows_of(fresh) == rows, "mongodb://: every row reads back")
        fresh.close()
        cfg = surface_config()
        cfg.database.data_store, cfg.database.cache_store = data_url, cache_url
        node = InOneNode(cfg, workdir=str(tmp / "mongo_node"), device=dev)
        check(type(node.data).__name__ == "MongoDataStore"
              and type(node.cache).__name__ == "MongoCacheStore",
              "the node opened mongodb:// for its data and cache")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = node.run_once()
        torch.cuda.synchronize()
        out["mongo_cycle_s"] = time.perf_counter() - t0
        out["mongo_launches"] = dict(topk_launches(), bpr_epoch=bpr_kernel.bpr_epoch.launches)
        check(summary["users_refreshed"] == MONGO_USERS,
              f"the worker refreshed {summary['users_refreshed']} of {MONGO_USERS} users")
        index = node.worker.cf_index
        # a catalog of 3 users' items: the ungated route (block_topk, merge_topk)
        want = dict(want_launches(index, [u["user_id"] for u in rows[0]], node.data,
                                  cfg.recommend.cache_size), bpr_epoch=MASTER_EPOCHS)
        check(out["mongo_launches"] == want,
              f"the cycle over mongodb:// launched {out['mongo_launches']}, want {want}")
        for u in rows[0]:
            uid = u["user_id"]
            seen = [fb.item_id for fb in node.data.get_user_feedback(uid)]
            want = index.search_users([uid], cfg.recommend.cache_size, exclude=[seen])[0]
            got = node.cache.search_scores(ck.COLLABORATIVE, uid)
            check(bool(got) and sorted((-s.score, s.id) for s in got)
                  == sorted((-s.score, s.id) for s in want),
                  f"{uid}: mongodb://'s collaborative list equals search_users on the card")
        node.shutdown()
        node.data.close()
        node.cache.close()

        # ---- the vector databases against the card's exact store
        ids, table = master.cf_index.serving_items()
        table = np.asarray(table, np.float32)
        by_id = dict(zip(ids, table))
        trained = np.flatnonzero(master.cf_index.user_predictable)[:VECTOR_QUERIES]
        queries = master.cf_index.user_factors[torch.as_tensor(trained, device=dev)].cpu().numpy()
        exact = MemoryVectorStore(device=dev)
        exact.create_collection("items", table.shape[1], distance="dot")
        exact.add("items", ids, table)
        want = exact.query("items", queries, VECTOR_K)
        vectors = {}
        for engine, mini in minis.items():
            url = (f"milvus://{mini.token}@127.0.0.1:{mini.port}" if engine == "milvus"
                   else f"{engine}://:{mini.api_key}@127.0.0.1:{mini.port}")
            store = open_vector_store(url, dev)
            store.create_collection("items", table.shape[1], distance="dot")
            t0 = time.perf_counter()
            store.add("items", ids, table)
            sync_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = store.query("items", queries, VECTOR_K)
            query_s = time.perf_counter() - t0
            recall = hold_vector_rows(f"{engine}://", got, want, queries, by_id)
            check(recall == 1.0, f"{engine}://: recall@{VECTOR_K} {recall}, want 1.0")
            vectors[engine] = {"rows": len(ids), "sync_s": sync_s, "query_s": query_s,
                               "recall": recall}
        out["vectors"] = vectors
    finally:
        mongo.stop()
        for mini in minis.values():
            mini.stop()
    log(f"  (f) mongodb:// {sum(len(t) for t in rows):,} rows in {out['mongo_insert_s']:.2f} s, "
        f"read back; the in-one cycle {out['mongo_cycle_s']:.1f} s, launches "
        f"{json.dumps(out['mongo_launches'])}, {MONGO_USERS} lists equal search_users; "
        + "; ".join(f"{k}:// {v['rows']:,} rows synced in {v['sync_s']:.2f} s, recall@{VECTOR_K} "
                    f"{v['recall']:.1f}" for k, v in vectors.items()))
    return out


def phase_surface(dev, smi: str, seed: int) -> dict:
    """Phase 16: the rest of the surface on the card."""
    from gorse_tpu_torch.llm.mock import MockOpenAIServer

    t_phase = time.perf_counter()
    result = {"card": smi, "users": LLM_USERS}
    steps = result["steps_s"] = {}
    t_step = time.perf_counter()

    def step(name: str) -> None:
        nonlocal t_step
        steps[name] = time.perf_counter() - t_step
        t_step = time.perf_counter()

    mock = MockOpenAIServer(dimensions=CHAT_DIM).start()
    try:
        with tempfile.TemporaryDirectory(prefix="gorse_surface_") as tmp_name:
            tmp = Path(tmp_name)
            result["llm"], master, data = surface_llm(dev, seed, tmp, mock)
            step("llm")
            result["chat"] = surface_chat(dev, mock)
            step("chat")
            result["dump"] = surface_dump(dev, tmp, master, data)
            step("dump")
            result["oidc"] = surface_oidc(dev, seed, tmp)
            step("oidc")
            result["mocks"] = surface_mocks(dev, seed, tmp, master)
            step("mocks")
            data.close()
    finally:
        mock.close()
    llm, dump, mocks = result["llm"], result["dump"], result["mocks"]
    result["launches"] = {name: (llm["recall_launches"][name] + llm["llm_launches"][name]
                                 + llm["api_launches"][name] + dump["launches"][name]
                                 + mocks["mongo_launches"][name]) for name in KERNELS}
    result["launches"]["bpr_epoch"] = (llm["fit_launches"]["bpr_epoch"]
                                       + dump["launches"]["bpr_epoch"]
                                       + mocks["mongo_launches"]["bpr_epoch"])
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 in {result['seconds']:.1f} s ({smi}); steps (s): "
        f"{json.dumps({k: round(v, 1) for k, v in steps.items()})}; launches "
        f"{json.dumps(result['launches'])}")
    check(result["seconds"] <= SURFACE_PHASE_S,
          f"phase 16 took {result['seconds']:.1f} s of its {SURFACE_PHASE_S} s")
    return result


# ---------------------------------------------------------------- phase 17


def bitset_draws(bits, counts_full, cap: int, keys, n_items: int, n_tries: int) -> dict:
    """Over the step keys, for the users the cap cuts: the draws whose
    ``n_tries`` candidates all lie in the user's full positive set, and the
    bitset words the first-free rule needs (each candidate up to the first
    free one, every one when all collide) over every active user."""
    import torch

    n_users = bits.shape[0]
    rows = torch.arange(n_users, device=bits.device)[:, None]
    capped = counts_full > cap
    active = counts_full > 0
    all_collide = words = 0
    for step in keys:
        cand = step_candidates(step, n_users, n_tries, n_items, bits.device)
        member = ((bits[rows, cand >> 5] >> (cand & 31).to(torch.int32)) & 1).bool()
        every = member.all(dim=1)
        all_collide += int((every & capped).sum())
        first_free = torch.argmax((~member).to(torch.int8), dim=1)
        words += int(torch.where(every, n_tries, first_free + 1)[active].sum())
    return {"all_collide": all_collide, "words": words}


def full_set_negatives(bits, counts_full, cap: int, neg) -> int:
    """The negatives ``neg`` ``[S, U]`` of the users the cap cuts that lie
    in the user's full positive set."""
    import torch

    rows = torch.arange(bits.shape[0], device=bits.device)[None, :]
    member = ((bits[rows, (neg >> 5).long()] >> (neg & 31)) & 1).bool()
    return int((member & (counts_full > cap)[None, :]).sum())


def phase_bitset(dev, smi: str) -> dict:
    """Phase 17: full-set negative rejection in the single-card fit, on a
    corpus where the reference's gate holds (the history cap binds, the
    bitset within 64 MiB). The sampled sweep and the epoch with the bitset
    against their plain versions; ``BPR.fit`` through ``bpr_epoch`` with
    the bitset; the capped users' negatives in their full positive sets,
    with and without it; K1's time at this shape both ways."""
    import logging

    import torch

    from gorse_tpu_torch.data.loaders import synthetic_cf_access
    from gorse_tpu_torch.models import BPR, FitConfig, Params
    from gorse_tpu_torch.models import bpr as bpr_model
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import sampling

    t_phase = time.perf_counter()
    data = synthetic_cf_access(BITSET_USERS, BITSET_ITEMS, nnz=BITSET_NNZ, seed=BITSET_SEED)
    train, test = data.split_cf(seed=0)
    cap, widest = bpr_model.history_cap(train)
    csr = train.padded_user_positives(max_len=cap, seed=0)
    bits_np = bpr_model.rejection_bitset(train, cap, widest)
    n_users, n_items, k = train.count_users(), train.count_items(), TRAIN_DIM
    check(cap < widest and bits_np is not None
          and bits_np.nbytes <= bpr_model.BITSET_MAX_BYTES,
          f"phase 17: cap {cap}, widest {widest}: the gate must hold")
    counts_full = torch.as_tensor(np.fromiter((len(fb) for fb in train.user_feedback),
                                              dtype=np.int64, count=n_users), device=dev)
    bits = torch.from_numpy(bits_np.view(np.int32)).to(dev)
    padded = torch.as_tensor(csr.padded, device=dev)
    counts = torch.as_tensor(csr.counts, device=dev)
    n_active = max(int((csr.counts > 0).sum()), 1)
    n_steps = max(round(train.count_feedback() / n_active), 1)
    n_tries = bpr_model.adaptive_neg_tries(float(np.mean(csr.counts)) / n_items)
    result = {"users": n_users, "items": n_items, "train_feedback": train.count_feedback(),
              "k": k, "cap": cap, "widest": widest, "bitset_bytes": int(bits_np.nbytes),
              "capped_users": int((counts_full > cap).sum()), "n_steps": n_steps,
              "n_tries": n_tries, "data_s": time.perf_counter() - t_phase}
    log(f"  {n_users} users, {n_items} items, {train.count_feedback()} train feedback: cap "
        f"{cap} < widest {widest}, {result['capped_users']} users capped, bitset "
        f"{bits_np.nbytes / 1e6:.1f} MB; made in {result['data_s']:.1f} s")

    # the sampled sweep and the epoch, kernel against plain, both with bits.
    # The sweep from 0.1-scale factors, as phase 4's full width; the epochs
    # from the fit's init: from 0.1-scale factors at lr 0.05 the dense sweep
    # diverges at this shape (p 0.1 -> 4.3 in 5 steps) and the growth
    # carries the atomics' reordered sums past EPOCH_TOL (1.6e-4 at 5 steps)
    rng = np.random.default_rng(17)
    p = torch.as_tensor(rng.normal(scale=0.1, size=(n_users, k)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.normal(scale=0.1, size=(n_items, k)).astype(np.float32), device=dev)
    key = sampling.raw_step_keys(sampling.prng_key(17), 1)[0]
    errors = hold_bpr("bitset sweep", p, q, padded, counts, key, torch.float32, n_tries, bits)
    init = BPR(Params(n_factors=k), device=dev)
    init.init(train, seed=0)
    p, q = init.user_factors, init.item_factors
    errors["bpr_epoch"] = 0.0
    for steps in EPOCH_STEPS:
        keys = sampling.raw_step_keys(sampling.prng_key(18), steps)
        errors["bpr_epoch"] = max(errors["bpr_epoch"], hold_epoch(
            f"bitset epoch of {steps}", p, q, padded, counts, keys, torch.float32, n_tries, bits))
    result["errors"] = errors
    result["first_epoch_rel_err"] = hold_first_epoch(train, csr, dev, n_steps, bits)
    log(f"  with the bitset: the sweep's pairs equal, the epoch over {EPOCH_STEPS} steps within "
        f"EPOCH_TOL, a whole epoch within FIRST_EPOCH_TOL; errors {json.dumps(errors)}")

    # the fit: every epoch one bpr_epoch launch with the bitset
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    fit_logger = logging.getLogger(bpr_model.__name__)
    fit_logger.addHandler(handler)
    level = fit_logger.level
    fit_logger.setLevel(logging.INFO)
    try:
        model = BPR(Params(n_factors=k, n_epochs=BITSET_EPOCHS, lr=LR, reg=REG), device=dev)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = model.fit(train, test, FitConfig())
        torch.cuda.synchronize()
        result["fit_s"] = time.perf_counter() - t0
        launches = {n: getattr(bk, n).launches for n in BPR_KERNELS}
        bits_launches = bk.bpr_epoch.bits_launches
    finally:
        fit_logger.removeHandler(handler)
        fit_logger.setLevel(level)
    said = [r.getMessage() for r in records if "full positive sets" in r.getMessage()]
    want = dict(bpr_sweep_sampled=0, bpr_sweep_pairs=0, bpr_epoch=BITSET_EPOCHS)
    check(launches == want and bits_launches == BITSET_EPOCHS,
          f"bitset fit: {launches} launches, {bits_launches} with the bitset; want {want}, "
          "each with it")
    check(len(said) == 1, f"bitset fit: the gate's log line ({len(said)} found)")
    result.update(launches=launches, bits_launches=bits_launches, fit_log=said[0],
                  epoch_s=model.epoch_seconds, ndcg=score.ndcg,
                  finite=bool(torch.isfinite(model.user_factors).all()
                              and torch.isfinite(model.item_factors).all()))
    log(f"  fit: {json.dumps(launches)}, {bits_launches} with the bitset; log: {said[0]}")
    del model

    # the negatives of one epoch's pairs, with the bitset and without
    keys = sampling.raw_step_keys(sampling.prng_key(19), n_steps)
    in_full = {}
    for side, b in (("bits", bits), ("rows", None)):
        pairs = torch.empty((2, n_steps, n_users), dtype=torch.int32, device=dev)
        bk.bpr_epoch(p, q.clone(), torch.zeros_like(q), torch.zeros((1,), device=dev), padded,
                     counts, keys, n_items, LR, REG, n_tries, pairs=pairs, bits=b)
        in_full[side] = full_set_negatives(bits, counts_full, cap, pairs[1])
    draws = bitset_draws(bits, counts_full, cap, keys, n_items, n_tries)
    check(in_full["bits"] == draws["all_collide"],
          f"bitset: {in_full['bits']} capped users' negatives in their full sets, "
          f"{draws['all_collide']} draws with every candidate in it")
    check(in_full["rows"] > in_full["bits"],
          f"rows: {in_full['rows']} full-set negatives, the bitset's {in_full['bits']}")
    result["full_set_negatives"] = dict(in_full, all_collide=draws["all_collide"],
                                        steps=n_steps, capped_users=result["capped_users"])
    log(f"  one epoch ({n_steps} steps): capped users' negatives in their full sets "
        f"{in_full['bits']} with the bitset (all-collide draws {draws['all_collide']}), "
        f"{in_full['rows']} against the capped rows")

    # K1 at this shape, both ways, in turns; the bounds of one epoch
    delta, cost = torch.zeros_like(q), torch.zeros((1,), device=dev)
    _, pos, neg = bk.bpr_sweep_sampled(p, q, delta, cost, padded, counts, keys[0], n_items,
                                       LR, REG, n_tries, bits=bits)
    act = counts > 0
    touched = int(torch.unique(torch.cat([pos[act], neg[act]])).numel())
    user_bytes = 2 * n_users * k * 4  # p read, p_new written
    row_bytes = touched * 3 * k * 4  # q rows read once, delta rows read and written
    flops = n_active * 16 * k
    hist_bytes = int(counts.sum()) * 4 + n_users * 4  # the rows' valid entries, the counts
    # what a step reads to sample: with the bitset a positive and a count a
    # user and one word a candidate the first-free rule tests; against the
    # rows every valid entry. By the rule (each input read once) the epoch
    # reads the rows once and at most the whole bitset.
    sample_bytes = {"bits": n_users * 8 + draws["words"] * 4 / n_steps, "rows": hist_bytes}
    once_bytes = {"bits": hist_bytes + min(draws["words"] * 4, bits_np.nbytes),
                  "rows": hist_bytes}
    q_epoch = q.clone()

    def epoch(b):
        return lambda: bk.bpr_epoch_fused(p, q_epoch, padded, counts, keys, n_items, LR, REG,
                                          mm_dtype=torch.float32, n_tries=n_tries, bits=b)

    times = {"rows": [], "bits": []}
    for side in ("rows", "bits", "bits", "rows"):
        times[side].append(median_ms(epoch(bits if side == "bits" else None), 20))
    queued = {side: queued_ms(epoch(bits if side == "bits" else None), 10)
              for side in ("rows", "bits")}
    plain_ms = median_ms(lambda: bk.bpr_epoch_plain(
        p, q_epoch, torch.zeros_like(q), cost, padded, counts, keys, n_items, LR, REG, n_tries,
        bits=bits), 2)
    timing = {}
    for side in ("bits", "rows"):
        rule = bound(user_bytes + 2 * q.numel() * 4 + once_bytes[side] + n_steps * 8 + 4,
                     n_steps * flops, F32_FLOP_S, n_steps * draw_ops(n_users, n_tries))
        # p a round trip a step, the sampling's reads, the touched q / delta rows
        trip = n_steps * bound(user_bytes + sample_bytes[side] + row_bytes, flops,
                               F32_FLOP_S, draw_ops(n_users, n_tries))[0]
        timing[side] = dict(ms=times[side], queued_ms=queued[side], bound_ms=rule[0],
                            bound_by=rule[1], round_trip_bound_ms=trip)
    timing["bits"].update(plain_ms=plain_ms, library_ms=None, touched_rows=touched,
                          words_read=draws["words"])

    # K2, one sampled sweep (the first step's key), both ways, in turns; its
    # bound as phase 4's with this sweep's sampling reads, pos and neg written
    step_words = bitset_draws(bits, counts_full, cap, keys[:1], n_items, n_tries)["words"]
    sweep_sample = {"bits": n_users * 8 + step_words * 4, "rows": hist_bytes}

    def sweep(b):
        return lambda: bk.bpr_sweep_sampled(p, q, delta, cost, padded, counts, keys[0], n_items,
                                            LR, REG, n_tries, bits=b)

    sweep_ms = {"rows": [], "bits": []}
    for side in ("rows", "bits", "bits", "rows"):
        sweep_ms[side].append(median_ms(sweep(bits if side == "bits" else None), 50))
    for side in ("bits", "rows"):
        s_bound = bound(user_bytes + row_bytes + sweep_sample[side] + n_users * 8 + 4, flops,
                        F32_FLOP_S, draw_ops(n_users, n_tries))
        timing[f"sweep_{side}"] = dict(
            ms=sweep_ms[side], queued_ms=queued_ms(sweep(bits if side == "bits" else None)),
            bound_ms=s_bound[0], bound_by=s_bound[1])
    timing["sweep_bits"].update(
        plain_ms=median_ms(lambda: bk.bpr_sweep_sampled_plain(
            p, q, delta, cost, padded, counts, keys[0], n_items, LR, REG, n_tries, bits=bits), 5),
        library_ms=None, words_read=step_words)
    result["timing"] = timing
    result["card"] = smi
    for side, row in timing.items():
        what = "bpr_sweep_sampled" if side.startswith("sweep") else f"bpr_epoch, {n_steps} steps"
        log(f"  time {what} ({side.removeprefix('sweep_')}): " + json.dumps(row))
    del p, q, init, q_epoch, delta, bits, padded, counts
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17 in {result['seconds']:.1f} s ({smi})")
    check(result["seconds"] <= BITSET_PHASE_S,
          f"phase 17 took {result['seconds']:.1f} s of its {BITSET_PHASE_S} s")
    return result


def bitset_gate(train, cap: int, widest: int, bits) -> str:
    """Which rejection ``BPR.fit`` takes on ``train`` and the inputs of the
    reference's gate (``rejection_bitset``) that chose it."""
    rows_mb = train.count_users() * widest * 4 / 1e6
    bits_mb = train.count_users() * -(-train.count_items() // 32) * 4 / 1e6
    return (f"{'bitset' if bits is not None else 'rows'} (rejection_bitset: history cap {cap}, "
            f"widest {widest}, the padded rows {rows_mb:.1f} MB, the bitset {bits_mb:.1f} MB)")


def time_powerlaw_epoch(train, cap: int, dev) -> dict:
    """K1 at the quality gate's shape: one epoch from the fit's init against
    the padded rows (the fit's route here) and against the full-set bitset.
    Where the cap does not bind the rows are the full sets, so both reject
    the same candidates: every step's pairs equal. CUDA-event medians in
    turns (rows, bits, bits, rows), beside the epoch's bound by the rule."""
    import torch

    from gorse_tpu_torch.models import BPR, Params
    from gorse_tpu_torch.models import bpr as bpr_model
    from gorse_tpu_torch.ops import bpr_kernel as bk
    from gorse_tpu_torch.ops import sampling

    csr = train.padded_user_positives(max_len=cap, seed=0)
    padded = torch.as_tensor(csr.padded, device=dev)
    counts = torch.as_tensor(csr.counts, device=dev)
    bits = torch.from_numpy(train.positives_bitset().view(np.int32)).to(dev)
    n_users, n_items, k = train.count_users(), train.count_items(), POWERLAW_BPR["n_factors"]
    n_active = max(int((csr.counts > 0).sum()), 1)
    n_steps = max(round(train.count_feedback() / n_active), 1)
    n_tries = bpr_model.adaptive_neg_tries(float(np.mean(csr.counts)) / n_items)
    lr, reg = POWERLAW_BPR["lr"], POWERLAW_BPR["reg"]
    init = BPR(Params(POWERLAW_BPR), device=dev)
    init.init(train, seed=0)
    p, q = init.user_factors, init.item_factors
    keys = sampling.raw_step_keys(sampling.prng_key(18), n_steps)
    pairs = {}
    for side, b in (("rows", None), ("bits", bits)):
        pairs[side] = torch.empty((2, n_steps, n_users), dtype=torch.int32, device=dev)
        bk.bpr_epoch(p, q.clone(), torch.zeros_like(q), torch.zeros((1,), device=dev), padded,
                     counts, keys, n_items, lr, reg, n_tries, pairs=pairs[side], bits=b)
    same = bool(torch.equal(pairs["rows"], pairs["bits"]))
    check(same or cap < int(csr.counts.max()),
          "phase 18: at cap = widest the bitset must reject as the rows do (pairs differ)")
    q_epoch = q.clone()
    times = {"rows": [], "bits": []}
    for side in ("rows", "bits", "bits", "rows"):
        b = bits if side == "bits" else None
        times[side].append(median_ms(lambda: bk.bpr_epoch_fused(
            p, q_epoch, padded, counts, keys, n_items, lr, reg, mm_dtype=torch.float32,
            n_tries=n_tries, bits=b), 5))
    rows_read = int(counts.sum()) * 4 + n_users * 4
    rule = bound(2 * n_users * k * 4 + 2 * q.numel() * 4 + rows_read + n_steps * 8 + 4,
                 n_steps * n_active * 16 * k, F32_FLOP_S, n_steps * draw_ops(n_users, n_tries))
    out = {"n_steps": n_steps, "n_tries": n_tries, "widest": int(csr.counts.max()),
           "pairs_equal": same, "rows_ms": times["rows"], "bits_ms": times["bits"],
           "bound_ms": rule[0], "bound_by": rule[1]}
    log(f"  K1 at this shape, {n_steps} steps an epoch (CUDA events, in turns): against the rows "
        f"{times['rows']} ms, against the bitset {times['bits']} ms; pairs equal: {same}; "
        f"bound {rule[0]:.4f} ms ({rule[1]})")
    return out


def phase_powerlaw(dev, smi: str) -> dict:
    """Phase 18: the reference's ml-1m-scale quality gate on the card, BPR
    through ``bpr_epoch`` and eALS, each model's ``evaluate_model`` held
    against the same factors on the CPU."""
    import logging

    import torch

    from gorse_tpu_torch.data.loaders import synthetic_cf_powerlaw
    from gorse_tpu_torch.models import ALS, BPR, FitConfig, Params, evaluate_model
    from gorse_tpu_torch.models import bpr as bpr_model
    from gorse_tpu_torch.ops import bpr_kernel as bk

    t_phase = time.perf_counter()
    data = synthetic_cf_powerlaw(seed=POWERLAW_SEED)
    gen_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    train, test = data.split_cf(seed=0)
    split_s = time.perf_counter() - t0
    cap, widest = bpr_model.history_cap(train)
    bits = bpr_model.rejection_bitset(train, cap, widest)
    gate = bitset_gate(train, cap, widest, bits)
    result = {"users": train.count_users(), "items": train.count_items(),
              "ratings": data.count_feedback(), "train_feedback": train.count_feedback(),
              "generator_s": gen_s, "split_s": split_s, "cap": cap, "widest": widest,
              "bitset": bits is not None, "gate": gate}
    log(f"  synthetic_cf_powerlaw(seed={POWERLAW_SEED}): {result['users']} users, "
        f"{result['items']} items, {result['ratings']} ratings in {gen_s:.2f} s on the host; "
        f"split_cf in {split_s:.2f} s; negatives rejected against the {gate}")
    del bits

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    fit_logger = logging.getLogger(bpr_model.__name__)
    fit_logger.addHandler(handler)
    level = fit_logger.level
    fit_logger.setLevel(logging.INFO)
    fits = {}
    try:
        for name, cls, params, verbose in (("bpr", BPR, POWERLAW_BPR, 10),
                                           ("als", ALS, POWERLAW_ALS, 5)):
            model = cls(Params(params), device=dev)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            score = model.fit(train, test, FitConfig(verbose=verbose, patience=0))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            fits[name] = dict(model=model, ndcg=score.ndcg, fit_s=fit_s,
                              epoch_s=getattr(model, "epoch_seconds", None),
                              launches={n: getattr(bk, n).launches for n in BPR_KERNELS},
                              bits_launches=bk.bpr_epoch.bits_launches)
    finally:
        fit_logger.removeHandler(handler)
        fit_logger.setLevel(level)
    # evaluate_model on the card's factors and on their copy on the CPU
    for name, fit in fits.items():
        model = fit.pop("model")
        cpu = type(model)(Params(POWERLAW_BPR if name == "bpr" else POWERLAW_ALS), device="cpu")
        cpu.user_factors, cpu.item_factors = model.user_factors.cpu(), model.item_factors.cpu()
        on_card, on_cpu = evaluate_model(model, test, train), evaluate_model(cpu, test, train)
        fit.update(evaluate_card=on_card, evaluate_cpu=on_cpu,
                   evaluate_max_diff=max(abs(on_card[m] - on_cpu[m]) for m in on_cpu))
        del model, cpu
    bpr, als = fits["bpr"], fits["als"]
    said = [r.getMessage() for r in records if "full positive sets" in r.getMessage()]
    result.update(bpr=bpr, als=als, ndcg_diff=bpr["ndcg"] - als["ndcg"], fit_log=said)
    log(f"  NDCG@10 BPR {bpr['ndcg']:.4f} ({bpr['fit_s']:.2f} s, {json.dumps(bpr['launches'])}, "
        f"{bpr['bits_launches']} with the bitset), eALS {als['ndcg']:.4f} ({als['fit_s']:.2f} s); "
        f"difference {result['ndcg_diff']:+.4f}; gate {POWERLAW_NDCG} (with the counter "
        f"sampler and torch-generator inits the card read BPR 0.6059, eALS 0.6016)")
    log(f"  evaluate_model card against CPU: BPR {bpr['evaluate_max_diff']:.3g}, eALS "
        f"{als['evaluate_max_diff']:.3g} (tolerance {POWERLAW_EVAL_TOL}); on the card BPR "
        f"{json.dumps(bpr['evaluate_card'])}, eALS {json.dumps(als['evaluate_card'])}")

    epochs = POWERLAW_BPR["n_epochs"]
    want = dict(bpr_sweep_sampled=0, bpr_sweep_pairs=0, bpr_epoch=epochs)
    check(bpr["launches"] == want, f"phase 18 BPR fit: {bpr['launches']} launches, want {want}")
    check(bpr["bits_launches"] == (epochs if result["bitset"] else 0),
          f"phase 18 BPR fit: {bpr['bits_launches']} launches with the bitset ({gate})")
    check(len(said) == result["bitset"], f"phase 18 BPR fit: the gate's log lines {said}")
    check(als["launches"] == dict.fromkeys(BPR_KERNELS, 0), "phase 18 eALS fit: no BPR kernel")
    for name, fit in fits.items():
        check(fit["ndcg"] >= POWERLAW_NDCG,
              f"phase 18 {name}: NDCG@10 {fit['ndcg']:.4f} < {POWERLAW_NDCG}")
        check(fit["evaluate_max_diff"] <= POWERLAW_EVAL_TOL,
              f"phase 18 {name}: evaluate_model on the card {fit['evaluate_card']} against the "
              f"CPU {fit['evaluate_cpu']}")
    result["k1"] = time_powerlaw_epoch(train, cap, dev)
    torch.cuda.empty_cache()
    result["card"] = smi
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18 in {result['seconds']:.1f} s ({smi})")
    check(result["seconds"] <= POWERLAW_PHASE_S,
          f"phase 18 took {result['seconds']:.1f} s of its {POWERLAW_PHASE_S} s")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run after phase 1 (default: all); "
                             "a partial run prints its numbers and no result line")
    parser.add_argument("--hold-inits", type=int, default=HOLD_INITS,
                        help="inits and keys at which phase 12 holds the user-sharded epoch")
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

    if "4" in phases or "5" in phases or "12" in phases:
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
        if "bpr_timings" in out:
            k1 = out["bpr_timings"]["bpr_epoch"]
            log(f"  K1, an epoch of {k1['n_steps']} steps at {TRAIN_USERS} x {TRAIN_ITEMS} "
                f"drawing the one-device sampler: {k1['ms']:.4f} ms, queued "
                f"{k1['queued_ms']:.4f} ms (with the counter sampler's draws an H100 read "
                f"1.292-1.341 ms, queued 1.132-1.161) ({smi})")

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
    if "10" in phases:
        log("== phase 10: the in-one node from config.toml.example")
        out["in_one"] = phase_in_one(dev, smi, args.seed,
                                     {"load_steps": out.get("ctr", {}).get("load_steps"),
                                      "path": out.get("path")})
        log("  in_one: " + json.dumps(out["in_one"], default=str))
    if "11" in phases:
        log("== phase 11: the master, server and worker as processes on the card")
        out["cluster"] = phase_cluster(dev, smi, args.seed, {"in_one": out.get("in_one")})
        log("  cluster: " + json.dumps(out["cluster"], default=str))
    if "12" in phases:
        log(f"== phase 12: sharded training on {SHARDS} shards of the card")
        out["sharded"] = phase_sharded(train, test, csr, dev, smi, args.seed, out.get("training"),
                                       args.hold_inits)
        log("  sharded: " + json.dumps(out["sharded"], default=str))
    if "4" in phases or "5" in phases or "12" in phases:
        del train, test, csr
    if "13" in phases:
        log("== phase 13: the approximate tier, external sources, the bench and the CLI")
        out["approx"] = phase_approx(dev, smi, args.seed, {"path": out.get("path")})
    if "14" in phases:
        log("== phase 14: the in-one node over the remote stores")
        out["remote"] = phase_remote(dev, smi, args.seed, {"in_one": out.get("in_one")})
        log("  remote: " + json.dumps(out["remote"], default=str))
    if "15" in phases:
        log("== phase 15: the gRPC plane: the nodes on the master's proxy over mutual TLS")
        out["grpc"] = phase_grpc(dev, smi, args.seed)
        log("  grpc: " + json.dumps(out["grpc"], default=str))
    if "16" in phases:
        log("== phase 16: the rest of the surface: LLM ranking, chat item-to-item, dump and "
            "restore, OIDC, the mock servers")
        out["surface"] = phase_surface(dev, smi, args.seed)
        log("  surface: " + json.dumps(out["surface"], default=str))
    if "17" in phases:
        log("== phase 17: full-set negative rejection in the single-card fit")
        out["bitset"] = phase_bitset(dev, smi)
        log("  bitset: " + json.dumps(out["bitset"], default=str))
    if "18" in phases:
        log("== phase 18: the reference's ml-1m-scale quality gate")
        out["powerlaw"] = phase_powerlaw(dev, smi)
        log("  powerlaw: " + json.dumps(out["powerlaw"], default=str))
    check(not {"jax", "gorse_tpu", "grpc", "google.protobuf", "jinja2", "msgpack",
                "cryptography"} & set(sys.modules),
          "neither JAX, grpc, protobuf, jinja2, msgpack, cryptography nor gorse_tpu was imported")
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

    def row(name, source, replaces, launches, err, timing, **extra):
        return {"name": name, "route": "cuda", "source": f"gorse_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                **{key: timing[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")}, **extra}

    # the serving path's launches (phase 3) with the fm worker's recall
    # (phase 9), the in-one node's cycles (phases 10 and 14) and the card
    # worker that phase 11 runs beside the worker process
    in_one = out["in_one"]["launches"]
    cluster = out["cluster"]["launches"]
    approx = out["approx"]
    remote = out["remote"]["launches"]  # the cycle over the remote stores (phase 14)
    grpc = out["grpc"]  # the worker and master processes on the proxy (phase 15)
    surface = out["surface"]["launches"]  # the LLM, restored and mongodb:// paths (phase 16)
    kernels = [row(name, "topk.cu", REPLACES[name],
                   path["launches"][name] + out["ctr"]["worker_topk_launches"][name]
                   + in_one[name] + cluster[name] + remote[name] + grpc["launches"][name]
                   + surface[name] + approx["worker"]["launches"].get(name, 0),
                   out["errors"][name], rows[name])
               for name in KERNELS]
    # the training path's launches of bpr_epoch (phase 5) with the in-one
    # nodes' fits and BPR search trials (phases 10 and 14); the sweeps' from their
    # own paths (phase 4), K3's with the sharded fits (phase 12). No single PyTorch call computes a sweep or an
    # epoch, so library_ms is null.
    bpr_launches = dict(out["training"]["launches"], **out["path_launches"])
    bpr_launches["bpr_epoch"] += (in_one["bpr_epoch"] + remote["bpr_epoch"]
                                  + grpc["master_launches"]["bpr_epoch"] + surface["bpr_epoch"])
    # K3 on the sharded path: phase 12's epoch and the sharded master's fit
    bpr_launches["bpr_sweep_pairs"] += out["sharded"]["launches"]["bpr_sweep_pairs"]
    # the single-card fit with the full-set bitset (phase 17): its launches
    # count with bpr_epoch's, and the row carries the variant's own numbers
    # at 120k x 4k (median of its timings in turns, its bounds)
    bitset = out["bitset"]
    bpr_launches["bpr_epoch"] += bitset["launches"]["bpr_epoch"]
    # the quality gate's BPR fit (phase 18), one launch an epoch
    bpr_launches["bpr_epoch"] += out["powerlaw"]["bpr"]["launches"]["bpr_epoch"]

    def with_bits(kernel: str, side: str, launches: int) -> dict:
        t = bitset["timing"]
        return {"bits": {
            "launches": launches, "max_abs_err": bitset["errors"][kernel],
            "ms": statistics.median(t[side]["ms"]), "plain_ms": t[side]["plain_ms"],
            "bound_ms": t[side]["bound_ms"], "bound_by": t[side]["bound_by"],
            "library_ms": None,
            "rows_ms": statistics.median(t[side.replace("bits", "rows")]["ms"]),
        }}

    # K2's bitset launches are phase 17's holds and timings only: no path
    # of the system launches the sampled sweep on its own
    extra = {"bpr_epoch": with_bits("bpr_epoch", "bits", bitset["bits_launches"]),
             "bpr_sweep_sampled": with_bits("bpr_sweep_sampled", "sweep_bits", 0)}
    kernels += [row(name, "bpr.cu", BPR_REPLACES[name], bpr_launches[name],
                    out["bpr_errors"][name], out["bpr_timings"][name], **extra.get(name, {}))
                for name in BPR_KERNELS]
    # the SQ kernels: launches from the store path (phase 7b), times at the
    # 1M x 64 dot shape (phase 7a)
    kernels += [row(name, "topk.cu", SQ_REPLACES[name], out["store"]["launches"][name],
                    out["sq_errors"][name], out["sq_timings"]["dot"][name]) for name in SQ_KERNELS]
    # the approximate tier: bin_max's launches from the worker at index_recall
    # 0.99 (phase 13b), timed at its fetch; bin_max_sq's from sq_topk_approx,
    # its entry point, timed at k = 10 (phase 13a)
    tier = approx["tier"]
    timed_bf16 = next(r for r in tier["bf16"]
                      if r["k"] == tier["fetch"] and r["target"] == APPROX_RECALL)
    timed_sq = next(r for r in tier["sq"] if r["metric"] == "dot" and r["target"] == APPROX_RECALL)
    kernels += [
        row("bin_max", "topk.cu", APPROX_REPLACES["bin_max"],
            approx["worker"]["launches"]["bin_max"],
            max(r["max_abs_err"] for r in tier["bf16"]), timed_bf16),
        row("bin_max_sq", "topk.cu", APPROX_REPLACES["bin_max_sq"],
            tier["sq_launches"]["bin_max_sq"], max(r["max_abs_err"] for r in tier["sq"]), timed_sq),
    ]
    log("  K6 routes (ms old -> new, library, candidates new): " + json.dumps({
        shape: [r["old"]["ms"], r["new"]["ms"], r["new"]["library_ms"], r["new"]["candidates"]]
        for shape, r in out["routes"].items()}))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
