"""Worker node: the offline per-user recommendation pipeline (port of
gorse_tpu/serve/worker.py).

Each worker owns a shard of users (rendezvous hashing over the live worker
set), pulls the CF index and the CTR model from the blob store by id, and
materializes the ``collaborative`` and ``recommend`` cache collections per
user, with staleness checks and replacement. The collaborative top-k of the
whole shard goes through ``MatrixFactorizationIndex.search_users`` in
256-user chunks on the card. Ranking: ``ranker.type = "none"`` sorts the
candidates by score; ``fm`` scores every (user, candidate) row of the shard
with the AFM in one ``batch_predict`` on the card (sorted by score when no
model is fitted yet); ``llm`` raises (ROADMAP.md, M21).
"""

from __future__ import annotations

import hashlib
import logging
import time

from ..logics.cf import MatrixFactorizationIndex
from ..logics.item_to_item import _flatten_labels
from ..logics.recommend import Recommender
from ..models.fm import AFM
from ..storage import cache as ck
from ..storage.blob import BlobStore
from ..storage.cache import CacheStore, key
from ..storage.data import DataStore
from ..storage.types import Score
from ..utils.config import Config
from ..utils.expression import match_any
from ..utils.gcpause import gc_paused
from ..utils.sizeof import deep_size
from .item_cache import ItemCache
from .metrics import MetricsRegistry
from .progress import ProgressTracker

logger = logging.getLogger(__name__)


def rendezvous_owner(user_id: str, nodes: list[str]) -> str | None:
    """Highest-random-weight owner of ``user_id`` among ``nodes``."""
    if not nodes:
        return None
    return max(
        nodes,
        key=lambda n: hashlib.md5(f"{n}\x00{user_id}".encode()).digest(),
    )


class Worker:
    def __init__(
        self,
        config: Config,
        data_store: DataStore,
        cache_store: CacheStore,
        blob_store: BlobStore,
        node_id: str = "worker-0",
        device=None,
    ) -> None:
        self.config = config
        self.data = data_store
        self.cache = cache_store
        self.blob = blob_store
        self.node_id = node_id
        self.device = device  # None: the card, resolved when the index loads
        self.progress = ProgressTracker()
        self.metrics = MetricsRegistry(namespace="gorse")
        self._step_labels: set[str] = set()  # step gauges written so far
        self.cf_index: MatrixFactorizationIndex | None = None
        self.cf_model_id = ""
        self.ctr_model: AFM | None = None
        self.ctr_model_id = ""
        self.items = ItemCache(data_store)

    # ------------------------------------------------------------- syncing

    def pull_models(self, cf_model_id: str, ctr_model_id: str = "") -> None:
        """Pull new model artifacts by id."""
        if cf_model_id and cf_model_id != self.cf_model_id and self.blob.exists(cf_model_id):
            self.cf_index = MatrixFactorizationIndex.load(
                self.blob.open(cf_model_id), device=self.device
            )
            self.cf_model_id = cf_model_id
            logger.info("pulled CF model %s", cf_model_id)
        if ctr_model_id and ctr_model_id != self.ctr_model_id and self.blob.exists(ctr_model_id):
            self.ctr_model = AFM.load(self.blob.open(ctr_model_id), device=self.device)
            self.ctr_model_id = ctr_model_id
            logger.info("pulled CTR model %s", ctr_model_id)

    def pull_users(self, peers: list[str]) -> list[str]:
        """My shard of users."""
        peers = peers or [self.node_id]
        return [
            u.user_id
            for u in self.data.get_users()
            if rendezvous_owner(u.user_id, peers) == self.node_id
        ]

    # ------------------------------------------------------------ pipeline

    def needs_update(self, user_id: str) -> bool:
        """Staleness check, clause for clause as the reference: (1) empty
        cache is stale; (2) missing/mismatched digest is stale; (3) missing
        update time is stale; (4) older than recommend.cache_expire is
        stale; (5) a user inactive since the last update is re-checked
        against ranker.cache_expire; an active-since-update user is stale."""
        if not self.cache.search_scores(ck.RECOMMEND, user_id):
            return True
        digest = self.cache.get(key(ck.RECOMMEND_DIGEST, user_id))
        if not digest or digest != self._active_digest():
            return True
        raw_update = self.cache.get(key(ck.LAST_UPDATE_USER_RECOMMEND_TIME, user_id))
        if not raw_update:
            return True
        last_update = float(raw_update)
        now = time.time()
        if now - last_update > self.config.recommend.cache_expire * 3600.0:
            return True
        last_modified = float(self.cache.get(key(ck.LAST_MODIFY_USER_TIME, user_id)) or 0)
        if last_modified < last_update:
            return now - last_update > self.config.recommend.ranker.cache_expire * 3600.0
        return True

    def is_active(self, user_id: str) -> bool:
        """Skip long-inactive users (recommend.active_user_ttl days)."""
        ttl_days = self.config.recommend.active_user_ttl
        if ttl_days <= 0:
            return True
        fb = self.data.get_user_feedback(user_id)
        if not fb:
            return False
        newest = max(f.timestamp for f in fb)
        return (time.time() - newest) <= ttl_days * 86400

    def _active_digest(self) -> str:
        """Config digest gating recomputation; model ids are deliberately
        not part of it, as in the reference."""
        return self.config.recommend.hash()

    def recommend(self, user_ids: list[str], force: bool = False) -> int:
        """Materialize recommendations for users. Returns the number of
        users refreshed."""
        cfg = self.config.recommend
        todo = [
            u for u in user_ids if force or (self.is_active(u) and self.needs_update(u))
        ]
        if not todo:
            self.metrics.gauge_set("worker_update_user_recommend_total", 0)
            self.metrics.gauge_set("worker_offline_recommend_total_seconds", 0.0)
            for step in self._step_labels:
                self.metrics.gauge_set(
                    "worker_offline_recommend_step_seconds", 0.0, labels={"step": step}
                )
            return 0
        self.items.clear()  # fresh metadata per pipeline run
        t_total = time.perf_counter()
        step_timings: dict[str, float] = {}
        with self.progress.span("recommend", total=len(todo)) as span:
            # STEP 1: collaborative scores for the whole shard on the card
            t_cf = time.perf_counter()
            if self.cf_index is not None:
                exclude = [
                    [fb.item_id for fb in self.data.get_user_feedback(u)] for u in todo
                ]
                cf_results = self.cf_index.search_users(todo, cfg.cache_size, exclude=exclude)
                run_ts = time.time()
                for user_id, scores in zip(todo, cf_results):
                    if scores:
                        for s in scores:
                            s.timestamp = run_ts
                        self.cache.add_scores(ck.COLLABORATIVE, user_id, scores)
                        # drop rows from older models / dropped items
                        self.cache.delete_scores(
                            ck.COLLABORATIVE, [user_id], before=run_ts
                        )
                        self.cache.set(
                            key(ck.COLLABORATIVE_DIGEST, user_id), self.cf_model_id
                        )
            step_timings["collaborative_recommend"] = time.perf_counter() - t_cf
            # STEP 2: per-user candidate assembly via the recommender chain;
            # replacement items join the candidate set before ranking
            candidates: dict[str, list[Score]] = {}
            replacement_sets: dict[str, tuple[set, set]] = {}
            for user_id in todo:
                recommender = Recommender(
                    cfg, self.cache, self.data, online=False, user_id=user_id
                )
                chain = cfg.ranker.recommenders or ["collaborative"]
                scores, _ = recommender.recommend_sequential(
                    [], cfg.cache_size, chain, timings=step_timings
                )
                scores, pos, neg = self._add_replacement_candidates(scores, recommender)
                candidates[user_id] = scores
                replacement_sets[user_id] = (pos, neg)
            # STEP 3: ranking
            t_rank = time.perf_counter()
            ranked = self._rank(candidates)
            step_timings["ranking"] = time.perf_counter() - t_rank
            now = time.time()
            for user_id, scores in ranked.items():
                scores = self._apply_replacement_decay(scores, *replacement_sets[user_id])
                ranked[user_id] = scores
                for s in scores:
                    s.timestamp = now
                self.cache.add_scores(ck.RECOMMEND, user_id, scores)
                self.cache.set(key(ck.RECOMMEND_DIGEST, user_id), self._active_digest())
                self.cache.set(key(ck.LAST_UPDATE_USER_RECOMMEND_TIME, user_id), str(now))
                # prune stale entries from previous runs
                self.cache.delete_scores(ck.RECOMMEND, [user_id], before=now)
                span.add(1)
        g = self.metrics.gauge_set
        g("worker_update_user_recommend_total", len(todo))
        g("worker_offline_recommend_total_seconds", time.perf_counter() - t_total)
        for step in self._step_labels - set(step_timings):
            step_timings[step] = 0.0  # steps skipped this run read as zero
        self._step_labels |= set(step_timings)
        for step, seconds in step_timings.items():
            g("worker_offline_recommend_step_seconds", seconds, labels={"step": step})
        # memory accounting at most once a minute: a deep walk of the item
        # cache is slow in Python
        now = time.perf_counter()
        last_t, last_v = getattr(self, "_sizeof_cache", (-1e9, 0))
        if now - last_t > 60.0:
            last_v = deep_size(self.items)
            self._sizeof_cache = (now, last_v)
        g("worker_memory_inuse_bytes", last_v, labels={"data": "item_cache"})
        return len(todo)

    def _add_replacement_candidates(
        self, scores: list[Score], recommender: Recommender
    ) -> tuple[list[Score], set, set]:
        """Re-insert consumed items as unscored candidates before ranking.
        Returns (candidates, positive item ids, read-only item ids)."""
        cfg = self.config.recommend
        if not cfg.replacement.enable_replacement:
            return scores, set(), set()
        positive: set[str] = set()
        distinct: set[str] = set()
        for fb in recommender.user_feedback:
            if match_any(cfg.data_source.positive_feedback_types, fb.feedback_type, fb.value):
                positive.add(fb.item_id)
                distinct.add(fb.item_id)
            elif match_any(cfg.data_source.read_feedback_types, fb.feedback_type, fb.value):
                distinct.add(fb.item_id)
        if not distinct:
            return scores, set(), set()
        existing = {s.id for s in scores}
        out = list(scores)
        present: set[str] = set()
        self.items.prefetch(sorted(distinct))
        for item_id in sorted(distinct):
            item = self.items.get(item_id)
            if item is None or item.is_hidden:
                continue
            present.add(item_id)
            if item_id in existing:
                continue
            out.append(Score(id=item_id, score=0.0, categories=item.categories))
            existing.add(item_id)
        return out, positive & present, (distinct - positive) & present

    def _apply_replacement_decay(
        self, results: list[Score], positive: set, negative: set
    ) -> list[Score]:
        """Decay the ranked scores of replacement items, then resort."""
        if not positive and not negative:
            return results
        cfg = self.config.recommend.replacement
        out = []
        changed = False
        for s in results:
            if s.id in positive:
                s = Score(s.id, s.score * cfg.positive_replacement_decay, s.categories, s.timestamp)
                changed = True
            elif s.id in negative:
                s = Score(s.id, s.score * cfg.read_replacement_decay, s.categories, s.timestamp)
                changed = True
            out.append(s)
        if changed:
            out.sort(key=lambda s: -s.score)
        return out

    def _rank(self, candidates: dict[str, list[Score]]) -> dict[str, list[Score]]:
        """Rank each user's candidates, best first (a stable sort). ``fm``
        with a fitted model: every (user, candidate) row of the shard in one
        ``batch_predict`` on the model's device, each row the user, the
        user's labels, the item and the item's labels in the model's index;
        otherwise the candidates' own scores."""
        cfg = self.config.recommend
        if cfg.ranker.type == "llm":
            raise NotImplementedError(
                "ranker.type 'llm': the LLM reranker is not ported yet (ROADMAP.md, M21)"
            )
        if cfg.ranker.type != "fm" or self.ctr_model is None or not self.ctr_model.is_fitted():
            return {u: sorted(s, key=lambda x: -x.score) for u, s in candidates.items()}
        with gc_paused():
            return self._rank_fm(candidates)

    def _rank_fm(self, candidates: dict[str, list[Score]]) -> dict[str, list[Score]]:
        rows = []
        owners = []
        index = self.ctr_model.index
        # one metadata fetch for the whole shard's candidates
        self.items.prefetch([s.id for scores in candidates.values() for s in scores])
        # an item's features are the same wherever it appears, and candidates
        # repeat across a shard's users: encode each once a pass, and each
        # user's features once, outside the candidate loop
        item_feats: dict[str, tuple[list[int], list[float]]] = {}
        for user_id, scores in candidates.items():
            user = self.data.get_user(user_id)
            u_idx: list[int] = []
            u_enc = index.encode_user(user_id)
            if u_enc >= 0:
                u_idx.append(u_enc)
            if user is not None:
                u_idx += [enc for label in _flatten_labels(user.labels)
                          if (enc := index.encode_user_label(label)) >= 0]
            u_val = [1.0] * len(u_idx)
            for s in scores:
                feat = item_feats.get(s.id)
                if feat is None:
                    f_idx: list[int] = []
                    i_enc = index.encode_item(s.id)
                    if i_enc >= 0:
                        f_idx.append(i_enc)
                    item = self.items.get(s.id)
                    if item is not None:
                        f_idx += [enc for label in _flatten_labels(item.labels)
                                  if (enc := index.encode_item_label(label)) >= 0]
                    feat = (f_idx, [1.0] * len(f_idx))
                    item_feats[s.id] = feat
                rows.append((u_idx + feat[0], u_val + feat[1]))
                owners.append((user_id, s))
        if not rows:
            return candidates
        preds = self.ctr_model.batch_predict(rows)
        ranked: dict[str, list[Score]] = {u: [] for u in candidates}
        for (user_id, s), p in zip(owners, preds.tolist()):
            ranked[user_id].append(Score(s.id, p, s.categories, s.timestamp))
        return {u: sorted(s, key=lambda x: -x.score) for u, s in ranked.items()}

    # ------------------------------------------------------------ main loop

    def sync_and_recommend(self, meta: dict) -> int:
        """One worker cycle against a master's meta dict (``cf_model_id``,
        ``ctr_model_id``, ``workers``)."""
        self.pull_models(meta["cf_model_id"], meta.get("ctr_model_id", ""))
        peers = meta.get("workers") or [self.node_id]
        users = self.pull_users(peers)
        return self.recommend(users)
