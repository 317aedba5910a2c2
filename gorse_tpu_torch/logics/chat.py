"""LLM-backed recommenders: chat item-to-item and the rerankers (port of
gorse_tpu/logics/chat.py).

gorse's logics/chat.go (the ChatReranker over a reranker HTTP API) and its
chat item-to-item engine (logics/item_to_item.go:383-531): a prompt
rendered per item, a chat completion, the queries parsed from it, their
embeddings, and the nearest items to them. Prompts render through the
port's template engine (utils/template.py), the reference's jinja2 subset
with ``ChainableUndefined``. The neighbour search is the exact
``embedding_query`` (ops/similarity.py) on the engine's device, one call
for every item's queries at once; each query row is the reference's
per-item call.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import urllib.request

import numpy as np

from ..llm.client import OpenAIClient, parse_array_from_completion, strip_think
from ..ops.similarity import embedding_query
from ..storage.types import Item, Score, User
from ..utils import template
from .item_to_item import EmbeddingItemToItem, ItemToItemConfig

logger = logging.getLogger(__name__)


class ChatItemToItem(EmbeddingItemToItem):
    """LLM-generated-query similarity (reference: chatItemToItem). Without
    an enabled client it is the ``embedding`` type: the master builds it
    without one (gorse_tpu/serve/master.py:443-447), so its cache equals the
    embedding type's."""

    def __init__(
        self,
        cfg: ItemToItemConfig,
        n: int,
        timestamp: float | None = None,
        openai_client: OpenAIClient | None = None,
        prompt: str = "",
        device=None,
    ) -> None:
        super().__init__(cfg, n, timestamp, device)
        self.client = openai_client
        self.template = template.from_string(
            prompt or getattr(cfg, "prompt", "") or "{{ item.item_id }}")

    def pop_all(self):
        if self.client is None or not self.client.enabled() or not self.items:
            return super().pop_all()
        corpus = np.stack(self.vectors)
        dim = corpus.shape[1]
        k = min(self.n, len(self.items))
        # each item's query vectors, degraded to no neighbours where its
        # completion or an embedding fails, as the reference does
        queries: list[np.ndarray | None] = []
        for item in self.items:
            prompt = self.template.render(item=item)
            try:
                completion = self.client.chat_completion(prompt)
            except Exception as e:  # one item's failure leaves the others
                logger.error("chat completion failed for %s: %s", item.item_id, e)
                queries.append(None)
                continue
            texts = parse_array_from_completion(completion)
            if not texts:
                queries.append(None)
                continue
            try:
                vecs = np.stack([np.asarray(self.client.embedding(q)[:dim], dtype=np.float32)
                                 for q in texts])
            except Exception as e:  # one item's failure leaves the others
                logger.error("embedding failed for %s: %s", item.item_id, e)
                queries.append(None)
                continue
            if vecs.shape[1] < dim:
                vecs = np.pad(vecs, ((0, 0), (0, dim - vecs.shape[1])))
            queries.append(vecs)
        live = [q for q in queries if q is not None]
        if live:
            dists, idxs = embedding_query(np.concatenate(live), corpus, k_top=k,
                                          device=self.device)
            dists, idxs = dists.cpu().numpy(), idxs.cpu().numpy()
        out, first = [], 0
        for row, (item, vecs) in enumerate(zip(self.items, queries)):
            if vecs is None:
                out.append((item.item_id, []))
                continue
            # across the item's queries: each neighbour's smallest distance
            best: dict[int, float] = {}
            for qi in range(first, first + len(vecs)):
                for d, j in zip(dists[qi], idxs[qi]):
                    j = int(j)
                    if j == row:
                        continue
                    if j not in best or d < best[j]:
                        best[j] = float(d)
            first += len(vecs)
            ranked = sorted(best.items(), key=lambda kv: kv[1])[: self.n]
            out.append((item.item_id, [
                # 1/(1+distance), reference item_to_item.go:526
                Score(id=self.items[j].item_id, score=1.0 / (1.0 + d),
                      categories=self.items[j].categories, timestamp=self.timestamp)
                for j, d in ranked
            ]))
        return out


@dataclasses.dataclass
class RerankResult:
    index: int
    relevance_score: float


class RerankerClient:
    """HTTP reranker API client (reference: common/reranker/client.go):
    POST {model, query, documents} -> {results: [{index, relevance_score}]}."""

    def __init__(self, url: str, auth_token: str = "", model: str = "", timeout: float = 30.0) -> None:
        self.url = url
        self.auth_token = auth_token
        self.model = model
        self.timeout = timeout

    def rerank(self, query: str, documents: list[str]) -> list[RerankResult]:
        payload = json.dumps(
            {"model": self.model, "query": query, "documents": documents}
        ).encode()
        req = urllib.request.Request(
            self.url,
            data=payload,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.auth_token}",
            },
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read().decode())
        return [
            RerankResult(index=r["index"], relevance_score=float(r["relevance_score"]))
            for r in data.get("results", [])
        ]


class ChatReranker:
    """Rerank candidates with a reranker API (reference: logics/chat.go:39-108)
    using query and document templates."""

    def __init__(self, client: RerankerClient, query_template: str, doc_template: str) -> None:
        self.client = client
        self.query_template = template.from_string(query_template)
        self.doc_template = template.from_string(doc_template)

    def rank(self, user: User | None, feedback: list[tuple[str, Item]], items: list[Item]) -> list[Score]:
        query = self.query_template.render(user=user, feedback=feedback)
        documents = [self.doc_template.render(item=item) for item in items]
        results = self.client.rerank(query, documents)
        return [
            Score(
                id=items[r.index].item_id,
                score=r.relevance_score,
                categories=items[r.index].categories,
            )
            for r in results
            if 0 <= r.index < len(items)
        ]


class LLMReranker:
    """Chat-completion reranker (the worker's ranker.type == "llm" path,
    worker/pipeline.go:472-540 composed with a prompt instead of a reranker
    API): render user profile + history + candidates into one prompt, ask
    the model for a ranked JSON array of item ids."""

    DEFAULT_PROMPT = (
        "You are a recommender. The user {{ user.user_id }} recently liked:\n"
        "{% for fb in feedback %}- {{ fb[1].item_id }} {{ fb[1].comment }}\n{% endfor %}"
        "Rank the following candidate items for this user, best first. "
        "Respond with ONLY a JSON array of item ids.\n"
        "{% for item in items %}- {{ item.item_id }} {{ item.comment }}\n{% endfor %}"
    )

    def __init__(self, client: OpenAIClient, prompt: str = "") -> None:
        self.client = client
        self.template = template.from_string(prompt or self.DEFAULT_PROMPT)

    def rank(
        self,
        user: User | None,
        feedback: list[tuple[str, Item]],
        candidates: list[Score],
        items: dict[str, Item],
    ) -> list[Score]:
        item_objs = [items.get(s.id) or Item(item_id=s.id) for s in candidates]
        prompt = self.template.render(user=user, feedback=feedback, items=item_objs)
        try:
            completion = self.client.chat_completion(prompt)
        except Exception as e:  # the candidates stay in their order
            logger.error("LLM rerank failed: %s", e)
            return candidates
        ranked_ids = parse_array_from_completion(strip_think(completion))
        by_id = {s.id: s for s in candidates}
        out: list[Score] = []
        for rank, item_id in enumerate(ranked_ids):
            s = by_id.pop(item_id, None)
            if s is not None:
                out.append(Score(s.id, float(len(ranked_ids) - rank), s.categories, s.timestamp))
        # unranked leftovers keep their relative order below every LLM-ranked
        # item: lists are served from a score-ordered cache
        for i, s in enumerate(by_id.values()):
            out.append(Score(s.id, float(-1 - i), s.categories, s.timestamp))
        return out
