"""Ranking metrics over sampled candidates (port of ``rank_metrics`` in
gorse_tpu/ops/metrics.py): scores [U, M] -> top-k -> relevance ->
NDCG/Precision/Recall/HR/MAP/MRR, averaged over users with a test positive.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def rank_metrics(
    scores: torch.Tensor,  # [U, M] candidate scores
    is_target: torch.Tensor,  # [U, M] bool, True on a test positive
    valid: torch.Tensor,  # [U, M] bool, False on padding candidates
    top_k: int = 10,
) -> dict[str, torch.Tensor]:
    """All six metrics at ``top_k`` as 0-d f32 tensors. The top-k takes the
    lower candidate index first among equal scores, as ``lax.top_k`` does:
    a stable descending sort."""
    masked = torch.where(valid, scores, NEG_INF)
    top_idx = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :top_k]
    rel = torch.gather(is_target.to(torch.float32), 1, top_idx)  # [U, K]
    top_valid = torch.gather(valid, 1, top_idx)
    rel = torch.where(top_valid, rel, 0.0)

    n_targets = (is_target & valid).sum(dim=1)  # [U]
    has_target = n_targets > 0
    denom_users = torch.clamp(has_target.sum(), min=1)

    ranks = torch.arange(top_k, dtype=torch.float32, device=scores.device)
    discounts = 1.0 / torch.log2(ranks + 2.0)  # [K]

    dcg = (rel * discounts).sum(dim=1)
    ideal_hits = torch.clamp(n_targets, max=top_k)
    idcg_table = torch.cat([torch.zeros(1, device=scores.device), torch.cumsum(discounts, 0)])
    idcg = idcg_table[ideal_hits]
    ndcg = torch.where(has_target, dcg / torch.clamp(idcg, min=1e-12), 0.0)

    hits = rel.sum(dim=1)
    precision = hits / top_k
    recall = torch.where(has_target, hits / torch.clamp(n_targets, min=1), 0.0)
    hr = (hits > 0).to(torch.float32)

    cum_hits = torch.cumsum(rel, dim=1)
    ap = (rel * cum_hits / (ranks + 1.0)).sum(dim=1)
    map_ = torch.where(has_target, ap / torch.clamp(n_targets, min=1), 0.0)

    first_hit = torch.argmax(rel, dim=1)  # first maximum; masked by hr
    mrr = hr * (1.0 / (first_hit.to(torch.float32) + 1.0))

    def avg(x):
        return torch.where(has_target, x, 0.0).sum() / denom_users

    return {
        "NDCG": avg(ndcg),
        "Precision": avg(torch.where(has_target, precision, 0.0)),
        "Recall": avg(recall),
        "HR": avg(hr),
        "MAP": avg(map_),
        "MRR": avg(mrr),
    }
