"""Ranking and classification metrics (port of gorse_tpu/ops/metrics.py).

``rank_metrics``: scores [U, M] over sampled candidates -> top-k ->
relevance -> NDCG/Precision/Recall/HR/MAP/MRR, averaged over users with a
test positive. ``auc`` and ``classification_metrics``: the CTR model's
AUC/Accuracy/Precision/Recall at threshold 0 on logits.
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


def auc(labels: torch.Tensor, predictions: torch.Tensor,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-based AUC, (sum of positive ranks - P(P+1)/2) / (P N), as a 0-d
    f32 tensor; 0.5 when a class is empty.

    Ties take their average rank, from two ``searchsorted`` passes (left
    and right) over the sorted scores: a double argsort would give tied
    scores distinct ranks in row order. Invalid entries are pushed to the
    bottom, below every valid one, and the positive ranks shifted down past
    them. Counts and rank sums are f32, as in the reference (an int32 rank
    sum overflows past about 46k positives)."""
    if valid is None:
        valid = torch.ones_like(labels, dtype=torch.bool)
    preds = torch.where(valid, predictions.to(torch.float32), NEG_INF)
    sorted_p = torch.sort(preds).values
    lo = torch.searchsorted(sorted_p, preds, side="left")
    hi = torch.searchsorted(sorted_p, preds, side="right")
    avg_rank = (lo + hi + 1).to(torch.float32) * 0.5  # 1-based average rank
    pos = (labels > 0.5) & valid
    n_pos = pos.sum().to(torch.float32)
    n_valid = valid.sum().to(torch.float32)
    n_neg = n_valid - n_pos
    n_invalid = float(preds.shape[0]) - n_valid
    sum_pos_ranks = torch.where(pos, avg_rank, 0.0).sum() - n_pos * n_invalid
    numer = sum_pos_ranks - n_pos * (n_pos + 1.0) * 0.5
    both = (n_pos > 0) & (n_neg > 0)
    return torch.where(both, numer / torch.where(both, n_pos * n_neg, 1.0),
                       torch.tensor(0.5, device=preds.device))


def classification_metrics(labels: torch.Tensor, logits: torch.Tensor,
                           valid: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Accuracy / Precision / Recall / AUC at threshold 0 on logits, each a
    0-d f32 tensor."""
    if valid is None:
        valid = torch.ones_like(labels, dtype=torch.bool)
    pred_pos = (logits > 0.0) & valid
    actual_pos = (labels > 0.5) & valid
    tp = (pred_pos & actual_pos).sum().to(torch.float32)
    n = torch.clamp(valid.sum(), min=1).to(torch.float32)
    correct = ((pred_pos == actual_pos) & valid).sum().to(torch.float32)
    return {
        "Accuracy": correct / n,
        "Precision": tp / torch.clamp(pred_pos.sum(), min=1).to(torch.float32),
        "Recall": tp / torch.clamp(actual_pos.sum(), min=1).to(torch.float32),
        "AUC": auc(labels, logits, valid),
    }
