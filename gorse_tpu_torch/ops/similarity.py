"""Item-to-item / user-to-user similarity as blocked matrix products (port of
gorse_tpu/ops/similarity.py).

The IDF set distance of two entities' label sets, with ``M`` the ``[N, L]``
0/1 incidence matrix and ``w`` the IDF weights:

    commonSum[i,j]   = M diag(w) M^T
    commonCount[i,j] = M M^T
    weightedSum[i]   = M w

    distance = 1 - commonSum*commonCount /
               (sqrt(wsum_i) * sqrt(wsum_j) * (commonCount + 100))

with the reference's special cases: identical sets -> 0, disjoint or empty
sets -> 1. Rows go in blocks of 256: a block's ``[B, N]`` distances, self
excluded, then a stable ascending sort, so among equal distances the lower
index comes first, as ``jax.lax.top_k(-dist)`` orders them. Embedding
similarity is exact top-k by Euclidean or cosine distance, in the same
blocks.

The products are f32 ``torch.matmul``. TF32 would round the IDF weights and
embeddings to 10 mantissa bits and reorder neighbours, so it must stay off
(PyTorch's default). No Pallas kernel lies under these ops: the same code
runs on the card and, with ``device="cpu"``, on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .topk import _f32, dot_topk_xla

SHRINKAGE = 100.0  # the reference's commonCount + 100
BIG = 1e30  # self and padding sentinel distance
BLOCK = 256  # rows a block


def incidence_matrix(ragged: list[list[int]], n_labels: int) -> np.ndarray:
    """Dense [N, L] 0/1 incidence matrix from ragged per-entity label lists."""
    out = np.zeros((len(ragged), n_labels), dtype=np.float32)
    lengths = [len(r) for r in ragged]
    if sum(lengths):
        rows = np.repeat(np.arange(len(ragged)), lengths)
        out[rows, np.concatenate([np.asarray(r, np.int64) for r in ragged])] = 1.0
    return out


def _make_dist_block(incidence: torch.Tensor, idf: torch.Tensor):
    """Closure computing one [B, N] block of the IDF set-distance matrix
    (without self-exclusion) from a [B, L] block of incidence rows."""
    weighted = incidence * idf[None, :]
    counts = incidence.sum(dim=1)
    sqrt_wsum = torch.sqrt(torch.clamp_min(incidence @ idf, 0.0))

    def fn(inc_blk: torch.Tensor) -> torch.Tensor:
        common_sum = inc_blk @ weighted.T  # [B, N]
        common_cnt = inc_blk @ incidence.T
        blk_counts = inc_blk.sum(dim=1)
        blk_wsum = torch.sqrt(torch.clamp_min(inc_blk @ idf, 0.0))
        denom = blk_wsum[:, None] * sqrt_wsum[None, :] * (common_cnt + SHRINKAGE)
        dist = 1.0 - common_sum * common_cnt / torch.clamp_min(denom, 1e-12)
        same = (
            (blk_counts[:, None] == counts[None, :])
            & (common_cnt == blk_counts[:, None])
            & (blk_counts[:, None] > 0)
        )
        dist = torch.where(same, 0.0, dist)
        return torch.where(common_cnt == 0, 1.0, dist)

    return fn


def _rows_topk(block_dist, n: int, k_top: int, block: int, dev):
    """``block_dist(lo, hi)`` -> ``[hi - lo, n]`` distances for every block of
    rows; each row's own column set to BIG, then its ``k_top`` smallest by a
    stable ascending sort. Returns (distances [n, k] f32, indices [n, k]
    int32)."""
    dists = [torch.zeros((0, k_top), device=dev)]
    idxs = [torch.zeros((0, k_top), dtype=torch.int32, device=dev)]
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        dist = block_dist(lo, hi)
        rows = torch.arange(hi - lo, device=dev)
        dist[rows, lo + rows] = BIG
        top = torch.sort(dist, dim=1, stable=True)
        dists.append(top.values[:, :k_top])
        idxs.append(top.indices[:, :k_top].to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)


def idf_neighbors(incidence, idf, k_top: int = 10, block: int = BLOCK, device=None):
    """Top-k nearest neighbours per row under the IDF-weighted set distance.

    Returns (distances [N, k], indices [N, k]) ascending, self excluded."""
    dev = resolve_device(device)
    inc = _f32(incidence, dev)
    fn = _make_dist_block(inc, _f32(idf, dev))
    return _rows_topk(lambda lo, hi: fn(inc[lo:hi]), inc.shape[0], k_top, block, dev)


def idf_neighbors_avg(inc1, idf1, inc2, idf2, k_top: int = 10, block: int = BLOCK,
                      device=None):
    """Top-k under the average of two IDF set distances (the ``auto``
    type): both halves are averaged for every pair of a block before the
    selection, and memory stays O(block * N)."""
    dev = resolve_device(device)
    inc1, inc2 = _f32(inc1, dev), _f32(inc2, dev)
    fn1, fn2 = _make_dist_block(inc1, _f32(idf1, dev)), _make_dist_block(inc2, _f32(idf2, dev))
    return _rows_topk(lambda lo, hi: (fn1(inc1[lo:hi]) + fn2(inc2[lo:hi])) / 2.0,
                      inc1.shape[0], k_top, block, dev)


def idf_distance_matrix(incidence, idf, device=None) -> torch.Tensor:
    """Full [N, N] IDF-weighted set-distance matrix (the formula and special
    cases of :func:`idf_neighbors`, without top-k or self-exclusion)."""
    dev = resolve_device(device)
    inc = _f32(incidence, dev)
    return _make_dist_block(inc, _f32(idf, dev))(inc)


def embedding_neighbors(embeddings, k_top: int = 10, metric: str = "euclidean", device=None):
    """Exact nearest neighbours by embedding distance (squared Euclidean or
    cosine). Returns (distances [N, k], indices [N, k]) ascending, self
    excluded."""
    dev = resolve_device(device)
    x = _f32(embeddings, dev)
    if metric == "cosine":
        x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)

        def block_dist(lo, hi):
            return 1.0 - x[lo:hi] @ x.T
    elif metric == "euclidean":
        sq = (x * x).sum(dim=1)

        def block_dist(lo, hi):
            return torch.clamp_min(sq[lo:hi, None] + sq[None, :] - 2.0 * (x[lo:hi] @ x.T), 0.0)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return _rows_topk(block_dist, x.shape[0], k_top, BLOCK, dev)


def embedding_query(queries, corpus, k_top: int = 10, metric: str = "euclidean", device=None):
    """Nearest corpus rows of external query vectors, through the f32
    top-k route (``dot_topk_xla``): cosine on normalised rows, Euclidean
    as the augmented product ``2 q.c - |c|^2``."""
    dev = resolve_device(device)
    q, c = _f32(queries, dev), _f32(corpus, dev)
    if metric == "cosine":
        qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-12)
        cn = c / torch.clamp_min(torch.linalg.vector_norm(c, dim=1, keepdim=True), 1e-12)
        s, i = dot_topk_xla(qn, cn, k_top, device=dev)
        return 1.0 - s, i
    sq = (c * c).sum(dim=1)
    aug_q = torch.cat([q, torch.ones((q.shape[0], 1), device=dev)], dim=1)
    aug_c = torch.cat([2.0 * c, -sq[:, None]], dim=1)
    s, i = dot_topk_xla(aug_q, aug_c, k_top, device=dev)
    qsq = (q * q).sum(dim=1, keepdim=True)
    return torch.clamp_min(qsq - s, 0.0), i
