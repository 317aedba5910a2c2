"""eALS, element-wise weighted ALS for implicit feedback (port of
gorse_tpu/models/als.py).

Weight 1 on observed entries and ``alpha`` on every missing one (He et al.
2016). Each half-epoch solves every row's weighted ridge system exactly,

    p_u = [(1-a) * Sum_{i in R_u} q_i q_i^T + a * S + reg*I]^{-1} * Sum_{i in R_u} q_i

(and symmetrically for items), where S is the Gram matrix of the fixed
side over its rows that have feedback. Rows go in blocks of ``solve_block``
(256): the block's fixed-side rows are gathered into ``[block, w, k]``, the
block's ``k x k`` systems are factored by a batched
``torch.linalg.cholesky_ex`` and solved by ``torch.cholesky_solve``. No block
waits on the host: every block's ``info`` is gathered and checked once a
half-epoch, and a factorization that failed raises (no retry, no CPU solve).

Layout: each block is padded (-1) to its own widest row, where the
reference pads every row to the widest of the whole side. Pad entries are
masked to zero either way, so the arithmetic is the same; the gather of a
block holds ``block x w x k`` floats for that block's ``w`` only.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..data.dataset import Dataset
from .base import MatrixFactorization, Score, build_eval_candidates, evaluate_mf
from .params import ALPHA, INIT_MEAN, INIT_STDDEV, N_EPOCHS, N_FACTORS, REG, FitConfig, Params

logger = logging.getLogger(__name__)


def _als_solve_rows(
    other_factors: torch.Tensor,  # [M, k] fixed side
    fb_blocks,  # [block, w] int32 ids into the fixed side, pad -1, one a block
    alpha: float,
    reg: float,
    gram: torch.Tensor | None = None,  # optional precomputed [k, k] masked gram
    other_mask: torch.Tensor | None = None,  # [M] 1.0 where the fixed row HAS feedback
) -> torch.Tensor:
    """One half-epoch: the exact weighted ridge solve of every row, the
    blocks' rows concatenated (``[sum of block rows, k]``).

    The alpha-weighted Gram S sums only the fixed-side rows that have
    feedback when ``other_mask`` is given (or a pre-masked ``gram``);
    ``None`` keeps the unmasked Gram, for dense corpora where every row has
    feedback. Raises when a block's Cholesky factorization failed."""
    k = other_factors.shape[1]
    dev, dt = other_factors.device, other_factors.dtype
    if gram is None:
        masked = other_factors if other_mask is None else other_factors * other_mask[:, None].to(dt)
        gram = masked.T @ masked  # [k, k] = S
    eye = torch.eye(k, dtype=dt, device=dev)
    out, infos = [], []
    for fb in fb_blocks:
        mask = (fb >= 0).to(dt)[..., None]  # [b, w, 1]
        q = other_factors[fb.clamp_min(0).long()] * mask  # [b, w, k]
        a = (1.0 - alpha) * (q.transpose(1, 2) @ q)
        a = a + alpha * gram + reg * eye
        chol, info = torch.linalg.cholesky_ex(a)
        out.append(torch.cholesky_solve(q.sum(dim=1)[..., None], chol)[..., 0])
        infos.append(info)
    if not out:
        return other_factors.new_zeros((0, k))
    failed = int(torch.count_nonzero(torch.cat(infos)))
    if failed:
        raise RuntimeError(f"eALS: the Cholesky factorization failed for {failed} rows")
    return torch.cat(out)


def _has_feedback_mask(ragged: list[list[int]], device) -> torch.Tensor:
    """[n_rows] f32 mask: 1.0 where the row's feedback list is non-empty."""
    return torch.as_tensor(np.fromiter((len(r) > 0 for r in ragged), np.float32, len(ragged)),
                           device=device)


def _pad_rows(x: np.ndarray, multiple: int, fill) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)], axis=0)


def padded_blocks(ragged: list[list[int]], block: int, device) -> list[torch.Tensor]:
    """The rows of ``ragged`` in blocks of ``block`` rows, each ``[block, w]``
    int32 with ``w`` the block's widest row (at least 1), pad -1; the last
    block's missing rows are all -1."""
    blocks = []
    for lo in range(0, len(ragged), block):
        rows = ragged[lo : lo + block]
        out = np.full((len(rows), max(max(len(r) for r in rows), 1)), -1, np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        blocks.append(torch.as_tensor(_pad_rows(out, block, -1), device=device))
    return blocks


class ALS(MatrixFactorization):
    """eALS matrix factorization with the reference's hyper-parameters and
    defaults; ``alpha`` is the missing-entry weight."""

    name = "als"

    def __init__(self, params: Params | dict | None = None, device=None) -> None:
        super().__init__(params, device)
        p = self.params
        self.n_factors = p.get_int(N_FACTORS, 16)
        self.n_epochs = p.get_int(N_EPOCHS, 50)
        self.reg = p.get_float(REG, 0.06)
        self.init_mean = p.get_float(INIT_MEAN, 0.0)
        self.init_stddev = p.get_float(INIT_STDDEV, 0.1)
        self.alpha = p.get_float(ALPHA, 0.001)
        self.block = p.get_int("solve_block", 256)

    def epoch_inputs(self, train: Dataset) -> tuple:
        """Both sides' padded blocks and Gram masks (feedback-less rows stay
        out of the alpha term), on the model's device."""
        dev = self.device
        block = min(self.block, max(train.count_users(), 1), max(train.count_items(), 1))
        return (
            padded_blocks(train.user_feedback, block, dev),
            padded_blocks(train.item_feedback, block, dev),
            _has_feedback_mask(train.user_feedback, dev),
            _has_feedback_mask(train.item_feedback, dev),
        )

    def epoch(self, p: torch.Tensor, q: torch.Tensor, inputs: tuple):
        """One epoch from :meth:`epoch_inputs`: the user half, then the item
        half. Returns the new (p, q)."""
        user_fb, item_fb, user_mask, item_mask = inputs
        p = _als_solve_rows(q, user_fb, self.alpha, self.reg, other_mask=item_mask)[: p.shape[0]]
        q = _als_solve_rows(p, item_fb, self.alpha, self.reg, other_mask=user_mask)[: q.shape[0]]
        return p, q

    def fit(self, train: Dataset, test: Dataset, config: FitConfig | None = None) -> Score:
        config = config or FitConfig()
        self.init(train, seed=config.seed)
        eval_cands = build_eval_candidates(test, train, config.candidates)
        inputs = self.epoch_inputs(train)
        p, q = self.user_factors, self.item_factors
        metrics = evaluate_mf(p, q, *eval_cands, config.top_k)
        history = [(0, metrics["NDCG"])]
        logger.info("fit als 0/%d NDCG@%d=%.4f", self.n_epochs, config.top_k, metrics["NDCG"])
        for epoch in range(1, self.n_epochs + 1):
            t0 = time.perf_counter()
            p, q = self.epoch(p, q, inputs)
            if (config.verbose and epoch % config.verbose == 0) or epoch == self.n_epochs:
                metrics = evaluate_mf(p, q, *eval_cands, config.top_k)
                history.append((epoch, metrics["NDCG"]))
                logger.info(
                    "fit als %d/%d fit=%.2fs NDCG@%d=%.4f P@%d=%.4f R@%d=%.4f",
                    epoch, self.n_epochs, time.perf_counter() - t0,
                    config.top_k, metrics["NDCG"], config.top_k,
                    metrics["Precision"], config.top_k, metrics["Recall"],
                )
                if config.patience > 0 and epoch > config.patience:
                    best_epoch = max(history, key=lambda t: t[1])[0]
                    if best_epoch <= epoch - config.patience:
                        logger.info("early stopping at epoch %d (best %d)", epoch, best_epoch)
                        break
        self.user_factors, self.item_factors = p, q
        metrics = evaluate_mf(p, q, *eval_cands, config.top_k)
        return Score(ndcg=metrics["NDCG"], precision=metrics["Precision"], recall=metrics["Recall"])
