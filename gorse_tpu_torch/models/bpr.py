"""BPR, Bayesian Personalized Ranking (port of gorse_tpu/models/bpr.py).

Each epoch is ``n_steps`` dense-over-users sweeps: every active user draws
one (positive, negative) pair and takes the pairwise SGD update, items take
the sum of their updates at the end of the sweep. On the card an epoch is
one launch of the CUDA kernel ``bpr_epoch`` (ops/bpr_kernel.py: each step
the sampled sweep and the fold of its item deltas), whatever the catalog
size: its cost scales with the active users. On the CPU the same function
runs its plain version, a loop of sweeps and folds. With a mesh of more
than one shard (``FitConfig.mesh``) an epoch is the user-sharded epoch of
parallel/sharded.py (the explicit-pairs sweep, K3, once a shard and step),
or with ``shard_table`` the catalog-sharded one of parallel/catalog.py, as
the reference's fit branches.

Kept from the reference because they decide the outputs: the init (its
``jax.random.normal`` draws, :mod:`..ops.prng`), the history cap
(:func:`history_cap`), the rejection depth (:func:`adaptive_neg_tries`),
``n_steps = max(round(nnz / n_active), 1)``, the per-fit random subset of
capped histories, the key stream (``PRNGKey(seed + 1)``, split per epoch,
split into step keys), the samplers, the evaluation cadence, early stopping
and checkpoints. Dropped as TPU tuning: the 128-lane item packing and the
VMEM crossovers between the resident, fused and XLA epochs.

The samplers are the reference's. The fit on one card (no mesh, or a mesh
of one shard) draws the reference's one-device sampler
(:func:`_sample_pairs`, ``jax.random.randint`` under each step key, inside
``bpr_epoch``), so from the same seed it takes the pairs of the reference's
one-device fit, draw for draw; the sharded epochs draw the counter sampler
of the reference's sharded epoch (``sampling.sample_pairs``), as the
reference's do.

Negatives are rejected as the reference rejects them. The fit on one card
holds each candidate against the user's whole positive set, a bitset
(``Dataset.positives_bitset``), under the reference's gate
(gorse_tpu/models/bpr.py:398-409, :func:`rejection_bitset`): the history cap
binds and the bitset takes at most 64 MiB. Otherwise, and in the sharded
epochs, against the capped padded rows, as the reference does. The gate's
constants decide which negatives are drawn, so they are the reference's,
not tuned for the card.

One difference from the reference, by design: the sweep computes in f32
(``mm_dtype`` f32), as the reference's XLA and sharded epochs do; the bf16
rounding of the TPU kernels is a kernel option
(``mm_dtype=torch.bfloat16``) that the fit does not take.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from ..data.dataset import Dataset
from ..ops import sampling
from ..ops.bpr_kernel import bpr_epoch_fused
from .base import MatrixFactorization, Score, build_eval_candidates, evaluate_mf
from .params import INIT_MEAN, INIT_STDDEV, LR, N_EPOCHS, N_FACTORS, REG, FitConfig, Params

logger = logging.getLogger(__name__)


def history_cap(train) -> tuple[int, int]:
    """(cap, widest) history width of the padded positives: the widest
    history when the padded matrix stays within 96 MB, else the p99 width
    (at least 64)."""
    lengths = [len(fb) for fb in train.user_feedback if fb]
    widest = max(lengths) if lengths else 1
    if train.count_users() * widest * 4 <= 96 * 1024 * 1024:
        return max(widest, 1), widest
    return max(int(np.percentile(lengths, 99)), 64), widest


# the most bytes the full-set rejection bitset may take (the reference's 64 MiB)
BITSET_MAX_BYTES = 64 * 1024 * 1024


def rejection_bitset(train, cap: int, widest: int, mesh=None) -> np.ndarray | None:
    """The full-set rejection bitset the fit's epochs take, or None: built
    only for a fit on one card (``mesh`` None or of one shard) whose history
    cap binds (``cap < widest``) and whose ``[U, ceil(I/32)]`` uint32 words
    take at most :data:`BITSET_MAX_BYTES`, the reference's gate."""
    words = -(-train.count_items() // 32)
    if ((mesh is None or mesh.size == 1) and cap < widest
            and train.count_users() * words * 4 <= BITSET_MAX_BYTES):
        return train.positives_bitset()
    return None


def adaptive_neg_tries(mean_density: float, eps: float = 1e-4) -> int:
    """Rejection depth K with density**K <= eps, clamped to [2, 8]."""
    d = min(max(mean_density, 1e-6), 0.9)
    return min(max(math.ceil(math.log(eps) / math.log(d)), 2), 8)


def bpr_apply_pairs(p, q, pos, neg, active, lr: float, reg: float):
    """One sweep given explicit pairs, by the rule of the reference's XLA
    epoch (gorse_tpu/models/bpr.py:107-133): ``diff = sum(p * (qi - qj))``,
    every user reads the same q, repeated item rows add up. ``active`` is
    ``[U, 1]`` bool. Returns ``(p, q, cost)``, both tables new."""
    qi, qj = q[pos.long()], q[neg.long()]
    diff = (p * (qi - qj)).sum(dim=-1)
    cost = torch.where(active[:, 0], torch.nn.functional.softplus(-diff), 0.0).sum()
    grad = torch.where(active, torch.sigmoid(-diff)[:, None], 0.0)
    d_qi = torch.where(active, lr * (grad * p - reg * qi), 0.0)
    d_qj = torch.where(active, lr * (-grad * p - reg * qj), 0.0)
    d_pu = torch.where(active, lr * (grad * (qi - qj) - reg * p), 0.0)
    q = q.index_add(0, pos.long(), d_qi).index_add(0, neg.long(), d_qj)
    return p + d_pu, q, cost


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BPR(MatrixFactorization):
    """BPR matrix factorization with the reference's hyper-parameters and
    defaults."""

    name = "bpr"

    def __init__(self, params: Params | dict | None = None, device=None) -> None:
        super().__init__(params, device)
        p = self.params
        self.n_factors = p.get_int(N_FACTORS, 16)
        self.n_epochs = p.get_int(N_EPOCHS, 100)
        self.lr = p.get_float(LR, 0.05)
        self.reg = p.get_float(REG, 0.01)
        self.init_mean = p.get_float(INIT_MEAN, 0.0)
        self.init_stddev = p.get_float(INIT_STDDEV, 0.001)
        self.epoch_seconds: list[float] = []  # wall time of each epoch of the last fit

    def fit(self, train: Dataset, test: Dataset, config: FitConfig | None = None) -> Score:
        config = config or FitConfig()
        self.init(train, seed=config.seed)
        cap, widest = history_cap(train)
        csr = train.padded_user_positives(max_len=cap, seed=config.seed)
        bits = rejection_bitset(train, cap, widest, config.mesh)
        if bits is not None:
            logger.info("fit bpr: negatives rejected against the full positive sets (bitset "
                        "%d x %d words, %.1f MB; history cap %d < widest %d)",
                        bits.shape[0], bits.shape[1], bits.nbytes / 1e6, cap, widest)
        n_items = train.count_items()
        n_active = max(int(np.sum(csr.counts > 0)), 1)
        # each step visits every user once: nnz pairwise updates per epoch
        n_steps = max(round(train.count_feedback() / n_active), 1)
        n_tries = adaptive_neg_tries(float(np.mean(csr.counts)) / max(n_items, 1))
        eval_cands = build_eval_candidates(test, train, config.candidates)

        key = sampling.prng_key(config.seed + 1)
        metrics = evaluate_mf(self.user_factors, self.item_factors, *eval_cands, config.top_k)
        history = [(0, metrics["NDCG"])]
        logger.info("fit bpr 0/%d NDCG@%d=%.4f", self.n_epochs, config.top_k, metrics["NDCG"])

        run, p, q, rows, dense, devices = self._epochs(config, csr, n_steps, n_items, n_tries,
                                                       bits)
        self.epoch_seconds = []
        for epoch in range(1, self.n_epochs + 1):
            t0 = time.perf_counter()
            key, epoch_key = sampling.split(key)
            p, q, cost = run(p, q, *rows, epoch_key)
            for d in devices:
                _synchronize(d)
            self.epoch_seconds.append(time.perf_counter() - t0)
            if (config.verbose and epoch % config.verbose == 0) or epoch == self.n_epochs:
                cost = float(cost)
                p_eval, q_eval = dense(p, q)
                metrics = evaluate_mf(p_eval, q_eval, *eval_cands, config.top_k)
                history.append((epoch, metrics["NDCG"]))
                if config.checkpoint_dir:
                    np.savez(
                        f"{config.checkpoint_dir}/bpr_epoch_{epoch}.npz",
                        user_factors=p_eval.cpu().numpy(),
                        item_factors=q_eval.cpu().numpy(),
                        epoch=epoch,
                        ndcg=metrics["NDCG"],
                    )
                logger.info(
                    "fit bpr %d/%d fit=%.2fs cost=%.1f NDCG@%d=%.4f P@%d=%.4f R@%d=%.4f",
                    epoch, self.n_epochs, self.epoch_seconds[-1], cost,
                    config.top_k, metrics["NDCG"], config.top_k,
                    metrics["Precision"], config.top_k, metrics["Recall"],
                )
                if config.patience > 0 and epoch > config.patience:
                    best_epoch = max(history, key=lambda t: t[1])[0]
                    if best_epoch <= epoch - config.patience:
                        logger.info("early stopping at epoch %d (best %d)", epoch, best_epoch)
                        break
        p, q = dense(p, q)
        self.user_factors, self.item_factors = p, q
        metrics = evaluate_mf(p, q, *eval_cands, config.top_k)
        return Score(ndcg=metrics["NDCG"], precision=metrics["Precision"], recall=metrics["Recall"])

    def _epochs(self, config: FitConfig, csr, n_steps: int, n_items: int, n_tries: int,
                bits: np.ndarray | None = None):
        """The fit's epoch and its state: ``(run, p, q, rows, dense,
        devices)``, ``run(p, q, *rows, epoch_key) -> (p, q, cost)``,
        ``dense(p, q)`` the factor tables on the model's device, ``devices``
        the ones an epoch runs on. A mesh of more than one shard takes the
        user-sharded epoch (K3 a shard and step, the counter sampler's
        pairs), with ``shard_table`` the catalog-sharded one (its drops in
        ``catalog_drop_count``); otherwise one ``bpr_epoch`` launch (K1) an
        epoch on the model's device, drawing the reference's one-device
        sampler and rejecting against ``bits`` (:func:`rejection_bitset`)
        when given."""
        dev, mesh = self.device, config.mesh
        p, q = self.user_factors, self.item_factors
        n_users = p.shape[0]
        self.catalog_drop_count = None
        if mesh is None or mesh.size == 1:
            # the uint32 words' bits as int32, the type the kernel takes
            bits_t = None if bits is None else torch.from_numpy(bits.view(np.int32)).to(dev)

            def run(p, q, padded_pos, pos_counts, epoch_key):
                return bpr_epoch_fused(
                    p, q, padded_pos, pos_counts, sampling.raw_step_keys(epoch_key, n_steps),
                    n_items, self.lr, self.reg, mm_dtype=torch.float32, n_tries=n_tries,
                    bits=bits_t)

            rows = (torch.as_tensor(csr.padded, device=dev), torch.as_tensor(csr.counts, device=dev))
            return run, p, q, rows, lambda p, q: (p, q), [dev]

        def users(p):
            return mesh.all_gather(p)[0][:n_users].to(dev)

        devices = list(dict.fromkeys([dev, *mesh.devices]))
        if config.shard_table:
            from ..parallel.catalog import (
                make_catalog_sharded_bpr_epoch,
                shard_catalog_bpr_inputs,
                unpack_catalog,
            )

            catalog_epoch = make_catalog_sharded_bpr_epoch(
                mesh, n_steps, n_items, self.lr, self.reg, n_tries)

            def run(*args):
                p, q, stats = catalog_epoch(*args)
                self.catalog_drop_count = stats[1]
                return p, q, stats[0]

            p, q, *rows, _, _ = shard_catalog_bpr_inputs(mesh, p, q, csr.padded, csr.counts)
            return run, p, q, rows, lambda p, q: (users(p), torch.from_numpy(unpack_catalog(
                mesh.all_gather(q)[0], n_items, mesh.size)).to(dev)), devices

        from ..parallel.sharded import make_sharded_bpr_epoch, shard_bpr_inputs

        # bounded staleness: the item deltas summed every sync_every steps,
        # n_steps rounded up to a multiple of it
        sync_every = max(int(config.sync_every), 1)
        n_steps = -(-n_steps // sync_every) * sync_every
        run = make_sharded_bpr_epoch(mesh, n_steps, n_items, self.lr, self.reg, n_tries,
                                     sync_every)
        p, q, *rows, _ = shard_bpr_inputs(mesh, p, q, csr.padded, csr.counts)
        return run, p, q, rows, lambda p, q: (users(p), q[0].to(dev)), devices
