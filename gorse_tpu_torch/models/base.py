"""Matrix-factorization base model and sampled-candidate evaluation (port of
gorse_tpu/models/base.py).

Factors are f32 tensors on the model's device. ``save``/``load`` use the
reference's files (``factors.npz`` + ``meta.json``), so a model saved by
either package loads in the other. ``init`` draws the reference's
``jax.random.normal`` factors from ``seed`` (:mod:`..ops.prng`: equal to
jax's in about 99 entries of 100, the rest within 3 ulps), or takes given
factors as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import Dataset
from ..data.dict import FreqDict
from ..ops.metrics import rank_metrics
from ..ops.prng import normal, prng_key, split
from .params import Params


@dataclasses.dataclass
class Score:
    """Fit result."""

    ndcg: float
    precision: float
    recall: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MatrixFactorization:
    """User/item factor tables, dictionaries and predictability masks.
    Subclasses implement ``fit`` and set n_factors/init_mean/init_stddev."""

    name = "base"

    def __init__(self, params: Params | dict | None = None, device=None) -> None:
        self.params = Params(params or {})
        self.device = resolve_device(device)
        self.user_factors: torch.Tensor | None = None  # [U, k] f32
        self.item_factors: torch.Tensor | None = None  # [I, k] f32
        self.user_index = None
        self.item_index = None
        # users/items without training feedback keep their init factors and
        # are never served
        self.user_predictable: np.ndarray | None = None
        self.item_predictable: np.ndarray | None = None

    def init(self, train: Dataset, seed: int = 0, factors=None) -> None:
        """Gaussian factors as the reference draws them (``k1, k2 =
        split(PRNGKey(seed))``, users ``init_mean + init_stddev *
        normal(k1, (U, k))``, items the same from ``k2``; drawn on the host,
        so a fit on the card and one on the CPU start equal), or ``factors
        = (user [U, k], item [I, k])`` as given; then the dictionaries and
        predictability masks of ``train``."""
        n_users, n_items, k = train.count_users(), train.count_items(), self.n_factors
        if factors is None:
            k1, k2 = split(prng_key(seed))
            user = self.init_mean + self.init_stddev * normal(k1, (n_users, k))
            item = self.init_mean + self.init_stddev * normal(k2, (n_items, k))
        else:
            user, item = (torch.tensor(np.asarray(f, np.float32)) for f in factors)
            if user.shape != (n_users, k) or item.shape != (n_items, k):
                raise ValueError(f"factors {tuple(user.shape)}, {tuple(item.shape)}: need "
                                 f"({n_users}, {k}) and ({n_items}, {k})")
        self.user_factors = user.to(self.device, torch.float32).contiguous()
        self.item_factors = item.to(self.device, torch.float32).contiguous()
        self.user_index = train.user_dict
        self.item_index = train.item_dict
        self.user_predictable = np.fromiter(
            (len(fb) > 0 for fb in train.user_feedback), bool, n_users
        )
        self.item_predictable = np.fromiter(
            (len(fb) > 0 for fb in train.item_feedback), bool, n_items
        )

    # ------------------------------------------------------------ prediction

    def predict(self, user_indices, item_indices) -> torch.Tensor:
        """Dot-product predictions for (user, item) index pairs."""
        pu = self.user_factors[torch.as_tensor(user_indices, device=self.device).long()]
        qi = self.item_factors[torch.as_tensor(item_indices, device=self.device).long()]
        return (pu * qi).sum(dim=-1)

    def is_fitted(self) -> bool:
        return self.user_factors is not None

    # ------------------------------------------------------------- serialize

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays = {
            "user_factors": self.user_factors.cpu().numpy(),
            "item_factors": self.item_factors.cpu().numpy(),
        }
        if self.user_predictable is not None:
            arrays["user_predictable"] = self.user_predictable
            arrays["item_predictable"] = self.item_predictable
        np.savez(path / "factors.npz", **arrays)
        meta = {"name": self.name, "params": dict(self.params)}
        if self.user_index is not None:
            meta["user_index"] = self.user_index.to_dict()
            meta["item_index"] = self.item_index.to_dict()
        (path / "meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path, device=None) -> "MatrixFactorization":
        from .registry import create_mf_model

        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        model = create_mf_model(meta["name"], Params(meta["params"]), device=device)
        with np.load(path / "factors.npz") as arrays:
            model.user_factors = torch.as_tensor(arrays["user_factors"], device=model.device)
            model.item_factors = torch.as_tensor(arrays["item_factors"], device=model.device)
            if "user_predictable" in arrays:
                model.user_predictable = arrays["user_predictable"]
                model.item_predictable = arrays["item_predictable"]
        if "user_index" in meta:
            model.user_index = FreqDict.from_dict(meta["user_index"])
            model.item_index = FreqDict.from_dict(meta["item_index"])
        return model


def build_eval_candidates(
    test: Dataset, train: Dataset, n_candidates: int = 100, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(candidates [U, Tmax+C] int32, is_target, valid): per user its test
    positives first (padded), then ``n_candidates`` sampled negatives
    excluding train and test positives."""
    negatives = test.sample_user_negatives(train, n_candidates, seed=seed)
    n_cand = negatives.shape[1]
    n_users = test.count_users()
    t_max = max((len(fb) for fb in test.user_feedback), default=1) or 1
    m = t_max + n_cand
    candidates = np.zeros((n_users, m), dtype=np.int32)
    is_target = np.zeros((n_users, m), dtype=bool)
    valid = np.zeros((n_users, m), dtype=bool)
    for u in range(n_users):
        fb = test.user_feedback[u]
        t = len(fb)
        if t:
            candidates[u, :t] = fb
            is_target[u, :t] = True
            valid[u, :t] = True
            negs = negatives[u]
            candidates[u, t_max:] = np.maximum(negs, 0)
            valid[u, t_max:] = negs >= 0
    return candidates, is_target, valid


def evaluate_mf(
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    candidates: np.ndarray,
    is_target: np.ndarray,
    valid: np.ndarray,
    top_k: int = 10,
) -> dict[str, float]:
    """Sampled-candidate evaluation on the factors' device, then
    :func:`rank_metrics`. A candidate's score is its k products summed in
    factor order, each product and each sum rounded by an op of its own: the
    card and the CPU give the same bits, where a reduction's order (which
    differs between them) can swap two candidates a unit in the last place
    apart."""
    dev = user_factors.device
    cand = torch.as_tensor(candidates, device=dev).long()
    items_t = item_factors.t()  # [k, I]: column j of the items
    scores = torch.zeros(cand.shape, device=dev)
    for j in range(item_factors.shape[1]):
        scores += user_factors[:, j, None] * items_t[j][cand]
    out = rank_metrics(scores, torch.as_tensor(is_target, device=dev),
                       torch.as_tensor(valid, device=dev), top_k=top_k)
    return {k: float(v) for k, v in out.items()}


def evaluate_model(
    model: MatrixFactorization,
    test: Dataset,
    train: Dataset,
    top_k: int = 10,
    n_candidates: int = 100,
) -> dict[str, float]:
    """A fitted model's sampled-candidate metrics (NDCG, Precision, Recall
    at ``top_k``) on ``test``, over ``n_candidates`` negatives a user drawn
    with seed 0, on the factors' device."""
    cands, is_target, valid = build_eval_candidates(test, train, n_candidates)
    return evaluate_mf(model.user_factors, model.item_factors, cands, is_target, valid, top_k)
