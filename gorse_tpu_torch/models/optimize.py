"""Hyper-parameter search: random and TPE (copy of
gorse_tpu/models/optimize.py, numpy only).

A Tree-structured Parzen Estimator: observed trials split into good and bad
by the quantile ``gamma``, each side modelled by a Parzen (kernel-density)
estimator in the transformed (log) space, candidates sampled from the good
side and the one maximizing l(x)/g(x) taken. Its numpy generator and seed
are the reference's, so the same objective values give the same trials.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable

import numpy as np

from .params import Params

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SearchSpace:
    """Log-uniform or uniform range for one parameter."""

    low: float
    high: float
    log: bool = True
    integer: bool = False

    def sample(self, rng: np.random.Generator) -> float:
        if self.log:
            v = math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        else:
            v = rng.uniform(self.low, self.high)
        return int(round(v)) if self.integer else v

    def transform(self, v: float) -> float:
        return math.log(v) if self.log else v

    def inverse(self, t: float) -> float:
        v = math.exp(t) if self.log else t
        v = min(max(v, self.low), self.high)
        return int(round(v)) if self.integer else v


# Per-model suggest spaces (gorse's BPR, ALS and AFM SuggestParams)
BPR_SPACE = {
    "lr": SearchSpace(0.001, 0.1),
    "reg": SearchSpace(0.001, 0.1),
    "init_stddev": SearchSpace(0.001, 0.1),
}
ALS_SPACE = {
    "init_stddev": SearchSpace(0.001, 0.1),
    "reg": SearchSpace(0.001, 0.1),
    "alpha": SearchSpace(0.001, 0.1),
}
AFM_SPACE = {
    "lr": SearchSpace(0.001, 0.1),
    "reg": SearchSpace(0.001, 0.1),
    "init_stddev": SearchSpace(0.001, 0.1),
}


@dataclasses.dataclass
class Trial:
    params: Params
    value: float


class TPESampler:
    """Minimal TPE: good/bad Parzen estimators over transformed space."""

    def __init__(
        self,
        space: dict[str, SearchSpace],
        seed: int = 0,
        n_startup: int = 8,
        gamma: float = 0.25,
        n_ei_candidates: int = 24,
    ) -> None:
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_ei_candidates = n_ei_candidates

    def suggest(self, trials: list[Trial]) -> Params:
        if len(trials) < self.n_startup:
            return Params({k: s.sample(self.rng) for k, s in self.space.items()})
        # maximize: sort descending by value
        ordered = sorted(trials, key=lambda t: -t.value)
        n_good = max(1, int(self.gamma * len(ordered)))
        good, bad = ordered[:n_good], ordered[n_good:]
        out = Params()
        for k, s in self.space.items():
            good_t = np.asarray([s.transform(t.params[k]) for t in good])
            bad_t = np.asarray([s.transform(t.params[k]) for t in bad])
            width = (s.transform(s.high) - s.transform(s.low)) or 1.0
            bw_good = max(width / max(len(good_t), 1), 1e-3)
            bw_bad = max(width / max(len(bad_t), 1), 1e-3)
            # sample candidates from the good KDE, score by l/g
            centers = self.rng.choice(good_t, size=self.n_ei_candidates)
            cands = centers + self.rng.normal(0, bw_good, size=self.n_ei_candidates)
            lo, hi = s.transform(s.low), s.transform(s.high)
            cands = np.clip(cands, lo, hi)

            def kde(xs, centers, bw):
                d = (xs[:, None] - centers[None, :]) / bw
                return np.mean(np.exp(-0.5 * d * d), axis=1) / bw + 1e-12

            score = kde(cands, good_t, bw_good) / kde(cands, bad_t, bw_bad)
            out[k] = s.inverse(float(cands[int(np.argmax(score))]))
        return out


def model_search(
    objective: Callable[[Params], float],
    space: dict[str, SearchSpace],
    n_trials: int = 10,
    seed: int = 0,
    sampler: str = "tpe",
) -> tuple[Params, float, list[Trial]]:
    """Maximize ``objective`` over ``space``. Returns (best_params,
    best_value, trials)."""
    tpe = TPESampler(space, seed=seed)
    rng = np.random.default_rng(seed)
    trials: list[Trial] = []
    best: Trial | None = None
    for i in range(n_trials):
        if sampler == "tpe":
            params = tpe.suggest(trials)
        else:
            params = Params({k: s.sample(rng) for k, s in space.items()})
        value = float(objective(params))
        t = Trial(params=params, value=value)
        trials.append(t)
        if best is None or value > best.value:
            best = t
        logger.info("trial %d/%d value=%.4f params=%s (best=%.4f)", i + 1, n_trials, value, dict(params), best.value)
    if best is None:  # n_trials <= 0: search disabled — no-op, don't crash
        return Params({}), float("-inf"), trials
    return best.params, best.value, trials


def model_type_search(
    spaces: dict[str, dict[str, SearchSpace]],
    objective: Callable[[str, Params], float],
    n_trials: int = 10,
    seed: int = 0,
) -> tuple[str, Params, float, list[tuple[str, Trial]]]:
    """Joint search over model type (categorical) and per-type parameter
    spaces. The type is sampled TPE-style: proportional to its
    frequency among good trials (split by the same gamma quantile), with a
    +1 prior so unexplored types keep probability mass; parameters use each
    type's own TPESampler over that type's past trials.

    Returns (best_type, best_params, best_value, [(type, trial), ...]).
    """
    types = list(spaces)
    samplers = {t: TPESampler(spaces[t], seed=seed + i) for i, t in enumerate(types)}
    by_type: dict[str, list[Trial]] = {t: [] for t in types}
    all_trials: list[tuple[str, Trial]] = []
    rng = np.random.default_rng(seed)
    best: tuple[str, Trial] | None = None
    for i in range(n_trials):
        if len(all_trials) < len(types):
            mtype = types[i % len(types)]  # startup: visit each type once
        else:
            ranked = sorted(all_trials, key=lambda tt: -tt[1].value)
            n_good = max(1, int(round(0.25 * len(ranked))))
            good_counts = {t: 1.0 for t in types}
            for t, tr in ranked[:n_good]:
                good_counts[t] += 1.0
            total = sum(good_counts.values())
            mtype = rng.choice(types, p=[good_counts[t] / total for t in types])
        params = samplers[mtype].suggest(by_type[mtype])
        value = float(objective(mtype, params))
        tr = Trial(params=params, value=value)
        by_type[mtype].append(tr)
        all_trials.append((mtype, tr))
        if best is None or value > best[1].value:
            best = (mtype, tr)
        logger.info(
            "trial %d/%d model=%s value=%.4f params=%s (best=%s %.4f)",
            i + 1, n_trials, mtype, value, dict(params), best[0], best[1].value,
        )
    if best is None:  # n_trials <= 0: search disabled — no-op, don't crash
        return types[0], Params({}), float("-inf"), all_trials
    return best[0], best[1].params, best[1].value, all_trials
