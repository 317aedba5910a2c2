"""The port's model search (gorse_tpu_torch/models/optimize.py) against
gorse_tpu's: with the same injected objectives, ``model_search`` and
``model_type_search`` must draw the same trials, bit for bit (parameters
and values equal as floats), and pick the same best. Both run numpy's
generator from the same seed, so any difference in the sampler's
arithmetic or in the order of its draws shows here."""

import math

import numpy as np
import pytest

import gorse_tpu.models.optimize as R
import gorse_tpu_torch.models.optimize as P


def _quadratic(p) -> float:
    return -sum((math.log(v) - math.log(0.01)) ** 2 for v in p.values())


def _bumpy(p) -> float:
    # many local optima: a small change in a draw changes the ranking
    return float(sum(math.sin(37.0 * math.log(v)) + 0.1 * v for v in p.values()))


def _coarse(p) -> float:
    # ties between trials: the sort's order of equal values matters
    return float(round(sum(math.log(v) for v in p.values())))


OBJECTIVES = {"quadratic": _quadratic, "bumpy": _bumpy, "coarse": _coarse}


def _trials(trials) -> list:
    return [(dict(t.params), t.value) for t in trials]


def _spaces(mod):
    return {"bpr": mod.BPR_SPACE, "als": mod.ALS_SPACE, "afm": mod.AFM_SPACE,
            "mixed": {"lr": mod.SearchSpace(0.001, 0.1),
                      "n_factors": mod.SearchSpace(4, 64, log=True, integer=True),
                      "w": mod.SearchSpace(0.5, 1.5, log=False)}}


@pytest.mark.parametrize("space", ["bpr", "als", "afm", "mixed"])
@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("n_trials,seed", [(1, 0), (10, 0), (30, 3)])
def test_model_search_draws_the_reference_trials(space, objective, n_trials, seed):
    fn = OBJECTIVES[objective]
    got = P.model_search(fn, _spaces(P)[space], n_trials=n_trials, seed=seed)
    want = R.model_search(fn, _spaces(R)[space], n_trials=n_trials, seed=seed)
    assert _trials(got[2]) == _trials(want[2])
    assert dict(got[0]) == dict(want[0]) and got[1] == want[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_random_sampler_draws_the_reference_trials(seed):
    got = P.model_search(_bumpy, P.BPR_SPACE, n_trials=12, seed=seed, sampler="random")
    want = R.model_search(_bumpy, R.BPR_SPACE, n_trials=12, seed=seed, sampler="random")
    assert _trials(got[2]) == _trials(want[2]) and got[1] == want[1]


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("n_trials,seed", [(1, 0), (2, 0), (10, 0), (24, 7)])
def test_model_type_search_draws_the_reference_trials(objective, n_trials, seed):
    fn = OBJECTIVES[objective]

    def typed(mtype, params):
        return fn(params) + (0.5 if mtype == "als" else 0.0)

    got = P.model_type_search({"bpr": P.BPR_SPACE, "als": P.ALS_SPACE}, typed,
                              n_trials=n_trials, seed=seed)
    want = R.model_type_search({"bpr": R.BPR_SPACE, "als": R.ALS_SPACE}, typed,
                               n_trials=n_trials, seed=seed)
    assert [(t, dict(tr.params), tr.value) for t, tr in got[3]] == \
           [(t, dict(tr.params), tr.value) for t, tr in want[3]]
    assert (got[0], dict(got[1]), got[2]) == (want[0], dict(want[1]), want[2])


def test_disabled_search_is_the_reference():
    got = P.model_search(_quadratic, P.BPR_SPACE, n_trials=0)
    want = R.model_search(_quadratic, R.BPR_SPACE, n_trials=0)
    assert (dict(got[0]), got[1], got[2]) == (dict(want[0]), want[1], want[2])
    got = P.model_type_search({"bpr": P.BPR_SPACE}, lambda t, p: 0.0, n_trials=0)
    want = R.model_type_search({"bpr": R.BPR_SPACE}, lambda t, p: 0.0, n_trials=0)
    assert (got[0], dict(got[1]), got[2], got[3]) == (want[0], dict(want[1]), want[2], want[3])


@pytest.mark.parametrize("low,high,log,integer", [(0.001, 0.1, True, False), (4, 64, True, True),
                                                  (0.0, 1.0, False, False), (1, 9, False, True)])
def test_search_space_is_the_reference(low, high, log, integer):
    got, want = P.SearchSpace(low, high, log, integer), R.SearchSpace(low, high, log, integer)
    rng_p, rng_r = np.random.default_rng(1), np.random.default_rng(1)
    draws = [got.sample(rng_p) for _ in range(50)]
    assert draws == [want.sample(rng_r) for _ in range(50)]
    for v in draws:
        assert got.transform(v) == want.transform(v)
        assert got.inverse(got.transform(v)) == want.inverse(want.transform(v))


def test_tpe_suggest_is_the_reference():
    trials_p = [P.Trial(P.Params(lr=0.001 * (i + 1), reg=0.1 / (i + 1)), float(i % 5))
                for i in range(14)]
    trials_r = [R.Trial(R.Params(lr=0.001 * (i + 1), reg=0.1 / (i + 1)), float(i % 5))
                for i in range(14)]
    space_p = {"lr": P.SearchSpace(0.001, 0.1), "reg": P.SearchSpace(0.001, 0.1)}
    space_r = {"lr": R.SearchSpace(0.001, 0.1), "reg": R.SearchSpace(0.001, 0.1)}
    tpe_p, tpe_r = P.TPESampler(space_p, seed=2, n_startup=4), R.TPESampler(space_r, seed=2,
                                                                            n_startup=4)
    for n in (0, 3, 4, 9, 14):
        assert dict(tpe_p.suggest(trials_p[:n])) == dict(tpe_r.suggest(trials_r[:n]))
