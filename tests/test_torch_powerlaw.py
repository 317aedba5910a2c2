"""The power-law generator behind the reference's ml-1m-scale quality gates
(data/loaders.py ``synthetic_cf_powerlaw``) and ``evaluate_model``
(models/base.py) against gorse_tpu's.

- The generator draws with numpy alone, in the reference's order: every
  user's items and time stamps, and the item lists, are the reference's
  exactly, at 3 seeds and 2 small shapes.
- ``evaluate_model`` on the same factors injected into both packages, on
  the generator's data at about 600 x 400 with 20k ratings: every metric
  within 1e-6.
- The gates themselves at full size (6,040 x 3,706, 1M ratings, seed 42:
  BPR 30 epochs and eALS 15, NDCG@10 >= 0.55, tests/test_oracle.py's) run on
  the CPU only with ``GORSE_RUN_SLOW`` set, as the reference's do; on the
  card they are chip_smoke.py's phase 18."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gorse_tpu.data.loaders as ref_loaders
import gorse_tpu.models.base as ref_base
import gorse_tpu_torch.data.loaders as port_loaders
import gorse_tpu_torch.models.base as port_base
from gorse_tpu_torch.models import ALS, BPR, FitConfig, Params, evaluate_model

SMALL = dict(n_users=600, n_items=400, nnz=20_000)
ODD = dict(n_users=97, n_items=53, rank=4, nnz=1_500, zipf_s=1.3, pop_weight=0.5, noise=2.0)
METRIC_TOL = 1e-6


def _contents(d) -> tuple:
    return (d.user_feedback, d.item_feedback, d.timestamps, d.num_feedback,
            d.user_dict.to_dict(), d.item_dict.to_dict())


@pytest.mark.parametrize("shape", [SMALL, ODD], ids=["600x400", "97x53"])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_powerlaw_is_the_reference(shape, seed):
    got = port_loaders.synthetic_cf_powerlaw(seed=seed, **shape)
    want = ref_loaders.synthetic_cf_powerlaw(seed=seed, **shape)
    assert _contents(got) == _contents(want)
    counts = [len(fb) for fb in got.user_feedback]
    assert min(counts) >= 5 and max(counts) <= shape["n_items"] - 1
    assert got.num_feedback == sum(counts)


def test_powerlaw_defaults_are_the_reference():
    import inspect

    assert (inspect.signature(port_loaders.synthetic_cf_powerlaw)
            == inspect.signature(ref_loaders.synthetic_cf_powerlaw))


@pytest.fixture(scope="module")
def small_split():
    """The generator's small corpus split as tests/test_oracle.py splits
    the full one, in both packages."""
    port = port_loaders.synthetic_cf_powerlaw(seed=42, **SMALL).split_cf(seed=0)
    ref = ref_loaders.synthetic_cf_powerlaw(seed=42, **SMALL).split_cf(seed=0)
    for got, want in zip(port, ref, strict=True):
        assert _contents(got) == _contents(want)
    return port, ref


@pytest.fixture(scope="module")
def fitted(small_split):
    """Factors of a short BPR fit of the small corpus on the CPU."""
    train, test = small_split[0]
    model = BPR(Params(n_factors=8, n_epochs=3, lr=0.05, reg=0.01), device="cpu")
    model.fit(train, test, FitConfig(verbose=0))
    return model.user_factors.numpy(), model.item_factors.numpy()


def _models(train, factors):
    """The same factors in both packages' base model."""
    port, ref = port_base.MatrixFactorization(device="cpu"), ref_base.MatrixFactorization()
    port.user_factors, port.item_factors = (torch.from_numpy(f) for f in factors)
    ref.user_factors, ref.item_factors = (jnp.asarray(f) for f in factors)
    return port, ref


@pytest.mark.parametrize("top_k,n_candidates", [(10, 100), (5, 50), (20, 300)])
@pytest.mark.parametrize("factors", ["random", "fitted"])
def test_evaluate_model_is_the_reference(small_split, top_k, n_candidates, factors, request):
    (train, test), (ref_train, ref_test) = small_split
    if factors == "random":
        rng = np.random.default_rng(top_k)
        user = rng.normal(size=(train.count_users(), 8)).astype(np.float32)
        item = rng.normal(size=(train.count_items(), 8)).astype(np.float32)
    else:
        user, item = request.getfixturevalue("fitted")
    port, ref = _models(train, (user, item))
    got = evaluate_model(port, test, train, top_k=top_k, n_candidates=n_candidates)
    want = ref_base.evaluate_model(ref, ref_test, ref_train, top_k=top_k,
                                   n_candidates=n_candidates)
    assert set(got) == set(want) >= {"NDCG", "Precision", "Recall"}
    for name in want:
        assert abs(got[name] - want[name]) <= METRIC_TOL, (name, got[name], want[name])
    if factors == "fitted":
        assert got["NDCG"] > 0.2


slow = pytest.mark.skipif(not os.environ.get("GORSE_RUN_SLOW"),
                          reason="set GORSE_RUN_SLOW=1 to run")


@pytest.fixture(scope="module")
def full_split():
    return port_loaders.synthetic_cf_powerlaw(seed=42).split_cf(seed=0)


@slow
def test_bpr_ml1m_scale_powerlaw_gate(full_split):
    train, test = full_split
    model = BPR(Params(n_factors=8, n_epochs=30, lr=0.05, reg=0.01), device="cpu")
    score = model.fit(train, test, FitConfig(verbose=10, patience=0))
    assert score.ndcg >= 0.55, score.ndcg


@slow
def test_eals_ml1m_scale_powerlaw_gate(full_split):
    train, test = full_split
    model = ALS(Params(n_factors=8, n_epochs=15, reg=0.015, alpha=0.05), device="cpu")
    score = model.fit(train, test, FitConfig(verbose=5, patience=0))
    assert score.ndcg >= 0.55, score.ndcg
