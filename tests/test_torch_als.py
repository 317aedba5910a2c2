"""The port's eALS (gorse_tpu_torch/models/als.py) held against gorse_tpu's on
the CPU.

Tolerances:
- One half-epoch (``_als_solve_rows`` against ``_als_solve_side``): both
  solve the same ``k x k`` systems, whose matrices and right-hand sides are
  sums of at most L + k products summed in another order, by Cholesky
  (LAPACK in both, blocked differently). Each row's solution may then
  differ by ``cond(A) (4 (L + k) + 16) u`` of its largest magnitude
  (u = 2^-24; ``cond`` in f64 from the row's own system).
- Three epochs of ``ALS.fit`` from the reference's init factors: each
  half-epoch feeds the next, so the factors are held to 2e-4 of each
  table's largest magnitude (the differences seen are about a tenth of it),
  and NDCG@10, precision and recall to 1e-3 (a near-tie among a user's
  candidates may swap).
- The CCD oracle bridge mirrors tests/test_oracle.py with the port's
  solve, at that test's tolerances.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.data import load_built_in as ref_load_built_in
from gorse_tpu.data import synthetic_cf as ref_synthetic_cf
from gorse_tpu.models import ALS as RefALS
from gorse_tpu.models import FitConfig as RefFitConfig
from gorse_tpu.models import MatrixFactorization as RefMF
from gorse_tpu.models import Params as RefParams
from gorse_tpu.models.als import _als_solve_side
from gorse_tpu.models.base import build_eval_candidates as ref_build_eval_candidates
from gorse_tpu.models.base import evaluate_mf as ref_evaluate_mf
from gorse_tpu.models.oracle import _ccd_gram, _ccd_update_rows, eals_oracle_fit
from gorse_tpu_torch.data.loaders import load_built_in, synthetic_cf
from gorse_tpu_torch.models import ALS, FitConfig, MatrixFactorization, Params, create_mf_model
from gorse_tpu_torch.models.als import (
    _als_solve_rows,
    _has_feedback_mask,
    _pad_rows,
    padded_blocks,
)

SPEC = "synthetic://400,300,8,0.08,1"
U = 2.0**-24


def _padded(fb: list[list[int]]) -> np.ndarray:
    """The reference's layout: every row padded (-1) to the widest."""
    out = np.full((len(fb), max(max(len(r) for r in fb), 1)), -1, np.int32)
    for u, r in enumerate(fb):
        out[u, : len(r)] = r
    return out


def _row_tol(q, fb, alpha, reg, mask, x) -> np.ndarray:
    """Per-row tolerance ``cond(A) (4 (L + k) + 16) u max|x_row|``."""
    q64 = q.astype(np.float64)
    masked = q64 if mask is None else q64 * mask[:, None]
    gram = masked.T @ masked
    k = q.shape[1]
    tol = np.empty(len(fb))
    for row, ids in enumerate(fb):
        qi = q64[ids]
        a = (1 - alpha) * qi.T @ qi + alpha * gram + reg * np.eye(k)
        tol[row] = np.linalg.cond(a) * (4 * (len(ids) + k) + 16) * U * np.abs(x[row]).max()
    return tol


def _case(kind: str, seed: int):
    """(q, per-row feedback, item mask): dense (every item has feedback) or
    sparse (items past 12 never seen, some users with none)."""
    rng = np.random.default_rng(seed)
    n_users, n_items, k = 40, 30, 8
    q = rng.normal(0.0, 0.5, size=(n_items, k)).astype(np.float32)
    if kind == "dense":
        fb = [sorted(rng.choice(n_items, size=rng.integers(3, 12), replace=False).tolist())
              for _ in range(n_users)]
    else:
        fb = [sorted(rng.choice(12, size=rng.integers(0, 6), replace=False).tolist())
              if u % 5 else [] for u in range(n_users)]
    seen = {i for r in fb for i in r}
    mask = np.array([i in seen for i in range(n_items)], np.float32)
    return q, fb, mask


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("block", [8, 40])
def test_solve_rows_matches_the_reference(kind, masked, block):
    q, fb, mask = _case(kind, seed=len(kind) + block)
    alpha, reg = 0.05, 0.06
    padded = _pad_rows(_padded(fb), block, -1)
    want = np.asarray(_als_solve_side(
        jnp.asarray(q), jnp.asarray(padded), block=block, alpha=alpha, reg=reg,
        other_mask=jnp.asarray(mask) if masked else None,
    ))[: len(fb)]
    for blocks in (padded_blocks(fb, block, "cpu"),  # each block its own width
                   list(torch.as_tensor(padded).split(block))):  # the reference's width
        got = _als_solve_rows(torch.as_tensor(q), blocks, alpha, reg,
                              other_mask=torch.as_tensor(mask) if masked else None)
        got = got.numpy()[: len(fb)]
        tol = _row_tol(q, fb, alpha, reg, mask if masked else None, want)
        assert (np.abs(got - want).max(axis=1) <= tol).all()
    # rows without feedback solve (alpha S + reg I) x = 0
    empty = [u for u, r in enumerate(fb) if not r]
    assert kind == "dense" or (empty and not got[empty].any())


def test_padded_blocks_and_masks():
    fb = [[3, 1], [], [0, 1, 2, 4], [2]]
    blocks = padded_blocks(fb, 3, "cpu")
    assert [tuple(b.shape) for b in blocks] == [(3, 4), (3, 1)]
    assert blocks[0].tolist() == [[3, 1, -1, -1], [-1] * 4, [0, 1, 2, 4]]
    assert blocks[1].tolist() == [[2], [-1], [-1]] and blocks[0].dtype == torch.int32
    assert _has_feedback_mask(fb, "cpu").tolist() == [1.0, 0.0, 1.0, 1.0]
    assert padded_blocks([], 3, "cpu") == []
    x = np.arange(6).reshape(3, 2)
    assert _pad_rows(x, 3, -1) is x and _pad_rows(x, 4, -1)[3].tolist() == [-1, -1]


def test_solve_raises_when_a_factorization_fails():
    """A singular system (reg 0, no alpha term, one observed row) raises:
    no retry with jitter and no fallback."""
    q = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    with pytest.raises(RuntimeError, match="Cholesky"):
        _als_solve_rows(q, padded_blocks([[0]], 1, "cpu"), alpha=0.0, reg=0.0)


def _ref_init(train, n_factors: int):
    ref = RefALS(RefParams(n_factors=n_factors))
    ref.init(train, seed=0)
    return np.asarray(ref.user_factors), np.asarray(ref.item_factors)


@pytest.mark.parametrize("epochs", [1, 3])
def test_fit_matches_the_reference_fit(epochs, monkeypatch):
    """The port's fit on the CPU from the reference's init factors against
    the reference's single-device ALS.fit."""
    r_train, r_test = ref_load_built_in(SPEC)
    ref = RefALS(RefParams(n_factors=8, n_epochs=epochs))
    r_score = ref.fit(r_train, r_test, RefFitConfig(verbose=1))

    train, test = load_built_in(SPEC)
    model = ALS(Params(n_factors=8, n_epochs=epochs), device="cpu")
    init = model.init
    factors = _ref_init(r_train, 8)
    monkeypatch.setattr(model, "init", lambda tr, seed=0: init(tr, seed, factors=factors))
    score = model.fit(train, test, FitConfig(verbose=1))
    for got, want in ((model.user_factors, ref.user_factors),
                      (model.item_factors, ref.item_factors)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())
    for a, b in ((score.ndcg, r_score.ndcg), (score.precision, r_score.precision),
                 (score.recall, r_score.recall)):
        assert abs(a - b) <= 1e-3
    assert np.array_equal(model.user_predictable, ref.user_predictable)
    assert np.array_equal(model.item_predictable, ref.item_predictable)


@pytest.mark.parametrize("epochs", [1, 3])
def test_fit_from_the_seed_matches_the_reference_fit(epochs):
    """The port's fit on the CPU from the seed, nothing injected (its init
    draws jax's normal factors bit for bit), against the reference's
    single-device ALS.fit, at the tolerances of the fit from the
    reference's factors."""
    r_train, r_test = ref_load_built_in(SPEC)
    ref = RefALS(RefParams(n_factors=8, n_epochs=epochs))
    r_score = ref.fit(r_train, r_test, RefFitConfig(verbose=1))
    train, test = load_built_in(SPEC)
    model = ALS(Params(n_factors=8, n_epochs=epochs), device="cpu")
    score = model.fit(train, test, FitConfig(verbose=1))
    for got, want in ((model.user_factors, ref.user_factors),
                      (model.item_factors, ref.item_factors)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())
    for a, b in ((score.ndcg, r_score.ndcg), (score.precision, r_score.precision),
                 (score.recall, r_score.recall)):
        assert abs(a - b) <= 1e-3


def test_defaults_and_registry():
    model = create_mf_model("als", device="cpu")
    assert isinstance(model, ALS) and model.name == "als"
    ref = RefALS()
    for name in ("n_factors", "n_epochs", "reg", "init_mean", "init_stddev", "alpha", "block"):
        assert getattr(model, name) == getattr(ref, name), name
    tuned = create_mf_model("als", Params(alpha=0.05, solve_block=64, n_factors=4),
                            device="cpu")
    assert (tuned.alpha, tuned.block, tuned.n_factors) == (0.05, 64, 4)


def test_recovers_low_rank_structure():
    """The NDCG gate of tests/test_als.py, from the port's own init."""
    data = synthetic_cf(n_users=300, n_items=200, rank=4, density=0.1, seed=7)
    train, test = data.split_cf(seed=0)
    model = ALS(Params(n_factors=8, n_epochs=10, reg=0.015, alpha=0.05), device="cpu")
    score = model.fit(train, test, FitConfig(verbose=5, candidates=50))
    assert score.ndcg > 0.35, f"NDCG@10 too low: {score.ndcg}"


def test_verbose_zero_and_early_stopping():
    train, test = load_built_in(SPEC)
    score = ALS(Params(n_factors=4, n_epochs=3), device="cpu").fit(
        train, test, FitConfig(verbose=0, candidates=10))
    assert 0.0 <= score.ndcg <= 1.0
    # patience with evaluation every epoch; reg so large the factors collapse
    model = ALS(Params(n_factors=4, n_epochs=8, reg=1e6), device="cpu")
    model.fit(train, test, FitConfig(verbose=1, patience=2, candidates=10))
    assert float(model.user_factors.abs().max()) < 1e-3


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_saved_models_interchange(direction, tmp_path):
    train, test = load_built_in(SPEC)
    r_train, r_test = ref_load_built_in(SPEC)
    if direction == "reference_to_port":
        src = RefALS(RefParams(n_factors=4, n_epochs=2, alpha=0.01))
        src.fit(r_train, r_test, RefFitConfig(verbose=0, candidates=10))
        src.save(tmp_path)
        model = MatrixFactorization.load(tmp_path, device="cpu")
    else:
        src = ALS(Params(n_factors=4, n_epochs=2, alpha=0.01), device="cpu")
        src.fit(train, test, FitConfig(verbose=0, candidates=10))
        src.save(tmp_path)
        model = RefMF.load(tmp_path)
    assert type(model).__name__ == "ALS" and model.alpha == 0.01 and model.n_factors == 4
    assert json.loads((tmp_path / "meta.json").read_text())["name"] == "als"
    assert np.array_equal(np.asarray(model.user_factors), np.asarray(src.user_factors))
    assert np.array_equal(np.asarray(model.item_factors), np.asarray(src.item_factors))
    assert np.array_equal(model.item_predictable, src.item_predictable)
    assert model.item_index.to_dict() == src.item_index.to_dict()
    users, items = [0, 3, 7, 7], [1, 1, 0, 5]
    np.testing.assert_allclose(np.asarray(model.predict(users, items)),
                               np.asarray(src.predict(users, items)), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------ CCD oracle bridge


def _rand_factors(rng, n_users, n_items, k, stddev=0.1):
    p = rng.normal(0.0, stddev, size=(n_users, k)).astype(np.float32)
    q = rng.normal(0.0, stddev, size=(n_items, k)).astype(np.float32)
    return p, q


def test_ccd_converges_to_the_cholesky_fixed_point():
    """The oracle's CCD row update, iterated, converges to the port's exact
    solve of the weighted ridge system (tests/test_oracle.py:104)."""
    rng = np.random.default_rng(3)
    k, n_items, width = 8, 30, 12
    q = rng.normal(0.0, 0.5, size=(n_items, k)).astype(np.float32)
    fb = sorted(rng.choice(n_items, size=width, replace=False).tolist())
    weight, reg = 0.05, 0.06
    s = _ccd_gram(q, [[0] for _ in range(n_items)])
    row = rng.normal(0.0, 0.1, size=(1, k)).astype(np.float32)
    for _ in range(200):
        _ccd_update_rows(row, q, [fb], s, weight, reg)
    got = _als_solve_rows(torch.as_tensor(q), padded_blocks([fb], 1, "cpu"), weight, reg)
    np.testing.assert_allclose(row[0], got[0].numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_half_epoch_matches_the_oracle(kind):
    """The user half-step against many CCD iterations from the same start
    (tests/test_oracle.py:131, :161); on sparse data only the masked Gram
    reaches the oracle's fixed point."""
    rng = np.random.default_rng(4 if kind == "dense" else 11)
    n_users, n_items, k = 6, 25, 4
    p, q = _rand_factors(rng, n_users, n_items, k)
    observed = n_items if kind == "dense" else 12
    size = 6 if kind == "dense" else 5
    user_fb = [sorted(rng.choice(observed, size=size, replace=False).tolist())
               for _ in range(n_users)]
    item_feedback = [[0] if i < observed else [] for i in range(n_items)]
    weight, reg = 0.05, 0.06
    s = _ccd_gram(q, item_feedback)
    p_o = p.copy()
    for _ in range(300):
        _ccd_update_rows(p_o, q, user_fb, s, weight, reg)
    blocks = padded_blocks(user_fb, n_users, "cpu")
    mask = _has_feedback_mask(item_feedback, "cpu")
    got = _als_solve_rows(torch.as_tensor(q), blocks, weight, reg, other_mask=mask)
    np.testing.assert_allclose(got.numpy(), p_o, rtol=3e-3, atol=3e-4)
    if kind == "sparse":
        unmasked = _als_solve_rows(torch.as_tensor(q), blocks, weight, reg)
        assert float(np.abs(unmasked.numpy() - p_o).max()) > 1e-3


def test_trajectory_matches_the_oracle():
    """Converged NDCG against the CCD oracle's fit (tests/test_oracle.py:235):
    the oracle 20 CCD epochs, the port 10 exact ones."""
    data = ref_synthetic_cf(n_users=500, n_items=300, rank=8, density=0.06, seed=7)
    r_train, r_test = data.split_cf(seed=0)
    p_o, q_o = eals_oracle_fit(r_train.get_user_feedback(), r_train.get_item_feedback(),
                               n_factors=8, n_epochs=20, weight=0.05, reg=0.06, seed=0)
    cands = ref_build_eval_candidates(r_test, r_train, 100)
    oracle_ndcg = ref_evaluate_mf(jnp.asarray(p_o), jnp.asarray(q_o), *cands, 10)["NDCG"]

    train, test = synthetic_cf(n_users=500, n_items=300, rank=8, density=0.06,
                               seed=7).split_cf(seed=0)
    score = ALS(Params(n_factors=8, n_epochs=10, reg=0.06, alpha=0.05), device="cpu").fit(
        train, test, FitConfig(verbose=0, patience=0))
    assert abs(score.ndcg - oracle_ndcg) < 0.03, (score.ndcg, oracle_ndcg)
    assert oracle_ndcg > 0.30 and score.ndcg > 0.30
