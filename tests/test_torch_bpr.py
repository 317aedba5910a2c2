"""The port's BPR training (gorse_tpu_torch.models, .data, .ops.metrics) held
against gorse_tpu on the CPU.

Data and splits come from the same numpy seeds in both packages and must be
equal. The fit is held against the reference's ``BPR.fit`` on the 8-device
CPU mesh (tests/conftest.py), which is its user-sharded XLA epoch with the
same counter sampler and key stream as the port; given the reference's init
factors, the two differ only in the summation order of the dot products
(sum(p*qi) - sum(p*qj) here, sum(p*(qi - qj)) there) and of the item sums,
so factors agree to rtol 1e-4 / atol 1e-6 after 5 epochs and NDCG@10 to 1e-3.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorse_tpu.data import load_built_in as ref_load_built_in
from gorse_tpu.data.loaders import synthetic_cf as ref_synthetic_cf
from gorse_tpu.data.loaders import synthetic_cf_access as ref_synthetic_cf_access
from gorse_tpu.models import BPR as RefBPR
from gorse_tpu.models import FitConfig as RefFitConfig
from gorse_tpu.models import MatrixFactorization as RefMF
from gorse_tpu.models import Params as RefParams
from gorse_tpu.models.base import build_eval_candidates as ref_build_eval_candidates
from gorse_tpu.models.base import evaluate_mf as ref_evaluate_mf
from gorse_tpu.models.bpr import adaptive_neg_tries as ref_adaptive_neg_tries
from gorse_tpu.models.bpr import history_cap as ref_history_cap
from gorse_tpu.ops.metrics import rank_metrics as ref_rank_metrics
from gorse_tpu.parallel import make_mesh
from gorse_tpu_torch.data.loaders import load_built_in, synthetic_cf, synthetic_cf_access
from gorse_tpu_torch.models import BPR, FitConfig, MatrixFactorization, Params, create_mf_model
from gorse_tpu_torch.models.base import build_eval_candidates, evaluate_mf
from gorse_tpu_torch.models.bpr import adaptive_neg_tries, history_cap
from gorse_tpu_torch.ops.metrics import rank_metrics

SPEC = "synthetic://400,300,8,0.08,1"


def _same_dataset(a, b):
    assert a.user_dict.to_dict() == b.user_dict.to_dict()
    assert a.item_dict.to_dict() == b.item_dict.to_dict()
    assert a.user_feedback == b.user_feedback and a.item_feedback == b.item_feedback
    assert a.timestamps == b.timestamps and a.count_feedback() == b.count_feedback()


@pytest.mark.parametrize("which", ["synthetic_cf", "synthetic_cf_access", "load_built_in"])
def test_datasets_and_splits_are_the_reference(which):
    if which == "synthetic_cf":
        _same_dataset(synthetic_cf(120, 80, 4, 0.1, seed=5), ref_synthetic_cf(120, 80, 4, 0.1, seed=5))
    elif which == "synthetic_cf_access":
        ref = ref_synthetic_cf_access(300, 200, nnz=4000, seed=2)
        mine = synthetic_cf_access(300, 200, nnz=4000, seed=2)
        _same_dataset(mine, ref)
        for (a, b) in zip(mine.split_cf(50, seed=3), ref.split_cf(50, seed=3)):
            _same_dataset(a, b)
    else:
        for a, b in zip(load_built_in(SPEC), ref_load_built_in(SPEC)):
            _same_dataset(a, b)


def test_fit_policies_and_eval_candidates_are_the_reference():
    train, test = load_built_in("synthetic://300,900,4,0.3,2")
    r_train, r_test = ref_load_built_in("synthetic://300,900,4,0.3,2")
    assert history_cap(train) == ref_history_cap(r_train)
    for d in (1e-7, 0.003, 0.05, 0.3, 0.95):
        assert adaptive_neg_tries(d) == ref_adaptive_neg_tries(d)
    for a, b in zip(build_eval_candidates(test, train, 50),
                    ref_build_eval_candidates(r_test, r_train, 50)):
        assert np.array_equal(a, b)
    cap = 40  # narrower than the widest history: capped rows, drawn per seed
    a = train.padded_user_positives(max_len=cap, seed=4)
    b = r_train.padded_user_positives(max_len=cap, seed=4)
    assert np.array_equal(a.padded, b.padded) and np.array_equal(a.counts, b.counts)


@pytest.mark.parametrize("case", ["ties", "random", "padding"])
def test_rank_metrics_match_with_ties(case):
    """Equal scores take the lower candidate index first, as lax.top_k."""
    rng = np.random.default_rng(len(case))
    n_users, m = 40, 30
    if case == "ties":
        scores = rng.integers(0, 3, size=(n_users, m)).astype(np.float32)
    else:
        scores = rng.normal(size=(n_users, m)).astype(np.float32)
    is_target = rng.uniform(size=(n_users, m)) < 0.15
    valid = np.ones((n_users, m), bool) if case != "padding" else rng.uniform(size=(n_users, m)) < 0.8
    ref = ref_rank_metrics(jnp.asarray(scores), jnp.asarray(is_target), jnp.asarray(valid), top_k=10)
    mine = rank_metrics(torch.as_tensor(scores), torch.as_tensor(is_target),
                        torch.as_tensor(valid), top_k=10)
    for name, v in ref.items():
        np.testing.assert_allclose(float(mine[name]), float(v), rtol=1e-6, err_msg=name)


def test_evaluate_mf_matches():
    train, test = load_built_in(SPEC)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(train.count_users(), 8)).astype(np.float32)
    i = rng.normal(size=(train.count_items(), 8)).astype(np.float32)
    cands = build_eval_candidates(test, train, 100)
    ref = ref_evaluate_mf(jnp.asarray(u), jnp.asarray(i), *cands, 10)
    mine = evaluate_mf(torch.as_tensor(u), torch.as_tensor(i), *cands, 10)
    for name, v in ref.items():
        np.testing.assert_allclose(mine[name], v, rtol=1e-6, atol=1e-7, err_msg=name)


def _ref_init(n_factors):
    r_train, _ = ref_load_built_in(SPEC)
    ref0 = RefBPR(RefParams(n_factors=n_factors))
    ref0.init(r_train, seed=0)
    return np.asarray(ref0.user_factors), np.asarray(ref0.item_factors)


@pytest.mark.parametrize("epochs", [1, 5])
def test_fit_matches_the_reference_sharded_fit(epochs, monkeypatch):
    """The port's fit on the CPU, started from the reference's init factors,
    against the reference's BPR.fit on the 8-device mesh."""
    r_train, r_test = ref_load_built_in(SPEC)
    ref = RefBPR(RefParams(n_factors=8, n_epochs=epochs))
    r_score = ref.fit(r_train, r_test, RefFitConfig(mesh=make_mesh(8), verbose=2))

    train, test = load_built_in(SPEC)
    model = BPR(Params(n_factors=8, n_epochs=epochs), device="cpu")
    init = model.init
    monkeypatch.setattr(model, "init", lambda tr, seed=0: init(tr, seed, factors=_ref_init(8)))
    score = model.fit(train, test, FitConfig(verbose=2))
    np.testing.assert_allclose(model.user_factors.numpy(), np.asarray(ref.user_factors),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.item_factors.numpy(), np.asarray(ref.item_factors),
                               rtol=1e-4, atol=1e-6)
    for a, b in ((score.ndcg, r_score.ndcg), (score.precision, r_score.precision),
                 (score.recall, r_score.recall)):
        assert abs(a - b) <= 1e-3
    assert len(model.epoch_seconds) == epochs
    assert np.array_equal(model.user_predictable, ref.user_predictable)
    assert np.array_equal(model.item_predictable, ref.item_predictable)


def test_fit_learns_from_its_own_init():
    """The torch-generator init: NDCG@10 well above random (~0.05) and in
    the band the verify notes give for this spec (~0.35 and up)."""
    train, test = load_built_in(SPEC)
    score = BPR(Params(n_factors=8, n_epochs=20), device="cpu").fit(train, test,
                                                                   FitConfig(verbose=5))
    assert score.ndcg >= 0.35


def test_early_stopping_and_checkpoints(tmp_path):
    train, test = load_built_in(SPEC)
    model = BPR(Params(n_factors=8, n_epochs=6, lr=0.0), device="cpu")
    model.fit(train, test, FitConfig(verbose=1, patience=2, checkpoint_dir=str(tmp_path)))
    # lr 0 never improves on epoch 0: stops once epoch - patience passes it
    assert len(model.epoch_seconds) == 3
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved == [f"bpr_epoch_{e}.npz" for e in (1, 2, 3)]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_saved_models_interchange(direction, tmp_path):
    train, _ = load_built_in(SPEC)
    r_train, _ = ref_load_built_in(SPEC)
    if direction == "reference_to_port":
        ref = RefBPR(RefParams(n_factors=8, lr=0.03))
        ref.init(r_train, seed=0)
        ref.save(tmp_path)
        model = MatrixFactorization.load(tmp_path, device="cpu")
        src_u, src_i = np.asarray(ref.user_factors), np.asarray(ref.item_factors)
        src = ref
    else:
        model = BPR(Params(n_factors=8, lr=0.03), device="cpu")
        model.init(train, seed=0)
        model.save(tmp_path)
        src_u, src_i = model.user_factors.numpy(), model.item_factors.numpy()
        src, model = model, RefMF.load(tmp_path)
    assert type(model).__name__ == "BPR" and model.lr == 0.03 and model.n_factors == 8
    assert np.array_equal(np.asarray(model.user_factors), src_u)
    assert np.array_equal(np.asarray(model.item_factors), src_i)
    assert np.array_equal(model.user_predictable, src.user_predictable)
    assert model.user_index.to_dict() == src.user_index.to_dict()
    assert json.loads((tmp_path / "meta.json").read_text())["name"] == "bpr"
    users, items = [0, 3, 7, 7], [1, 1, 0, 5]
    np.testing.assert_allclose(np.asarray(model.predict(users, items)),
                               np.asarray(src.predict(users, items)), rtol=1e-6, atol=1e-9)


def test_init_takes_numpy_factors_and_checks_their_shape():
    train, _ = load_built_in(SPEC)
    model = BPR(Params(n_factors=8), device="cpu")
    u, i = _ref_init(8)
    model.init(train, factors=(u, i))
    assert np.array_equal(model.user_factors.numpy(), u)
    with pytest.raises(ValueError, match="factors"):
        model.init(train, factors=(u[:, :4], i))
    model.init(train, seed=3)  # the generator init: reproducible from the seed
    again = BPR(Params(n_factors=8), device="cpu")
    again.init(train, seed=3)
    assert torch.equal(model.item_factors, again.item_factors)
    assert float(model.item_factors.std()) == pytest.approx(0.001, rel=0.1)


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match="M8"):
        create_mf_model("als", device="cpu")
    with pytest.raises(NotImplementedError, match="M14"):
        FitConfig(mesh=object())
    with pytest.raises(NotImplementedError, match="M14"):
        FitConfig(sync_every=2)
    with pytest.raises(KeyError):
        create_mf_model("nope", device="cpu")
    with pytest.raises(NotImplementedError):
        load_built_in("ml-1m")
