"""The reference's last public names in the port, each against gorse_tpu's
on the same inputs made from a seed with numpy: ``Dataset.edge_arrays``
(arrays and dtypes exact), ``Dataset.split_latest`` (train and test
contents exact, ties on time stamps included), ``Score.to_dict``,
``MatrixFactorization.is_fitted``, ``OnlineEvaluator`` (the same typed
feedback stream over 40 days: equal ``TimeSeriesPoint`` lists) and
``storage.types.now`` (the wall clock). The power-law generator and
``evaluate_model`` are held in tests/test_torch_powerlaw.py."""

import time

import numpy as np
import pytest

import gorse_tpu.data as ref_data
import gorse_tpu.models.base as ref_base
import gorse_tpu.serve.metrics as ref_metrics
import gorse_tpu.storage.types as ref_types
import gorse_tpu.utils.expression as ref_expression
import gorse_tpu_torch.data as port_data
import gorse_tpu_torch.models.base as port_base
import gorse_tpu_torch.serve.metrics as port_metrics
import gorse_tpu_torch.storage.types as port_types
import gorse_tpu_torch.utils.expression as port_expression


def _contents(d) -> tuple:
    return (d.user_feedback, d.item_feedback, d.timestamps, d.num_feedback,
            d.count_users(), d.count_items())


def _stamped(pkg, seed: int, ties: bool):
    """A dataset by ``add_feedback``: 30 users, 0 to 12 feedback each over 25
    items; with ``ties`` the time stamps come from 4 values, so many
    equal."""
    rng = np.random.default_rng(seed)
    d = pkg.Dataset()
    for u in range(30):
        for i in rng.choice(25, int(rng.integers(0, 13)), replace=False):
            t = float(rng.integers(4)) if ties else float(rng.uniform(0, 1e6))
            d.add_feedback(f"u{u}", f"i{i}", t)
    d.add_user("u_silent")
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_arrays_are_the_reference(seed):
    for data in (lambda p: p.synthetic_cf(n_users=60, n_items=40, density=0.1, seed=seed),
                 lambda p: _stamped(p, seed, ties=False)):
        got, want = data(port_data).edge_arrays(), data(ref_data).edge_arrays()
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)
    empty = port_data.Dataset().edge_arrays()
    assert [(a.dtype, a.shape) for a in empty] == [(np.int32, (0,))] * 2


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shots", [0, 1, 3, 100])
def test_split_latest_is_the_reference(ties, shots):
    """Every user's newest feedback to test and the next ``shots`` to
    train, in the reference's order, equal time stamps included."""
    data = _stamped(port_data, 2, ties)
    got = data.split_latest(shots)
    want = _stamped(ref_data, 2, ties).split_latest(shots)
    for g, w in zip(got, want, strict=True):
        assert _contents(g) == _contents(w)
    train, test = got
    assert test.num_feedback == sum(1 for fb in data.user_feedback if fb)
    assert all(len(fb) <= shots for fb in train.user_feedback)


def test_split_latest_of_the_reference_test():
    """tests/test_dataset.py's case, in the port."""
    d = port_data.Dataset()
    d.add_feedback("u", "a", 1.0)
    d.add_feedback("u", "b", 5.0)
    d.add_feedback("u", "c", 3.0)
    train, test = d.split_latest(shots=10)
    assert test.user_feedback[0] == [d.item_dict.to_number("b")]
    assert train.user_feedback[0] == [d.item_dict.to_number("c"), d.item_dict.to_number("a")]


def test_score_to_dict_and_is_fitted():
    args = (0.25, 0.125, 0.5)
    assert port_base.Score(*args).to_dict() == ref_base.Score(*args).to_dict() == {
        "ndcg": 0.25, "precision": 0.125, "recall": 0.5}
    port, ref = port_base.MatrixFactorization(device="cpu"), ref_base.MatrixFactorization()
    assert port.is_fitted() is ref.is_fitted() is False
    train = port_data.synthetic_cf(n_users=8, n_items=6, density=0.3, seed=0)
    port.n_factors, port.init_mean, port.init_stddev = 4, 0.0, 0.1
    port.init(train)
    assert port.is_fitted() is True


def _stream(seed: int, now: float, n: int = 3000):
    """Typed feedback over the 40 days before ``now`` (and a few after):
    reads with values 0 to 5, stars, likes and clicks."""
    rng = np.random.default_rng(seed)
    kinds = ("read", "read", "star", "like", "click")
    for _ in range(n):
        yield (kinds[int(rng.integers(len(kinds)))], float(rng.integers(0, 6)),
               int(rng.integers(50)), int(rng.integers(80)),
               now - float(rng.uniform(-2, 40)) * 86400.0)


@pytest.mark.parametrize("positive,read,window", [
    (["star", "like"], ["read"], 30),
    (["star", "read>=3"], ["read", "click"], 30),
    ([("like",), "read=5"], ["read<4"], 7),
])
def test_online_evaluator_is_the_reference(positive, read, window):
    """Expressions as strings, or (a tuple here) as each package's parsed
    ``FeedbackTypeExpression``."""
    def types(module, specs):
        return [module.FeedbackTypeExpression.parse(t[0]) if isinstance(t, tuple) else t
                for t in specs]

    port = port_metrics.OnlineEvaluator(types(port_expression, positive), read, window_size=window)
    ref = ref_metrics.OnlineEvaluator(types(ref_expression, positive), read, window_size=window)
    ref.window_end = port.window_end  # the same day, across midnight too
    for row in _stream(window, port.window_end):
        port.add(*row)
        ref.add(*row)
    got = [(p.name, p.timestamp, p.value) for p in port.evaluate()]
    want = [(p.name, p.timestamp, p.value) for p in ref.evaluate()]
    assert got == want and len(got) > window
    assert {name for name, _, _ in got} >= {"positive_feedback_ratio"}
    assert all(isinstance(p, port_types.TimeSeriesPoint) for p in port.evaluate())
    assert port.window_end % 86400.0 == 0 and port.window_end <= time.time()


def test_now_is_the_wall_clock():
    before = time.time()
    got, want = port_types.now(), ref_types.now()
    assert before <= got <= time.time() and abs(got - want) < 5.0
