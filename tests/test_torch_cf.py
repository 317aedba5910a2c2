"""The port's MatrixFactorizationIndex held against gorse_tpu.logics.cf.

Factors are small multiples of 1/4, exact in bf16, so every score is exact
in f32 on both routes of both packages: Score lists must be equal (ids,
order and scores, tolerance 0). similar_users divides by norms, which the
two packages compute in different orders: its scores agree to 1e-6.
"""

import numpy as np
import pytest
import torch

from gorse_tpu.data.dict import FreqDict as RefFreqDict
from gorse_tpu.logics.cf import MatrixFactorizationIndex as RefIndex
from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex
from gorse_tpu_torch.ops import topk as port_topk

N_USERS, N_ITEMS, DIM = 300, 700, 8


def _fixture(seed=0, n_users=N_USERS, n_items=N_ITEMS, dim=DIM):
    rng = np.random.default_rng(seed)
    uf = (rng.integers(-8, 9, size=(n_users, dim)) / 4).astype(np.float32)
    itf = (rng.integers(-8, 9, size=(n_items, dim)) / 4).astype(np.float32)
    users, items = RefFreqDict(), RefFreqDict()
    for u in range(n_users):
        users.add(f"u{u}")
    for i in range(n_items):
        items.add(f"i{i}")
    user_pred = rng.random(n_users) > 0.1
    item_pred = rng.random(n_items) > 0.15
    cats = [[f"c{i % 3}"] for i in range(n_items)]
    ref = RefIndex(uf, itf, users, items, cats, 7.0,
                   user_predictable=user_pred, item_predictable=item_pred)
    port = MatrixFactorizationIndex.from_numpy(
        uf, itf, users.to_dict(), items.to_dict(), cats, 7.0,
        user_predictable=user_pred, item_predictable=item_pred, device="cpu",
    )
    return rng, ref, port


def _as_tuples(rows):
    return [[(s.id, s.score, tuple(s.categories), s.timestamp) for s in row] for row in rows]


@pytest.mark.parametrize("route", ["kernel", "f32"])
def test_search_users_matches_reference(route):
    """Chunking past 256 users, unknown and unpredictable users, exclusion
    lists with unknown and unpredictable items, ragged widths."""
    rng, ref, port = _fixture()
    user_ids = [f"u{u}" for u in range(N_USERS)] + ["nobody"]
    exclude = []
    for u in range(len(user_ids)):
        width = int(rng.integers(0, 12))
        ex = [f"i{j}" for j in rng.choice(N_ITEMS, size=width, replace=False)]
        exclude.append(ex + (["unknown-item"] if u % 7 == 0 else []))
    if route == "kernel":
        want = ref.search_users(user_ids, 20, exclude, use_pallas=True, interpret=True)
        got = port.search_users(user_ids, 20, exclude)
    else:
        want = ref.search_users(user_ids, 20, exclude, use_pallas=False)
        got = port.search_users(user_ids, 20, exclude, use_kernel=False)
    assert _as_tuples(got) == _as_tuples(want)
    assert got[-1] == []  # unknown user
    assert any(row == [] for row in got[:-1])  # an unpredictable user


def test_wide_fetch_takes_f32_route():
    """n + widest exclusion > 2048 sends the chunk to the f32 route in both
    packages (the route rule of gorse_tpu/logics/cf.py:168)."""
    rng, ref, port = _fixture(seed=1, n_users=4, n_items=2600, dim=8)
    user_ids = [f"u{u}" for u in range(4)]
    exclude = [[f"i{j}" for j in rng.choice(2600, size=60, replace=False)] for _ in user_ids]
    before = port_topk.dot_topk_xla.uses
    launches = port_topk.block_topk.launches
    got = port.search_users(user_ids, 2000, exclude)
    assert port_topk.dot_topk_xla.uses == before + 1
    assert port_topk.block_topk.launches == launches  # no kernel launch on the CPU
    want = ref.search_users(user_ids, 2000, exclude, use_pallas=False)
    assert _as_tuples(got) == _as_tuples(want)


def test_similar_users_matches_reference():
    _, ref, port = _fixture(seed=2)
    for u in ("u0", "u5", "u17", "nobody"):
        want = ref.similar_users(u, 15)
        got = port.similar_users(u, 15)
        assert [s.id for s in got] == [s.id for s in want]
        np.testing.assert_allclose([s.score for s in got], [s.score for s in want],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_index_files_interchange(writer, tmp_path):
    """An index saved by either package loads in the other with the same
    arrays, dictionaries and search results."""
    _, ref, port = _fixture(seed=3)
    if writer == "reference":
        ref.save(tmp_path)
        loaded_port = MatrixFactorizationIndex.load(tmp_path, device="cpu")
        loaded_ref = ref
    else:
        port.save(tmp_path)
        loaded_ref = RefIndex.load(tmp_path)
        loaded_port = port
    np.testing.assert_array_equal(loaded_port.user_factors.numpy(), np.asarray(loaded_ref.user_factors))
    np.testing.assert_array_equal(loaded_port.item_factors.numpy(), np.asarray(loaded_ref.item_factors))
    np.testing.assert_array_equal(loaded_port.item_predictable, loaded_ref.item_predictable)
    np.testing.assert_array_equal(loaded_port.user_predictable, loaded_ref.user_predictable)
    assert loaded_port.user_index.to_dict() == loaded_ref.user_index.to_dict()
    assert loaded_port.item_index.to_dict() == loaded_ref.item_index.to_dict()
    assert loaded_port.item_categories == loaded_ref.item_categories
    assert loaded_port.timestamp == loaded_ref.timestamp
    ids = [f"u{u}" for u in range(40)]
    assert _as_tuples(loaded_port.search_users(ids, 10, use_kernel=False)) == _as_tuples(
        loaded_ref.search_users(ids, 10, use_pallas=False)
    )
    assert loaded_port.serving_items()[0] == loaded_ref.serving_items()[0]


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    _, ref, _ = _fixture(seed=4, n_users=3, n_items=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        MatrixFactorizationIndex(np.asarray(ref.user_factors), np.asarray(ref.item_factors),
                                 ref.user_index, ref.item_index)
