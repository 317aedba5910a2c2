"""The CTR data of the port against gorse_tpu's, on the CPU: the unified
and direct indexes, the padded view, the splits, the libFM parser,
``synthetic_ctr`` and the feature scalers. All are host code and must be
bit-equal (dicts equal, arrays equal dtype and value for value, the same
rows in the same order); the scalers' saved dicts equal, in the same key
order."""

import json

import numpy as np
import pytest

from gorse_tpu.data import ctr as ref_ctr
from gorse_tpu.data.dict import FreqDict as RefFreqDict
from gorse_tpu.data.unified_index import DirectIndex as RefDirectIndex
from gorse_tpu.data.unified_index import UnifiedIndex as RefUnifiedIndex
from gorse_tpu.models import scaler as ref_scaler
from gorse_tpu_torch.data import ctr
from gorse_tpu_torch.data.dict import FreqDict
from gorse_tpu_torch.data.unified_index import DirectIndex, UnifiedIndex
from gorse_tpu_torch.models import scaler


def _dicts(freq_dict):
    """Users, items and labels of either package, in one insertion order."""
    out = []
    for prefix, n in (("u", 7), ("i", 5), ("ul", 3), ("il", 4)):
        d = freq_dict()
        for j in range(n):
            d.add(f"{prefix}{j}")
        d.add(f"{prefix}0")  # a second occurrence: counts differ from ids
        out.append(d)
    return out


def test_unified_index_is_the_reference():
    port = UnifiedIndex(*_dicts(FreqDict))
    ref = RefUnifiedIndex(*_dicts(RefFreqDict))
    assert port.to_dict() == ref.to_dict()
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert len(port) == len(ref) == 19
    for name in ("item_offset", "user_label_offset", "item_label_offset",
                 "context_label_offset"):
        assert getattr(port, name) == getattr(ref, name), name
    for fn, names in (("encode_user", ["u0", "u6", "x"]), ("encode_item", ["i4", "u0"]),
                      ("encode_user_label", ["ul2", "il0"]), ("encode_item_label", ["il3", "z"]),
                      ("encode_context_label", ["c"])):
        for name in names:
            assert getattr(port, fn)(name) == getattr(ref, fn)(name), (fn, name)
    back = UnifiedIndex.from_dict(ref.to_dict())
    assert back.to_dict() == RefUnifiedIndex.from_dict(port.to_dict()).to_dict()


def test_direct_index_is_the_reference():
    port, ref = DirectIndex(12), RefDirectIndex(12)
    assert port.to_dict() == ref.to_dict() == {"direct": 12}
    assert DirectIndex.from_dict(ref.to_dict()).n == RefDirectIndex.from_dict(port.to_dict()).n
    for name in ("0", "11", "12", "-1", "a"):
        assert port.encode_item(name) == ref.encode_item(name)
        assert port.encode_user_label(name) == ref.encode_user_label(name)
    assert len(port) == len(ref)


def _rows(module, n=60, seed=3, embeddings=False):
    """A dataset of ragged rows (1 to 6 features, some numerical), users
    and timestamps with ties, from ``seed``; an embedding column whose
    vectors are missing on some rows when ``embeddings``."""
    rng = np.random.default_rng(seed)
    d = module.CTRDataset(module.DirectIndex(40))
    if embeddings:
        d.embedding_dims = [5]
        d.embeddings = [[]]
    for _ in range(n):
        m = int(rng.integers(1, 7))
        idx = rng.choice(40, size=m, replace=False).tolist()
        val = [1.0 if rng.uniform() < 0.7 else float(rng.normal()) for _ in range(m)]
        emb = None
        if embeddings:
            emb = [None if rng.uniform() < 0.3 else rng.normal(size=5).astype(np.float32)]
        d.add(idx, val, float(rng.uniform() < 0.4), user=int(rng.integers(6)),
              timestamp=float(rng.integers(0, 5)), embeddings=emb)
    return d


def _same_rows(a, b):
    assert a.features == b.features
    assert a.targets == b.targets and a.users == b.users and a.timestamps == b.timestamps
    assert a.embedding_dims == b.embedding_dims
    assert len(a.embeddings) == len(b.embeddings)
    for ca, cb in zip(a.embeddings, b.embeddings):
        assert [None if e is None else e.tolist() for e in ca] == \
               [None if e is None else e.tolist() for e in cb]


@pytest.mark.parametrize("pad_to", [None, 9])
@pytest.mark.parametrize("embeddings", [False, True])
def test_padded_is_the_reference(pad_to, embeddings):
    port, ref = _rows(ctr, embeddings=embeddings), _rows(ref_ctr, embeddings=embeddings)
    _same_rows(port, ref)
    assert port.max_dimension() == ref.max_dimension() == 6
    assert (port.count_positive(), port.count_negative()) == (
        ref.count_positive(), ref.count_negative())
    a, b = port.padded(pad_to), ref.padded(pad_to)
    for name in ("indices", "values", "valid", "targets"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert len(a.embeddings) == len(b.embeddings)
    for x, y in zip(a.embeddings, b.embeddings):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_padded_of_an_empty_dataset():
    a, b = ctr.CTRDataset().padded(), ref_ctr.CTRDataset().padded()
    assert a.indices.shape == b.indices.shape == (0, 1)
    assert a.values.dtype == b.values.dtype and a.valid.dtype == b.valid.dtype


@pytest.mark.parametrize("ratio, seed", [(0.2, 0), (0.2, 1), (0.5, 7), (0.0, 3)])
def test_split_is_the_reference(ratio, seed):
    port, ref = _rows(ctr, embeddings=True), _rows(ref_ctr, embeddings=True)
    for a, b in zip(port.split(ratio, seed), ref.split(ratio, seed)):
        _same_rows(a, b)
        assert a.index is port.index


@pytest.mark.parametrize("ratio", [0.2, 0.5])
def test_split_by_user_time_is_the_reference(ratio):
    port, ref = _rows(ctr, n=80, embeddings=True), _rows(ref_ctr, n=80, embeddings=True)
    for a, b in zip(port.split_by_user_time(ratio), ref.split_by_user_time(ratio)):
        _same_rows(a, b)


LIBFM_TRAIN = "1 0:1 3:0.5\n-1 1:1 2:1\n\n0 4:2 7\n1 6:0.1 2:-3.25\n"
LIBFM_TEST = "1 0:1 5:1\n0 9:0.3\n"


def test_libfm_round_trip(tmp_path):
    """The port parses in Python, the reference natively where it can: the
    rows' ids, targets and float32 values must agree, and the shared
    index must cover both files."""
    p, q = tmp_path / "train.libfm", tmp_path / "test.libfm"
    p.write_text(LIBFM_TRAIN)
    q.write_text(LIBFM_TEST)
    train, test = ctr.load_libfm(str(p), str(q))
    ref_train, ref_test = ref_ctr.load_libfm(str(p), str(q))
    for a, b in ((train, ref_train), (test, ref_test)):
        assert a.targets == b.targets
        assert [f[0] for f in a.features] == [f[0] for f in b.features]
        assert [np.float32(f[1]).tolist() for f in a.features] == \
               [np.float32(f[1]).tolist() for f in b.features]
        assert a.index.to_dict() == b.index.to_dict() == {"direct": 10}
        assert np.array_equal(a.padded().values, b.padded().values)
    assert train.targets == [1.0, 0.0, 0.0, 1.0]
    assert train.features[2] == ([4, 7], [2.0, 1.0])
    assert test.index is train.index


@pytest.mark.parametrize("kwargs", [
    {"n_samples": 300, "seed": 0},
    {"n_samples": 200, "seed": 5, "numerical": True},
    {"n_users": 30, "n_items": 20, "n_user_labels": 3, "n_item_labels": 4, "rank": 2,
     "n_samples": 150, "seed": 2},
])
def test_synthetic_ctr_is_the_reference(kwargs):
    port, ref = ctr.synthetic_ctr(**kwargs), ref_ctr.synthetic_ctr(**kwargs)
    _same_rows(port, ref)
    assert port.index.to_dict() == ref.index.to_dict()
    assert port.num_features() == ref.num_features()


# ---------------------------------------------------------------- scalers
# tests/test_fm.py's scaler cases, each run against both packages


def _case_scalers(mod):
    mm = mod.MinMaxScaler().fit(np.array([1.0, 3.0]))
    rs = mod.RobustScaler().fit(np.arange(101, dtype=np.float32))
    a = mod.AutoScaler().fit(np.array([0.0, 1.0, 10.0, 100.0], dtype=np.float32))
    a2 = mod.AutoScaler().fit(np.array([-5.0, 0.0, 5.0], dtype=np.float32))
    assert mm.transform(2.0) == 0.5
    assert mod.MinMaxScaler().fit(np.array([2.0, 2.0])).transform(2.0) == 1
    assert a.use_log and 0.0 <= a.transform(5.0) <= 1.0 and not a2.use_log
    return [mm.transform(2.0), rs.transform(50.0), a.transform(5.0), a2.transform(2.5),
            mm.to_dict(), rs.to_dict(), a.to_dict(), a2.to_dict()]


def _case_only_numerical(mod):
    scalers = mod.fit_auto_scalers([([0, 1], [1.0, 3.5]), ([0, 1], [1.0, 2.0])])
    assert 1 in scalers and 0 not in scalers
    return {k: s.to_dict() for k, s in scalers.items()}


def _case_clamps_negative(mod):
    s = mod.AutoScaler().fit(np.array([0.0, 1.0, 10.0, 100.0], dtype=np.float32))
    out = s.transform(np.array([-5.0, -1.0, 0.0, 10.0], dtype=np.float32))
    assert np.all(np.isfinite(out)) and out[0] == out[1] == out[2]
    return out.tolist()


def _case_rows(mod):
    """fit_auto_scalers on synthetic numerical rows and on rows with
    negatives and a constant feature, then apply_scalers over the padded
    view; the scalers in first-occurrence order."""
    rows = _rows(ref_ctr, n=200, seed=11)
    rows.add([39, 2], [-4.0, 2.0], 1.0)
    rows.add([38], [7.0], 0.0)
    rows.add([38], [7.0], 1.0)  # a constant non-1 feature: a degenerate range
    data = ref_ctr.synthetic_ctr(n_samples=200, seed=4, numerical=True)
    out = []
    for d in (rows, data):
        scalers = mod.fit_auto_scalers(d.features)
        pad = d.padded()
        values = mod.apply_scalers(pad.indices, pad.values, scalers, pad.valid)
        out.append((list(scalers), {k: s.to_dict() for k, s in scalers.items()},
                    values.dtype.str, values.tolist()))
    return out


@pytest.mark.parametrize("case", [_case_scalers, _case_only_numerical, _case_clamps_negative,
                                  _case_rows])
def test_scalers_are_the_reference(case):
    port, ref = case(scaler), case(ref_scaler)
    assert json.dumps(port) == json.dumps(ref)


def test_scaler_dicts_load_across_packages():
    values = np.array([-2.0, 0.5, 3.0, 9.0], np.float32)
    for src, dst in ((scaler, ref_scaler), (ref_scaler, scaler)):
        s = src.AutoScaler().fit(values)
        back = dst.AutoScaler.from_dict(json.loads(json.dumps(s.to_dict())))
        assert back.to_dict() == s.to_dict()
        assert np.array_equal(back.transform(values), s.transform(values))
