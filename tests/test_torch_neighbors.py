"""The port's non-personalized, item-to-item and user-to-user recommenders
and the master's three update tasks, held against gorse_tpu on the CPU.

The same items, users and feedback (from a seed) go to both packages. The
non-personalized lists are host work in both and must be equal exactly.
The neighbour lists come from ops/similarity.py on the port's side and
jax on the reference's: their distances may differ by summation order,
within the tolerances of tests/test_torch_similarity.py (here the IDF
bound ``(4 L + 16) u``, L the most labels or users in a row, and the
embedding bound ``(4 d + 16) u (|x_i|^2 + |x_j|^2)``), and a score is
``1 / (1 + d)``, so each score is held within its distance's tolerance.
Ids must be equal and in the same order wherever neighbouring distances
differ by more than twice the tolerance; at the sizes used here that is
every slot except exact ties, whose order (lower index first) must also be
equal, so every list is in fact held id for id.
"""

import re

import numpy as np
import pytest

from gorse_tpu.data.loaders import synthetic_cf as ref_synthetic_cf
from gorse_tpu.logics.item_to_item import ItemToItemConfig as RefI2IConfig
from gorse_tpu.logics.item_to_item import new_item_to_item as ref_new_item_to_item
from gorse_tpu.logics.non_personalized import NonPersonalized as RefNonPersonalized
from gorse_tpu.logics.non_personalized import NonPersonalizedConfig as RefNPConfig
from gorse_tpu.logics.user_to_user import UserToUser as RefUserToUser
from gorse_tpu.logics.user_to_user import UserToUserConfig as RefU2UConfig
from gorse_tpu.serve.master import Master as RefMaster
from gorse_tpu.storage import types as ref_types
from gorse_tpu.storage.blob import BlobStore as RefBlobStore
from gorse_tpu.storage.cache import MemoryCacheStore as RefCache
from gorse_tpu.storage.data import MemoryDataStore as RefData
from gorse_tpu.storage.meta import MetaStore as RefMeta
from gorse_tpu.utils import config as ref_config
from gorse_tpu.utils.safe_expr import SafeExpression as RefSafeExpression
from gorse_tpu_torch.data.loaders import synthetic_cf
from gorse_tpu_torch.logics.item_to_item import ItemToItemConfig, new_item_to_item
from gorse_tpu_torch.logics.non_personalized import NonPersonalized, NonPersonalizedConfig
from gorse_tpu_torch.logics.user_to_user import UserToUser, UserToUserConfig
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.storage import cache as ck
from gorse_tpu_torch.storage import types
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore
from gorse_tpu_torch.storage.meta import MetaStore
from gorse_tpu_torch.utils import config as port_config
from gorse_tpu_torch.utils.safe_expr import SafeExpression

U = 2.0**-24
N_USERS, N_ITEMS, DIM, N_GENRES = 120, 90, 8, 6


def _items(t, seed: int = 0):
    """Items with 1-3 genres, an 8-float embedding, categories, timestamps
    with repeats, a few hidden; the same through either package's types."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_ITEMS):
        genres = sorted(rng.choice(N_GENRES, size=rng.integers(1, 4), replace=False).tolist())
        out.append(t.Item(
            f"i{i}", is_hidden=i % 17 == 5, categories=[f"c{i % 3}"],
            timestamp=float(rng.integers(0, 40)),
            labels={"genre": [f"g{g}" for g in genres],
                    "embedding": rng.normal(size=DIM).astype(np.float32).tolist()},
        ))
    return out


def _users(t):
    return [t.User(f"u{u}", labels={"age": f"a{u % 4}", "city": [f"c{u % 5}"]})
            for u in range(N_USERS)]


def _feedback(t):
    ds = synthetic_cf(N_USERS, N_ITEMS, 4, 0.08, seed=2)
    rows = [t.Feedback("like", f"u{u}", f"i{i}", 1.0, ts)
            for u, (fb, stamps) in enumerate(zip(ds.user_feedback, ds.timestamps))
            for i, ts in zip(fb, stamps)]
    rows += [t.Feedback("read", f"u{u}", f"i{(u * 7) % N_ITEMS}", 1.0, 5.0)
             for u in range(0, N_USERS, 3)]
    return ds, rows


def _idf_tol(widest: int) -> float:
    """A score's tolerance, its IDF distance's (L = ``widest``)."""
    return (4 * widest + 16) * U


def _emb_tol(mag: float) -> float:
    """A score's tolerance, its embedding distance's (mag = |x_i|^2 + |x_j|^2)."""
    return (4 * DIM + 16) * U * mag


def _assert_lists(got, want, tol_of):
    """(id, [Score]) lists of both packages: the same ids in the same order,
    scores within ``tol_of(id, neighbour id, score)``, the same categories."""
    assert [i for i, _ in got] == [i for i, _ in want]
    for (item_id, scores), (_, ref_scores) in zip(got, want):
        assert [s.id for s in scores] == [s.id for s in ref_scores], item_id
        for s, r in zip(scores, ref_scores):
            assert abs(s.score - r.score) <= tol_of(item_id, s.id, r.score), (item_id, s.id)
            assert s.categories == r.categories


# ---------------------------------------------------------------- engines


@pytest.mark.parametrize("cfg", [
    dict(name="popular"),
    dict(name="latest", score="item.timestamp"),
    dict(name="fresh", score="item.timestamp", filter="len(feedback) > 2"),
    dict(name="mix", score="len(feedback) + item.timestamp / 100", filter="not item.is_hidden"),
])
def test_non_personalized_matches_reference(cfg):
    items, ref_items = _items(types), _items(ref_types)
    _, rows = _feedback(types)
    _, ref_rows = _feedback(ref_types)
    port, ref = NonPersonalized(NonPersonalizedConfig(**cfg), 7), RefNonPersonalized(
        RefNPConfig(**cfg), 7)
    assert NonPersonalizedConfig(**cfg).digest() == RefNPConfig(**cfg).digest()
    for item, ref_item in zip(items, ref_items):
        port.push(item, [f for f in rows if f.item_id == item.item_id])
        ref.push(ref_item, [f for f in ref_rows if f.item_id == ref_item.item_id])
    got, want = port.pop_all(), ref.pop_all()
    assert [(s.id, s.score, s.categories) for s in got] == [
        (s.id, s.score, s.categories) for s in want]


@pytest.mark.parametrize("source", ["len(feedback)", "item.timestamp * 2 + 1",
                                    "max([1, 2]) if item.is_hidden else log(1 + len(feedback))",
                                    "__import__('os')", "item.__class__", "(lambda: 1)()"])
def test_safe_expression_is_the_reference(source):
    item = types.Item("a", timestamp=3.0)
    try:
        want = RefSafeExpression(source)(item=item, feedback=[1, 2])
    except ValueError:
        with pytest.raises(ValueError):
            SafeExpression(source)
        return
    assert SafeExpression(source)(item=item, feedback=[1, 2]) == want


def _engine_inputs():
    ds, _ = _feedback(types)
    ref_ds = ref_synthetic_cf(N_USERS, N_ITEMS, 4, 0.08, seed=2)
    np.testing.assert_array_equal(ds.user_idf(), ref_ds.user_idf())
    np.testing.assert_array_equal(ds.item_idf(), ref_ds.item_idf())
    assert ds.get_item_feedback() == ref_ds.get_item_feedback()
    assert ds.get_user_feedback() == ref_ds.get_user_feedback()
    return ds


@pytest.mark.parametrize("typ", ["embedding", "tags", "users", "auto"])
@pytest.mark.parametrize("with_idf", [False, True])
def test_item_to_item_engines_match_reference(typ, with_idf):
    ds = _engine_inputs()
    items, ref_items = _items(types, seed=3), _items(ref_types, seed=3)
    tag_idf = np.linspace(0.5, 2.0, N_GENRES).astype(np.float32) if with_idf else None
    user_idf = ds.user_idf() if with_idf else None
    kw = dict(name="e", type=typ, column="item.Labels.embedding" if typ == "embedding" else "")
    port = new_item_to_item(ItemToItemConfig(**kw), 10, timestamp=1.0, tag_idf=tag_idf,
                            user_idf=user_idf, device="cpu")
    ref = ref_new_item_to_item(RefI2IConfig(**kw), 10, timestamp=1.0, tag_idf=tag_idf,
                               user_idf=user_idf)
    assert ItemToItemConfig(**kw).digest() == RefI2IConfig(**kw).digest()
    for i, (item, ref_item) in enumerate(zip(items, ref_items)):
        port.push(item, ds.item_feedback[i])
        ref.push(ref_item, ds.item_feedback[i])
    vectors = {it.item_id: np.asarray(it.labels["embedding"], np.float64) for it in items}
    widest = max(max(len(f) for f in ds.item_feedback), 3)

    def tol_of(a, b, score):
        if typ == "embedding":
            return _emb_tol((vectors[a] ** 2).sum() + (vectors[b] ** 2).sum())
        return _idf_tol(widest)

    got, want = port.pop_all(), ref.pop_all()
    assert len(got) == N_ITEMS and all(len(s) == 10 for _, s in got)
    _assert_lists(got, want, tol_of)
    assert all(s.timestamp == 1.0 for _, scores in got for s in scores)


@pytest.mark.parametrize("typ", ["items", "tags", "auto", "embedding"])
def test_user_to_user_matches_reference(typ):
    ds = _engine_inputs()
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(N_USERS, DIM)).astype(np.float32).tolist()
    kw = dict(name="u", type=typ, column="user.Labels.v" if typ == "embedding" else "")
    port = UserToUser(UserToUserConfig(**kw), 8, timestamp=2.0, item_idf=ds.item_idf(),
                      device="cpu")
    ref = RefUserToUser(RefU2UConfig(**kw), 8, timestamp=2.0, item_idf=ds.item_idf())
    assert UserToUserConfig(**kw).digest() == RefU2UConfig(**kw).digest()
    for u, (user, ref_user) in enumerate(zip(_users(types), _users(ref_types))):
        user.labels["v"] = ref_user.labels["v"] = vecs[u]
        port.push(user, ds.user_feedback[u])
        ref.push(ref_user, ds.user_feedback[u])
    widest = max(len(f) for f in ds.user_feedback)
    mags = {f"u{u}": float(np.square(np.asarray(v, np.float64)).sum()) for u, v in enumerate(vecs)}

    def tol_of(a, b, score):
        return _emb_tol(mags[a] + mags[b]) if typ == "embedding" else _idf_tol(widest)

    _assert_lists(port.pop_all(), ref.pop_all(), tol_of)


def test_tags_without_an_index_number_labels_in_push_order():
    """Without a label index the local ids follow the push order, so two
    engines over the same corpus agree (and agree with the reference)."""
    def build(new, item):
        eng = new(ItemToItemConfig(name="t", type="tags"), n=3, **(
            {"device": "cpu"} if new is new_item_to_item else {}))
        for iid, labels in (("a", ["x", "y"]), ("b", ["x", "y", "z"]), ("c", ["z", "w"]),
                            ("d", ["w"])):
            eng.push(item(iid, labels=labels), [])
        assert eng._local_ids == {"x": 0, "y": 1, "z": 2, "w": 3}
        return [(i, [(s.id, round(s.score, 6)) for s in scores]) for i, scores in eng.pop_all()]

    first = build(new_item_to_item, types.Item)
    assert first == build(new_item_to_item, types.Item) == build(ref_new_item_to_item,
                                                                  ref_types.Item)
    # every label in two of four items: idf log 2; a and b share x and y
    d = 1 - 2 * np.log(2) * 2 / (np.sqrt(2 * np.log(2)) * np.sqrt(3 * np.log(2)) * 102)
    neighbor, score = dict(first)["a"][0]
    assert neighbor == "b" and abs(score - 1 / (1 + d)) < 1e-6


def test_small_catalogs_and_what_is_not_ported():
    """One item gives empty lists; ``chat`` without a client is the
    ``embedding`` type, as the reference's (its client case:
    tests/test_torch_chat.py); an unknown type raises as the reference
    does."""
    eng = new_item_to_item(ItemToItemConfig(name="t", type="users"), 5, device="cpu")
    eng.push(types.Item("only"), [1])
    assert eng.pop_all() == [("only", [])]
    emb = new_item_to_item(ItemToItemConfig(name="e", type="embedding", column="v"), 5,
                           device="cpu")
    emb.push(types.Item("novec", labels={"v": "text"}), [])
    assert emb.pop_all() == []
    chat = new_item_to_item(ItemToItemConfig(name="c", type="chat", column="v",
                                             prompt="{{ item }}"), 5, timestamp=1.0,
                            device="cpu")
    emb = new_item_to_item(ItemToItemConfig(name="c", type="embedding", column="v"), 5,
                           timestamp=1.0, device="cpu")
    for k in range(4):
        item = types.Item(f"c{k}", labels={"v": [float(k), float(k * k % 3)]})
        chat.push(item, [])
        emb.push(item, [])
    assert type(chat).__name__ == "ChatItemToItem" and chat.pop_all() == emb.pop_all()
    with pytest.raises(ValueError):
        new_item_to_item(ItemToItemConfig(name="x", type="nope"), 5, device="cpu")
    with pytest.raises(ValueError):
        UserToUser(UserToUserConfig(name="x", type="users"), 5, device="cpu")


# ---------------------------------------------------------------- masters


def _configure(cfg, mod):
    cfg.recommend.cache_size = 10
    cfg.recommend.non_personalized.append(
        mod.NonPersonalizedConfigEntry(name="fresh", score="item.timestamp",
                                       filter="len(feedback) > 2"))
    cfg.recommend.item_to_item.extend([
        mod.ItemToItemConfigEntry(name="by_users", type="users"),
        mod.ItemToItemConfigEntry(name="by_tags", type="tags"),
        mod.ItemToItemConfigEntry(name="by_auto", type="auto"),
        mod.ItemToItemConfigEntry(name="by_vec", type="embedding",
                                  column="item.Labels.embedding"),
    ])
    cfg.recommend.user_to_user.extend([
        mod.UserToUserConfigEntry(name="by_items", type="items"),
        mod.UserToUserConfigEntry(name="by_tags", type="tags"),
    ])
    return cfg


def _fill(data, t):
    data.insert_items(_items(t, seed=6))
    data.insert_users(_users(t))
    data.insert_feedback(_feedback(t)[1])


def _run(master):
    loaded = master.load_dataset()
    master.update_non_personalized(loaded)
    master.update_item_to_item(loaded)
    master.update_user_to_user(loaded)
    return loaded


@pytest.fixture(scope="module")
def masters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("neighbors")
    ref_data = RefData()
    _fill(ref_data, ref_types)
    ref = RefMaster(_configure(ref_config.Config(), ref_config), ref_data, RefCache(),
                    RefBlobStore(tmp / "ref"), RefMeta())
    data = MemoryDataStore()
    _fill(data, types)
    port = Master(_configure(port_config.Config(), port_config), data, MemoryCacheStore(),
                  BlobStore(tmp / "port"), MetaStore(), device="cpu")
    return ref, _run(ref), port, _run(port)


TIME_KEYS = (ck.NON_PERSONALIZED_UPDATE_TIME, ck.ITEM_TO_ITEM_UPDATE_TIME,
             ck.USER_TO_USER_UPDATE_TIME, ck.LAST_UPDATE_POPULAR_ITEMS_TIME,
             ck.LAST_UPDATE_LATEST_ITEMS_TIME)


def test_master_keys_and_digests_are_the_reference(masters):
    ref, _, port, _ = masters
    assert port.cache._kv.keys() == ref.cache._kv.keys()
    stamped = [k for k in port.cache._kv if any(t in k for t in TIME_KEYS)]
    assert len(stamped) == 3 + 4 + 2 + 2
    for k, v in port.cache._kv.items():
        if k in stamped:
            assert float(v) > 0 and float(ref.cache._kv[k]) > 0
        else:
            assert v == ref.cache._kv[k], k
    assert [s["Name"] for s in port.progress.list()] == [s["Name"] for s in ref.progress.list()]


def test_master_non_personalized_caches_are_the_reference(masters):
    ref, _, port, _ = masters
    names = sorted(port.cache.scan_score_subsets(ck.NON_PERSONALIZED))
    assert names == ["fresh", "latest", "popular"]
    assert names == sorted(ref.cache.scan_score_subsets(ck.NON_PERSONALIZED))
    for name in names:
        got = port.cache.search_scores(ck.NON_PERSONALIZED, name)
        want = ref.cache.search_scores(ck.NON_PERSONALIZED, name)
        assert [(s.id, s.score, s.categories) for s in got] == [
            (s.id, s.score, s.categories) for s in want]


@pytest.mark.parametrize("collection", [ck.ITEM_TO_ITEM, ck.USER_TO_USER])
def test_master_neighbour_caches_are_the_reference(masters, collection):
    ref, ref_loaded, port, loaded = masters
    subsets = sorted(port.cache.scan_score_subsets(collection))
    assert subsets == sorted(ref.cache.scan_score_subsets(collection))
    n_entities = N_ITEMS if collection == ck.ITEM_TO_ITEM else N_USERS
    assert len(subsets) == n_entities * (4 if collection == ck.ITEM_TO_ITEM else 2)
    ds = loaded.dataset
    widest = max(max(len(f) for f in ds.item_feedback), max(len(f) for f in ds.user_feedback),
                 len(ds.item_label_dict), len(ds.user_label_dict))
    vectors = {it.item_id: np.asarray(it.labels["embedding"], np.float64) for it in loaded.items}

    def tol_of(subset, b, score):
        name, a = subset.split("/", 1)
        if name == "by_vec":
            return _emb_tol((vectors[a] ** 2).sum() + (vectors[b] ** 2).sum())
        return _idf_tol(widest)

    got = [(s, port.cache.search_scores(collection, s)) for s in subsets]
    want = [(s, ref.cache.search_scores(collection, s)) for s in subsets]
    assert all(len(scores) == 10 for _, scores in got)
    _assert_lists(got, want, tol_of)


def test_master_gauges_and_the_digest_gate(masters):
    ref, ref_loaded, port, loaded = masters

    def gauges(m):
        text = m.metrics.render()
        return {name: float(re.search(rf"^\w+_{name} (\S+)$", text, re.M).group(1))
                for name in ("master_update_item_neighbors_total",
                             "master_update_user_neighbors_total")}

    assert gauges(port) == gauges(ref) == {"master_update_item_neighbors_total": N_ITEMS,
                                           "master_update_user_neighbors_total": N_USERS}
    # unchanged config and corpus within the cache period: no entry refreshes
    spans = len(port.progress.list())
    port.update_item_to_item(loaded)
    port.update_user_to_user(loaded)
    assert len(port.progress.list()) == spans
    # a changed entry refreshes on its own
    port.config.recommend.item_to_item[1].column = "changed"
    port.update_item_to_item(loaded)
    assert [s["Name"] for s in port.progress.list()[spans:]] == ["item_to_item/by_tags"]
