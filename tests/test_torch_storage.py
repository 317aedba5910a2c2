"""The port's data and cache stores (gorse_tpu_torch/storage/data.py,
cache.py) against gorse_tpu's.

The cases of tests/test_storage.py run, as cases of one parametrised test,
over both packages' memory and SQLite stores, each recording what every
call returned (entities as ``dataclasses.asdict``): the port's records
must equal the reference's field for field. Then the file formats: a
``data.sqlite`` and a ``cache.sqlite`` written by either package read back
equal in the other. Then full-text search (``reconcile``, ``search_items``)
with the FTS5 index and without it, a search while the index is rebuilt,
and the URL schemes: ``proxy://`` raising, the remote ones dialling what
the reference's openers dial."""

import dataclasses
import threading

import pytest

import gorse_tpu.storage.cache as RC
import gorse_tpu.storage.data as RD
import gorse_tpu.storage.types as RT
import gorse_tpu_torch.storage.cache as PC
import gorse_tpu_torch.storage.data as PD
import gorse_tpu_torch.storage.types as PT

PACKAGES = {"port": (PD, PC, PT), "ref": (RD, RC, RT)}


def _rec(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_rec(v) for v in x]
    return x


# ---------------------------------------------------------------- data cases


def data_users_crud(store, t):
    store.insert_users([t.User("u1", labels={"city": "x"}), t.User("u2", comment="c",
                                                                   subscribe=["a"])])
    out = [_rec(store.get_user("u1")), _rec(list(store.get_users()))]
    out.append(_rec(list(store.get_users(begin_id="u1"))))
    out.append(_rec(list(store.get_users(limit=1))))
    store.delete_user("u1")
    return out + [_rec(store.get_user("u1")), store.count_users()]


def data_items_crud(store, t):
    store.insert_items([
        t.Item("i1", categories=["a"], timestamp=100.0),
        t.Item("i2", is_hidden=True, timestamp=200.0),
        t.Item("i3", categories=["a", "b"], timestamp=300.0, labels={"t": [1, 2]}, comment="x"),
    ])
    return [
        _rec(store.get_item("i2")),
        _rec(store.get_latest_items(10)),
        _rec(store.get_latest_items(10, categories=["b"])),
        _rec(store.get_latest_items(10, after=150.0)),
        _rec(store.get_latest_items(1)),
        _rec(store.batch_get_items(["i1", "i2", "zzz"], skip_hidden=True)),
        _rec(store.batch_get_items(["i3", "i1"], after=150.0)),
        _rec(list(store.get_items(begin_id="i1", limit=1))),
        store.count_items(),
    ]


def data_feedback_insert_and_query(store, t):
    store.insert_feedback([
        t.Feedback("read", "u1", "i1", timestamp=1.0),
        t.Feedback("like", "u1", "i2", 2.0, timestamp=2.0, comment="nice"),
        t.Feedback("read", "u2", "i1", timestamp=3.0),
    ])
    out = [_rec(store.get_user("u1")), _rec(store.get_item("i2"))]
    out.append(_rec(store.get_user_feedback("u1")))
    out.append(_rec(store.get_user_feedback("u1", feedback_types=["like"])))
    out.append(_rec(store.get_user_feedback("u1", end_time=1.5)))
    out.append(sorted(map(str, _rec(store.get_item_feedback("i1")))))
    out.append(sorted(map(str, _rec(list(store.get_feedback(begin_time=1.5))))))
    out.append(store.count_feedback())
    store.insert_feedback([t.Feedback("read", "u1", "i1", 9.0, timestamp=9.0)], overwrite=False)
    out.append(_rec(store.get_user_feedback("u1")))
    out.append(store.delete_user_item_feedback("u1", "i2"))
    return out + [store.count_feedback()]


def data_feedback_no_insert_flags(store, t):
    store.insert_feedback([t.Feedback("read", "nope", "i9", timestamp=1.0)],
                          insert_user=False, insert_item=True)
    store.insert_users([t.User("u")])
    store.insert_feedback([t.Feedback("read", "u", "i9", timestamp=1.0)],
                          insert_user=False, insert_item=False)
    return [store.count_feedback(), store.count_items(), store.count_users()]


def data_item_search(store, t):
    store.insert_items([
        t.Item("film1", comment="a space opera classic", labels={"title": "Star Battles"}),
        t.Item("film2", comment="romantic drama", labels={"title": "The Notebook Returns"}),
        t.Item("film3", comment="space documentary", labels={"title": "Cosmos Explained"}),
    ])
    out = [_rec(store.search_items("space", 10))]
    store.reconcile(["comment", "labels.title"])
    out.append(sorted(i.item_id for i in store.search_items("space", 10)))
    out.append(_rec(store.search_items("notebook", 10)))
    out.append(sorted(i.item_id for i in store.search_items("cosm", 10)))
    out.append(_rec(store.search_items("film2", 10)))
    store.delete_item("film3")
    out.append(_rec(store.search_items("space", 10)))
    return out


DATA_CASES = {f.__name__: f for f in (data_users_crud, data_items_crud,
                                       data_feedback_insert_and_query,
                                       data_feedback_no_insert_flags, data_item_search)}


# --------------------------------------------------------------- cache cases


def cache_kv_and_queue(store, t):
    store.set("k1", "v1")
    out = [store.get("k1")]
    store.delete("k1")
    out.append(store.get("k1"))
    for v in ("a", "b", "a"):
        store.push("q", v)
    out.append(store.remain("q"))
    out += [store.pop("q"), store.pop("q"), store.pop("q")]
    return out


def cache_scores(store, t):
    store.add_scores("recommend", "u1", [
        t.Score("i1", 0.9, ["a"], 5.0), t.Score("i2", 0.5, []), t.Score("i3", 0.7, ["a", "b"]),
    ])
    out = [_rec(store.search_scores("recommend", "u1"))]
    out.append(_rec(store.search_scores("recommend", "u1", categories=["a"])))
    out.append(_rec(store.search_scores("recommend", "u1", begin=1, end=2)))
    store.add_scores("recommend", "u1", [t.Score("i2", 1.5, [])])
    out.append(_rec(store.search_scores("recommend", "u1")))
    store.update_scores(["recommend"], None, "i2", is_hidden=True)
    out.append(_rec(store.search_scores("recommend", "u1")))
    store.update_scores(["recommend"], "u1", "i3", categories=["z"])
    out.append(_rec(store.search_scores("recommend", "u1", categories=["z"])))
    out.append(sorted(str(_rec(r)) for r in store.scan_scores("recommend")))
    store.add_scores("recommend", "u2", [t.Score("i9", 0.1, [])])
    out.append(sorted(store.scan_score_subsets("recommend")))
    out.append(list(store.scan_score_subsets("no-such-collection")))
    store.delete_scores("recommend", ["u1", "u2"])
    out.append(_rec(store.search_scores("recommend", "u1")))
    return out


def cache_delete_scores_before(store, t):
    store.add_scores("recommend", "u", [
        t.Score("old", 1.0, [], timestamp=10.0), t.Score("new", 0.5, [], timestamp=100.0),
    ])
    store.add_scores("other", "v", [t.Score("x", 1.0, [], timestamp=10.0)])
    store.delete_scores("recommend", ["u"], before=50.0)
    store.delete_scores("other", before=50.0)
    return [_rec(store.search_scores("recommend", "u")), _rec(store.search_scores("other", "v"))]


def cache_time_series(store, t):
    store.add_time_series_points([
        t.TimeSeriesPoint("m", 1.0, 10.0), t.TimeSeriesPoint("m", 2.0, 20.0),
        t.TimeSeriesPoint("other", 1.5, 99.0),
    ])
    return [_rec(store.get_time_series_points("m", 0.0, 10.0)),
            _rec(store.get_time_series_points("m", 1.5, 10.0))]


CACHE_CASES = {f.__name__: f for f in (cache_kv_and_queue, cache_scores,
                                        cache_delete_scores_before, cache_time_series)}


def _open(kind, pkg, backend, tmp_path):
    data_mod, cache_mod, _ = PACKAGES[pkg]
    if backend == "memory":
        return data_mod.MemoryDataStore() if kind == "data" else cache_mod.MemoryCacheStore()
    path = str(tmp_path / f"{pkg}_{kind}.sqlite")
    return data_mod.SQLiteDataStore(path) if kind == "data" else cache_mod.SQLiteCacheStore(path)


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
@pytest.mark.parametrize("case", sorted(DATA_CASES) + sorted(CACHE_CASES))
def test_store_case_is_the_reference(tmp_path, case, backend):
    kind, fn = (("data", DATA_CASES[case]) if case in DATA_CASES
                else ("cache", CACHE_CASES[case]))
    records = {}
    for pkg in ("port", "ref"):
        store = _open(kind, pkg, backend, tmp_path)
        records[pkg] = fn(store, PACKAGES[pkg][2])
        store.close()
    assert records["port"] == records["ref"]


# ------------------------------------------------------------ file interchange


def _fill_data(store, t):
    store.insert_users([t.User(f"u{u}", labels={"age": u}, comment=f"c{u}",
                               subscribe=[f"s{u % 2}"]) for u in range(5)])
    store.insert_items([t.Item(f"i{i}", is_hidden=i == 3, categories=[f"c{i % 2}"],
                               timestamp=float(i * 10), labels={"genre": [f"g{i % 3}"]},
                               comment=f"item {i}") for i in range(7)])
    store.insert_feedback([t.Feedback(("like", "read", "star")[(u + i) % 3], f"u{u}", f"i{i}",
                                      float(u + i), float(u * 7 + i), f"fb{u}{i}")
                           for u in range(5) for i in range(7) if (u * i) % 3 != 1])
    store.insert_feedback([t.Feedback("like", "u9", "i9", 1.0, 3.0)])  # auto-inserted


def _read_data(store) -> list:
    return [
        _rec(list(store.get_users())), _rec(list(store.get_items())),
        _rec(list(store.get_feedback())), _rec(store.get_latest_items(4)),
        [_rec(store.get_user_feedback(f"u{u}")) for u in range(5)],
        [store.count_users(), store.count_items(), store.count_feedback()],
    ]


def _fill_cache(store, t):
    store.set("recommend_digest/u1", "abc")
    for v in ("x", "y"):
        store.push("queue", v)
    store.add_scores("recommend", "u1", [t.Score(f"i{i}", 1.0 / (i + 1), [f"c{i % 2}"], 7.0)
                                         for i in range(6)])
    store.add_scores("item-to-item", "n/i1", [t.Score("i2", 0.5, [], 8.0)])
    store.update_scores(["recommend"], "u1", "i2", is_hidden=True)
    store.add_time_series_points([t.TimeSeriesPoint("num_users", 5.0, 11.0)])


def _read_cache(store) -> list:
    return [
        store.get("recommend_digest/u1"), store.remain("queue"),
        _rec(store.search_scores("recommend", "u1")),
        _rec(store.search_scores("recommend", "u1", categories=["c1"])),
        sorted(str(_rec(r)) for r in store.scan_scores("item-to-item")),
        _rec(store.get_time_series_points("num_users", 0.0, 100.0)),
    ]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_data_sqlite_interchange(tmp_path, writer, reader):
    path = str(tmp_path / "data.sqlite")
    wrote = PACKAGES[writer][0].SQLiteDataStore(path)
    _fill_data(wrote, PACKAGES[writer][2])
    want = _read_data(wrote)
    wrote.close()
    read = PACKAGES[reader][0].open_data_store(f"sqlite://{path}")
    assert _read_data(read) == want
    read.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_cache_sqlite_interchange(tmp_path, writer, reader):
    import shutil

    path = str(tmp_path / "cache.sqlite")
    wrote = PACKAGES[writer][1].SQLiteCacheStore(path)
    _fill_cache(wrote, PACKAGES[writer][2])
    want = _read_cache(wrote)
    wrote.close()
    shutil.copy(path, tmp_path / "copy.sqlite")
    read = PACKAGES[reader][1].open_cache_store(f"sqlite://{path}")
    assert _read_cache(read) == want
    # the queue pops in the same order as the writer's own store pops it
    again = PACKAGES[writer][1].SQLiteCacheStore(str(tmp_path / "copy.sqlite"))
    assert [read.pop("queue") for _ in range(3)] == [again.pop("queue") for _ in range(3)]
    read.close()
    again.close()


def test_sqlite_schema_is_the_reference(tmp_path):
    """The same tables, columns and indexes in both packages' files."""
    import sqlite3

    def schema(path):
        with sqlite3.connect(path) as conn:
            return sorted(conn.execute("SELECT type, name, sql FROM sqlite_master").fetchall())

    for kind in ("data", "cache"):
        for pkg in PACKAGES:
            store = _open(kind, pkg, "sqlite", tmp_path)
            if kind == "data":
                store.reconcile(["comment"])
            store.close()
        assert schema(tmp_path / f"port_{kind}.sqlite") == schema(tmp_path / f"ref_{kind}.sqlite")


# ------------------------------------------------------------- search


SEARCH_QUERIES = ("space", "notebook", "cosm", "star battles", "item", "film2", "", "zzz",
                  "opera classic")


def _search_items(t):
    return [t.Item("film1", comment="a space opera classic", labels={"title": "Star Battles"}),
            t.Item("film2", comment="romantic drama", labels={"title": "The Notebook Returns"}),
            t.Item("film3", comment="space documentary", labels={"title": "Cosmos Explained"}),
            t.Item("film4", comment="space space item", categories=["x"],
                   labels={"title": {"en": "Item Four"}})]


@pytest.mark.parametrize("backend", ["memory", "sqlite_fts", "sqlite_scan"])
@pytest.mark.parametrize("columns", [["comment"], ["comment", "labels.title"], ["item.item_id"],
                                     ["labels"], ["categories", "Item.Comment"]])
def test_search_items_is_the_reference(tmp_path, backend, columns):
    """``sqlite_fts``: reconciled, FTS5's bm25 order; ``sqlite_scan``: never
    reconciled, the columns given at query time (the tokenized scan)."""
    got = {}
    for pkg in PACKAGES:
        store = _open("data", pkg, "memory" if backend == "memory" else "sqlite", tmp_path)
        store.insert_items(_search_items(PACKAGES[pkg][2]))
        if backend != "sqlite_scan":
            store.reconcile(columns)
        got[pkg] = [[i.item_id for i in store.search_items(
            q, 3, columns=None if backend != "sqlite_scan" else columns)]
            for q in SEARCH_QUERIES]
        store.close()
    assert got["port"] == got["ref"]


def test_reconcile_keeps_the_index_and_drops_it(tmp_path):
    """Unchanged columns keep the index (items inserted since are in it);
    no columns drop it, and search then finds nothing, as the reference."""
    got = {}
    for pkg in PACKAGES:
        store = _open("data", pkg, "sqlite", tmp_path)
        t = PACKAGES[pkg][2]
        store.insert_items(_search_items(t))
        store.reconcile(["comment"])
        store.insert_items([t.Item("film5", comment="deep space nine")])
        store.reconcile(["comment"])
        first = [i.item_id for i in store.search_items("space", 10)]
        store.reconcile([])
        got[pkg] = (first, store._fts_ready, [i.item_id for i in store.search_items("space", 10)])
        store.close()
    assert got["port"] == got["ref"] and "film5" in got["port"][0]


def test_search_while_the_index_is_rebuilt(tmp_path):
    """reconcile records its columns before it takes the lock, as the
    reference does: searches on other threads while the index is rebuilt
    raise nothing, and those run after it give the reference's answer."""
    store = PD.SQLiteDataStore(str(tmp_path / "data.sqlite"))
    store.insert_items([PT.Item(f"i{n}", comment=f"word{n % 50} common") for n in range(4000)])
    errors, answers = [], []
    stop = threading.Event()

    def search():
        while not stop.is_set():
            try:
                answers.append([i.item_id for i in store.search_items("word7", 5)])
            except Exception as e:  # noqa: BLE001 - recorded and asserted on
                errors.append(e)

    threads = [threading.Thread(target=search) for _ in range(3)]
    for th in threads:
        th.start()
    for columns in (["comment"], ["item_id", "comment"], ["comment"]):
        store.reconcile(columns)
    stop.set()
    for th in threads:
        th.join()
    assert not errors and answers
    ref = RD.SQLiteDataStore(str(tmp_path / "ref.sqlite"))
    ref.insert_items([RT.Item(f"i{n}", comment=f"word{n % 50} common") for n in range(4000)])
    ref.reconcile(["comment"])
    assert [i.item_id for i in store.search_items("word7", 5)] == \
           [i.item_id for i in ref.search_items("word7", 5)]
    store.close()
    ref.close()


def test_item_search_without_reconcile_across_processes(tmp_path):
    """A store opened on a file another store indexed searches with the
    columns it is given; feedback-inserted items join the index."""
    path = str(tmp_path / "shared.db")
    writer = RD.SQLiteDataStore(path)
    writer.insert_items([RT.Item("m1", comment="space opera")])
    writer.reconcile(["comment"])
    writer.close()
    reader = PD.SQLiteDataStore(path)
    assert [i.item_id for i in reader.search_items("space", 5, columns=["comment"])] == ["m1"]
    reader.reconcile(["item_id", "comment"])
    reader.insert_feedback([PT.Feedback("like", "u1", "brandnew42")])
    assert [i.item_id for i in reader.search_items("brandnew42", 5)] == ["brandnew42"]
    reader.close()


# ------------------------------------------------------------- URLs


class _Dialled(Exception):
    """Raised in place of a store's connection: what it would have dialled."""


def _dial_of(pkg: str, url: str, opener: str, monkeypatch) -> tuple:
    """The connection ``opener`` of package ``pkg`` makes for ``url``, by
    class and arguments, caught before it reaches the network."""
    import importlib

    root = "gorse_tpu_torch" if pkg == "port" else "gorse_tpu"
    for module, name in (("pgwire", "PGConnection"), ("mysqlwire", "MySQLConnection"),
                         ("chhttp", "ClickHouseConnection"), ("redis", "RespClient"),
                         ("redis", "RespClusterClient")):
        def dial(*args, _name=name, **kwargs):
            raise _Dialled(_name, args, kwargs)

        monkeypatch.setattr(importlib.import_module(f"{root}.storage.{module}"), name, dial)

    class Mongo:
        @staticmethod
        def from_url(*args, **kwargs):
            raise _Dialled("MongoConnection", args, kwargs)

    monkeypatch.setattr(importlib.import_module(f"{root}.storage.mongo"), "MongoConnection",
                        Mongo)
    mod = importlib.import_module(f"{root}.storage.{opener}")
    with pytest.raises(_Dialled) as caught:
        getattr(mod, f"open_{opener}_store")(url, table_prefix="p_")
    return caught.value.args


@pytest.mark.parametrize("url", ["proxy://127.0.0.1:8086", "mysql://u:p@h:3306/db",
                                 "postgres://u:p@h/db", "postgresql://u:p@h/db",
                                 "clickhouse://h:8123/db", "mongodb://h:27017/db"])
def test_data_store_schemes_not_ported_raise_m21(url, monkeypatch):
    """Every scheme opens what the reference's opener opens: ``proxy://``
    the proxy store on the same target (its channel connects at the first
    call), the others dial what the reference dials, with the same
    arguments (caught here before any connection)."""
    if url.startswith("proxy://"):
        got, want = PD.open_data_store(url), RD.open_data_store(url)
        assert type(got).__name__ == type(want).__name__ == "ProxyDataStore"
        assert got._channel.target == url[len("proxy://"):]
        got.close()
        want.close()
        return
    assert _dial_of("port", url, "data", monkeypatch) == _dial_of("ref", url, "data", monkeypatch)


@pytest.mark.parametrize("url", ["redis://h:6379/0", "redis+cluster://h:6379", "proxy://h:1",
                                 "mysql://u:p@h/db", "postgres://u:p@h/db",
                                 "postgresql://u:p@h/db", "mongodb://h/db"])
def test_cache_store_schemes_not_ported_raise_m21(url, monkeypatch):
    """As for the data store: ``proxy://`` opens the proxy store on the
    same target, the rest dial what the reference dials."""
    if url.startswith("proxy://"):
        got, want = PC.open_cache_store(url), RC.open_cache_store(url)
        assert type(got).__name__ == type(want).__name__ == "ProxyCacheStore"
        assert got._channel.target == url[len("proxy://"):]
        got.close()
        want.close()
        return
    assert _dial_of("port", url, "cache", monkeypatch) == \
        _dial_of("ref", url, "cache", monkeypatch)


@pytest.mark.parametrize("url,kind", [("memory://", "Memory"), ("sqlite://", "SQLite"),
                                      ("none://", "No"), ("", "No"), ("memory", "Memory")])
def test_open_by_url_is_the_reference(url, kind):
    from gorse_tpu_torch.storage.none import NoDatabaseError

    for opener, ref_opener in ((PD.open_data_store, RD.open_data_store),
                               (PC.open_cache_store, RC.open_cache_store)):
        got, want = opener(url), ref_opener(url)
        assert type(got).__name__ == type(want).__name__ and type(got).__name__.startswith(kind)
        assert got.ping() == want.ping()
        if kind == "No":
            with pytest.raises(NoDatabaseError):
                got.get_user("u") if opener is PD.open_data_store else got.get("k")
        got.close()
        want.close()
    with pytest.raises(ValueError):
        PD.open_data_store("bogus://x")
    with pytest.raises(ValueError):
        PC.open_cache_store("bogus://x")


def test_stores_from_config_use_the_config(tmp_path):
    from gorse_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.database.data_store = f"sqlite://{tmp_path / 'd.sqlite'}"
    cfg.database.cache_store = f"sqlite://{tmp_path / 'c.sqlite'}"
    data, cache = PD.open_data_store_from_config(cfg.database), \
        PC.open_cache_store_from_config(cfg.database)
    assert isinstance(data, PD.SQLiteDataStore) and isinstance(cache, PC.SQLiteCacheStore)
    data.close()
    cache.close()
    assert (tmp_path / "d.sqlite").exists() and (tmp_path / "c.sqlite").exists()
