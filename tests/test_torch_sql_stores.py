"""The port's remote data and cache stores against gorse_tpu's: the server
SQL stores (gorse_tpu_torch/storage/sqlstores.py over mysqlwire.py,
pgwire.py and chhttp.py), Redis (redis.py over resp.py) and MongoDB
(mongo.py over mongowire.py).

The cases of tests/test_torch_storage.py run, as cases of one parametrised
contract test, on each backend: MySQL, Postgres and ClickHouse (data;
ClickHouse is no cache store in the reference either), MySQL, Postgres,
Redis, a three-node Redis Cluster and MongoDB (cache), MongoDB (data), each
store on the port's server (Mongo: the port's ``MiniMongo``); each records what every call returned, and the records
must be equal. A case a backend then crosses packages: the port's store on
gorse_tpu's server and gorse_tpu's on the port's give the same. Then the
SQL layer itself: ``sql_literal``/``sql_interpolate`` against the
reference's on the same values, MySQL's backslash rule, each wire client's
refusal of a bad password on either package's server, and the dialects'
DDL."""

import importlib
import threading

import pytest

import gorse_tpu.storage.cache as RC
import gorse_tpu.storage.data as RD
import gorse_tpu.storage.minisql as RMS
import gorse_tpu.storage.resp as RRESP
import gorse_tpu.storage.sqlstores as RSQL
import gorse_tpu_torch.storage.cache as PC
import gorse_tpu_torch.storage.data as PD
import gorse_tpu_torch.storage.minisql as PMS
import gorse_tpu_torch.storage.resp as PRESP
import gorse_tpu_torch.storage.sqlstores as PSQL
from test_torch_storage import CACHE_CASES, DATA_CASES, PACKAGES

SERVERS = {"port": (PMS, PRESP), "ref": (RMS, RRESP)}
DATA_BACKENDS = ("mysql", "postgres", "clickhouse", "mongodb")
CACHE_BACKENDS = ("mysql", "postgres", "redis", "redis-cluster", "mongodb")
CASES = ([(b, c) for b in DATA_BACKENDS for c in sorted(DATA_CASES)]
         + [(b, c) for b in CACHE_BACKENDS for c in sorted(CACHE_CASES)])


class _Server:
    """A backend's server from package ``pkg``: ``url`` and ``close``."""

    def __init__(self, backend: str, pkg: str) -> None:
        minisql, resp = SERVERS[pkg]
        if backend == "mongodb":
            minimongo = importlib.import_module(
                {"port": "gorse_tpu_torch", "ref": "gorse_tpu"}[pkg] + ".storage.minimongo")
            self._mini = minimongo.MiniMongo().start()
            self.url, self.close = self._mini.url(), self._mini.stop
        elif backend in ("redis", "redis-cluster"):
            self._mini = resp.MiniRedis() if backend == "redis" else resp.MiniRedisCluster(3)
            self.url, self.close = self._mini.url, self._mini.close
        else:
            cls = {"mysql": minisql.MiniMySQL, "postgres": minisql.MiniPostgres,
                   "clickhouse": minisql.MiniClickHouse}[backend]
            self._mini = cls().start()
            self.url, self.close = self._mini.url(), self._mini.stop


@pytest.fixture(scope="module")
def servers():
    """Each (backend, package) server, started at first use and shared by
    the module's tests (stopping one waits out its poll interval); every
    store opened on one gets a table prefix of its own."""
    started: dict = {}
    prefixes = iter(range(1 << 30))

    def get(backend: str, pkg: str) -> tuple[str, str]:
        if (backend, pkg) not in started:
            started[backend, pkg] = _Server(backend, pkg)
        return started[backend, pkg].url, f"t{next(prefixes)}_"

    yield get
    stops = [threading.Thread(target=server.close) for server in started.values()]
    for t in stops:
        t.start()
    for t in stops:
        t.join(timeout=30)


def _record(servers, pkg: str, server_pkg: str, backend: str, case: str):
    """What ``case`` returns from package ``pkg``'s store on package
    ``server_pkg``'s server."""
    kind, fn = (("data", DATA_CASES[case]) if case in DATA_CASES
                else ("cache", CACHE_CASES[case]))
    url, prefix = servers(backend, server_pkg)
    data_mod, cache_mod, types_mod = PACKAGES[pkg]
    opener = data_mod.open_data_store if kind == "data" else cache_mod.open_cache_store
    store = opener(url, table_prefix=prefix)
    try:
        return fn(store, types_mod)
    finally:
        store.close()


@pytest.mark.parametrize("backend,case", CASES, ids=[f"{b}-{c}" for b, c in CASES])
def test_remote_store_case_is_the_reference(servers, backend, case):
    assert _record(servers, "port", "port", backend, case) == \
        _record(servers, "ref", "port", backend, case)


CROSS = [("mysql", "data_feedback_insert_and_query"), ("postgres", "data_items_crud"),
         ("clickhouse", "data_feedback_insert_and_query"), ("mysql", "cache_scores"),
         ("postgres", "cache_kv_and_queue"), ("redis", "cache_scores"),
         ("redis-cluster", "cache_scores"), ("mongodb", "data_items_crud"),
         ("mongodb", "cache_scores")]


@pytest.mark.parametrize("backend,case", CROSS, ids=[f"{b}-{c}" for b, c in CROSS])
def test_clients_and_servers_cross(servers, backend, case):
    """The port's store on gorse_tpu's server, and gorse_tpu's store on
    the port's, give what each gives on its own package's server."""
    want = _record(servers, "ref", "ref", backend, case)
    assert _record(servers, "port", "ref", backend, case) == want
    assert _record(servers, "ref", "port", backend, case) == want


@pytest.mark.parametrize("backend,kind", [(b, "data") for b in DATA_BACKENDS]
                         + [(b, "cache") for b in CACHE_BACKENDS])
def test_remote_schemes_open_the_reference_class(servers, backend, kind):
    """Each scheme opens the port's counterpart of the reference's class
    (and dialect)."""
    names = {}
    for pkg in ("port", "ref"):
        url, prefix = servers(backend, "port")
        data_mod, cache_mod, _ = PACKAGES[pkg]
        opener = data_mod.open_data_store if kind == "data" else cache_mod.open_cache_store
        store = opener(url, table_prefix=prefix)
        try:
            assert store.ping()
            names[pkg] = type(store).__name__
            if hasattr(store, "d"):
                names[pkg] += "/" + type(store.d).__name__
        finally:
            store.close()
    assert names["port"] == names["ref"]


# --------------------------------------------------------------- the SQL layer


LITERALS = [None, True, False, 0, -7, 1 << 40, 1.5, -0.0, 1e-300, float("inf"), "", "plain",
            "o'brien", "''", "back\\slash", "\\'", "nul\0byte", "ünï©ødé", "a?b", "line\nbreak",
            "tab\there"]


@pytest.mark.parametrize("escape_backslash", [False, True])
def test_sql_literal_is_the_reference(escape_backslash):
    got = [PSQL.sql_literal(v, escape_backslash) for v in LITERALS]
    assert got == [RSQL.sql_literal(v, escape_backslash) for v in LITERALS]
    sql = "INSERT INTO t VALUES (" + ", ".join("?" * len(LITERALS)) + ")"
    assert PSQL.sql_interpolate(sql, LITERALS, escape_backslash) == \
        RSQL.sql_interpolate(sql, LITERALS, escape_backslash)
    with pytest.raises(ValueError):
        PSQL.sql_interpolate("SELECT ?", ())


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
@pytest.mark.parametrize("backend", ["mysql", "postgres", "clickhouse"])
def test_strings_round_trip_through_each_server(servers, backend, server_pkg):
    """Quotes, backslashes and non-ASCII labels survive the trip:
    MySQL's connection runs with NO_BACKSLASH_ESCAPES, ClickHouse's
    literals escape the backslash."""
    url, prefix = servers(backend, server_pkg)
    store = PD.open_data_store(url, table_prefix=prefix)
    try:
        values = [v for v in LITERALS if isinstance(v, str) and v]
        store.insert_items([PACKAGES["port"][2].Item(f"i{n}", comment=v, labels={"v": v},
                                                      categories=[v])
                            for n, v in enumerate(values)])
        for n, v in enumerate(values):
            item = store.get_item(f"i{n}")
            # a NUL is dropped from a literal; JSON columns keep it escaped
            assert (item.comment, item.categories, item.labels) == (
                v.replace("\0", ""), [v], {"v": v})
    finally:
        store.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "ref"), ("ref", "port"),
                                                   ("port", "port")])
def test_wire_clients_refuse_a_bad_password(client_pkg, server_pkg):
    import gorse_tpu.storage.chhttp as rch
    import gorse_tpu.storage.mysqlwire as rmy
    import gorse_tpu.storage.pgwire as rpg
    import gorse_tpu_torch.storage.chhttp as pch
    import gorse_tpu_torch.storage.mysqlwire as pmy
    import gorse_tpu_torch.storage.pgwire as ppg

    pg, my, ch = (ppg, pmy, pch) if client_pkg == "port" else (rpg, rmy, rch)
    minisql = SERVERS[server_pkg][0]
    mini = minisql.MiniPostgres().start()
    try:
        with pytest.raises(pg.PGError):
            pg.PGConnection("127.0.0.1", mini.port, user=mini.user, password="wrong")
        conn = pg.PGConnection("127.0.0.1", mini.port, user=mini.user, password=mini.password)
        assert conn.query("SELECT 1 AS one") == [("1",)] and conn.ping()
        conn.close()
    finally:
        mini.stop()
    mini = minisql.MiniMySQL().start()
    try:
        with pytest.raises(my.MySQLError):
            my.MySQLConnection("127.0.0.1", mini.port, user=mini.user, password="wrong")
        conn = my.MySQLConnection("127.0.0.1", mini.port, user=mini.user, password=mini.password)
        conn.query("CREATE TABLE t (a TEXT, b DOUBLE)")
        conn.query("INSERT INTO t VALUES ('it''s', 1.5)")
        assert conn.query("SELECT a, b FROM t") == [("it's", "1.5")] and conn.ping()
        conn.close()
    finally:
        mini.stop()
    mini = minisql.MiniClickHouse().start()
    try:
        with pytest.raises(ch.ClickHouseError):
            ch.ClickHouseConnection("127.0.0.1", mini.port, password="wrong").query("SELECT 1")
        good = ch.ClickHouseConnection("127.0.0.1", mini.port, user=mini.user,
                                       password=mini.password)
        assert good.query("SELECT 1") == [(1,)]
    finally:
        mini.stop()


def test_scram_and_native_password_are_the_reference():
    """The auth primitives give the reference's bytes on the same inputs."""
    import gorse_tpu.storage.mysqlwire as rmy
    import gorse_tpu.storage.pgwire as rpg
    import gorse_tpu_torch.storage.mysqlwire as pmy
    import gorse_tpu_torch.storage.pgwire as ppg

    for password, salt in (("", b"\x01" * 20), ("gorse_pass", bytes(range(20))),
                           ("pässwörd", b"abcdefghijklmnopqrst")):
        assert pmy.native_password_scramble(password, salt) == \
            rmy.native_password_scramble(password, salt)
    for name in ("encode_lenenc_int",):
        for v in (0, 250, 251, 65535, 65536, 1 << 24, 1 << 40):
            assert getattr(pmy, name)(v) == getattr(rmy, name)(v)
    assert pmy.encode_lenenc_str(b"x" * 300) == rmy.encode_lenenc_str(b"x" * 300)
    # SCRAM-SHA-256: each package's client against the other's server side
    for client, server in ((ppg, rpg), (rpg, ppg)):
        for password in ("gorse_pass", "pässwörd"):
            _, first = client.scram_client_first("gorse")
            server_first, verify = server.scram_server_exchange(password, first)
            final, signature = client.scram_client_final(password, first, server_first)
            assert verify(final) is not None
            wrong, _ = client.scram_client_final("wrong", first, server_first)
            assert verify(wrong) is None


@pytest.mark.parametrize("dialect", ["PostgresDialect", "MySQLDialect", "ClickHouseDialect"])
def test_dialects_are_the_reference(dialect):
    """Every statement a dialect renders equals the reference's."""
    got, want = getattr(PSQL, dialect)(), getattr(RSQL, dialect)()
    cols = ["user_id", "labels", "comment", "subscribe"]
    for d in (got, want):
        d.rendered = [d.name, d.needs_existence_check, d.escape_backslash, d.create_tables(),
                      d.cache_create_tables(), d.upsert("users", ["user_id"], cols),
                      d.insert_ignore("users", ["user_id"], cols),
                      d.upsert_many("users", ["user_id"], cols, 3), d.from_table("items"),
                      d.delete("items", "item_id = 'x'"), d.count("feedback")]
    assert got.rendered == want.rendered
