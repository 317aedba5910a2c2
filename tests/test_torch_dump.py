"""The port's dump, restore and bulk import/export (gorse_tpu_torch/serve/
dump.py and the routes of serve/dashboard.py) against gorse_tpu's, on the
CPU.

- The same rows, made from a seed with numpy (labels of every JSON kind,
  comments with commas, quotes and newlines, hidden items, categories,
  feedback values and time stamps), go into both packages' memory and
  SQLite data stores: their dumps, CSV exports and JSONL exports are
  byte-equal, across packages and store kinds.
- Each package restores the other's dump into either store kind: every
  row equal, and the restored store dumps to the same bytes; a stream of
  more than 1,000 rows restores in batches.
- The CSV and JSONL imports give the same rows in both packages, and the
  same errors for bad ids and bad JSON, line numbers included.
- The routes give the reference's status codes and bodies: purge without
  a password, with an incomplete checklist and with the whole one; the
  multipart and plain bulk imports; restore of a non-stream.
Exact throughout: no tolerance.
"""

import io
import json

import numpy as np
import pytest

import gorse_tpu.serve.dump as RDUMP
import gorse_tpu.storage.data as RD
import gorse_tpu.storage.types as RT
import gorse_tpu_torch.serve.dump as PDUMP
import gorse_tpu_torch.storage.data as PD
import gorse_tpu_torch.storage.types as PT

PACKAGES = {"ref": (RD, RT, RDUMP), "port": (PD, PT, PDUMP)}
STORES = ("memory", "sqlite")


def _rows(seed: int, n_users: int = 30, n_items: int = 40, n_feedback: int = 150):
    """Users, items and feedback as constructor keyword dicts."""
    rng = np.random.default_rng(seed)
    texts = ["plain", "with, comma", 'with "quotes"', "line\nbreak", "ünïcode ✓", ""]
    labels = [None, ["a", "b"], {"k": "v", "n": 3, "f": 0.25, "l": [1, 2.5]}, "tag", 7,
              {"nested": {"x": [True, None]}}]
    users = [{"user_id": f"u{k}", "labels": labels[int(rng.integers(len(labels)))],
              "comment": texts[int(rng.integers(len(texts)))],
              "subscribe": None if rng.random() < 0.5 else ["x", "y"]} for k in range(n_users)]
    items = [{"item_id": f"i{k}", "is_hidden": bool(rng.random() < 0.2),
              "categories": [f"c{int(c)}" for c in rng.choice(4, int(rng.integers(0, 3)),
                                                              replace=False)],
              "timestamp": float(np.round(rng.uniform(0, 2e9), 3)),
              "labels": labels[int(rng.integers(len(labels)))],
              "comment": texts[int(rng.integers(len(texts)))]} for k in range(n_items)]
    pairs = sorted({(int(u), int(i)) for u, i in zip(rng.integers(n_users, size=n_feedback),
                                                      rng.integers(n_items, size=n_feedback))})
    feedback = [{"feedback_type": ["like", "read", "star"][int(rng.integers(3))],
                 "user_id": f"u{u}", "item_id": f"i{i}", "value": float(rng.integers(1, 6)),
                 "timestamp": float(np.round(rng.uniform(0, 2e9), 3)),
                 "comment": texts[int(rng.integers(len(texts)))]} for u, i in pairs]
    return users, items, feedback


def _store(pkg: str, kind: str, tmp_path, rows=None):
    D, T, _ = PACKAGES[pkg]
    store = D.MemoryDataStore() if kind == "memory" else \
        D.SQLiteDataStore(str(tmp_path / f"{pkg}-{kind}-{id(rows)}.sqlite"))
    if rows is not None:
        users, items, feedback = rows
        store.insert_users([T.User(**u) for u in users])
        store.insert_items([T.Item(**i) for i in items])
        store.insert_feedback([T.Feedback(**f) for f in feedback])
    return store


def _dump(pkg: str, store) -> bytes:
    buf = io.BytesIO()
    PACKAGES[pkg][2].dump(store, buf)
    return buf.getvalue()


def _text(pkg: str, fn: str, store) -> str:
    buf = io.StringIO()
    getattr(PACKAGES[pkg][2], fn)(store, buf)
    return buf.getvalue()


def _contents(store):
    """Every row of a store, as dicts (users, items, feedback)."""
    return ([u.to_dict() for u in store.get_users()], [i.to_dict() for i in store.get_items()],
            [f.to_dict() for f in store.get_feedback()])


EXPORTS = ("export_users", "export_items", "export_feedback", "export_users_jsonl",
           "export_items_jsonl", "export_feedback_jsonl")


@pytest.mark.parametrize("kind", STORES)
def test_dumps_and_exports_are_byte_equal(kind, tmp_path):
    rows = _rows(0)
    stores = {pkg: _store(pkg, kind, tmp_path, rows) for pkg in PACKAGES}
    dumps = {pkg: _dump(pkg, s) for pkg, s in stores.items()}
    assert dumps["port"] == dumps["ref"] and dumps["port"].startswith(b"GTPU1")
    assert dumps["port"] == _dump("port", _store("port", "memory", tmp_path, rows))
    for fn in EXPORTS:
        texts = {pkg: _text(pkg, fn, s) for pkg, s in stores.items()}
        assert texts["port"] == texts["ref"] and texts["port"].count("\n") >= 30, fn


@pytest.mark.parametrize("src", list(PACKAGES))
@pytest.mark.parametrize("kind", STORES)
def test_each_restores_the_others_dump(src, kind, tmp_path):
    rows = _rows(1)
    stream = _dump(src, _store(src, "memory", tmp_path, rows))
    dst = "ref" if src == "port" else "port"
    restored = _store(dst, kind, tmp_path)
    counts = PACKAGES[dst][2].restore(restored, io.BytesIO(stream))
    assert counts == {"users": 30, "items": 40, "feedback": len(rows[2])}
    assert _dump(dst, restored) == stream
    assert _contents(restored) == _contents(_store(src, "memory", tmp_path, rows))


class _Counting:
    """A memory store that records the batch sizes of its inserts."""

    def __init__(self, store):
        self.store, self.batches = store, []

    def __getattr__(self, name):
        fn = getattr(self.store, name)
        if name.startswith("insert_"):
            def insert(rows):
                rows = list(rows)
                self.batches.append((name, len(rows)))
                return fn(rows)
            return insert
        return fn


def test_large_restore_flushes_every_thousand_rows(tmp_path):
    rows = _rows(2, n_users=700, n_items=900, n_feedback=2500)
    stream = _dump("ref", _store("ref", "memory", tmp_path, rows))
    batches = {}
    for pkg in PACKAGES:
        counting = _Counting(PACKAGES[pkg][0].MemoryDataStore())
        PACKAGES[pkg][2].restore(counting, io.BytesIO(stream))
        batches[pkg] = counting.batches
        assert _dump(pkg, counting.store) == stream
    assert batches["port"] == batches["ref"]
    assert max(n for _, n in batches["port"]) <= 1000 and len(batches["port"]) >= 5


def test_restore_refuses_a_foreign_stream():
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="dump stream"):
            PACKAGES[pkg][2].restore(PACKAGES[pkg][0].MemoryDataStore(), io.BytesIO(b"NOPE!"))


def _import(pkg: str, fn: str, text: str):
    store = PACKAGES[pkg][0].MemoryDataStore()
    try:
        n = getattr(PACKAGES[pkg][2], fn)(store, io.StringIO(text))
    except ValueError as e:
        return ("error", str(e)), _contents(store)
    return ("ok", n), _contents(store)


IMPORTS = [
    ("import_users", "user_id,labels\nu1,\nu2,\"{\"\"a\"\": [1, 2]}\"\nu3,[\"x\"]\n"),
    ("import_items", "item_id,is_hidden,categories,timestamp,labels,description\n"
                     "i1,true,a|b,5.5,[],hello\ni2,False,,,,\"multi\nline\"\ni3,x,c,7,3,\n"),
    ("import_feedback", "feedback_type,user_id,item_id,timestamp\nlike,u1,i1,7\nread,u2,i2,\n"),
    ("import_users_jsonl", '{"UserId": "j1", "Labels": {"k": 1}}\n\n{"UserId": "j2"}\n'),
    ("import_items_jsonl", '{"ItemId": "k1", "Categories": ["c"], "IsHidden": true}\n'
                           '{"ItemId": "k2", "Timestamp": "2024-01-02T03:04:05Z"}\n'),
    ("import_feedback_jsonl", '{"FeedbackType": "like", "UserId": "a", "ItemId": "b", '
                              '"Value": 2.5, "Timestamp": 9}\n'),
    # bad ids and bad JSON: the same message, line numbers included
    ("import_users_jsonl", '{"UserId": "ok"}\n{"UserId": "a/b"}\n'),
    ("import_users_jsonl", '{"UserId": "ok"}\n\n{"UserId": "  "}\n'),
    ("import_items_jsonl", '{"ItemId": "x"}\n{"ItemId": ""}\n'),
    ("import_feedback_jsonl", '{"FeedbackType": "like", "UserId": "u/1", "ItemId": "i"}\n'),
    ("import_feedback_jsonl", '{"FeedbackType": "like", "UserId": "u", "ItemId": " "}\n'),
    ("import_items_jsonl", '{"ItemId": "x"}\n{"ItemId": "y"\n'),
    ("import_users_jsonl", "not json at all\n"),
    ("import_users", "user_id,labels\nu1,{bad json\n"),
]


@pytest.mark.parametrize("fn,text", IMPORTS, ids=[f"{fn}-{n}" for n, (fn, _) in
                                                   enumerate(IMPORTS)])
def test_imports_match(fn, text):
    got, want = _import("port", fn, text), _import("ref", fn, text)
    assert got == want


def test_import_batches_of_jsonl():
    """More than one 1,000-row batch through the JSONL import."""
    text = "".join(json.dumps({"UserId": f"b{k}"}) + "\n" for k in range(2345))
    got, want = _import("port", "import_users_jsonl", text), _import("ref", "import_users_jsonl",
                                                                     text)
    assert got == want and got[0] == ("ok", 2345)


@pytest.mark.parametrize("value,ok", [("abc", True), ("a/b", False), ("", False), ("  ", False),
                                      (" x ", True)])
def test_validate_id(value, ok):
    outcomes = []
    for pkg in PACKAGES:
        try:
            PACKAGES[pkg][2].validate_id(value)
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1] and (outcomes[0] == "ok") == ok


# ------------------------------------------------------------------ routes


def _rest(pkg: str, tmp_path, password: str = ""):
    import importlib

    root = {"ref": "gorse_tpu", "port": "gorse_tpu_torch"}[pkg]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    config = m("utils.config").Config()
    config.master.dashboard_password = password
    store = _store(pkg, "memory", tmp_path, _rows(3, 5, 6, 12))
    master = m("serve.master").Master(config, store, m("storage.cache").MemoryCacheStore(),
                                      m("storage.blob").BlobStore(tmp_path / f"{pkg}-blob"),
                                      m("storage.meta").MetaStore(),
                                      **({"device": "cpu"} if pkg == "port" else {}))
    return m("serve.dashboard").MasterRestServer(master)


def _multipart(parts: list[tuple[str, bytes]]) -> bytes:
    out = b""
    for name, payload in parts:
        out += (b"--B0und\r\nContent-Disposition: form-data; name=\"" + name.encode()
                + b"\"; filename=\"f.jsonl\"\r\nContent-Type: application/octet-stream\r\n\r\n"
                + payload + b"\r\n")
    return out + b"--B0und--\r\n"


MP = {"Content-Type": "multipart/form-data; boundary=B0und"}
ROUTE_CALLS = [
    ("POST", "/api/purge", {"check_list": "delete_users,delete_items,delete_feedback,"
                                          "delete_cache"}, {}),
    ("POST", "/api/bulk/users", _multipart([("other", b"x"), ("file", b'{"UserId": "m1"}\n'
                                                               b'{"UserId": "m2"}\n')]), MP),
    ("POST", "/api/bulk/items", _multipart([("file", b'{"ItemId": "n1"}\n')]), MP),
    ("POST", "/api/bulk/feedback", _multipart([("file", b'{"FeedbackType": "like", '
                                                         b'"UserId": "m1", "ItemId": "n1"}\n')]),
     MP),
    ("POST", "/api/bulk/users", _multipart([("nofile", b"x")]), MP),
    ("POST", "/api/bulk/users", _multipart([("file", b'{"UserId": "bad/id"}\n')]), MP),
    ("POST", "/api/bulk/items", b'{"ItemId": "p1"}\n{"ItemId": "p2"}\n', {}),
    ("POST", "/api/bulk/items", b'{"ItemId": "p3"}\n{broken\n', {}),
    ("POST", "/api/restore", "not bytes", {}),
    ("POST", "/api/restore", b"GTPU1", {}),
    ("GET", "/api/bulk/users", None, {}),
    ("GET", "/api/dump", None, {}),
]


@pytest.mark.parametrize("password", ["", "pw"])
def test_routes_answer_as_the_reference(password, tmp_path):
    """The calls above in order, both packages: the same status and body
    (a dump or a JSONL export as bytes). Without a password the purge is
    refused (401); with one, the checklist decides."""
    answers = {}
    for pkg in PACKAGES:
        rest = _rest(pkg, tmp_path, password)
        calls = list(ROUTE_CALLS)
        if password:
            calls = [("POST", "/api/purge", {"check_list": "delete_users,delete_items"}, {}),
                     ("POST", "/api/purge", {}, {})] + calls
        out = []
        for method, path, body, headers in calls:
            status, payload = rest.dispatch(method, path, {}, body, headers)
            data, ctype, extra, status = rest.render_payload(status, payload)
            out.append((path, status, data))
        answers[pkg] = out
    assert answers["port"] == answers["ref"]
    statuses = [s for _, s, _ in answers["port"]]
    if password:
        assert statuses[:3] == [401, 401, 200] and answers["port"][-1][2] != b"GTPU1"
    else:
        assert statuses[0] == 401
    assert 400 in statuses and statuses.count(200) >= 5
