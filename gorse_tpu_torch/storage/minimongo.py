"""MiniMongo: an in-process mock MongoDB speaking OP_MSG + SCRAM-SHA-256
(copy of gorse_tpu/storage/minimongo.py).

The MongoDB counterpart of MiniRedis and MiniPostgres (resp.py,
minisql.py), standing in for the MongoDB service that gorse's
mongodb_test.go suites run against. It implements the command subset the stores in mongo.py use: hello,
ping, saslStart/saslContinue (verifying real SCRAM-SHA-256 proofs), find
(with $gt/$gte/$lt/$lte/$in, sort, limit, getMore batching), insert, update
($set/$setOnInsert/upsert/multi), delete, count.
"""

from __future__ import annotations

import socketserver
import struct
import threading

from . import bson
from .pgwire import scram_server_exchange

__all__ = ["MiniMongo"]

_BATCH = 3  # firstBatch size — small to force getMore round-trips in tests


def _match(doc: dict, q: dict) -> bool:
    for k, cond in q.items():
        v = doc.get(k)
        if isinstance(cond, dict) and any(key.startswith("$") for key in cond):
            for op, rhs in cond.items():
                if op == "$gt":
                    ok = v is not None and v > rhs
                elif op == "$gte":
                    ok = v is not None and v >= rhs
                elif op == "$lt":
                    ok = v is not None and v < rhs
                elif op == "$lte":
                    ok = v is not None and v <= rhs
                elif op == "$in":
                    ok = v in rhs
                elif op == "$nin":
                    ok = v not in rhs
                elif op == "$ne":
                    ok = v != rhs
                elif op == "$eq":
                    ok = v == rhs
                else:
                    raise ValueError(f"unsupported operator {op}")
                if not ok:
                    return False
        elif v != cond:
            return False
    return True


def _apply_sort(docs: list[dict], sort: dict) -> list[dict]:
    for field, direction in reversed(list(sort.items())):
        docs = sorted(docs, key=lambda d: d.get(field), reverse=direction < 0)
    return docs


class _State:
    def __init__(self, user: str, password: str) -> None:
        self.user, self.password = user, password
        self.dbs: dict[str, dict[str, list[dict]]] = {}
        self.cursors: dict[int, list[dict]] = {}
        self.next_cursor = 1
        self.lock = threading.Lock()

    def coll(self, db: str, name: str) -> list[dict]:
        return self.dbs.setdefault(db, {}).setdefault(name, [])


class _MongoHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        state: _State = self.server.state  # type: ignore[attr-defined]
        rfile = self.request.makefile("rb")
        authed = not state.user
        verify = None
        while True:
            header = rfile.read(16)
            if len(header) < 16:
                return
            length, req_id, _, opcode = struct.unpack("<iiii", header)
            payload = rfile.read(length - 16)
            if opcode != 2013 or payload[4] != 0:
                return
            doc = bson.decode(payload[5:])
            cmd = next(iter(doc))
            db = doc.get("$db", "admin")
            try:
                if cmd in ("hello", "isMaster", "ping"):
                    reply = {"ok": 1.0, "maxWireVersion": 17}
                elif cmd == "saslStart":
                    if doc.get("mechanism") != "SCRAM-SHA-256":
                        reply = {"ok": 0.0, "errmsg": "unsupported mechanism"}
                    else:
                        client_first = doc["payload"].decode()
                        server_first, verify = scram_server_exchange(
                            state.password, client_first
                        )
                        reply = {
                            "conversationId": 1,
                            "done": False,
                            "payload": server_first.encode(),
                            "ok": 1.0,
                        }
                elif cmd == "saslContinue":
                    data = doc["payload"].decode()
                    if verify is not None and data:
                        server_final = verify(data)
                        if server_final is None:
                            reply = {"ok": 0.0, "errmsg": "Authentication failed.", "code": 18}
                        else:
                            authed = True
                            verify = None
                            reply = {
                                "conversationId": 1,
                                "done": True,
                                "payload": server_final.encode(),
                                "ok": 1.0,
                            }
                    else:
                        reply = {"conversationId": 1, "done": True, "payload": b"", "ok": 1.0}
                elif not authed:
                    reply = {"ok": 0.0, "errmsg": "command requires authentication", "code": 13}
                else:
                    reply = self._run(state, db, cmd, doc)
            except Exception as e:  # the error goes back to the client
                reply = {"ok": 0.0, "errmsg": str(e)}
            body = struct.pack("<I", 0) + b"\x00" + bson.encode(reply)
            out = struct.pack("<iiii", len(body) + 16, 0, req_id, 2013) + body
            self.request.sendall(out)

    @staticmethod
    def _run(state: _State, db: str, cmd: str, doc: dict) -> dict:
        with state.lock:
            if cmd == "insert":
                coll = state.coll(db, doc["insert"])
                coll.extend(doc["documents"])
                return {"n": len(doc["documents"]), "ok": 1.0}
            if cmd == "find":
                coll = state.coll(db, doc["find"])
                matched = [d for d in coll if _match(d, doc.get("filter") or {})]
                if doc.get("sort"):
                    matched = _apply_sort(matched, doc["sort"])
                if doc.get("limit"):
                    matched = matched[: doc["limit"]]
                first, rest = matched[:_BATCH], matched[_BATCH:]
                cursor_id = 0
                if rest:
                    cursor_id = state.next_cursor
                    state.next_cursor += 1
                    state.cursors[cursor_id] = rest
                return {
                    "cursor": {"firstBatch": first, "id": cursor_id, "ns": f"{db}.{doc['find']}"},
                    "ok": 1.0,
                }
            if cmd == "getMore":
                rest = state.cursors.pop(doc["getMore"], [])
                batch, rest = rest[:_BATCH], rest[_BATCH:]
                cursor_id = 0
                if rest:
                    cursor_id = doc["getMore"]
                    state.cursors[cursor_id] = rest
                return {
                    "cursor": {"nextBatch": batch, "id": cursor_id, "ns": f"{db}.{doc['collection']}"},
                    "ok": 1.0,
                }
            if cmd == "update":
                coll = state.coll(db, doc["update"])
                n = 0
                for u in doc["updates"]:
                    q, upd = u["q"], u["u"]
                    matches = [d for d in coll if _match(d, q)]
                    if not u.get("multi"):
                        matches = matches[:1]
                    if matches:
                        for d in matches:
                            d.update(upd.get("$set", {}))
                            n += 1
                    elif u.get("upsert"):
                        new = {
                            k: v
                            for k, v in q.items()
                            if not (isinstance(v, dict) and any(s.startswith("$") for s in v))
                        }
                        new.update(upd.get("$setOnInsert", {}))
                        new.update(upd.get("$set", {}))
                        coll.append(new)
                        n += 1
                return {"n": n, "ok": 1.0}
            if cmd == "delete":
                coll = state.coll(db, doc["delete"])
                n = 0
                for dd in doc["deletes"]:
                    q, limit = dd["q"], dd.get("limit", 0)
                    keep, removed = [], 0
                    for d in coll:
                        if _match(d, q) and (limit == 0 or removed < limit):
                            removed += 1
                        else:
                            keep.append(d)
                    coll[:] = keep
                    n += removed
                return {"n": n, "ok": 1.0}
            if cmd == "findAndModify":
                coll = state.coll(db, doc["findAndModify"])
                matched = [d for d in coll if _match(d, doc.get("query") or {})]
                if doc.get("sort"):
                    matched = _apply_sort(matched, doc["sort"])
                if not matched:
                    return {"value": None, "ok": 1.0}
                victim = matched[0]
                if doc.get("remove"):
                    coll.remove(victim)
                elif doc.get("update"):
                    victim.update(doc["update"].get("$set", {}))
                return {"value": victim, "ok": 1.0}
            if cmd == "count":
                coll = state.coll(db, doc["count"])
                q = doc.get("query") or {}
                return {"n": sum(1 for d in coll if _match(d, q)), "ok": 1.0}
            if cmd == "distinct":
                coll = state.coll(db, doc["distinct"])
                q = doc.get("query") or {}
                key = doc["key"]
                values, seen = [], set()
                for d in coll:
                    if _match(d, q) and key in d and d[key] not in seen:
                        seen.add(d[key])
                        values.append(d[key])
                return {"values": values, "ok": 1.0}
            return {"ok": 0.0, "errmsg": f"no such command: {cmd}"}


class _ThreadingTCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class MiniMongo:
    def __init__(self, user: str = "gorse", password: str = "gorse_pass") -> None:
        self.state = _State(user, password)
        self.server = _ThreadingTCP(("127.0.0.1", 0), _MongoHandler)
        self.server.state = self.state  # type: ignore[attr-defined]
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def start(self) -> "MiniMongo":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def url(self, database: str = "gorse") -> str:
        return (
            f"mongodb://{self.state.user}:{self.state.password}"
            f"@127.0.0.1:{self.port}/{database}"
        )
