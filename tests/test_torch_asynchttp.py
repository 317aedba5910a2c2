"""tests/test_asynchttp.py's protocol cases against the port's event-loop
front end (gorse_tpu_torch/serve/asynchttp.py): keep-alive reuse,
pipelining, bodies, the chunked refusal, CORS, auth, HTTP/1.0, the 414 and
413 limits and the graceful drain's idle state, with the threaded front end
still available."""

import http.client
import json
import socket

import numpy as np
import pytest

from gorse_tpu_torch.serve.rest import RestServer
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore
from gorse_tpu_torch.storage.types import Feedback, Item, User
from gorse_tpu_torch.utils.config import default_config


@pytest.fixture()
def server():
    config = default_config()
    rest = RestServer(config, MemoryDataStore(), MemoryCacheStore())
    httpd = rest.serve(port=0, backend="async")
    yield rest, httpd.server_address[1]
    rest.shutdown()


def test_keep_alive_many_requests_one_connection(server):
    rest, port = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    for i in range(20):
        conn.request("POST", "/api/item", json.dumps({"ItemId": f"i{i}"}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        r.read()
    conn.request("GET", "/api/item/i7")
    r = conn.getresponse()
    assert r.status == 200
    assert json.loads(r.read())["ItemId"] == "i7"
    conn.close()


def test_pipelined_requests_raw_socket(server):
    """Two requests written back-to-back before reading — the parser must
    answer both in order on the same connection."""
    rest, port = server
    rest.data.insert_items([Item(item_id="x1"), Item(item_id="x2")])
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(
        b"GET /api/item/x1 HTTP/1.1\r\nHost: t\r\n\r\n"
        b"GET /api/item/x2 HTTP/1.1\r\nHost: t\r\n\r\n"
    )
    buf = b""
    while buf.count(b"HTTP/1.1 200") < 2:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    assert buf.count(b"HTTP/1.1 200") == 2
    assert b"x1" in buf and b"x2" in buf
    s.close()


def test_chunked_body_refused_and_connection_dropped(server):
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(
        b"POST /api/users HTTP/1.1\r\nHost: t\r\n"
        b"Transfer-Encoding: chunked\r\n\r\n"
    )
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    assert b"501" in buf and b"chunked" in buf
    s.close()


def test_connection_close_honored(server):
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"GET /api/health/live HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break  # server closed, as requested
        buf += chunk
    assert b"HTTP/1.1 200" in buf and b"Connection: close" in buf
    s.close()


def test_large_json_body_round_trip(server):
    rest, port = server
    users = [{"UserId": f"u{i}", "Labels": ["x" * 50]} for i in range(2000)]
    body = json.dumps(users)
    assert len(body) > 150_000
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/api/users", body, {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    r.read()
    conn.request("GET", "/api/user/u1999")
    r = conn.getresponse()
    assert json.loads(r.read())["UserId"] == "u1999"
    conn.close()


def test_invalid_json_body_400_keeps_connection(server):
    rest, port = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("POST", "/api/users", b"{not json", {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 400
    r.read()
    # connection still usable
    conn.request("GET", "/api/health/live")
    assert conn.getresponse().status == 200
    conn.close()


def test_bad_request_line_400(server):
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"GARBAGE\r\n\r\n")
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    assert b"400" in buf
    s.close()


def test_cors_preflight_and_headers(server):
    rest, port = server
    rest.config.master.http_cors_domains = [r"https://app\.example\.com"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("OPTIONS", "/api/items", headers={"Origin": "https://app.example.com"})
    r = conn.getresponse()
    assert r.status == 204
    assert r.getheader("Access-Control-Allow-Origin") == "https://app.example.com"
    r.read()
    conn.request("GET", "/api/items", headers={"Origin": "https://app.example.com"})
    r = conn.getresponse()
    assert r.getheader("Access-Control-Allow-Origin") == "https://app.example.com"
    r.read()
    # non-matching origin: no CORS headers, still served
    conn.request("GET", "/api/items", headers={"Origin": "https://evil.example.com"})
    r = conn.getresponse()
    assert r.getheader("Access-Control-Allow-Origin") is None
    assert r.status == 200
    r.read()
    conn.close()


def test_api_key_auth_matches_threaded(server):
    rest, port = server
    rest.api_key = "sekrit"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", "/api/items")
    r = conn.getresponse()
    assert r.status == 401
    r.read()
    conn.request("GET", "/api/items", headers={"X-API-Key": "sekrit"})
    r = conn.getresponse()
    assert r.status == 200
    r.read()
    rest.api_key = ""
    conn.close()


def test_query_multi_values(server):
    rest, port = server
    rest.data.insert_items([
        Item(item_id="a", categories=["c1", "c2"]),
        Item(item_id="b", categories=["c1"]),
    ])
    rest.cache.add_scores("latest", "", [])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", "/api/latest?category=c1&category=c2")
    r = conn.getresponse()
    assert r.status == 200
    r.read()
    conn.close()


def test_threaded_backend_still_available():
    config = default_config()
    rest = RestServer(config, MemoryDataStore(), MemoryCacheStore())
    httpd = rest.serve(port=0, backend="threaded")
    port = httpd.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", "/api/health/live")
    assert conn.getresponse().status == 200
    conn.close()
    rest.shutdown()


def test_http10_closes_by_default(server):
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"GET /api/health/live HTTP/1.0\r\nHost: t\r\n\r\n")
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break  # server closed: HTTP/1.0 default
        buf += chunk
    assert b"HTTP/1.1 200" in buf
    s.close()


def test_oversized_request_line_414(server):
    """StreamReader.readline raises ValueError (not LimitOverrunError) on
    overrun; the server must still answer 414, not silently drop."""
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"GET /api/" + b"x" * 128 * 1024 + b" HTTP/1.1\r\nHost: t\r\n\r\n")
    buf = b""
    while True:
        try:
            chunk = s.recv(65536)
        except OSError:
            break
        if not chunk:
            break
        buf += chunk
    assert b"414" in buf
    s.close()


def test_oversized_content_length_413_before_read(server):
    """A huge declared Content-Length is refused up-front — the body is
    never buffered (auth runs only after the body is read)."""
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(
        b"POST /api/users HTTP/1.1\r\nHost: t\r\n"
        b"Content-Type: application/json\r\n"
        b"Content-Length: 99999999999\r\n\r\n"
    )
    buf = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    assert b"413" in buf
    s.close()


def test_options_preflight_resets_busy(server):
    """A connection whose LAST request was a CORS preflight must be idle for
    graceful drain (the OPTIONS path must reset the busy flag)."""
    rest, port = server
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(
        b"OPTIONS /api/item HTTP/1.1\r\nHost: t\r\n"
        b"Origin: http://x\r\nAccess-Control-Request-Method: POST\r\n\r\n"
    )
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
    assert b"204" in buf
    httpd = rest._httpd if hasattr(rest, "_httpd") else None
    # reach into the server's connection table: exactly one connection, idle
    import time as _time

    from gorse_tpu_torch.serve import asynchttp

    srv = rest._servers[0] if hasattr(rest, "_servers") else None
    if srv is None:  # locate via the module-level fixture server object
        srv = getattr(rest, "_async_server", None)
    # fall back: the fixture's httpd IS the AsyncHTTPServer
    # (rest.serve returned it) — find it through gc if not exposed
    if srv is None:
        import gc

        srv = next(o for o in gc.get_objects()
                   if isinstance(o, asynchttp.AsyncHTTPServer)
                   and o.server_address[1] == port)
    deadline = _time.time() + 2
    while _time.time() < deadline:
        states = list(srv._conns.values())
        if states and not any(st["busy"] for st in states):
            break
        _time.sleep(0.02)
    assert states and not any(st["busy"] for st in states)
    s.close()
