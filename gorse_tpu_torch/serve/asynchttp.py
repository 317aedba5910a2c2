"""Event-loop HTTP/1.1 front end for the REST service (port of
gorse_tpu/serve/asynchttp.py, stdlib only).

The stdlib ThreadingHTTPServer spends about 0.3 ms a request on parsing the
request line (the email parser's header path), assembling the response and
scheduling a thread, more than a whole recommend handler, and a thread a
connection contends for the GIL. This front end is ONE asyncio event loop
with minimal HTTP/1.1 parsing (readline + partition, no email parser),
keep-alive, and the same ``RestServer.dispatch`` contract, so every route,
auth check, CORS rule and metric behaves as on the threaded server, which
stays available as ``backend="threaded"`` (see RestServer.serve). gorse's
own server is Go's net/http, where goroutines make concurrent connections
nearly free (server/rest.go:197); an event loop is the Python shape of the
same requirement.

Small requests run inline on the loop; the admin and batch prefixes, the
store-pinging readiness probe and any request with a large body dispatch on
a small thread pool, so a blocking handler cannot hold up the loop (see
SLOW_PREFIXES / POOL_BODY_BYTES).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http import HTTPStatus

logger = logging.getLogger(__name__)

# Dispatch placement: pooling every handler costs an executor round trip a
# request plus GIL-quantum stalls for whatever stays inline, so the loop
# runs everything SMALL inline and pools exactly the requests that can
# genuinely block it:
# - the admin/batch prefixes (dump/restore/export/import/bulk/purge and
#   the remote-blocking LLM chat proxy — GET dump/export included);
# - the readiness probe (it pings stores, which can hang when a backend
#   is down; liveness is pure and stays inline);
# - any request with a large body (a 50k-row feedback batch holds the
#   store lock for seconds — body size is the cheap, accurate predictor;
#   a normal write-back or session POST is a few hundred bytes).
SLOW_PREFIXES = (
    "/api/dump",
    "/api/restore",
    "/api/bulk",
    "/api/export",
    "/api/import",
    "/api/purge",
    "/api/chat",
    "/api/health/ready",
)
POOL_BODY_BYTES = 64 * 1024

# Reject any declared Content-Length above this cap with 413 BEFORE reading
# the body: dispatch authenticates only after the body is read, so an
# unauthenticated client could otherwise stream a multi-GB body into memory.
# Generous enough for restore/bulk-import payloads.
MAX_BODY_BYTES = 256 * 1024 * 1024


def _inline_ok(path: str, body_len: int) -> bool:
    return body_len < POOL_BODY_BYTES and not path.startswith(SLOW_PREFIXES)


class _LineTooLong(Exception):
    """Request line or header beyond the StreamReader limit.

    ``StreamReader.readline`` converts its internal LimitOverrunError into a
    bare ValueError, so catching LimitOverrunError around readline is dead
    code; this wrapper restores a precise exception type."""


async def _readline(reader: asyncio.StreamReader) -> bytes:
    try:
        return await reader.readline()
    except (asyncio.LimitOverrunError, ValueError) as e:
        raise _LineTooLong from e

_REASONS = {s.value: s.phrase for s in HTTPStatus}


class AsyncHTTPServer:
    """Asyncio front-end driving ``rest.dispatch``; duck-compatible with the
    ThreadingHTTPServer the callers expect (``server_address``,
    ``shutdown()``)."""

    def __init__(self, rest, host: str, port: int) -> None:
        self.rest = rest
        self._host, self._port = host, port
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._boot_error: BaseException | None = None
        # sized for a mix of fast handlers and a couple of genuinely slow
        # ones (LLM chat proxy, dump/restore) without starving the rest;
        # the GIL bounds useful CPU parallelism anyway
        self._pool = ThreadPoolExecutor(max_workers=8)
        self.server_address = (host, port)
        # writer -> "busy" flag (mid-request); lets the drain close IDLE
        # keep-alive connections immediately instead of waiting them out
        self._conns: dict = {}
        self._draining = False

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "AsyncHTTPServer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=15):
            raise RuntimeError("async HTTP server failed to start in time")
        if self._boot_error is not None:
            raise self._boot_error
        return self

    def _run(self) -> None:
        try:
            import sys

            # pool threads hold the GIL for a full switch quantum; the
            # default 5 ms stalls the loop's inline reads behind any pooled
            # mutation — 1 ms caps that head-of-line tax
            sys.setswitchinterval(0.001)
            asyncio.run(self._main())
        except BaseException as e:  # noqa: BLE001 — surface boot failures
            self._boot_error = e
            self._started.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._conn, self._host, self._port)
        self.server_address = server.sockets[0].getsockname()[:2]
        self._started.set()
        await self._stop.wait()
        # graceful drain: stop accepting, close idle keep-alive connections
        # right away (their handlers exit on EOF), let mid-request handlers
        # finish and self-close (the _conn loop checks _draining after each
        # response), and cap the whole wait (3.12+ wait_closed waits for
        # connection handlers) before asyncio.run cancels what remains
        self._draining = True
        server.close()
        for w, st in list(self._conns.items()):
            if not st["busy"]:
                w.close()
        try:
            await asyncio.wait_for(server.wait_closed(), timeout=5)
        except (TimeoutError, asyncio.TimeoutError):
            pass

    def shutdown(self) -> None:
        if self._loop is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._pool.shutdown(wait=False)

    # --------------------------------------------------------- connection

    async def _conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        from .rest import decode_body, parse_query

        rest = self.rest
        state = {"busy": False}
        self._conns[writer] = state
        try:
            while True:
                line = await _readline(reader)
                if not line:
                    break
                if line in (b"\r\n", b"\n"):
                    continue  # stray blank between pipelined requests
                state["busy"] = True
                try:
                    method, target, version = (
                        line.decode("latin1").rstrip("\r\n").split(" ", 2)
                    )
                except ValueError:
                    self._reply(writer, 400, b'{"error": "bad request line"}',
                                "application/json", {}, close=True)
                    break
                headers: dict[str, str] = {}
                while True:
                    h = await _readline(reader)
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip()] = v.strip()
                hl = {k.lower(): v for k, v in headers.items()}
                if "chunked" in hl.get("transfer-encoding", "").lower():
                    # same refusal as the threaded server: an unread chunked
                    # body would desynchronize the keep-alive stream
                    self._reply(writer, 501,
                                b'{"error": "chunked request bodies are not supported"}',
                                "application/json", {}, close=True)
                    break
                try:
                    length = int(hl.get("content-length") or 0)
                    if length < 0:
                        raise ValueError(length)
                except ValueError:
                    self._reply(writer, 400, b'{"error": "invalid Content-Length"}',
                                "application/json", {}, close=True)
                    break
                if length > MAX_BODY_BYTES:
                    # refuse before buffering: auth happens after body read
                    self._reply(writer, 413, b'{"error": "request body too large"}',
                                "application/json", {}, close=True)
                    break
                raw = await reader.readexactly(length) if length else b""

                try:
                    parsed = urllib.parse.urlparse(target)
                except ValueError:
                    self._reply(writer, 400, b'{"error": "bad request target"}',
                                "application/json", {}, close=True)
                    break
                origin = hl.get("origin", "")
                if method == "OPTIONS":
                    cors = rest.cors_headers(origin)
                    self._reply(writer, 204 if cors else 405, b"", "text/plain", cors)
                    # not mid-request anymore: without this an idle
                    # keep-alive connection whose last request was a CORS
                    # preflight stalls graceful drain. And if
                    # drain began while this request was in flight (the
                    # one-shot idle sweep already skipped us), close now
                    # instead of waiting out the 5s shutdown cap.
                    state["busy"] = False
                    if self._draining:
                        break
                    continue
                body, err = decode_body(raw, hl.get("content-type"))
                if err is not None:
                    self._reply(writer, 400, err, "application/json",
                                rest.cors_headers(origin))
                    state["busy"] = False
                    if self._draining:
                        break
                    continue
                query = parse_query(parsed.query)

                # HEAD serves as GET with the body suppressed (RFC 9110)
                dm = "GET" if method == "HEAD" else method
                if _inline_ok(parsed.path, length):
                    status, payload = rest.dispatch(
                        dm, parsed.path, query, body, headers
                    )
                else:
                    status, payload = await asyncio.get_running_loop().run_in_executor(
                        self._pool, rest.dispatch,
                        dm, parsed.path, query, body, headers,
                    )
                data, ctype, extra, status = rest.render_payload(status, payload)
                conn_hdr = hl.get("connection", "").lower()
                # HTTP/1.0 defaults to close unless keep-alive is requested
                close = conn_hdr == "close" or (
                    version == "HTTP/1.0" and conn_hdr != "keep-alive"
                )
                self._reply(writer, status, data, ctype,
                            {**extra, **rest.cors_headers(origin)}, close=close,
                            head=(method == "HEAD"))
                await writer.drain()
                state["busy"] = False
                if close or self._draining:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except _LineTooLong:
            # request/header line beyond the StreamReader limit (~64 KiB):
            # answer like the threaded backend's 414 and drop the connection
            try:
                self._reply(writer, 414, b'{"error": "request line or header too long"}',
                            "application/json", {}, close=True)
                await writer.drain()
            except Exception:  # noqa: BLE001
                pass
        except Exception:  # noqa: BLE001 — never kill the server on one conn
            logger.exception("async http connection error")
        finally:
            self._conns.pop(writer, None)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _reply(writer, status: int, data: bytes, ctype: str,
               extra: dict, close: bool = False, head: bool = False) -> None:
        reason = _REASONS.get(status, "OK")
        parts = [
            f"HTTP/1.1 {status} {reason}\r\n",
            f"Content-Type: {ctype}\r\n",
            f"Content-Length: {len(data)}\r\n",
        ]
        for k, v in extra.items():
            parts.append(f"{k}: {v}\r\n")
        if close:
            parts.append("Connection: close\r\n")
        parts.append("\r\n")
        # HEAD responses carry the headers (incl. the GET Content-Length)
        # but no body — writing one would desynchronize keep-alive clients
        writer.write("".join(parts).encode("latin1") + (b"" if head else data))
