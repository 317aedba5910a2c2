"""gRPC over protocol/h2.py: a server and a channel with grpc's surface.

The port's counterpart of grpcio, which the reference's control plane
(protocol/rpc.py, storage/proxy.py, utils/tls.py, the ``otlp`` exporter of
utils/tracing.py) is built on. What crosses the wire is the gRPC HTTP/2
protocol as grpcio speaks it:

- a message is one byte of compression flag, four bytes of big-endian
  length, the bytes; this side asks for ``identity`` and refuses a
  compressed message;
- a request is HEADERS (``:method POST``, ``:path /service/method``,
  ``content-type: application/grpc``, ``te: trailers``, ``grpc-timeout`` in
  its units ``H M S m u n``), DATA, END_STREAM; an answer is HEADERS
  (``:status 200``), DATA, then trailers with ``grpc-status`` and a
  percent-encoded ``grpc-message``, or, for an error before any message,
  one trailers-only HEADERS frame.

``Server`` takes generic handlers keyed by ``/service/method`` with their
(de)serialisers (``unary_unary``, ``unary_stream`` and ``stream_unary``),
``add_insecure_port``/``add_secure_port`` (an
``ssl.SSLContext``) return the bound port, then ``start()`` and
``stop(grace)``. Each connection has one reader thread, which hands each new
stream to one of ``max_workers`` handler threads (the reference's pool of
8); a request-streaming handler iterates over its messages while frames
still arrive. ``Channel`` opens one connection (again after it is lost)
and multiplexes its calls on odd stream ids; ``unary_unary``,
``unary_stream`` and ``stream_unary`` give callables as grpc's channel
does. Failures surface as ``RpcError`` with ``code()`` and ``details()``;
a handler ends a call with ``context.abort(code, details)``.
"""

from __future__ import annotations

import enum
import logging
import queue
import socket
import ssl
import threading
import time
import urllib.parse

from . import h2

logger = logging.getLogger(__name__)

MAX_RECEIVE_MESSAGE = 512 << 20  # the reference's grpc.max_receive_message_length
CONNECT_TIMEOUT_S = 20.0
USER_AGENT = "grpc-python-gorse-tpu-torch/1.0"


class StatusCode(enum.Enum):
    """gRPC's status codes, by grpc's names."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str) -> None:
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Abort(Exception):
    """Raised by ``ServicerContext.abort``: ends the handler with its status."""


# ---------------------------------------------------------------- wire pieces


def encode_message(data: bytes) -> bytes:
    return b"\x00" + len(data).to_bytes(4, "big") + bytes(data)


class Deframer:
    """Length-prefixed messages out of a stream of DATA payloads."""

    def __init__(self, max_length: int = MAX_RECEIVE_MESSAGE) -> None:
        self._buf = bytearray()
        self.max_length = max_length

    def feed(self, data: bytes) -> list[bytes]:
        buf = self._buf
        buf += data
        out = []
        while len(buf) >= 5:
            if buf[0]:
                raise RpcError(StatusCode.INTERNAL,
                               "received a compressed message, but identity was asked for")
            length = int.from_bytes(buf[1:5], "big")
            if length > self.max_length:
                raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                               f"Received message larger than max ({length} vs. "
                               f"{self.max_length})")
            if len(buf) < 5 + length:
                break
            out.append(bytes(buf[5:5 + length]))
            del buf[:5 + length]
        return out


def quote_message(text: str) -> str:
    """grpc-message's percent-encoding: bytes outside 0x20-0x7E and '%'."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode())


def unquote_message(text: str) -> str:
    return urllib.parse.unquote(text, errors="replace")


_TIMEOUT_UNITS = (("n", 1e-9), ("u", 1e-6), ("m", 1e-3), ("S", 1.0), ("M", 60.0), ("H", 3600.0))


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits, in the finest unit that fits."""
    seconds = max(seconds, 0.0)
    for unit, scale in _TIMEOUT_UNITS:
        value = int(seconds / scale + 0.5)
        if value < 10**8:
            return f"{value}{unit}"
    return "99999999H"


def decode_timeout(text: str) -> float:
    scale = dict(_TIMEOUT_UNITS).get(text[-1:])
    if scale is None or not text[:-1].isdigit():
        raise ValueError(f"invalid grpc-timeout {text!r}")
    return int(text[:-1]) * scale


def _status_of(fields: dict) -> tuple[StatusCode, str] | None:
    """The status in trailers (or a trailers-only answer), None without one."""
    raw = fields.get("grpc-status")
    if raw is None:
        return None
    try:
        code = StatusCode(int(raw))
    except ValueError:
        code = StatusCode.UNKNOWN
    return code, unquote_message(fields.get("grpc-message", ""))


def _http_status(status: str) -> StatusCode:
    # grpc's mapping of an HTTP status without grpc-status
    return {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
            "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
            "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
            "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE}.get(
        status, StatusCode.UNKNOWN)


# ---------------------------------------------------------------- handlers


class RpcMethodHandler:
    """A method's function with its streaming kinds and (de)serialisers
    (None: the bytes as they are)."""

    def __init__(self, fn, request_streaming: bool, response_streaming: bool,
                 request_deserializer=None, response_serializer=None) -> None:
        self.fn = fn
        self.request_streaming = request_streaming
        self.response_streaming = response_streaming
        self.request_deserializer = request_deserializer
        self.response_serializer = response_serializer


def unary_unary_rpc_method_handler(fn, request_deserializer=None, response_serializer=None):
    return RpcMethodHandler(fn, False, False, request_deserializer, response_serializer)


def unary_stream_rpc_method_handler(fn, request_deserializer=None, response_serializer=None):
    return RpcMethodHandler(fn, False, True, request_deserializer, response_serializer)


def stream_unary_rpc_method_handler(fn, request_deserializer=None, response_serializer=None):
    return RpcMethodHandler(fn, True, False, request_deserializer, response_serializer)


class GenericRpcHandler:
    """A service's handlers by their full path ``/service/method``."""

    def __init__(self, methods: dict) -> None:
        self.methods = methods


def method_handlers_generic_handler(service: str, handlers: dict) -> GenericRpcHandler:
    return GenericRpcHandler({f"/{service}/{name}": h for name, h in handlers.items()})


class ServicerContext:
    """What a handler is given beside its request: ``abort``."""

    def __init__(self) -> None:
        self.code: StatusCode | None = None
        self.details = ""
        self.aborted = False

    def abort(self, code: StatusCode, details: str):
        """End the call with ``code`` and ``details``: raises, and the
        status holds even where the handler catches what was raised."""
        self.code, self.details, self.aborted = code, details, True
        raise _Abort(details)


_RESPONSE_HEADERS = [(":status", "200"), ("content-type", "application/grpc"),
                     ("grpc-accept-encoding", "identity")]


class _Cancelled(Exception):
    """The client reset the stream or the connection was lost."""


# ---------------------------------------------------------------- server


class Server:
    """A gRPC server (see the module docstring)."""

    def __init__(self, max_workers: int = 8,
                 max_receive_message_length: int = MAX_RECEIVE_MESSAGE) -> None:
        self._methods: dict[str, RpcMethodHandler] = {}
        self._max_receive = max_receive_message_length
        self._listeners: list[tuple[socket.socket, ssl.SSLContext | None]] = []
        self._conns: set[h2.Connection] = set()
        self._lock = threading.Lock()
        self._tasks: queue.Queue = queue.Queue()
        self._workers = [threading.Thread(target=self._work, name=f"grpc-handler-{n}",
                                          daemon=True) for n in range(max_workers)]
        self._active = 0  # handlers running
        self._idle = threading.Condition(self._lock)
        self._stopped = threading.Event()

    def add_generic_rpc_handlers(self, handlers) -> None:
        for handler in handlers:
            self._methods.update(handler.methods)

    def _bind(self, address: str, context) -> int:
        host, port = split_target(address)
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        sock = socket.create_server((host or "0.0.0.0", port), family=family)
        self._listeners.append((sock, context))
        return sock.getsockname()[1]

    def add_insecure_port(self, address: str) -> int:
        return self._bind(address, None)

    def add_secure_port(self, address: str, context: ssl.SSLContext) -> int:
        return self._bind(address, context)

    def start(self) -> None:
        for worker in self._workers:
            worker.start()
        for sock, context in self._listeners:
            threading.Thread(target=self._accept, args=(sock, context), name="grpc-accept",
                             daemon=True).start()

    def stop(self, grace: float | None) -> threading.Event:
        """Stop listening; after ``grace`` seconds (now when None or 0)
        end every connection with GOAWAY, in-flight streams with it. The
        event is set once that is done."""
        for sock, _ in self._listeners:
            try:
                sock.close()
            except OSError:
                pass
        self._stopped.set()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:  # no new streams; those open may finish within grace
            try:
                conn.send_frame(h2.GOAWAY, 0, 0, conn._last_peer_id.to_bytes(4, "big")
                                + bytes(4))
            except h2.ConnectionLost:
                pass
        if grace:
            deadline = time.monotonic() + grace
            with self._idle:
                while self._active and time.monotonic() < deadline:
                    self._idle.wait(deadline - time.monotonic())
        for conn in conns:
            conn.close()
        for _ in self._workers:
            self._tasks.put(None)
        done = threading.Event()
        done.set()
        return done

    def _accept(self, sock: socket.socket, context) -> None:
        while not self._stopped.is_set():
            try:
                raw, _ = sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_connection, args=(raw, context),
                             name="grpc-connection", daemon=True).start()

    def _serve_connection(self, raw: socket.socket, context) -> None:
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            if context is not None:
                raw.settimeout(10.0)
                raw = context.wrap_socket(raw, server_side=True)
                if raw.selected_alpn_protocol() not in (None, "h2"):
                    raise ssl.SSLError(f"ALPN chose {raw.selected_alpn_protocol()!r}, not h2")
        except (OSError, ssl.SSLError) as e:
            logger.info("gRPC handshake from a peer failed: %s", e)
            raw.close()
            return
        conn = h2.Connection(h2.Transport(raw), client=False, on_stream=self._on_stream)
        with self._lock:
            if self._stopped.is_set():
                conn.transport.close()
                return
            self._conns.add(conn)
        try:
            conn.serve()
        finally:
            with self._lock:
                self._conns.discard(conn)

    def _on_stream(self, conn: h2.Connection, stream: h2.Stream, fields) -> None:
        with self._lock:
            self._active += 1
        self._tasks.put((conn, stream, fields))

    def _work(self) -> None:
        while True:
            task = self._tasks.get()
            if task is None:
                return
            try:
                self._handle(*task)
            except Exception:  # noqa: BLE001 - a worker outlives any one call
                logger.exception("gRPC stream failed")
            finally:
                with self._idle:
                    self._active -= 1
                    self._idle.notify_all()

    # ------------------------------------------------------------ one call

    def _handle(self, conn: h2.Connection, stream: h2.Stream, fields) -> None:
        headers = dict(fields)
        stream.events.get_nowait()  # the request headers, already in ``fields``
        deadline = None
        if "grpc-timeout" in headers:
            try:
                deadline = time.monotonic() + decode_timeout(headers["grpc-timeout"])
            except ValueError:
                pass
        context = ServicerContext()
        sent_headers = [False]

        def respond_headers():
            if not sent_headers[0]:
                conn.send_headers(stream, _RESPONSE_HEADERS)
                sent_headers[0] = True

        def finish(code: StatusCode, details: str) -> None:
            trailers = [("grpc-status", str(code.value))]
            if details:
                trailers.append(("grpc-message", quote_message(details)))
            if not sent_headers[0]:  # trailers only
                trailers = [(":status", "200"), ("content-type", "application/grpc")] + trailers
            conn.send_headers(stream, trailers, end_stream=True)

        handler = self._methods.get(headers.get(":path", ""))
        try:
            if headers.get(":method") != "POST" or not headers.get(
                    "content-type", "").startswith("application/grpc"):
                finish(StatusCode.INTERNAL, "not a gRPC request")
            elif handler is None:
                finish(StatusCode.UNIMPLEMENTED, "Method not found!")
            else:
                self._call(conn, stream, handler, context, respond_headers, finish, deadline)
        except (h2.ConnectionLost, _Cancelled):
            pass  # the client went away: nothing to answer
        finally:
            if stream.remote_closed:
                conn.release(stream)
            else:  # the answer is complete; the client need send no more
                conn.reset_stream(stream, h2.NO_ERROR)

    def _call(self, conn, stream, handler, context, respond_headers, finish, deadline) -> None:
        requests = self._requests(conn, stream, handler.request_deserializer, deadline)
        serialize = handler.response_serializer or bytes
        try:
            if handler.request_streaming:
                arg = requests
            else:
                items = list(requests)
                if len(items) != 1:
                    finish(StatusCode.UNIMPLEMENTED if not items else StatusCode.INTERNAL,
                           f"expected one request message, got {len(items)}")
                    return
                arg = items[0]
            if handler.response_streaming:
                for response in handler.fn(arg, context):
                    respond_headers()
                    conn.send_data(stream, encode_message(serialize(response)), deadline=deadline)
            else:
                body = encode_message(serialize(handler.fn(arg, context)))
                if conn.send_response(stream, _RESPONSE_HEADERS, body, [("grpc-status", "0")]):
                    return  # the whole answer in one write
                respond_headers()
                conn.send_data(stream, body, deadline=deadline)
        except RpcError as e:  # a malformed or oversized request
            finish(e.code(), e.details())
            return
        except (h2.ConnectionLost, _Cancelled):
            raise
        except TimeoutError:
            finish(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
            return
        except Exception as e:  # noqa: BLE001 - the handler's error is the caller's status
            if context.aborted:
                finish(context.code, context.details)
            else:
                what = "iterating responses" if handler.response_streaming else "calling application"
                logger.exception("gRPC handler %s failed", handler.fn)
                finish(StatusCode.UNKNOWN, f"Exception {what}: {e}")
            return
        finish(StatusCode.OK, "")

    def _requests(self, conn, stream, deserialize, deadline):
        deframer = Deframer(self._max_receive)
        while True:
            wait = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            try:
                kind, value, *rest = stream.events.get(timeout=wait)
            except queue.Empty:
                raise TimeoutError("deadline passed waiting for a request message") from None
            if kind == "data":
                conn.consumed(stream, len(value))
                for message in deframer.feed(value):
                    try:
                        yield deserialize(message) if deserialize else message
                    except (ValueError, TypeError) as e:
                        raise RpcError(StatusCode.INTERNAL,
                                       "Exception deserializing request!") from e
                if rest[0]:
                    return
            elif kind == "headers":
                if rest[0]:
                    return
            else:  # reset or closed
                raise _Cancelled(str(value))


# ---------------------------------------------------------------- channel


def split_target(target: str) -> tuple[str, int]:
    """``host:port`` or ``[v6]:port``."""
    host, sep, port = target.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"target {target!r} names no port")
    return host.strip("[]"), int(port)


class Channel:
    """A client connection to ``target`` (TLS with ``ssl_context``), opened
    at the first call and again after it is lost."""

    def __init__(self, target: str, ssl_context: ssl.SSLContext | None = None) -> None:
        self.target = target
        self._host, self._port = split_target(target)
        self._ssl = ssl_context
        self._lock = threading.Lock()
        self._conn: h2.Connection | None = None
        self._closed = False

    def _connection(self, deadline: float | None) -> h2.Connection:
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "Channel closed!")
            conn = self._conn
            if conn is None or conn.error is not None or conn.goaway is not None:
                # after a GOAWAY the old connection's open streams finish on it
                self._conn = conn = self._connect(deadline)
            return conn

    def _connect(self, deadline: float | None) -> h2.Connection:
        timeout = CONNECT_TIMEOUT_S
        if deadline is not None:
            timeout = max(min(timeout, deadline - time.monotonic()), 0.001)
        try:
            sock = socket.create_connection((self._host, self._port), timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl is not None:
                sock = self._ssl.wrap_socket(sock, server_hostname=self._host)
                if sock.selected_alpn_protocol() != "h2":
                    sock.close()
                    raise ssl.SSLError(f"the server chose ALPN {sock.selected_alpn_protocol()!r}"
                                       ", not h2")
        except (OSError, ssl.SSLError) as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to all addresses; last error: {e}") from e
        conn = h2.Connection(h2.Transport(sock), client=True)
        try:
            conn.start()
        except h2.ConnectionLost as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
        return conn

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _headers(self, method: str, timeout: float | None) -> list:
        headers = [(":method", "POST"), (":scheme", "https" if self._ssl else "http"),
                   (":path", method), (":authority", f"{self._host}:{self._port}"),
                   ("te", "trailers"), ("content-type", "application/grpc"),
                   ("grpc-accept-encoding", "identity"), ("user-agent", USER_AGENT)]
        if timeout is not None:
            headers.append(("grpc-timeout", encode_timeout(timeout)))
        return headers

    def _start(self, method: str, timeout: float | None, requests, serialize):
        """Open the call's stream and send its requests (an iterable of
        messages); returns the stream, its connection and the deadline."""
        deadline = None if timeout is None else time.monotonic() + timeout
        conn = self._connection(deadline)
        serialize = serialize or bytes
        # one request message rides with the HEADERS when the windows allow
        body = encode_message(serialize(requests[0])) if isinstance(requests, tuple) else None
        try:
            stream = conn.open_stream(self._headers(method, timeout), body)
        except h2.ConnectionLost as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from e
        try:
            if not stream.local_closed:
                for message in ((body,) if body is not None else
                                (encode_message(serialize(r)) for r in requests)):
                    conn.send_data(stream, message, deadline=deadline)
                conn.send_data(stream, b"", end_stream=True)
        except h2.ConnectionLost:
            pass  # the answer (an early status, or the lost connection) says why
        except TimeoutError:
            conn.reset_stream(stream)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except BaseException:
            conn.reset_stream(stream)
            raise
        return conn, stream, deadline

    def _responses(self, conn, stream, deadline, deserialize):
        """The answer's messages; raises ``RpcError`` for a status other
        than OK. Resets the stream when left before its end."""
        deframer = Deframer()
        status = None
        finished = False
        try:
            got_headers = False
            while status is None:
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    status = StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded"
                    break
                try:
                    kind, value, *rest = stream.events.get(timeout=wait)
                except queue.Empty:
                    continue
                if kind == "headers":
                    fields = dict(value)
                    status = _status_of(fields)
                    if not got_headers and status is None and fields.get(":status") != "200":
                        status = (_http_status(fields.get(":status", "")),
                                  f"Received http2 header with status: {fields.get(':status')}")
                    got_headers = True
                    if rest[0] and status is None:
                        status = StatusCode.INTERNAL, "the stream ended without a grpc-status"
                elif kind == "data":
                    conn.consumed(stream, len(value))
                    for message in deframer.feed(value):
                        yield deserialize(message) if deserialize else message
                    if rest[0]:
                        status = StatusCode.INTERNAL, "the stream ended without trailers"
                elif kind == "reset":
                    status = (StatusCode.CANCELLED if value == h2.CANCEL else StatusCode.INTERNAL,
                              f"Received RST_STREAM with error code {value}")
                else:
                    status = StatusCode.UNAVAILABLE, str(value)
            finished = True
        except RpcError as e:
            status = e.code(), e.details()
        finally:
            if not finished or status[0] is not StatusCode.OK:
                conn.reset_stream(stream)
            else:
                conn.release(stream)
        if status[0] is not StatusCode.OK:
            raise RpcError(*status)

    def _unary_response(self, conn, stream, deadline, deserialize):
        messages = list(self._responses(conn, stream, deadline, deserialize))
        if len(messages) != 1:
            raise RpcError(StatusCode.INTERNAL,
                           f"expected one response message, got {len(messages)}")
        return messages[0]

    def unary_unary(self, method: str, request_serializer=None, response_deserializer=None):
        def call(request, timeout: float | None = None):
            conn, stream, deadline = self._start(method, timeout, (request,), request_serializer)
            return self._unary_response(conn, stream, deadline, response_deserializer)

        return call

    def unary_stream(self, method: str, request_serializer=None, response_deserializer=None):
        def call(request, timeout: float | None = None):
            conn, stream, deadline = self._start(method, timeout, (request,), request_serializer)
            return self._responses(conn, stream, deadline, response_deserializer)

        return call

    def stream_unary(self, method: str, request_serializer=None, response_deserializer=None):
        def call(request_iterator, timeout: float | None = None):
            conn, stream, deadline = self._start(method, timeout, request_iterator,
                                                 request_serializer)
            return self._unary_response(conn, stream, deadline, response_deserializer)

        return call
