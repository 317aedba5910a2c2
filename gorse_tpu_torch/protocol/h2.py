"""HTTP/2 (RFC 9113) with HPACK (RFC 7541) over ``socket`` and ``ssl``.

The transport under the port's gRPC (protocol/grpcwire.py), where the
reference relies on grpcio's C core. Two parts:

- **HPACK**: the integer and string codecs, the 61-entry static table, the
  dynamic table with its size bound and size updates, and the Huffman code
  of Appendix B both ways. ``Decoder`` accepts every representation;
  ``Encoder`` writes indexed static entries and literals without indexing
  and without Huffman, which every decoder accepts, so the peer's dynamic
  table stays empty.
- **Framing**: the preface, DATA, HEADERS with CONTINUATION, SETTINGS and
  its ACK, PING and its ACK, WINDOW_UPDATE, RST_STREAM and GOAWAY, and flow
  control for the connection and for each stream. ``Connection`` runs one
  reader thread that decodes frames in order and queues each stream's
  events; senders split DATA at the peer's ``MAX_FRAME_SIZE`` and wait on
  the peer's windows (an ``INITIAL_WINDOW_SIZE`` change from SETTINGS moves
  every open stream's window). The receive windows are advertised large
  (``STREAM_WINDOW``, ``CONNECTION_WINDOW``: the reference's 512 MiB
  message limit) and given back with WINDOW_UPDATE as data is consumed: the
  connection's as frames arrive, a stream's as its reader takes the data.
"""

from __future__ import annotations

import queue
import select
import socket
import ssl
import struct
import threading
import time

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types and flags (RFC 9113 §6)
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, \
    CONTINUATION = range(10)
END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20

# settings (RFC 9113 §6.5.2)
HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE, \
    MAX_HEADER_LIST_SIZE = range(1, 7)

# error codes (RFC 9113 §7)
NO_ERROR, PROTOCOL_ERROR, CANCEL, COMPRESSION_ERROR = 0, 1, 8, 9

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
# what this side advertises: 16 MiB a stream (a 1 MiB BlobChunk never waits
# on a WINDOW_UPDATE), the connection up to the 512 MiB message limit
STREAM_WINDOW = 16 << 20
CONNECTION_WINDOW = 512 << 20
LOCAL_MAX_FRAME = 4 << 20


class HPACKError(ValueError):
    """A header block that does not decode (a COMPRESSION_ERROR)."""


class ConnectionLost(ConnectionError):
    """The connection ended, or the stream was reset, while waiting on it."""


# ---------------------------------------------------------------- HPACK

STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"), (":status", "200"),
    (":status", "204"), (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
_STATIC_PAIR = {entry: i + 1 for i, entry in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {name: i + 1 for i, (name, _) in reversed(list(enumerate(STATIC_TABLE)))}

# Appendix B: the code length of each symbol 0..255 and EOS (256). The code
# is canonical: codes of one length are consecutive in symbol order, and
# each length's first code follows the last code of the shorter ones.
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
)
EOS = 256


def _canonical():
    order = sorted(range(257), key=lambda s: (HUFFMAN_LENGTHS[s], s))
    codes = [0] * 257
    first: dict[int, tuple[int, int, int]] = {}  # length -> (first code, first rank, count)
    code, prev = 0, HUFFMAN_LENGTHS[order[0]]
    for rank, sym in enumerate(order):
        length = HUFFMAN_LENGTHS[sym]
        code <<= length - prev
        prev = length
        codes[sym] = code
        c0, r0, n = first.get(length, (code, rank, 0))
        first[length] = (c0, r0, n + 1)
        code += 1
    return codes, order, first


HUFFMAN_CODES, _HUFF_ORDER, _HUFF_FIRST = _canonical()


def huffman_encode(data: bytes) -> bytes:
    """``data`` in the Huffman code, padded to a byte with EOS's leading ones."""
    acc, nbits = 0, 0
    for b in data:
        length = HUFFMAN_LENGTHS[b]
        acc = (acc << length) | HUFFMAN_CODES[b]
        nbits += length
    pad = -nbits % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    """Inverse of ``huffman_encode``; raises on EOS, on padding longer than
    7 bits or not all ones."""
    out = bytearray()
    code = length = 0
    first = _HUFF_FIRST
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            length += 1
            entry = first.get(length)
            if entry is not None and code - entry[0] < entry[2]:
                sym = _HUFF_ORDER[entry[1] + code - entry[0]]
                if sym == EOS:
                    raise HPACKError("EOS in a Huffman-coded string")
                out.append(sym)
                code = length = 0
            elif length > 30:
                raise HPACKError("invalid Huffman code")
    if length > 7 or code != (1 << length) - 1:
        raise HPACKError("invalid Huffman padding")
    return bytes(out)


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """RFC 7541 §5.1: ``value`` on an N-bit prefix, ``first`` the byte's
    high bits."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(buf: bytes, i: int, prefix: int) -> tuple[int, int]:
    limit = (1 << prefix) - 1
    if i >= len(buf):
        raise HPACKError("truncated integer")
    value = buf[i] & limit
    i += 1
    if value < limit:
        return value, i
    shift = 0
    while True:
        if i >= len(buf) or shift > 28:
            raise HPACKError("truncated or oversized integer")
        b = buf[i]
        i += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def encode_str(text: str) -> bytes:
    """A string literal without Huffman."""
    raw = text.encode("latin-1")
    return encode_int(len(raw), 7) + raw


def decode_str(buf: bytes, i: int) -> tuple[str, int]:
    if i >= len(buf):
        raise HPACKError("truncated string")
    huffman = buf[i] & 0x80
    length, i = decode_int(buf, i, 7)
    if i + length > len(buf):
        raise HPACKError("truncated string")
    raw = bytes(buf[i:i + length])
    return (huffman_decode(raw) if huffman else raw).decode("latin-1"), i + length


def entry_size(name: str, value: str) -> int:
    return len(name.encode("latin-1")) + len(value.encode("latin-1")) + 32


class Decoder:
    """HPACK decoder with its dynamic table; ``max_table_size`` is the
    SETTINGS_HEADER_TABLE_SIZE this side advertised (the bound on size
    updates)."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_allowed = max_table_size
        self.max_size = max_table_size
        self.table: list[tuple[str, str]] = []  # newest first
        self.size = 0

    def _entry(self, index: int) -> tuple[str, str]:
        if 0 < index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        dyn = index - len(STATIC_TABLE) - 1
        if index == 0 or dyn >= len(self.table):
            raise HPACKError(f"header index {index} out of range")
        return self.table[dyn]

    def _evict(self) -> None:
        while self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= entry_size(name, value)

    def _add(self, name: str, value: str) -> None:
        size = entry_size(name, value)
        if size > self.max_size:  # an entry larger than the table empties it
            self.table.clear()
            self.size = 0
            return
        self.table.insert(0, (name, value))
        self.size += size
        self._evict()

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        i = 0
        while i < len(block):
            b = block[i]
            if b & 0x80:  # indexed field
                index, i = decode_int(block, i, 7)
                headers.append(self._entry(index))
            elif b & 0x40:  # literal with incremental indexing
                index, i = decode_int(block, i, 6)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, i = decode_str(block, i)
                value, i = decode_str(block, i)
                self._add(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update, before any field
                if headers:
                    raise HPACKError("table size update after a header field")
                size, i = decode_int(block, i, 5)
                if size > self.max_allowed:
                    raise HPACKError(f"table size update {size} above {self.max_allowed}")
                self.max_size = size
                self._evict()
            else:  # literal without indexing (0000) or never indexed (0001)
                index, i = decode_int(block, i, 4)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, i = decode_str(block, i)
                value, i = decode_str(block, i)
                headers.append((name, value))
        return headers


class Encoder:
    """HPACK encoder that never indexes: a static entry that matches name
    and value is indexed, every other field a literal without indexing
    (name indexed where the static table has it), no Huffman."""

    def __init__(self) -> None:
        self._size_update: int | None = None

    def set_max_table_size(self, size: int) -> None:
        """The peer's SETTINGS_HEADER_TABLE_SIZE: below the default, the
        next block opens with a size update, as RFC 7541 §4.2 asks."""
        if size < 4096:
            self._size_update = size

    def encode(self, headers) -> bytes:
        out = bytearray()
        if self._size_update is not None:
            out += encode_int(self._size_update, 5, 0x20)
            self._size_update = None
        for name, value in headers:
            index = _STATIC_PAIR.get((name, value))
            if index:
                out += encode_int(index, 7, 0x80)
                continue
            index = _STATIC_NAME.get(name)
            out += encode_int(index, 4) if index else b"\x00" + encode_str(name)
            out += encode_str(value)
        return bytes(out)


# ---------------------------------------------------------------- transport


class Transport:
    """A connected socket (plain or TLS, handshake done) made non-blocking,
    with every socket or TLS call under one lock, so that one thread reads
    while others write: an ``ssl`` object must not run two calls at once."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        sock.setblocking(False)
        self._lock = threading.Lock()
        self.closed = False

    def _wait(self, want_write: bool, timeout: float) -> None:
        try:
            if want_write:
                select.select([], [self.sock], [], timeout)
            else:
                select.select([self.sock], [], [], timeout)
        except (OSError, ValueError) as e:
            raise ConnectionLost("socket closed") from e

    def recv(self) -> bytes:
        """The next bytes, b"" at the end of the stream."""
        while not self.closed:
            with self._lock:
                try:
                    return self.sock.recv(1 << 20)
                except (ssl.SSLWantReadError, BlockingIOError):
                    want_write = False
                except ssl.SSLWantWriteError:
                    want_write = True
            self._wait(want_write, 1.0)
        return b""

    def sendall(self, data) -> None:
        view = memoryview(data)
        while view:
            if self.closed:
                raise ConnectionLost("socket closed")
            with self._lock:
                try:
                    view = view[self.sock.send(view):]
                    continue
                except (ssl.SSLWantWriteError, BlockingIOError):
                    want_write = True
                except ssl.SSLWantReadError:
                    want_write = False
            self._wait(want_write, 1.0)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


# ---------------------------------------------------------------- connection


def frame(ftype: int, flags: int, stream_id: int, payload=b"") -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
            + (stream_id & MAX_WINDOW).to_bytes(4, "big") + bytes(payload))


class Stream:
    """One stream's state. ``events`` holds, in arrival order,
    ``("headers", fields, end_stream)``, ``("data", bytes, end_stream)``,
    ``("reset", error_code)`` and ``("closed", reason)``."""

    def __init__(self, stream_id: int, send_window: int) -> None:
        self.id = stream_id
        self.events: queue.Queue = queue.Queue()
        self.send_window = send_window
        self.recv_unacked = 0
        self.remote_closed = False  # END_STREAM received
        self.local_closed = False  # END_STREAM sent
        self.reset: str | None = None  # why no more can be sent


class Connection:
    """An HTTP/2 connection over a ``Transport``. ``client``: this side
    sends the preface and opens odd streams; a server passes ``on_stream``,
    called on the reader thread with each new stream and its request
    headers. ``serve()`` runs the reader loop in the calling thread;
    ``start()`` runs it on a daemon thread."""

    def __init__(self, transport: Transport, client: bool, on_stream=None) -> None:
        self.transport = transport
        self.client = client
        self._on_stream = on_stream
        self._write_lock = threading.Lock()
        self._flow = threading.Condition()
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.send_window = DEFAULT_WINDOW
        self._recv_unacked = 0
        self.streams: dict[int, Stream] = {}
        self._next_id = 1
        self._last_peer_id = 0
        self.error: str | None = None  # set once the connection is lost
        self.goaway: int | None = None  # the peer's last stream id after GOAWAY
        self._rbuf = bytearray()
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- writing

    def _write(self, data: bytes) -> None:
        try:
            with self._write_lock:
                self.transport.sendall(data)
        except OSError as e:
            self._fail(f"write failed: {e}")
            raise ConnectionLost(str(e)) from e

    def send_frame(self, ftype: int, flags: int, stream_id: int, payload=b"") -> None:
        self._write(frame(ftype, flags, stream_id, payload))

    def _preface(self) -> None:
        settings = [(INITIAL_WINDOW_SIZE, STREAM_WINDOW), (MAX_FRAME_SIZE, LOCAL_MAX_FRAME)]
        if self.client:
            settings.insert(0, (ENABLE_PUSH, 0))
        out = PREFACE if self.client else b""
        out += frame(SETTINGS, 0, 0, b"".join(struct.pack(">HI", k, v) for k, v in settings))
        out += frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", CONNECTION_WINDOW - DEFAULT_WINDOW))
        self._write(out)

    def _header_frames(self, stream_id: int, headers, end_stream: bool) -> bytes:
        block = self.encoder.encode(headers)
        size = self.peer_max_frame
        chunks = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        out = bytearray()
        for n, chunk in enumerate(chunks):
            flags = END_HEADERS if n == len(chunks) - 1 else 0
            if n == 0:
                out += frame(HEADERS, flags | (END_STREAM if end_stream else 0), stream_id, chunk)
            else:
                out += frame(CONTINUATION, flags, stream_id, chunk)
        return bytes(out)

    def _take_window(self, stream: Stream, n: int) -> bool:
        """Take ``n`` bytes of the stream's and the connection's send
        windows when both hold them and one frame carries them."""
        with self._flow:
            if stream.reset is None and n <= min(stream.send_window, self.send_window,
                                                 self.peer_max_frame):
                stream.send_window -= n
                self.send_window -= n
                return True
        return False

    def open_stream(self, headers, body: bytes | None = None) -> Stream:
        """A client's new stream, its HEADERS sent: the id is taken and the
        frames written under one lock, so ids reach the wire in order.
        ``body``, when the windows hold it, goes in the same write as one
        DATA frame that ends the stream (``local_closed`` says whether)."""
        try:
            with self._write_lock:
                with self._flow:
                    if self.error is not None or self.goaway is not None:
                        raise ConnectionLost(self.error or "the peer sent GOAWAY")
                    stream = Stream(self._next_id, self.peer_initial_window)
                    self._next_id += 2
                    self.streams[stream.id] = stream
                out = self._header_frames(stream.id, headers, False)
                if body is not None and self._take_window(stream, len(body)):
                    out += frame(DATA, END_STREAM, stream.id, body)
                    stream.local_closed = True
                self.transport.sendall(out)
        except OSError as e:
            self._fail(f"write failed: {e}")
            raise ConnectionLost(str(e)) from e
        return stream

    def send_response(self, stream: Stream, headers, body: bytes, trailers) -> bool:
        """HEADERS, one DATA frame and the trailers that end the stream, in
        one write, when the windows hold ``body``; False (nothing sent)
        when they do not."""
        if not self._take_window(stream, len(body)):
            return False
        try:
            with self._write_lock:
                self.transport.sendall(self._header_frames(stream.id, headers, False)
                                       + frame(DATA, 0, stream.id, body)
                                       + self._header_frames(stream.id, trailers, True))
        except OSError as e:
            self._fail(f"write failed: {e}")
            raise ConnectionLost(str(e)) from e
        stream.local_closed = True
        return True

    def send_headers(self, stream: Stream, headers, end_stream: bool = False) -> None:
        if stream.reset is not None:
            raise ConnectionLost(stream.reset)
        try:
            with self._write_lock:
                data = self._header_frames(stream.id, headers, end_stream)
                self.transport.sendall(data)
        except OSError as e:
            self._fail(f"write failed: {e}")
            raise ConnectionLost(str(e)) from e
        if end_stream:
            stream.local_closed = True

    def send_data(self, stream: Stream, data, end_stream: bool = False,
                  deadline: float | None = None) -> None:
        """``data`` in frames of at most the peer's MAX_FRAME_SIZE, each
        within the stream's and the connection's send windows; raises
        ``ConnectionLost`` when the stream is reset or the connection lost,
        ``TimeoutError`` past ``deadline`` (``time.monotonic`` seconds)."""
        view = memoryview(data)
        while True:
            with self._flow:
                while view and (stream.send_window <= 0 or self.send_window <= 0):
                    if stream.reset is not None:
                        raise ConnectionLost(stream.reset)
                    wait = None if deadline is None else deadline - time.monotonic()
                    if wait is not None and wait <= 0:
                        raise TimeoutError("deadline passed waiting for the peer's window")
                    self._flow.wait(1.0 if wait is None else min(wait, 1.0))
                if stream.reset is not None:
                    raise ConnectionLost(stream.reset)
                n = min(len(view), stream.send_window, self.send_window, self.peer_max_frame)
                stream.send_window -= n
                self.send_window -= n
            last = n == len(view)
            self.send_frame(DATA, END_STREAM if last and end_stream else 0, stream.id, view[:n])
            view = view[n:]
            if last:
                break
        if end_stream:
            stream.local_closed = True

    def reset_stream(self, stream: Stream, code: int = CANCEL) -> None:
        """RST_STREAM, unless the stream already ended both ways or was
        already reset or released."""
        with self._flow:
            open_ = self.streams.get(stream.id) is stream
        if open_ and not (stream.local_closed and stream.remote_closed) and self.error is None:
            try:
                self.send_frame(RST_STREAM, 0, stream.id, struct.pack(">I", code))
            except ConnectionLost:
                pass
        self.release(stream, f"reset by this side ({code})")

    def release(self, stream: Stream, why: str = "stream ended") -> None:
        with self._flow:
            self.streams.pop(stream.id, None)
            if stream.reset is None:
                stream.reset = why
            self._flow.notify_all()

    def consumed(self, stream: Stream, n: int) -> None:
        """Give ``n`` bytes of a stream's window back once its reader has
        taken them."""
        stream.recv_unacked += n
        if stream.recv_unacked >= STREAM_WINDOW // 4 and not stream.remote_closed:
            inc, stream.recv_unacked = stream.recv_unacked, 0
            try:
                self.send_frame(WINDOW_UPDATE, 0, stream.id, struct.pack(">I", inc))
            except ConnectionLost:
                pass

    def close(self) -> None:
        """GOAWAY, then close the socket; every open stream gets a
        ``closed`` event."""
        if self.error is None:
            try:
                self.send_frame(GOAWAY, 0, 0, struct.pack(">II", self._last_peer_id, NO_ERROR))
            except ConnectionLost:
                pass
        self._fail("connection closed")

    # ----------------------------------------------------------- reading

    def start(self) -> None:
        """Write this side's preface, then run the reader loop on a daemon
        thread: a caller's first frame follows the preface."""
        self._preface()
        self._thread = threading.Thread(target=self._read_loop, name="h2-reader", daemon=True)
        self._thread.start()

    def _read(self, n: int) -> bytes:
        buf = self._rbuf
        while len(buf) < n:
            data = self.transport.recv()
            if not data:
                raise ConnectionLost("the peer closed the connection")
            buf += data
        out = bytes(buf[:n])
        del buf[:n]
        return out

    def _read_frame(self) -> tuple[int, int, int, bytes]:
        head = self._read(9)
        length = int.from_bytes(head[:3], "big")
        sid = int.from_bytes(head[5:9], "big") & MAX_WINDOW
        return head[3], head[4], sid, self._read(length) if length else b""

    def serve(self) -> None:
        """Write this side's preface, then run the reader loop in the
        calling thread until the connection ends."""
        try:
            self._preface()
        except ConnectionLost:
            return
        self._read_loop()

    def _read_loop(self) -> None:
        try:
            if not self.client and self._read(len(PREFACE)) != PREFACE:
                raise ConnectionLost("not an HTTP/2 client preface")
            while self.error is None:
                self._dispatch(*self._read_frame())
        except Exception as e:  # noqa: BLE001 - any fault ends the connection, never the process
            if self.error is None and not isinstance(e, OSError):
                try:
                    self.send_frame(GOAWAY, 0, 0, struct.pack(
                        ">II", self._last_peer_id,
                        COMPRESSION_ERROR if isinstance(e, HPACKError) else PROTOCOL_ERROR))
                except ConnectionLost:
                    pass
            self._fail(str(e) or type(e).__name__)

    def _fail(self, reason: str) -> None:
        with self._flow:
            if self.error is None:
                self.error = reason
            streams = list(self.streams.values())
            self.streams.clear()
            for stream in streams:
                if stream.reset is None:
                    stream.reset = reason
            self._flow.notify_all()
        for stream in streams:
            stream.events.put(("closed", reason))
        self.transport.close()

    def _dispatch(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            self._on_headers(flags, sid, payload)
        elif ftype == SETTINGS:
            if not flags & ACK:
                self._on_settings(payload)
        elif ftype == PING:
            if not flags & ACK:
                self.send_frame(PING, ACK, 0, payload)
        elif ftype == WINDOW_UPDATE:
            inc = struct.unpack(">I", payload)[0] & MAX_WINDOW
            with self._flow:
                if sid == 0:
                    self.send_window += inc
                elif sid in self.streams:
                    self.streams[sid].send_window += inc
                self._flow.notify_all()
        elif ftype == RST_STREAM:
            code = struct.unpack(">I", payload)[0]
            with self._flow:
                stream = self.streams.pop(sid, None)
                if stream is not None and stream.reset is None:
                    stream.reset = f"reset by the peer ({code})"
                self._flow.notify_all()
            if stream is not None:
                stream.events.put(("reset", code))
        elif ftype == GOAWAY:
            last, code = struct.unpack(">II", payload[:8])
            last &= MAX_WINDOW
            reason = f"GOAWAY ({code}) {payload[8:].decode('latin-1')}".strip()
            with self._flow:
                self.goaway = last
                refused = [s for i, s in self.streams.items()
                           if i > last and (i % 2 == 1) == self.client]
                for stream in refused:
                    del self.streams[stream.id]
                    stream.reset = reason
                self._flow.notify_all()
            for stream in refused:
                stream.events.put(("closed", reason))
        elif ftype == PUSH_PROMISE:
            raise ValueError("PUSH_PROMISE with push disabled")
        elif ftype == CONTINUATION:
            raise ValueError("CONTINUATION without HEADERS")
        # PRIORITY and unknown types are ignored (RFC 9113 §5.5)

    def _on_settings(self, payload: bytes) -> None:
        """Apply the peer's settings and acknowledge them under the write
        lock: the ACK reaches the wire before any frame that uses the new
        values, as a peer holds frames to the settings it has seen
        acknowledged (grpcio answers a DATA frame above 16,384 bytes that
        precedes the ACK of its larger MAX_FRAME_SIZE with GOAWAY)."""
        if len(payload) % 6:
            raise ValueError("SETTINGS length not a multiple of 6")
        try:
            with self._write_lock:
                for off in range(0, len(payload), 6):
                    key, value = struct.unpack(">HI", payload[off:off + 6])
                    if key == HEADER_TABLE_SIZE:
                        self.encoder.set_max_table_size(value)
                    elif key == INITIAL_WINDOW_SIZE:
                        with self._flow:
                            delta = value - self.peer_initial_window
                            self.peer_initial_window = value
                            for stream in self.streams.values():
                                stream.send_window += delta
                            self._flow.notify_all()
                    elif key == MAX_FRAME_SIZE:
                        self.peer_max_frame = value
                self.transport.sendall(frame(SETTINGS, ACK, 0))
        except OSError as e:
            self._fail(f"write failed: {e}")
            raise ConnectionLost(str(e)) from e

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        self._recv_unacked += len(payload)
        if self._recv_unacked >= CONNECTION_WINDOW // 4:
            inc, self._recv_unacked = self._recv_unacked, 0
            self.send_frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", inc))
        if flags & PADDED:
            payload = payload[1:len(payload) - payload[0]]
        stream = self.streams.get(sid)
        if stream is None:
            return  # a stream this side already ended: counted, dropped
        end = bool(flags & END_STREAM)
        stream.remote_closed = stream.remote_closed or end
        stream.events.put(("data", payload, end))

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        end = bool(flags & END_STREAM)
        if flags & PADDED:
            payload = payload[1:len(payload) - payload[0]]
        if flags & PRIORITY_FLAG:
            payload = payload[5:]
        block = bytearray(payload)
        while not flags & END_HEADERS:
            ftype, flags, csid, more = self._read_frame()
            if ftype != CONTINUATION or csid != sid:
                raise ValueError("a header block interrupted")
            block += more
        fields = self.decoder.decode(bytes(block))  # decoded in order, even if dropped
        stream = self.streams.get(sid)
        if stream is None and not self.client and sid % 2 == 1 and sid > self._last_peer_id:
            self._last_peer_id = sid
            with self._flow:
                stream = Stream(sid, self.peer_initial_window)
                self.streams[sid] = stream
            stream.remote_closed = end
            stream.events.put(("headers", fields, end))
            self._on_stream(self, stream, fields)
            return
        if stream is not None:
            stream.remote_closed = stream.remote_closed or end
            stream.events.put(("headers", fields, end))
