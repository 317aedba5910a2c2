"""The port's HTTP/2 and HPACK (gorse_tpu_torch/protocol/h2.py).

HPACK against RFC 7541 Appendix C (C.2-C.6, with and without Huffman,
across C.5/C.6's evictions at a 256-byte table) and against libnghttp2
(loaded with ctypes): nghttp2's Huffman-coding, indexing deflater's blocks
decode to the same headers in the port's decoder, and the port's blocks
decode in nghttp2's inflater. The nghttp2 cases skip only where the library
is absent. The framing against a raw client on a socket: the server's
preface, PING answered, DATA split at the client's MAX_FRAME_SIZE and held
within the client's INITIAL_WINDOW_SIZE until its WINDOW_UPDATE. Every
socket has a timeout of its own, and ``stall_guard`` (tests/_stall.py)
bounds each test.
"""

import ctypes
import ctypes.util
import socket
import struct

import numpy as np
import pytest

from gorse_tpu_torch.protocol import h2
from _stall import stall_guard  # noqa: F401 - autouse: a stalled stream fails its test

# ---------------------------------------------------------------- HPACK

C2 = [  # (block, headers, table after as (name, value) newest first)
    ("400a637573746f6d2d6b65790d637573746f6d2d686561646572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")]),
    ("040c2f73616d706c652f70617468", [(":path", "/sample/path")], []),
    ("100870617373776f726406736563726574", [("password", "secret")], []),
    ("82", [(":method", "GET")], []),
]
REQUESTS = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com"),
     ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
C3 = ["828684410f7777772e6578616d706c652e636f6d", "828684be58086e6f2d6361636865",
      "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"]
C4 = ["828684418cf1e3c2e5f23a6ba0ab90f4ff", "828684be5886a8eb10649cbf",
      "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]
REQUEST_TABLES = [(57, 1), (110, 2), (164, 3)]  # (size, entries) after each
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESPONSES = [
    [(":status", "302"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:21 GMT"), ("location", "https://www.example.com")],
    [(":status", "307"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:21 GMT"), ("location", "https://www.example.com")],
    [(":status", "200"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:22 GMT"), ("location", "https://www.example.com"),
     ("content-encoding", "gzip"), ("set-cookie", COOKIE)],
]
C5 = ["4803333032580770726976617465611d4d6f6e2c203231204f637420323031332032303a31333a3231"
      "20474d546e1768747470733a2f2f7777772e6578616d706c652e636f6d",
      "4803333037c1c0bf",
      "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d54c05a04677a6970"
      "7738666f6f3d4153444a4b48514b425a584f5157454f50495541585157454f49553b206d61782d61"
      "67653d333630303b2076657273696f6e3d31"]
C6 = ["488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1bff6e919d29ad"
      "171863c78f0b97c8e9ae82ae43d3",
      "4883640effc1c0bf",
      "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab77ad94e7821dd7f2"
      "e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587316065c003ed4ee5b1063d5007"]
RESPONSE_TABLES = [  # C.5/C.6 at SETTINGS_HEADER_TABLE_SIZE = 256
    [("location", "https://www.example.com"), ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
     ("cache-control", "private"), (":status", "302")],
    [(":status", "307"), ("location", "https://www.example.com"),
     ("date", "Mon, 21 Oct 2013 20:13:21 GMT"), ("cache-control", "private")],
    [("set-cookie", COOKIE), ("content-encoding", "gzip"),
     ("date", "Mon, 21 Oct 2013 20:13:22 GMT")],
]


@pytest.mark.parametrize("n", range(len(C2)))
def test_rfc7541_c2_single_fields(n):
    block, headers, table = C2[n]
    d = h2.Decoder()
    assert d.decode(bytes.fromhex(block)) == headers
    assert d.table == table and d.size == sum(h2.entry_size(*e) for e in table)


@pytest.mark.parametrize("blocks", [C3, C4], ids=["C3-plain", "C4-huffman"])
def test_rfc7541_requests_on_one_connection(blocks):
    d = h2.Decoder()
    for block, headers, (size, entries) in zip(blocks, REQUESTS, REQUEST_TABLES):
        assert d.decode(bytes.fromhex(block)) == headers
        assert (d.size, len(d.table)) == (size, entries)


@pytest.mark.parametrize("blocks", [C5, C6], ids=["C5-plain", "C6-huffman"])
def test_rfc7541_responses_evict_at_256(blocks):
    d = h2.Decoder(max_table_size=256)
    for block, headers, table in zip(blocks, RESPONSES, RESPONSE_TABLES):
        assert d.decode(bytes.fromhex(block)) == headers
        assert d.table == table and d.size == sum(h2.entry_size(*e) for e in table)
    assert d.size == 215


def test_huffman_strings_of_c4_and_c6():
    """The Huffman codes of C.4.1's and C.6.1's strings, both ways."""
    for text, coded in (("www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
                        ("no-cache", "a8eb10649cbf"), ("custom-key", "25a849e95ba97d7f"),
                        ("custom-value", "25a849e95bb8e8b4bf"), ("302", "6402"),
                        ("private", "aec3771a4b"),
                        ("https://www.example.com", "9d29ad171863c78f0b97c8e9ae82ae43d3")):
        assert h2.huffman_encode(text.encode()).hex() == coded
        assert h2.huffman_decode(bytes.fromhex(coded)) == text.encode()


def test_huffman_round_trip_and_rejections():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 300):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert h2.huffman_decode(h2.huffman_encode(data)) == data
    assert h2.HUFFMAN_CODES[h2.EOS] == (1 << 30) - 1  # EOS: thirty ones
    with pytest.raises(h2.HPACKError):
        h2.huffman_decode(b"\xff\xff\xff\xff")  # EOS inside the string
    with pytest.raises(h2.HPACKError):
        h2.huffman_decode(b"\x00")  # '0' then three zero bits of padding
    with pytest.raises(h2.HPACKError):
        h2.huffman_decode(bytes.fromhex("1fff"))  # 'a' then 11 bits of padding


def test_integer_codec_and_size_updates():
    assert h2.encode_int(10, 5) == bytes([10])  # C.1.1
    assert h2.encode_int(1337, 5) == bytes([31, 154, 10])  # C.1.2
    assert h2.encode_int(42, 8) == bytes([42])  # C.1.3
    for value in (0, 30, 31, 127, 128, 1 << 20):
        for prefix in (4, 5, 6, 7):
            assert h2.decode_int(h2.encode_int(value, prefix), 0, prefix) == (value, len(
                h2.encode_int(value, prefix)))
    d = h2.Decoder()
    d.decode(bytes.fromhex(C3[0]))
    assert d.decode(bytes.fromhex("20") + bytes.fromhex("82")) == [(":method", "GET")]
    assert d.table == [] and d.max_size == 0  # a size update to 0 evicts all
    with pytest.raises(h2.HPACKError):
        d.decode(bytes.fromhex("82") + bytes.fromhex("20"))  # after a field
    with pytest.raises(h2.HPACKError):
        d.decode(h2.encode_int(4097, 5, 0x20))  # above the advertised bound
    with pytest.raises(h2.HPACKError):
        d.decode(bytes.fromhex("be"))  # index 62 with an empty table
    e = h2.Encoder()
    e.set_max_table_size(100)
    first, second = e.encode([(":status", "200")]), e.encode([(":status", "200")])
    assert first == h2.encode_int(100, 5, 0x20) + b"\x88" and second == b"\x88"


# ---------------------------------------------------------------- nghttp2


class _NV(ctypes.Structure):
    _fields_ = [("name", ctypes.POINTER(ctypes.c_uint8)), ("value", ctypes.POINTER(ctypes.c_uint8)),
                ("namelen", ctypes.c_size_t), ("valuelen", ctypes.c_size_t),
                ("flags", ctypes.c_uint8)]


@pytest.fixture(scope="module")
def nghttp2():
    path = ctypes.util.find_library("nghttp2")
    if path is None:
        pytest.skip("libnghttp2 is not installed")
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.nghttp2_hd_deflate_new.argtypes = [ctypes.POINTER(vp), ctypes.c_size_t]
    lib.nghttp2_hd_deflate_hd.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.POINTER(_NV), ctypes.c_size_t]
    lib.nghttp2_hd_deflate_hd.restype = ctypes.c_ssize_t
    lib.nghttp2_hd_deflate_del.argtypes = [vp]
    lib.nghttp2_hd_inflate_new.argtypes = [ctypes.POINTER(vp)]
    lib.nghttp2_hd_inflate_hd2.argtypes = [vp, ctypes.POINTER(_NV), ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
    lib.nghttp2_hd_inflate_end_headers.argtypes = [vp]
    lib.nghttp2_hd_inflate_del.argtypes = [vp]
    return lib


def _deflate(lib, header_lists) -> list[bytes]:
    deflater = ctypes.c_void_p()
    assert lib.nghttp2_hd_deflate_new(ctypes.byref(deflater), 4096) == 0
    out = []
    try:
        for headers in header_lists:
            raw = [(n.encode("latin-1"), v.encode("latin-1")) for n, v in headers]
            nva = (_NV * len(raw))()
            keep = []
            for i, (n, v) in enumerate(raw):
                nb, vb = ctypes.create_string_buffer(n, len(n)), ctypes.create_string_buffer(v, len(v))
                keep += [nb, vb]
                nva[i] = _NV(ctypes.cast(nb, ctypes.POINTER(ctypes.c_uint8)),
                             ctypes.cast(vb, ctypes.POINTER(ctypes.c_uint8)), len(n), len(v), 0)
            buf = ctypes.create_string_buffer(1 << 16)
            n = lib.nghttp2_hd_deflate_hd(deflater, buf, len(buf), nva, len(raw))
            assert n >= 0
            out.append(buf.raw[:n])
    finally:
        lib.nghttp2_hd_deflate_del(deflater)
    return out


def _inflate(lib, blocks) -> list[list[tuple[str, str]]]:
    inflater = ctypes.c_void_p()
    assert lib.nghttp2_hd_inflate_new(ctypes.byref(inflater)) == 0
    out = []
    try:
        for block in blocks:
            headers, pos = [], 0
            while True:
                nv, flags = _NV(), ctypes.c_int(0)
                rv = lib.nghttp2_hd_inflate_hd2(inflater, ctypes.byref(nv), ctypes.byref(flags),
                                                block[pos:], len(block) - pos, 1)
                assert rv >= 0, rv
                pos += rv
                if flags.value & 0x02:  # NGHTTP2_HD_INFLATE_EMIT
                    headers.append((ctypes.string_at(nv.name, nv.namelen).decode("latin-1"),
                                    ctypes.string_at(nv.value, nv.valuelen).decode("latin-1")))
                if flags.value & 0x01:  # NGHTTP2_HD_INFLATE_FINAL
                    break
            lib.nghttp2_hd_inflate_end_headers(inflater)
            out.append(headers)
    finally:
        lib.nghttp2_hd_inflate_del(inflater)
    return out


def _header_lists(seed: int, n: int = 12):
    """gRPC-like requests, answers and trailers, values repeating across
    blocks (the dynamic table's references) and some with any byte."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        out.append([(":method", "POST"), (":scheme", "http"), (":path", f"/svc.S/M{k % 3}"),
                    (":authority", "127.0.0.1:8086"), ("te", "trailers"),
                    ("content-type", "application/grpc"), ("grpc-timeout", f"{k * 7}m"),
                    ("user-agent", "grpc-python/1.76.0 grpc-c/49.0.0 (linux; chttp2)"),
                    ("x-blob-bin", bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                                      dtype=np.uint8)).decode("latin-1"))])
        out.append([(":status", "200"), ("content-type", "application/grpc"),
                    ("grpc-status", str(k % 17)), ("grpc-message", "Method%20not%20found!")])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nghttp2_huffman_blocks_decode_in_the_port(nghttp2, seed):
    lists = _header_lists(seed)
    blocks = _deflate(nghttp2, lists)
    # later blocks refer to the dynamic table: shorter than the same list alone
    assert len(blocks[2]) < len(_deflate(nghttp2, [lists[2]])[0])
    assert sum(len(b) for b in blocks) < sum(len(h2.Encoder().encode(h)) for h in lists)
    d = h2.Decoder()
    assert [d.decode(b) for b in blocks] == lists
    assert d.size > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_blocks_decode_in_nghttp2(nghttp2, seed):
    lists = _header_lists(seed)
    e = h2.Encoder()
    assert _inflate(nghttp2, [e.encode(h) for h in lists]) == lists


# ---------------------------------------------------------------- framing


class _RawClient:
    """An HTTP/2 client written frame by frame on a socket."""

    def __init__(self, port: int, settings: dict) -> None:
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.buf = b""
        self.decoder = h2.Decoder()
        payload = b"".join(struct.pack(">HI", k, v) for k, v in settings.items())
        self.sock.sendall(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0, payload))

    def read_frame(self):
        while True:
            if len(self.buf) >= 9:
                length = int.from_bytes(self.buf[:3], "big")
                if len(self.buf) >= 9 + length:
                    head, self.buf = self.buf[:9 + length], self.buf[9 + length:]
                    return head[3], head[4], int.from_bytes(head[5:9], "big"), head[9:]
            data = self.sock.recv(1 << 16)
            assert data, "the server closed the connection"
            self.buf += data

    def close(self):
        self.sock.close()


def test_server_preface_ping_frame_size_and_windows(tmp_path):
    """A Download of a 100,000-byte file to a client that allows 16,384-byte
    frames and 1,000-byte stream windows: the server's first frame is its
    SETTINGS; a PING comes back as its ACK; no DATA frame exceeds 16,384,
    the stream never runs past its window, the rest follows each
    WINDOW_UPDATE, and the file arrives whole."""
    from gorse_tpu_torch.protocol import pb, rpc
    from gorse_tpu_torch.protocol.grpcwire import Deframer
    from gorse_tpu_torch.storage.blob import BlobStore

    blob = BlobStore(tmp_path / "blobs")
    payload = np.random.default_rng(0).bytes(100_000)
    (blob.create("m") / "w.bin").write_bytes(payload)

    class _Master:
        pass

    server, port = rpc.serve_master_grpc(_Master(), blob, port=0)
    client = _RawClient(port, {h2.INITIAL_WINDOW_SIZE: 1000, h2.MAX_FRAME_SIZE: 16384})
    try:
        ftype, flags, sid, body = client.read_frame()
        assert (ftype, flags, sid) == (h2.SETTINGS, 0, 0)
        client.sock.sendall(h2.frame(h2.SETTINGS, h2.ACK, 0)
                            + h2.frame(h2.WINDOW_UPDATE, 0, 0, struct.pack(">I", 1 << 20))
                            + h2.frame(h2.PING, 0, 0, b"12345678"))
        request = pb.BlobRequest(name="m").SerializeToString()
        headers = [(":method", "POST"), (":scheme", "http"), (":path", "/gorse_tpu.BlobStore/Download"),
                   (":authority", "x"), ("te", "trailers"), ("content-type", "application/grpc")]
        client.sock.sendall(
            h2.frame(h2.HEADERS, h2.END_HEADERS, 1, h2.Encoder().encode(headers))
            + h2.frame(h2.DATA, h2.END_STREAM, 1, b"\x00" + len(request).to_bytes(4, "big")
                       + request))
        deframer, got, pinged, trailers = Deframer(), [], False, None
        window, sizes = 1000, []
        while trailers is None:
            ftype, flags, sid, body = client.read_frame()
            if ftype == h2.PING and flags & h2.ACK:
                assert body == b"12345678"
                pinged = True
            elif ftype == h2.DATA:
                sizes.append(len(body))
                window -= len(body)
                assert window >= 0, "the server sent past the stream's window"
                got += deframer.feed(body)
                if window == 0:  # give the window back, a little at a time
                    window = 25_000
                    client.sock.sendall(h2.frame(h2.WINDOW_UPDATE, 0, 1, struct.pack(">I", 25_000)))
            elif ftype == h2.HEADERS:
                fields = dict(client.decoder.decode(body))
                if "grpc-status" in fields:
                    trailers = fields
        assert pinged and trailers["grpc-status"] == "0"
        assert max(sizes) <= 16384 and sizes[0] <= 1000
        chunks = [pb.BlobChunk.FromString(m) for m in got]
        assert b"".join(c.data for c in chunks) == payload and chunks[-1].eof
    finally:
        client.close()
        server.stop(None)


def _read_frame(sock, buf: bytearray):
    while True:
        if len(buf) >= 9:
            length = int.from_bytes(buf[:3], "big")
            if len(buf) >= 9 + length:
                head = bytes(buf[:9 + length])
                del buf[:9 + length]
                return head[3], head[4], int.from_bytes(head[5:9], "big"), head[9:]
        data = sock.recv(1 << 16)
        assert data, "the client closed the connection"
        buf += data


def test_settings_ack_precedes_frames_that_use_them():
    """A client stalled on a zero window gets the server's SETTINGS that
    raise MAX_FRAME_SIZE and INITIAL_WINDOW_SIZE to 4 MiB: its ACK reaches
    the wire before any DATA frame above the default 16,384 bytes (grpcio's
    server holds frames to the settings it has seen acknowledged and closes
    the connection with GOAWAY "Failed parsing HTTP/2" otherwise). The
    reader stalls for 0.2 s on the HEADER_TABLE_SIZE that follows, as a
    descheduled thread would, while the woken sender is free to write."""
    import threading
    import time

    listener = socket.create_server(("127.0.0.1", 0))
    listener.settimeout(10)
    conn = h2.Connection(h2.Transport(socket.create_connection(listener.getsockname()[:2],
                                                               timeout=10)), client=True)
    resize = conn.encoder.set_max_table_size
    conn.encoder.set_max_table_size = lambda size: (time.sleep(0.2), resize(size))
    conn.start()
    server, _ = listener.accept()
    server.settimeout(10)
    buf = bytearray()
    try:
        assert bytes(server.recv(len(h2.PREFACE), socket.MSG_WAITALL)) == h2.PREFACE
        server.sendall(h2.frame(h2.SETTINGS, 0, 0, struct.pack(">HI", h2.INITIAL_WINDOW_SIZE, 0)))
        acks = 0
        while not acks:  # acknowledged: the zero window applies to the stream
            ftype, flags, _, body = _read_frame(server, buf)
            acks += ftype == h2.SETTINGS and bool(flags & h2.ACK)
        stream = conn.open_stream([(":method", "POST"), (":scheme", "http"), (":path", "/t"),
                                   (":authority", "x")])
        sender = threading.Thread(target=conn.send_data,
                                  args=(stream, b"x" * 100_000, True), daemon=True)
        sender.start()
        assert _read_frame(server, buf)[0] == h2.HEADERS
        # the sender waits on the zero window; now raise both settings
        server.sendall(h2.frame(h2.SETTINGS, 0, 0, struct.pack(
            ">HIHIHI", h2.MAX_FRAME_SIZE, 1 << 22, h2.INITIAL_WINDOW_SIZE, 1 << 22,
            h2.HEADER_TABLE_SIZE, 4096)))
        sent, order = 0, []
        while sent < h2.DEFAULT_WINDOW:  # the connection's window stays at its default
            ftype, flags, _, body = _read_frame(server, buf)
            if ftype == h2.SETTINGS and flags & h2.ACK:
                acks += 1
            elif ftype == h2.DATA:
                sent += len(body)
                order.append((len(body), acks))
        assert acks == 2 and sent == h2.DEFAULT_WINDOW
        assert all(ack == 2 for size, ack in order), order
        assert max(size for size, _ in order) > h2.DEFAULT_MAX_FRAME
    finally:
        conn.close()
        server.close()
        listener.close()
