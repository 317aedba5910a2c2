"""The port's gRPC control plane held against the reference's grpcio on the
wire (gorse_tpu_torch/protocol/: pb.py, grpcwire.py, rpc.py;
utils/tls.py).

- ``pb``: hypothesis-drawn values of all nine messages encode to the bytes
  of the reference's protoc module, and each side parses the other's.
- Interop, both directions, plain and over mutual TLS: the port's
  ``MasterGrpcClient`` and ``BlobStoreClient`` against the reference's
  ``serve_master_grpc``, the reference's clients against the port's, on
  GetMeta registration, PushProgress, List, and an Upload/Download of a
  3 MiB file beside a zero-byte one and a nested one (more than grpcio's
  first windows and frame sizes), the files back byte for byte; a client
  without a certificate, or without TLS, refused by both servers.
- A trailers-only error (an unknown method), a deadline, a handler's
  abort and a handler's exception, each with grpc's codes and texts on both
  sides; many threads on one channel.

Every socket wait here is bounded: the clients' calls take timeouts, the
threads are joined with one, and ``stall_guard`` (tests/_stall.py) fails a
test that runs past its bound.
"""

import json
import sys
import threading
import time
from pathlib import Path

import grpc
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gorse_tpu.protocol import gorse_tpu_pb2 as ref_pb
from gorse_tpu.protocol import rpc as ref_rpc
from gorse_tpu.serve.master import Master as RefMaster
from gorse_tpu.storage import BlobStore as RefBlobStore
from gorse_tpu.storage import MemoryCacheStore as RefMemoryCacheStore
from gorse_tpu.storage import MemoryDataStore as RefMemoryDataStore
from gorse_tpu.storage import MetaStore as RefMetaStore
from gorse_tpu.utils import tls as ref_tls
from gorse_tpu.utils.config import Config as RefConfig
from gorse_tpu_torch.protocol import grpcwire, pb
from gorse_tpu_torch.protocol import rpc as port_rpc
from gorse_tpu_torch.serve.master import Master
from gorse_tpu_torch.storage.blob import BlobStore
from gorse_tpu_torch.storage.cache import MemoryCacheStore
from gorse_tpu_torch.storage.data import MemoryDataStore
from gorse_tpu_torch.storage.meta import MetaStore
from gorse_tpu_torch.utils import tls as port_tls
from gorse_tpu_torch.utils.config import Config
from _stall import stall_guard  # noqa: F401 - autouse: a stalled stream fails its test

TLS_DIR = Path(__file__).parent / "data" / "tls"
CALL_S = 30  # every call's timeout

# ---------------------------------------------------------------- pb

_text = st.text(max_size=40)
_int64 = st.integers(-(1 << 63), (1 << 63) - 1)
_double = st.floats(allow_nan=False)


def _span():
    return st.fixed_dictionaries({
        "name": _text, "total": _int64, "count": _int64, "status": _text,
        "start_time": _double, "finish_time": _double, "error": _text})


MESSAGE_VALUES = {
    "NodeInfo": st.fixed_dictionaries({"uuid": _text, "hostname": _text, "node_type": _text,
                                       "version": _text}),
    "Meta": st.fixed_dictionaries({"config_json": _text, "cf_model_id": _text,
                                   "ctr_model_id": _text, "servers": st.lists(_text, max_size=4),
                                   "workers": st.lists(_text, max_size=4)}),
    "ProgressSpan": _span(),
    "Progress": st.fixed_dictionaries({"uuid": _text, "spans": st.lists(_span(), max_size=3)}),
    "PushProgressResponse": st.just({}),
    "BlobChunk": st.fixed_dictionaries({"name": _text, "filename": _text,
                                        "data": st.binary(max_size=64), "eof": st.booleans()}),
    "BlobRequest": st.fixed_dictionaries({"name": _text}),
    "BlobList": st.fixed_dictionaries({"names": st.lists(_text, max_size=5)}),
    "UploadResponse": st.fixed_dictionaries({"bytes_received": _int64}),
}


def _build(module, name: str, values: dict):
    cls = getattr(module, name)
    if name == "Progress":
        return cls(uuid=values["uuid"],
                   spans=[module.ProgressSpan(**s) for s in values["spans"]])
    return cls(**values)


def _fields(msg) -> dict:
    """A message's values, either package's, for comparison."""
    out = {}
    for name in ("uuid", "hostname", "node_type", "version", "config_json", "cf_model_id",
                 "ctr_model_id", "servers", "workers", "name", "total", "count", "status",
                 "start_time", "finish_time", "error", "filename", "data", "eof", "names",
                 "bytes_received"):
        if hasattr(msg, name):
            v = getattr(msg, name)
            out[name] = list(v) if name in ("servers", "workers", "names") else v
    if hasattr(msg, "spans"):
        out["spans"] = [_fields(s) for s in msg.spans]
    return out


@pytest.mark.parametrize("name", list(MESSAGE_VALUES))
def test_pb_bytes_equal_the_reference(name):
    assert getattr(pb, name) in pb.MESSAGES

    @settings(max_examples=60, deadline=None)
    @given(MESSAGE_VALUES[name])
    def check(values):
        got, want = _build(pb, name, values), _build(ref_pb, name, values)
        data = got.SerializeToString()
        assert data == want.SerializeToString()
        assert _fields(getattr(pb, name).FromString(data)) == _fields(want)
        assert _fields(getattr(ref_pb, name).FromString(data)) == _fields(got)

    check()


def test_pb_skips_unknown_fields_and_rejects_truncation():
    # a NodeInfo with every wire type of unknown field in between
    extra = (b"\x28\x96\x01"  # 5: varint
             b"\x31" + bytes(8) +  # 6: fixed64
             b"\x3a\x03abc"  # 7: length-delimited
             b"\x45" + bytes(4) +  # 8: fixed32
             b"\x4b\x50\x01\x4c")  # 9: a group holding a varint
    data = ref_pb.NodeInfo(uuid="u", version="v").SerializeToString()
    mixed = data[:3] + extra + data[3:]
    assert _fields(pb.NodeInfo.FromString(mixed)) == _fields(ref_pb.NodeInfo.FromString(mixed))
    assert pb.NodeInfo.FromString(b"\x12\x01a\x12\x01b").hostname == "b"  # the last one wins
    for bad in (b"\x0a\x05ab", b"\x80", b"\x0a\x02\xff\xfe"):
        with pytest.raises(ValueError):
            pb.NodeInfo.FromString(bad)


# ---------------------------------------------------------------- interop


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """The port's generate_test_certs, for both packages' TLSConfig."""
    server, client = port_tls.generate_test_certs(tmp_path_factory.mktemp("certs"))
    return {"port": (server, client),
            "ref": (ref_tls.TLSConfig(server.ssl_ca, server.ssl_cert, server.ssl_key),
                    ref_tls.TLSConfig(client.ssl_ca, client.ssl_cert, client.ssl_key))}


def _serve(side: str, tmp_path, tls=None):
    """A master of ``side`` with its gRPC plane; (master, server, port)."""
    if side == "port":
        config = Config()
        master = Master(config, MemoryDataStore(), MemoryCacheStore(),
                        BlobStore(tmp_path / "port_blobs"), MetaStore(), device="cpu")
        server, port = port_rpc.serve_master_grpc(master, master.blob, port=0, tls=tls)
    else:
        master = RefMaster(RefConfig(), RefMemoryDataStore(), RefMemoryCacheStore(),
                           RefBlobStore(tmp_path / "ref_blobs"), RefMetaStore())
        server, port = ref_rpc.serve_master_grpc(master, master.blob, port=0, tls=tls)
    return master, server, port


def _artifact(tmp_path) -> Path:
    src = tmp_path / "model-src"
    (src / "sub").mkdir(parents=True)
    (src / "weights.bin").write_bytes(np.random.default_rng(0).bytes(3 * (1 << 20) + 17))
    (src / "sub" / "meta.json").write_text('{"a": 1}')
    (src / "empty.bin").write_bytes(b"")
    return src


PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]


@pytest.mark.parametrize("secure", [False, True], ids=["plain", "mtls"])
@pytest.mark.parametrize("server_side,client_side", PAIRS)
def test_master_and_blob_services_interoperate(server_side, client_side, secure, certs,
                                               tmp_path):
    server_tls, client_tls = certs[server_side][0] if secure else None, \
        certs[client_side][1] if secure else None
    master, server, port = _serve(server_side, tmp_path, server_tls)
    rpc = port_rpc if client_side == "port" else ref_rpc
    host = "localhost" if secure else "127.0.0.1"
    try:
        c1 = rpc.MasterGrpcClient(f"{host}:{port}", "worker", node_id="w1", tls=client_tls)
        meta = c1.get_meta()
        assert meta["workers"] == ["w1"] and meta["servers"] == []
        assert json.loads(meta["config"])["recommend"]["cache_size"] == 100
        c2 = rpc.MasterGrpcClient(f"{host}:{port}", "server", node_id="s1", tls=client_tls)
        meta = c2.get_meta()  # the second call on a grpcio connection uses its dynamic table
        assert (meta["workers"], meta["servers"]) == (["w1"], ["s1"])
        c1.push_progress([{"Name": "recommend", "Total": 10, "Count": 5, "Status": "running",
                           "StartTime": 1.5, "FinishTime": 0.0, "Error": ""}])
        assert any(t.get("Node") == "w1" and t["Count"] == 5 and t["Total"] == 10
                   for t in master.progress.list())
        blobs = rpc.BlobStoreClient(f"{host}:{port}", tls=client_tls)
        src = _artifact(tmp_path)
        assert blobs.upload("m123", src) == 3 * (1 << 20) + 17 + len('{"a": 1}')
        assert blobs.list() == ["m123"]
        dst = blobs.download("m123", tmp_path / "model-dst")
        for rel in ("weights.bin", "sub/meta.json", "empty.bin"):
            assert (dst / rel).read_bytes() == (src / rel).read_bytes()
            assert (Path(master.blob.open("m123")) / rel).read_bytes() == \
                (src / rel).read_bytes()
        for c in (c1, c2, blobs):
            c.close()
    finally:
        server.stop(None)


@pytest.mark.parametrize("server_side", ["port", "ref"])
def test_clients_without_a_certificate_are_refused(server_side, certs, tmp_path):
    """A bare client (no TLS) and a TLS client without a certificate fail on
    a mutually authenticated server, as grpc's do: UNAVAILABLE."""
    import ssl

    _, server, port = _serve(server_side, tmp_path, certs[server_side][0])
    try:
        for rpc, error in ((port_rpc, grpcwire.RpcError), (ref_rpc, grpc.RpcError)):
            bare = rpc.MasterGrpcClient(f"localhost:{port}", "worker", node_id="intruder")
            with pytest.raises(error) as caught:
                bare._get_meta(pb.NodeInfo(uuid="intruder") if rpc is port_rpc
                               else ref_pb.NodeInfo(uuid="intruder"), timeout=CALL_S)
            assert caught.value.code().name == "UNAVAILABLE"
            bare.close()
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        context.load_verify_locations(certs["port"][1].ssl_ca)
        context.set_alpn_protocols(["h2"])
        channel = grpcwire.Channel(f"localhost:{port}", context)
        with pytest.raises(grpcwire.RpcError) as caught:
            channel.unary_unary("/gorse_tpu.Master/GetMeta")(b"", timeout=CALL_S)
        assert caught.value.code() is grpcwire.StatusCode.UNAVAILABLE
        channel.close()
    finally:
        server.stop(None)


def test_committed_test_certificates_authenticate(tmp_path):
    """tests/data/tls (the material chip_smoke.py's phase 15 reads) works
    for both packages: the port's server and the reference's client."""
    files = [str(TLS_DIR / n) for n in ("ca.pem", "server.pem", "server.key")]
    client = [str(TLS_DIR / n) for n in ("ca.pem", "client.pem", "client.key")]
    _, server, port = _serve("port", tmp_path, port_tls.TLSConfig(*files))
    try:
        for host in ("localhost", "127.0.0.1"):
            c = ref_rpc.MasterGrpcClient(f"{host}:{port}", "worker", node_id="w",
                                         tls=ref_tls.TLSConfig(*client))
            assert c.get_meta()["workers"] == ["w"]
            c.close()
    finally:
        server.stop(None)


# ---------------------------------------------------------------- errors


def _echo_server(side: str):
    """A server of ``side`` with /t.T/Echo (unary), /t.T/Abort (abort
    with NOT_FOUND), /t.T/Boom (raises), /t.T/Slow (sleeps past a
    deadline) and /t.T/Many (a stream of n messages)."""
    lib = grpcwire if side == "port" else grpc

    def echo(req, context):
        return req

    def abort(req, context):
        context.abort(lib.StatusCode.NOT_FOUND, "no such thing: ü %")

    def boom(req, context):
        raise KeyError("k")

    def slow(req, context):
        time.sleep(1.0)
        return req

    def many(req, context):
        for n in range(int(req)):
            yield str(n).encode() * 1000

    handlers = lib.method_handlers_generic_handler("t.T", {
        "Echo": lib.unary_unary_rpc_method_handler(echo),
        "Abort": lib.unary_unary_rpc_method_handler(abort),
        "Boom": lib.unary_unary_rpc_method_handler(boom),
        "Slow": lib.unary_unary_rpc_method_handler(slow),
        "Many": lib.unary_stream_rpc_method_handler(many),
    })
    if side == "port":
        server = grpcwire.Server()
    else:
        from concurrent.futures import ThreadPoolExecutor

        server = grpc.server(ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((handlers,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port


def _outcome(fn):
    try:
        return "OK", fn()
    except (grpc.RpcError, grpcwire.RpcError) as e:
        return e.code().name, e.details()


@pytest.mark.parametrize("server_side,client_side", PAIRS)
def test_statuses_match_grpc(server_side, client_side):
    """Trailers-only errors (unknown method, abort, a handler's exception)
    and a deadline read the same on every pairing as grpc on both sides."""
    server, port = _echo_server(server_side)
    channel = (grpcwire.Channel(f"127.0.0.1:{port}") if client_side == "port"
               else grpc.insecure_channel(f"127.0.0.1:{port}"))
    try:
        call = {m: channel.unary_unary(f"/t.T/{m}") for m in ("Echo", "Abort", "Boom", "Slow",
                                                              "Nope")}
        assert _outcome(lambda: call["Echo"](b"x" * 100_000, timeout=CALL_S)) == \
            ("OK", b"x" * 100_000)
        assert _outcome(lambda: call["Echo"](b"", timeout=CALL_S)) == ("OK", b"")
        assert _outcome(lambda: call["Nope"](b"", timeout=CALL_S)) == \
            ("UNIMPLEMENTED", "Method not found!")
        assert _outcome(lambda: call["Abort"](b"", timeout=CALL_S)) == \
            ("NOT_FOUND", "no such thing: ü %")
        assert _outcome(lambda: call["Boom"](b"", timeout=CALL_S)) == \
            ("UNKNOWN", "Exception calling application: 'k'")
        assert _outcome(lambda: call["Slow"](b"", timeout=0.2))[0] == "DEADLINE_EXCEEDED"
        many = channel.unary_stream("/t.T/Many")
        assert [len(m) for m in many(b"50", timeout=CALL_S)] == \
            [len(str(n)) * 1000 for n in range(50)]
        assert _outcome(lambda: call["Echo"](b"after", timeout=CALL_S)) == ("OK", b"after")
    finally:
        channel.close()
        server.stop(None)


def test_many_threads_share_one_channel():
    """16 threads, each 100 calls and a stream, on one channel to the
    port's server with the interpreter switching threads every 10 us: every
    call succeeds and every answer is the thread's own (the first calls
    race the channel's connection: its preface must precede them)."""
    server, port = _echo_server("port")
    channel = grpcwire.Channel(f"127.0.0.1:{port}")
    echo, many = channel.unary_unary("/t.T/Echo"), channel.unary_stream("/t.T/Many")
    wrong: list = []

    def work(k: int) -> None:
        try:
            for n in range(100):
                body = f"{k}-{n}".encode() * (1 + n % 7)
                if echo(body, timeout=CALL_S) != body:
                    wrong.append((k, n))
            if len(list(many(b"20", timeout=CALL_S))) != 20:
                wrong.append((k, "stream"))
        except grpcwire.RpcError as e:
            wrong.append((k, e.code().name, e.details()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and wrong == []
        assert channel._conn is not None and not channel._conn.streams  # all released
    finally:
        sys.setswitchinterval(interval)
        channel.close()
        server.stop(None)


def test_timeout_header_and_message_codecs():
    assert grpcwire.encode_timeout(1.5) == "1500000u"
    for seconds in (0.0, 1e-6, 0.2, 1.5, 30.0, 3600.0, 86400.0 * 1000):
        text = grpcwire.encode_timeout(seconds)
        assert len(text) <= 9 and abs(grpcwire.decode_timeout(text) - seconds) <= \
            max(seconds * 1e-6, 1e-9)
    assert grpcwire.decode_timeout("1500m") == 1.5 and grpcwire.decode_timeout("2H") == 7200
    with pytest.raises(ValueError):
        grpcwire.decode_timeout("15x")
    text = "a%b\nü"
    assert grpcwire.quote_message(text) == "a%25b%0A%C3%BC"
    assert grpcwire.unquote_message(grpcwire.quote_message(text)) == text
    deframer = grpcwire.Deframer(max_length=10)
    assert deframer.feed(b"\x00\x00\x00\x00\x02a") == [] and deframer.feed(b"b") == [b"ab"]
    with pytest.raises(grpcwire.RpcError) as e:
        deframer.feed(b"\x01\x00\x00\x00\x00")
    assert e.value.code() is grpcwire.StatusCode.INTERNAL
    with pytest.raises(grpcwire.RpcError) as e:
        grpcwire.Deframer(max_length=10).feed(b"\x00\x00\x00\x00\x0b")
    assert e.value.code() is grpcwire.StatusCode.RESOURCE_EXHAUSTED
