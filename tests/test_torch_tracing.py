"""The port's tracing (gorse_tpu_torch/utils/tracing.py), events and log
held against the reference's.

- tests/test_tracing.py's cases on the port's tracer;
- each exporter's ``encode()`` byte for byte the reference's for spans
  with fixed ids, times, attributes and statuses;
- the OTLP/gRPC exporter over the wire both ways: the port's exporter into
  a grpcio collector, the reference's into a collector on the port's
  grpcwire server; an export to nothing never raises;
- REST requests as spans (their ``traceparent`` continued) and recorded
  events; the redaction of the log module.

Every export has a timeout (the exporters' own, 2 s), and every test runs
under ``stall_guard`` (tests/_stall.py).
"""

import http.server
import json
import logging
import struct
import threading

import grpc
import pytest

from gorse_tpu.utils import events as ref_events
from gorse_tpu.utils import log as ref_log
from gorse_tpu.utils import tracing as ref_tracing
from gorse_tpu_torch.protocol import grpcwire
from gorse_tpu_torch.utils import events, log, tracing
from gorse_tpu_torch.utils.config import Config
from gorse_tpu_torch.utils.tracing import configure, configure_from, tracer
from _stall import stall_guard  # noqa: F401 - autouse: a stalled stream fails its test


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    configure(enabled=False)


# ------------------------------------------------- tests/test_tracing.py


def test_span_nesting_and_export():
    t = configure(enabled=True)
    with t.span("parent") as parent:
        with t.span("child", user="u1") as child:
            assert child.trace_id == parent.trace_id
            assert child.parent_id == parent.span_id
    spans = t.export()
    assert [s["name"] for s in spans] == ["child", "parent"]
    assert spans[0]["attrs"]["user"] == "u1"
    assert spans[1]["duration_ms"] is not None


def test_traceparent_propagation():
    t = configure(enabled=True)
    with t.span("upstream") as up:
        header = up.traceparent()
    with t.span("downstream", traceparent=header) as down:
        assert down.trace_id == up.trace_id
        assert down.parent_id == up.span_id


def test_disabled_tracer_is_noop():
    t = configure(enabled=False)
    with t.span("x") as s:
        assert s is None
    assert t.export() == []


def test_error_status():
    t = configure(enabled=True)
    with pytest.raises(ValueError):
        with t.span("boom"):
            raise ValueError("nope")
    assert "error" in t.export()[0]["status"]


def test_sample_ratio_zero_drops_roots():
    t = configure(enabled=True, sample_ratio=0.0)
    with t.span("root") as s:
        assert s is None
    assert t.export() == []
    with t.span("child", traceparent="00-" + "a" * 32 + "-" + "b" * 16 + "-01") as s:
        assert s is not None


def test_configure_from_config():
    cfg = Config()
    cfg.tracing.enable = True
    cfg.tracing.sampler = "ratio"
    cfg.tracing.ratio = 0.5
    t = configure_from(cfg)
    assert tracer() is t and t.enabled and t.sample_ratio == 0.5
    cfg.tracing.enable = False
    assert not configure_from(cfg).enabled


class _Collector:
    """An HTTP collector in this process, keeping each POST."""

    def __init__(self):
        collector = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                collector.requests.append((self.path, self.rfile.read(length)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.requests = []
        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_otlp_http_export_wire_format():
    col = _Collector()
    try:
        t = tracing.Tracer(enabled=True,
                           exporter=tracing.OTLPHTTPExporter(f"http://127.0.0.1:{col.port}"),
                           batch_size=2)
        with t.span("parent", kind="train") as parent:
            with t.span("child", step=3):
                pass
        t.flush()
        assert len(col.requests) == 1
        path, body = col.requests[0]
        assert path == "/v1/traces"
        spans = json.loads(body)["resourceSpans"][0]["scopeSpans"][0]["spans"]
        child = next(s for s in spans if s["name"] == "child")
        par = next(s for s in spans if s["name"] == "parent")
        assert child["traceId"] == par["traceId"] == parent.trace_id
        assert child["parentSpanId"] == par["spanId"]
        assert child["attributes"] == [{"key": "step", "value": {"intValue": "3"}}]
        assert child["status"] == {"code": 1}
    finally:
        col.close()


def test_zipkin_export_wire_format():
    col = _Collector()
    try:
        t = tracing.Tracer(enabled=True, exporter=tracing.ZipkinExporter(
            f"http://127.0.0.1:{col.port}/api/v2/spans"), batch_size=64)
        with t.span("load", table="users"):
            pass
        with t.span("boom") as s:
            s.status = "error: db down"
        t.flush()
        path, body = col.requests[0]
        assert path == "/api/v2/spans"
        docs = {d["name"]: d for d in json.loads(body)}
        assert docs["load"]["localEndpoint"] == {"serviceName": "gorse_tpu"}
        assert docs["load"]["tags"] == {"table": "users"} and docs["load"]["duration"] >= 1
        assert docs["boom"]["tags"]["error"] == "error: db down"
    finally:
        col.close()


@pytest.mark.parametrize("kind", ["otlphttp", "otlp", "zipkin"])
def test_export_failure_never_raises(kind, caplog):
    endpoint = "127.0.0.1:1" if kind == "otlp" else "http://127.0.0.1:1"
    t = tracing.Tracer(enabled=True, exporter=tracing.make_exporter(kind, endpoint),
                       batch_size=1)
    with caplog.at_level(logging.WARNING, logger=tracing.__name__):
        with t.span("still-works"):
            pass  # the export fails on its thread; the span's code does not see it
        t.flush()
    assert t.export()[0]["name"] == "still-works"
    assert "trace export to collector failed" in caplog.text


def test_configure_from_collector_endpoint():
    cfg = Config()
    cfg.tracing.enable = True
    cfg.tracing.exporter = "zipkin"
    cfg.tracing.collector_endpoint = "http://example:9411/api/v2/spans"
    assert configure_from(cfg).exporter.endpoint == "http://example:9411/api/v2/spans"
    cfg.tracing.exporter = "otlphttp"
    cfg.tracing.collector_endpoint = "http://example:4318"
    assert configure_from(cfg).exporter.endpoint == "http://example:4318/v1/traces"
    cfg.tracing.exporter = "otlp"
    cfg.tracing.collector_endpoint = "http://example:4317/"
    t = configure_from(cfg)
    assert isinstance(t.exporter, tracing.OTLPGRPCExporter) and t.exporter.target == "example:4317"


# ------------------------------------------------- encode(), byte for byte


def _spans(module):
    spans = []
    for n, (name, parent, attrs, status) in enumerate((
            ("root", None, {"kind": "train", "n": 3, "ok": True, "ratio": 0.25}, "ok"),
            ("child", "1" * 16, {"user": "ü", "big": -(1 << 40)}, "error: db down"),
            ("GET /api/recommend/{user-id}", "2" * 16, {}, "ok"))):
        s = module.Span(name, f"{n + 1:032x}", parent)
        s.span_id = f"{n + 10:016x}"
        s.start, s.end = 1.75e9 + n, 1.75e9 + n + 0.125
        s.attrs.update(attrs)
        s.status = status
        spans.append(s)
    return spans


@pytest.mark.parametrize("kind", ["otlphttp", "otlp", "zipkin"])
def test_exporters_encode_the_references_bytes(kind):
    got = tracing.make_exporter(kind, "", "svc").encode(_spans(tracing))
    want = ref_tracing.make_exporter(kind, "", "svc").encode(_spans(ref_tracing))
    assert got == want and len(got) > 100


# ------------------------------------------------- OTLP/gRPC over the wire

_EXPORT = "opentelemetry.proto.collector.trace.v1.TraceService"


def _collector(side: str):
    """A TraceService collector on ``side``'s server; (server, port, received)."""
    lib = grpcwire if side == "port" else grpc
    received = []

    def export(request: bytes, context) -> bytes:
        received.append(request)
        return b""

    handler = lib.method_handlers_generic_handler(
        _EXPORT, {"Export": lib.unary_unary_rpc_method_handler(export)})
    if side == "port":
        server = grpcwire.Server(max_workers=2)
    else:
        from concurrent.futures import ThreadPoolExecutor

        server = grpc.server(ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port, received


def _pb(data: bytes) -> list:
    """[(field, wire type, value), ...] of one protobuf message."""
    out, i = [], 0

    def varint():
        nonlocal i
        v = shift = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v

    while i < len(data):
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            out.append((field, wire, varint()))
        elif wire == 1:
            out.append((field, wire, struct.unpack("<Q", data[i:i + 8])[0]))
            i += 8
        else:
            n = varint()
            out.append((field, wire, data[i:i + n]))
            i += n
    return out


@pytest.mark.parametrize("exporter_side,collector_side", [("port", "ref"), ("ref", "port"),
                                                          ("port", "port")])
def test_otlp_grpc_export_over_the_wire(exporter_side, collector_side):
    module = tracing if exporter_side == "port" else ref_tracing
    server, port, received = _collector(collector_side)
    try:
        t = module.Tracer(enabled=True, exporter=module.OTLPGRPCExporter(f"127.0.0.1:{port}"),
                          batch_size=2)
        with t.span("parent", kind="train") as parent:
            with t.span("child", step=3):
                pass
        with t.span("trailing"):
            pass
        t.flush()  # the batch of two on the export thread, then the third inline
        assert len(received) == 2
        request = _pb(received[0])
        rs = _pb([v for f, _, v in request if f == 1][0])
        scope_spans = _pb([v for f, _, v in rs if f == 2][0])
        spans = [dict((f, v) for f, _, v in _pb(v)) for f, _, v in scope_spans if f == 2]
        by_name = {s[5]: s for s in spans}
        assert set(by_name) == {b"parent", b"child"}
        child, par = by_name[b"child"], by_name[b"parent"]
        assert child[1].hex() == par[1].hex() == parent.trace_id
        assert child[4].hex() == par[2].hex() and child[8] >= child[7]
        assert (3, 0, 1) in _pb(child[15])  # STATUS_CODE_OK
        assert received[0] == module.OTLPGRPCExporter("x:1").encode(
            [s for s in t.finished if s.name in ("child", "parent")])
    finally:
        server.stop(None)


# ------------------------------------------------- REST, events, log


def test_rest_requests_are_spans_and_events():
    from gorse_tpu_torch.serve.rest import RestServer
    from gorse_tpu_torch.storage.cache import MemoryCacheStore
    from gorse_tpu_torch.storage.data import MemoryDataStore

    t = configure(enabled=True)
    recorder = events.MemoryRecorder()
    events.set_recorder(recorder)
    try:
        rest = RestServer(Config(), MemoryDataStore(), MemoryCacheStore())
        up = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
        assert rest.dispatch("GET", "/api/recommend/u1", {}, None, {"traceparent": up})[0] == 200
        assert rest.dispatch("GET", "/api/user/nobody", {}, None, {})[0] == 404
        spans = t.export()
        assert [(s["name"], s["attrs"]["status_code"]) for s in spans] == [
            ("GET /api/recommend/{user-id}", 200), ("GET /api/user/{user-id}", 404)]
        assert (spans[0]["trace_id"], spans[0]["parent_id"]) == ("c" * 32, "d" * 16)
        assert [(e["method"], e["path"], e["status"]) for e in recorder.api_events] == [
            ("GET", "/api/recommend/{user-id}", 200), ("GET", "/api/user/{user-id}", 404)]
    finally:
        events.set_recorder(events.NopRecorder())


def test_events_and_log_are_the_references():
    assert isinstance(events.get_recorder(), events.NopRecorder)
    recorder = events.MemoryRecorder(keep=2)
    for n in range(3):
        recorder.record_storage("data", f"op{n}", 0.5)
    assert [e["op"] for e in recorder.storage_events] == ["op1", "op2"]
    for text in ("mysql://root:secret@db:3306/gorse", "api_key=abc123 password: 'x y'",
                 'redis://u:p@h:6379 {"auth-token": "tok"}', "nothing here"):
        assert log.redact(text) == ref_log.redact(text)
    assert ref_events.NopRecorder().record_api("GET", "/", 200, 0.1) is None
