"""Distributed tracing with OTLP and Zipkin export (port of
gorse_tpu/utils/tracing.py).

As gorse's OpenTelemetry set-up (TracingConfig, config/config.go:407-413;
the provider installed at node start, master/master.go:119-125; the
exporter switch, :556-568), without OpenTelemetry: spans with W3C
``traceparent`` propagation, head sampling, an in-memory buffer for the
dashboard, and batched export to a collector:

- ``otlp`` -> OTLP/gRPC: opentelemetry-proto's ExportTraceServiceRequest,
  encoded by hand, sent to ``TraceService/Export`` over the port's own gRPC
  (protocol/grpcwire.py);
- ``otlphttp`` -> OTLP/HTTP with the JSON mapping, POST to
  ``<endpoint>/v1/traces``;
- ``zipkin`` -> Zipkin v2 JSON, POST to the collector URL as configured.

Export runs in batches (every ``batch_size`` finished spans, on a thread of
its own) and on ``flush()``; its errors are logged and never reach the
traced code.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import random
import secrets
import threading
import time
import urllib.request

logger = logging.getLogger(__name__)

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gorse_tpu_span", default=None
)


class Span:
    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "start", "end", "attrs", "status",
    )

    def __init__(self, name: str, trace_id: str, parent_id: str | None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent_id
        self.start = time.time()
        self.end: float | None = None
        self.attrs: dict = {}
        self.status = "ok"

    def set_attribute(self, k: str, v) -> None:
        self.attrs[k] = v

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_ms": None if self.end is None else (self.end - self.start) * 1e3,
            "attrs": self.attrs,
            "status": self.status,
        }


def _attr_value(v) -> dict:
    """OTLP JSON AnyValue encoding."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


class OTLPHTTPExporter:
    """OTLP/HTTP exporter with JSON encoding (opentelemetry-proto JSON
    mapping). Default collector port/path: ``http://localhost:4318/v1/traces``.
    """

    def __init__(self, endpoint: str = "", service_name: str = "gorse_tpu", timeout: float = 2.0):
        endpoint = endpoint or "http://localhost:4318"
        if "/v1/traces" not in endpoint:
            endpoint = endpoint.rstrip("/") + "/v1/traces"
        self.endpoint = endpoint
        self.service_name = service_name
        self.timeout = timeout

    def encode(self, spans: list["Span"]) -> bytes:
        otlp_spans = []
        for s in spans:
            otlp_spans.append({
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_id or "",
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(s.start * 1e9)),
                "endTimeUnixNano": str(int((s.end or s.start) * 1e9)),
                "attributes": [
                    {"key": k, "value": _attr_value(v)} for k, v in s.attrs.items()
                ],
                "status": (
                    {"code": 1}
                    if s.status == "ok"
                    else {"code": 2, "message": s.status}
                ),
            })
        doc = {
            "resourceSpans": [{
                "resource": {
                    "attributes": [
                        {"key": "service.name",
                         "value": {"stringValue": self.service_name}}
                    ]
                },
                "scopeSpans": [{"scope": {"name": "gorse_tpu"}, "spans": otlp_spans}],
            }]
        }
        return json.dumps(doc).encode()

    def export(self, spans: list["Span"]) -> None:
        req = urllib.request.Request(
            self.endpoint, data=self.encode(spans),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        urllib.request.urlopen(req, timeout=self.timeout).read()


# --- minimal protobuf wire encoding (no generated code needed) ------------

def _pb_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_var(field: int, v: int) -> bytes:
    return _pb_varint(field << 3) + _pb_varint(v)


def _pb_fixed64(field: int, v: int) -> bytes:
    import struct

    return _pb_varint((field << 3) | 1) + struct.pack("<Q", v)


def _pb_double(field: int, v: float) -> bytes:
    import struct

    return _pb_varint((field << 3) | 1) + struct.pack("<d", v)


def _pb_anyvalue(v) -> bytes:
    # opentelemetry.proto.common.v1.AnyValue
    if isinstance(v, bool):
        return _pb_var(2, 1 if v else 0)
    if isinstance(v, int):
        return _pb_var(3, v)
    if isinstance(v, float):
        return _pb_double(4, v)
    return _pb_len(1, str(v).encode())


def _pb_keyvalue(k: str, v) -> bytes:
    return _pb_len(1, k.encode()) + _pb_len(2, _pb_anyvalue(v))


class OTLPGRPCExporter:
    """The OTLP/gRPC exporter, the reference's ``otlp`` (gorse wires
    otlptracegrpc, config/config.go:407-413): ExportTraceServiceRequest
    encoded by hand, one unary call to ``TraceService/Export`` over a
    grpcwire channel."""

    METHOD = "/opentelemetry.proto.collector.trace.v1.TraceService/Export"

    def __init__(self, endpoint: str = "", service_name: str = "gorse_tpu", timeout: float = 2.0):
        endpoint = endpoint or "localhost:4317"
        # accept URL-ish endpoints (http://host:4317) like the reference's
        # WithEndpointURL handling
        for prefix in ("http://", "https://", "grpc://"):
            if endpoint.startswith(prefix):
                endpoint = endpoint[len(prefix):]
        self.target = endpoint.rstrip("/")
        self.service_name = service_name
        self.timeout = timeout
        self._rpc = None

    def encode(self, spans: list["Span"]) -> bytes:
        """ExportTraceServiceRequest{resource_spans=[{resource, scope_spans}]}."""
        pb_spans = b""
        for s in spans:
            body = _pb_len(1, bytes.fromhex(s.trace_id))
            body += _pb_len(2, bytes.fromhex(s.span_id))
            if s.parent_id:
                body += _pb_len(4, bytes.fromhex(s.parent_id))
            body += _pb_len(5, s.name.encode())
            body += _pb_var(6, 1)  # SPAN_KIND_INTERNAL
            body += _pb_fixed64(7, int(s.start * 1e9))
            body += _pb_fixed64(8, int((s.end or s.start) * 1e9))
            for k, v in s.attrs.items():
                body += _pb_len(9, _pb_keyvalue(k, v))
            status = (
                _pb_var(3, 1)
                if s.status == "ok"
                else _pb_len(2, s.status.encode()) + _pb_var(3, 2)
            )
            body += _pb_len(15, status)
            pb_spans += _pb_len(2, body)  # ScopeSpans.spans
        scope = _pb_len(1, _pb_len(1, b"gorse_tpu"))  # InstrumentationScope.name
        scope_spans = scope + pb_spans
        resource = _pb_len(1, _pb_keyvalue("service.name", self.service_name))
        resource_spans = _pb_len(1, resource) + _pb_len(2, scope_spans)
        return _pb_len(1, resource_spans)

    def export(self, spans: list["Span"]) -> None:
        if self._rpc is None:
            from ..protocol.grpcwire import Channel

            self._rpc = Channel(self.target).unary_unary(self.METHOD)
        self._rpc(self.encode(spans), timeout=self.timeout)


class ZipkinExporter:
    """Zipkin v2 JSON exporter (POST to the configured collector URL,
    reference exporter switch master/master.go:558-561)."""

    def __init__(self, endpoint: str = "", service_name: str = "gorse_tpu", timeout: float = 2.0):
        self.endpoint = endpoint or "http://localhost:9411/api/v2/spans"
        self.service_name = service_name
        self.timeout = timeout

    def encode(self, spans: list["Span"]) -> bytes:
        docs = []
        for s in spans:
            d = {
                "traceId": s.trace_id,
                "id": s.span_id,
                "name": s.name,
                "timestamp": int(s.start * 1e6),
                "duration": max(int(((s.end or s.start) - s.start) * 1e6), 1),
                "localEndpoint": {"serviceName": self.service_name},
                "tags": {k: str(v) for k, v in s.attrs.items()},
            }
            if s.parent_id:
                d["parentId"] = s.parent_id
            if s.status != "ok":
                d["tags"]["error"] = s.status
            docs.append(d)
        return json.dumps(docs).encode()

    def export(self, spans: list["Span"]) -> None:
        req = urllib.request.Request(
            self.endpoint, data=self.encode(spans),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        urllib.request.urlopen(req, timeout=self.timeout).read()


def make_exporter(exporter: str, endpoint: str = "", service_name: str = "gorse_tpu"):
    """Exporter factory honoring the reference's config values
    (config/config.go:409: oneof=zipkin otlp otlphttp)."""
    if exporter == "zipkin":
        return ZipkinExporter(endpoint, service_name)
    if exporter == "otlp":
        # the reference's otlp == OTLP/gRPC (otlptracegrpc)
        return OTLPGRPCExporter(endpoint, service_name)
    if exporter == "otlphttp":
        return OTLPHTTPExporter(endpoint, service_name)
    raise ValueError(f"unknown tracing exporter {exporter!r}")


class Tracer:
    def __init__(
        self,
        enabled: bool = True,
        sample_ratio: float = 1.0,
        keep: int = 512,
        exporter=None,
        batch_size: int = 64,
    ) -> None:
        self.enabled = enabled
        self.sample_ratio = sample_ratio
        self.keep = keep
        self.exporter = exporter
        self.batch_size = batch_size
        self._pending: list[Span] = []
        self._export_failed = False
        self._lock = threading.Lock()
        self.finished: list[Span] = []
        self._export_thread: threading.Thread | None = None
        self._export_q = None

    @contextlib.contextmanager
    def span(self, name: str, traceparent: str | None = None, **attrs):
        if not self.enabled:
            yield None
            return
        parent = _current_span.get()
        # head sampling: root spans without an upstream context are sampled
        # at sample_ratio; children of sampled traces are always recorded
        if parent is None and not traceparent and random.random() >= self.sample_ratio:
            yield None
            return
        if traceparent:
            parts = traceparent.split("-")
            trace_id = parts[1] if len(parts) >= 3 else secrets.token_hex(16)
            parent_id = parts[2] if len(parts) >= 3 else None
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = secrets.token_hex(16), None
        span = Span(name, trace_id, parent_id)
        span.attrs.update(attrs)
        token = _current_span.set(span)
        try:
            yield span
        except Exception as e:
            span.status = f"error: {e}"
            raise
        finally:
            span.end = time.time()
            _current_span.reset(token)
            flush_batch = None
            with self._lock:
                self.finished.append(span)
                self.finished = self.finished[-self.keep:]
                if self.exporter is not None:
                    self._pending.append(span)
                    if len(self._pending) >= self.batch_size:
                        flush_batch, self._pending = self._pending, []
            if flush_batch:
                # export OFF the request thread (the reference uses otel's
                # background BatchSpanProcessor): a slow/down collector must
                # never add its network timeout to a live request's latency
                self._enqueue(flush_batch)

    def _enqueue(self, batch: list[Span]) -> None:
        with self._lock:
            if self._export_thread is None or not self._export_thread.is_alive():
                import queue

                self._export_q = queue.Queue(maxsize=64)
                t = threading.Thread(
                    target=self._export_loop, name="trace-export", daemon=True
                )
                self._export_thread = t
                t.start()
        try:
            self._export_q.put_nowait(batch)
        except Exception:  # queue full: drop the batch, never block serving
            pass

    def _export_loop(self) -> None:
        while True:
            batch = self._export_q.get()
            if batch is None:
                return
            self._send(batch)
            self._export_q.task_done()

    def _send(self, batch: list[Span]) -> None:
        try:
            self.exporter.export(batch)
            self._export_failed = False
        except Exception as e:  # network problems must never break traced code
            if not self._export_failed:
                logger.warning("trace export to collector failed: %s", e)
            self._export_failed = True

    def flush(self) -> None:
        """Export any buffered spans now (e.g. at node shutdown): drains the
        background export queue, then sends the partial batch inline."""
        with self._lock:
            batch, self._pending = self._pending, []
        q = self._export_q
        if q is not None:
            try:
                q.join()
            except Exception:
                pass
        if batch and self.exporter is not None:
            self._send(batch)

    def export(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self.finished]


_tracer = Tracer(enabled=False)


def configure(enabled: bool, sample_ratio: float = 1.0, exporter=None, batch_size: int = 64) -> Tracer:
    global _tracer
    _tracer = Tracer(
        enabled=enabled, sample_ratio=sample_ratio, exporter=exporter,
        batch_size=batch_size,
    )
    return _tracer


def configure_from(config, service_name: str = "gorse_tpu") -> Tracer:
    """Install the tracer from a utils.config.Config (reference: provider
    install at node start, master/master.go:119-125; exporter + sampler keys
    config/config.go:407-413). A collector endpoint activates real wire
    export; without one, spans stay in the in-memory dashboard buffer."""
    tc = config.tracing
    ratio = tc.ratio if tc.sampler in ("ratio", "traceidratio") else 1.0
    if tc.sampler == "never":
        ratio = 0.0
    exporter = None
    if tc.enable and tc.collector_endpoint:
        exporter = make_exporter(tc.exporter, tc.collector_endpoint, service_name)
    return configure(enabled=tc.enable, sample_ratio=ratio, exporter=exporter)


def tracer() -> Tracer:
    return _tracer
