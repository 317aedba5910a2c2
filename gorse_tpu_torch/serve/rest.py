"""REST API server core (port of gorse_tpu/serve/rest.py): the router,
``dispatch`` and a stdlib ThreadingHTTPServer front-end, with the health
and recommendation routes:

    GET /api/health/live
    GET /api/health/ready
    GET /api/recommend/{user-id}
    GET /api/recommend/{user-id}/{category}

Responses have the reference's JSON shapes and X-API-Key auth. The other
routes are not ported yet (ROADMAP.md, M16).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..logics.recommend import Recommender
from ..storage.cache import CacheStore
from ..storage.data import DataStore
from ..storage.types import Feedback, Score
from ..utils.config import Config
from .metrics import MetricsRegistry

logger = logging.getLogger(__name__)


class HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


def parse_query(query_string: str) -> dict:
    """Last-value-wins keys plus the ``__multi__`` map of every repeated
    value."""
    query: dict = {}
    query_multi: dict = {}
    for k, v in urllib.parse.parse_qsl(query_string):
        query[k] = v
        query_multi.setdefault(k, []).append(v)
    query["__multi__"] = query_multi
    return query


class Request:
    def __init__(self, params: dict, query: dict, body, headers: dict) -> None:
        self.params = params
        self.query = query
        self.body = body
        self.headers = headers

    def int_query(self, name: str, default: int) -> int:
        v = self.query.get(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise HTTPError(400, f"invalid integer for {name!r}: {v!r}")

    def query_all(self, name: str) -> list[str]:
        return self.query.get("__multi__", {}).get(name, [])


def _parse_duration(s: str) -> float:
    """Go-style durations: 10s, 5m, 2h, 1d."""
    m = re.match(r"^([0-9.]+)(s|m|h|d)?$", s)
    if not m:
        raise HTTPError(400, f"invalid duration {s!r}")
    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400, None: 1}[m.group(2)]
    return float(m.group(1)) * mult


class RestServer:
    def __init__(
        self,
        config: Config,
        data_store: DataStore,
        cache_store: CacheStore,
        api_key: str = "",
    ) -> None:
        self.config = config
        self.data = data_store
        self.cache = cache_store
        self.api_key = api_key
        self.metrics = MetricsRegistry(namespace="gorse")
        self._routes: list[tuple[str, re.Pattern, callable, str]] = []
        r = self.route
        r("GET", "/api/health/live", self.check_live)
        r("GET", "/api/health/ready", self.check_ready)
        r("GET", "/api/recommend/{user-id}/{category}", self.get_recommend)
        r("GET", "/api/recommend/{user-id}", self.get_recommend)
        self._httpd: ThreadingHTTPServer | None = None

    # ------------------------------------------------------------- routing

    def route(self, method: str, pattern: str, handler) -> None:
        # "{user-id}" -> named group "user_id"
        regex = re.compile(
            "^"
            + re.sub(
                r"\{([a-z\-]+)\}",
                lambda m: f"(?P<{m.group(1).replace('-', '_')}>[^/]+)",
                pattern,
            )
            + "/?$"
        )
        self._routes.append((method, regex, handler, pattern))

    def dispatch(
        self, method: str, path: str, query: dict | None = None, body=None,
        headers: dict | None = None,
    ) -> tuple[int, object]:
        query = query or {}
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        if len(path) > 1 and path.endswith("/"):
            path = path.rstrip("/")
        if self.api_key and headers.get("x-api-key") != self.api_key:
            matched = any(p.match(path) for m, p, _, _ in self._routes if m == method)
            if "/health/" not in path:
                return (401, {"error": "unauthorized"}) if matched else (404, {"error": "not found"})
        for m, pattern, handler, template in self._routes:
            if m != method:
                continue
            match = pattern.match(path)
            if match:
                req = Request(
                    params={k: urllib.parse.unquote(v) for k, v in match.groupdict().items()},
                    query=query,
                    body=body,
                    headers=headers,
                )
                t0 = time.perf_counter()
                try:
                    out = 200, handler(req)
                except HTTPError as e:
                    out = e.status, {"error": e.message}
                except Exception as e:  # noqa: BLE001 — surface as 500 like the reference
                    logger.exception("handler error")
                    out = 500, {"error": str(e)}
                self.metrics.counter_inc(
                    "rest_api_requests", labels={"method": method, "status": str(out[0])}
                )
                self.metrics.histogram_observe(
                    "server_rest_api_request_seconds", time.perf_counter() - t0,
                    labels={"api": template},
                )
                return out
        return 404, {"error": "not found"}

    # ------------------------------------------------------------- handlers

    def check_live(self, req) -> dict:
        return {"status": "live"}

    def check_ready(self, req) -> dict:
        if not (self.data.ping() and self.cache.ping()):
            raise HTTPError(503, "stores not ready")
        return {"status": "ready"}

    def _categories(self, req) -> list[str]:
        cats = []
        if "category" in req.params:
            cats.append(req.params["category"])
        cats.extend(req.query_all("category"))
        return [c for c in cats if c]

    def _scores_out(self, scores: list[Score], req) -> list:
        n = req.int_query("n", self.config.server.default_n)
        offset = req.int_query("offset", 0)
        page = scores[offset : offset + n] if n > 0 else scores[offset:]
        if req.headers.get("x-api-version") == "2":
            return [{"Id": s.id, "Score": s.score} for s in page]
        return [s.id for s in page]

    def get_recommend(self, req) -> list:
        """The latency path: the recommender chain over the caches."""
        user_id = req.params["user_id"]
        recommender = Recommender(
            self.config.recommend, self.cache, self.data,
            online=True, user_id=user_id, categories=self._categories(req),
        )
        n = req.int_query("n", self.config.server.default_n)
        offset = req.int_query("offset", 0)
        results = recommender.recommend(limit=n + offset if n > 0 else 0)
        # optional write-back feedback loop
        write_back_type = req.query.get("write-back-type", "")
        if write_back_type:
            delay = _parse_duration(req.query.get("write-back-delay", "0s"))
            self.data.insert_feedback(
                [
                    Feedback(write_back_type, user_id, s.id, timestamp=time.time() + delay)
                    for s in results[offset:]
                ]
            )
        return self._scores_out(results, req)

    # ------------------------------------------------------------- serving

    def serve(self, host: str = "127.0.0.1", port: int = 8087) -> ThreadingHTTPServer:
        """Start the HTTP front-end in a daemon thread; ``port=0`` picks a
        free port (read it from ``server_address``)."""
        rest = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive: one thread serves many requests
            disable_nagle_algorithm = True  # avoid 40ms delayed-ACK stalls

            def log_message(self, fmt, *args):  # quiet access log -> logger
                logger.debug("%s %s", self.address_string(), fmt % args)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
                status, payload = rest.dispatch(
                    "GET", parsed.path, parse_query(parsed.query), None, dict(self.headers)
                )
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        logger.info("REST server listening on %s:%d", *httpd.server_address)
        return httpd

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
