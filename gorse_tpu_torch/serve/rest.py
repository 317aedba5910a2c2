"""REST API server (port of gorse_tpu/serve/rest.py).

The public API of gorse's server/rest.go (:197-612): user, item and feedback
CRUD, the recommendation routes (recommend, collaborative-filtering, latest,
popular, non-personalized, item-to-item, user-to-user, neighbours, session
recommend), health checks and measurements, with X-API-Key auth and the
reference's JSON shapes, status codes and error texts; ``/apidocs.json``
(the OpenAPI document generated from the route table) and ``/metrics``.
Two front ends drive the same ``dispatch``: the event-loop server of
serve/asynchttp.py (the default) and the stdlib ThreadingHTTPServer. Each
request runs in a span of the process's tracer (utils/tracing.py) named
``METHOD /route/{template}``, a child of the caller's ``traceparent``, with
its status code, and goes to the event recorder (utils/events.py).
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
from ..storage import cache as ck
from ..storage.cache import CacheStore, key
from ..storage.data import DataStore
from ..storage.types import Feedback, Item, Score, User
from ..utils.config import Config
from ..utils.events import get_recorder
from ..utils.expression import match_any
from ..utils.tracing import tracer

logger = logging.getLogger(__name__)

DEFAULT_N = 10


class HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


class RawResponse:
    """Non-JSON handler result (dump streams, /metrics text)."""

    def __init__(
        self,
        body: bytes,
        content_type: str = "application/octet-stream",
        headers: dict | None = None,
        status: int = 200,
    ) -> None:
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}
        self.status = status


class Redirect(RawResponse):
    """302 redirect, optionally carrying Set-Cookie (login flows)."""

    def __init__(self, location: str, set_cookie: str | None = None) -> None:
        headers = {"Location": location}
        if set_cookie:
            headers["Set-Cookie"] = set_cookie
        super().__init__(b"", "text/plain", headers, status=302)


def parse_query(query_string: str) -> dict:
    """Query dict in the Request contract: last-value-wins keys plus the
    ``__multi__`` map of every repeated value (shared by the threaded and
    asyncio front-ends)."""
    query: dict = {}
    query_multi: dict = {}
    for k, v in urllib.parse.parse_qsl(query_string):
        query[k] = v
        query_multi.setdefault(k, []).append(v)
    query["__multi__"] = query_multi
    return query


def decode_body(raw: bytes, content_type: str | None):
    """Decode a request body per content type. Returns (body, error_bytes):
    exactly one is non-None (both None for an empty body). Shared by the
    threaded and asyncio front-ends so their route behavior is identical."""
    if not raw:
        return None, None
    ctype = (content_type or "application/json").split(";")[0]
    if ctype in (
        "application/octet-stream",
        "text/csv",
        "application/jsonl",
    ) or ctype.startswith("multipart/"):
        # binary/CSV/JSONL/multipart pass through (multipart boundary stays
        # in the Content-Type header)
        return raw, None
    if ctype == "application/x-www-form-urlencoded":
        # urllib sets this content type by default, so JSON bodies still
        # take precedence; real form posts (login) fall through to form
        # decoding
        try:
            return json.loads(raw.decode()), None
        except (json.JSONDecodeError, UnicodeDecodeError):
            return dict(urllib.parse.parse_qsl(raw.decode())), None
    try:
        return json.loads(raw.decode()), None
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None, b'{"error": "invalid JSON body"}'


class RestServer:
    """Shared REST service (embedded by both server and master nodes, like
    the reference's RestServer: master/master.go:74)."""

    def __init__(
        self,
        config: Config,
        data_store: DataStore,
        cache_store: CacheStore,
        api_key: str = "",
        metrics=None,
    ) -> None:
        self.config = config
        self.data = data_store
        self.cache = cache_store
        self.api_key = api_key
        if metrics is None and not hasattr(self, "metrics"):
            from .metrics import MetricsRegistry

            metrics = MetricsRegistry(namespace="gorse")
        if metrics is not None:
            self.metrics = metrics
        self._routes: list[tuple[str, re.Pattern, callable, str]] = []
        self._route_templates: list[tuple[str, str, callable]] = []
        self._register_routes()
        self.route("GET", "/apidocs.json", lambda req: self.openapi_spec())
        self.route("GET", "/metrics", self.get_metrics)
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
        self._route_templates.append((method, pattern, handler))

    # --- OpenAPI component schemas: the reference
    # emits full request/response models via go-restful-openapi
    # (server/rest.go:80-88); these mirror storage/types.py's wire shapes.
    _TIMESTAMP = {
        "oneOf": [
            {"type": "number", "description": "unix seconds"},
            {"type": "string", "format": "date-time"},
        ]
    }
    _OPENAPI_SCHEMAS = {
        "User": {
            "type": "object",
            "required": ["UserId"],
            "properties": {
                "UserId": {"type": "string"},
                "Labels": {"description": "free-form JSON labels"},
                "Comment": {"type": "string"},
                "Subscribe": {"type": "array", "items": {"type": "string"},
                              "nullable": True},
            },
        },
        "Item": {
            "type": "object",
            "required": ["ItemId"],
            "properties": {
                "ItemId": {"type": "string"},
                "IsHidden": {"type": "boolean"},
                "Categories": {"type": "array", "items": {"type": "string"}},
                "Timestamp": _TIMESTAMP,
                "Labels": {"description": "free-form JSON labels"},
                "Comment": {"type": "string"},
            },
        },
        "Feedback": {
            "type": "object",
            "required": ["FeedbackType", "UserId", "ItemId"],
            "properties": {
                "FeedbackType": {"type": "string"},
                "UserId": {"type": "string"},
                "ItemId": {"type": "string"},
                "Value": {"type": "number"},
                "Timestamp": _TIMESTAMP,
                "Comment": {"type": "string"},
            },
        },
        "Score": {
            "type": "object",
            "properties": {
                "Id": {"type": "string"},
                "Score": {"type": "number"},
                "Categories": {"type": "array", "items": {"type": "string"}},
                "Timestamp": _TIMESTAMP,
            },
        },
        "Success": {
            "type": "object",
            "properties": {"RowAffected": {"type": "integer"}},
        },
        "ErrorResponse": {
            "type": "object",
            "properties": {"error": {"type": "string"}},
        },
        "HealthStatus": {
            "type": "object",
            "properties": {"status": {"type": "string"}},
        },
        "UserList": {
            "type": "object",
            "properties": {
                "Cursor": {"type": "string"},
                "Users": {"type": "array",
                          "items": {"$ref": "#/components/schemas/User"}},
            },
        },
        "ItemList": {
            "type": "object",
            "properties": {
                "Cursor": {"type": "string"},
                "Items": {"type": "array",
                          "items": {"$ref": "#/components/schemas/Item"}},
            },
        },
        "FeedbackList": {
            "type": "object",
            "properties": {
                "Cursor": {"type": "string"},
                "Feedback": {"type": "array",
                             "items": {"$ref": "#/components/schemas/Feedback"}},
            },
        },
    }

    @staticmethod
    def _ref(name: str) -> dict:
        return {"$ref": f"#/components/schemas/{name}"}

    @staticmethod
    def _arr(name: str) -> dict:
        return {"type": "array", "items": RestServer._ref(name)}

    def _route_models(self) -> dict:
        """(method, pattern) -> {"body": schema, "response": schema} for the
        CRUD + recommend surface, so a generated client can round-trip it
        (reference models: data.User/Item/Feedback, server/rest.go)."""
        ref, arr = self._ref, self._arr
        success = ref("Success")
        str_arr = {"type": "array", "items": {"type": "string"}}
        m = {
            ("POST", "/api/user"): {"body": ref("User"), "response": success},
            ("PATCH", "/api/user/{user-id}"): {"body": ref("User"), "response": success},
            ("GET", "/api/user/{user-id}"): {"response": ref("User")},
            ("DELETE", "/api/user/{user-id}"): {"response": success},
            ("POST", "/api/users"): {"body": arr("User"), "response": success},
            ("GET", "/api/users"): {"response": ref("UserList")},
            ("POST", "/api/item"): {"body": ref("Item"), "response": success},
            ("PATCH", "/api/item/{item-id}"): {"body": ref("Item"), "response": success},
            ("GET", "/api/item/{item-id}"): {"response": ref("Item")},
            ("DELETE", "/api/item/{item-id}"): {"response": success},
            ("POST", "/api/items"): {"body": arr("Item"), "response": success},
            ("GET", "/api/items"): {"response": ref("ItemList")},
            ("PUT", "/api/item/{item-id}/category/{category}"): {"response": success},
            ("DELETE", "/api/item/{item-id}/category/{category}"): {"response": success},
            ("POST", "/api/feedback"): {"body": arr("Feedback"), "response": success},
            ("PUT", "/api/feedback"): {"body": arr("Feedback"), "response": success},
            ("GET", "/api/feedback"): {"response": ref("FeedbackList")},
            ("POST", "/api/session/recommend"): {
                "body": arr("Feedback"), "response": arr("Score"),
            },
            ("POST", "/api/session/recommend/{category}"): {
                "body": arr("Feedback"), "response": arr("Score"),
            },
            ("GET", "/api/health/live"): {"response": ref("HealthStatus")},
            ("GET", "/api/health/ready"): {"response": ref("HealthStatus")},
        }
        # recommendation / collection reads return id arrays (or Score rows
        # under X-API-Version: 2)
        for pat in (
            "/api/recommend/{user-id}", "/api/recommend/{user-id}/{category}",
        ):
            m[("GET", pat)] = {"response": str_arr}
        for pat in (
            "/api/latest", "/api/latest/{category}",
            "/api/popular", "/api/popular/{category}",
            "/api/non-personalized/{name}",
            "/api/item-to-item/{name}/{item-id}",
            "/api/user-to-user/{name}/{user-id}",
            "/api/item/{item-id}/neighbors",
            "/api/item/{item-id}/neighbors/{category}",
            "/api/user/{user-id}/neighbors",
            "/api/collaborative-filtering/{user-id}",
            "/api/collaborative-filtering/{user-id}/{category}",
        ):
            m[("GET", pat)] = {"response": arr("Score")}
        for pat in (
            "/api/feedback/{user-id}/{item-id}",
            "/api/feedback/{feedback-type}/{user-id}/{item-id}",
        ):
            m[("GET", pat)] = {"response": arr("Feedback")}
            m[("DELETE", pat)] = {"response": success}
        m[("GET", "/api/feedback/{feedback-type}")] = {"response": ref("FeedbackList")}
        for pat in (
            "/api/user/{user-id}/feedback/{feedback-type}",
            "/api/user/{user-id}/feedback",
            "/api/item/{item-id}/feedback/{feedback-type}",
            "/api/item/{item-id}/feedback",
        ):
            m[("GET", pat)] = {"response": arr("Feedback")}
        return m

    def openapi_spec(self) -> dict:
        """OpenAPI 3.0 document generated from the route table (reference:
        the go-restful-openapi spec served at /apidocs.json,
        server/rest.go:80-88), with request/response component schemas for
        the CRUD + recommend surface."""
        models = self._route_models()
        paths: dict[str, dict] = {}
        for method, pattern, handler in self._route_templates:
            if pattern == "/apidocs.json":
                continue
            params = [
                {
                    "name": name,
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for name in re.findall(r"\{([a-z\-]+)\}", pattern)
            ]
            op: dict = {
                "summary": (getattr(handler, "__doc__", None) or "").strip().split("\n")[0],
                "responses": {"200": {"description": "OK"}},
            }
            spec = models.get((method, pattern))
            if spec:
                if "body" in spec:
                    op["requestBody"] = {
                        "required": True,
                        "content": {"application/json": {"schema": spec["body"]}},
                    }
                if "response" in spec:
                    op["responses"]["200"]["content"] = {
                        "application/json": {"schema": spec["response"]}
                    }
            op["responses"]["401"] = {
                "description": "unauthorized",
                "content": {"application/json": {"schema": self._ref("ErrorResponse")}},
            }
            if params:
                op["parameters"] = params
            paths.setdefault(pattern, {})[method.lower()] = op
        return {
            "openapi": "3.0.3",
            "info": {
                "title": "gorse_tpu REST API",
                "description": "TPU-native recommender engine API "
                "(endpoint-compatible with gorse)",
                "version": "1",
            },
            "components": {
                "schemas": self._OPENAPI_SCHEMAS,
                "securitySchemes": {
                    "ApiKey": {"type": "apiKey", "in": "header", "name": "X-API-Key"}
                },
            },
            "paths": paths,
        }

    def _register_routes(self) -> None:
        r = self.route
        r("GET", "/api/health/live", self.check_live)
        r("GET", "/api/health/ready", self.check_ready)
        # users
        r("POST", "/api/user", self.insert_user)
        r("PATCH", "/api/user/{user-id}", self.modify_user)
        r("GET", "/api/user/{user-id}", self.get_user)
        r("DELETE", "/api/user/{user-id}", self.delete_user)
        r("POST", "/api/users", self.insert_users)
        r("GET", "/api/users", self.get_users)
        # items
        r("POST", "/api/item", self.insert_item)
        r("PATCH", "/api/item/{item-id}", self.modify_item)
        r("GET", "/api/item/{item-id}", self.get_item)
        r("DELETE", "/api/item/{item-id}", self.delete_item)
        r("POST", "/api/items", self.insert_items)
        r("GET", "/api/items", self.get_items)
        r("PUT", "/api/item/{item-id}/category/{category}", self.insert_item_category)
        r("DELETE", "/api/item/{item-id}/category/{category}", self.delete_item_category)
        # feedback
        r("POST", "/api/feedback", lambda req: self.insert_feedback(req, overwrite=False))
        r("PUT", "/api/feedback", lambda req: self.insert_feedback(req, overwrite=True))
        r("GET", "/api/feedback", self.get_feedback)
        r("GET", "/api/feedback/{feedback-type}", self.get_typed_feedback)
        r("GET", "/api/feedback/{user-id}/{item-id}", self.get_user_item_feedback)
        r("DELETE", "/api/feedback/{user-id}/{item-id}", self.delete_user_item_feedback)
        r("GET", "/api/feedback/{feedback-type}/{user-id}/{item-id}", self.get_typed_user_item_feedback)
        r("DELETE", "/api/feedback/{feedback-type}/{user-id}/{item-id}", self.delete_typed_user_item_feedback)
        r("GET", "/api/user/{user-id}/feedback/{feedback-type}", self.get_typed_feedback_by_user)
        r("GET", "/api/user/{user-id}/feedback", self.get_feedback_by_user)
        r("GET", "/api/item/{item-id}/feedback/{feedback-type}", self.get_typed_feedback_by_item)
        r("GET", "/api/item/{item-id}/feedback", self.get_feedback_by_item)
        # recommendations
        r("GET", "/api/collaborative-filtering/{user-id}/{category}", self.get_collaborative)
        r("GET", "/api/collaborative-filtering/{user-id}", self.get_collaborative)
        r("GET", "/api/latest/{category}", self.get_latest)
        r("GET", "/api/latest", self.get_latest)
        r("GET", "/api/popular/{category}", lambda req: self.get_non_personalized(req, name="popular"))
        r("GET", "/api/popular", lambda req: self.get_non_personalized(req, name="popular"))
        r("GET", "/api/non-personalized/{name}", self.get_non_personalized)
        r("GET", "/api/item-to-item/{name}/{item-id}", self.get_item_to_item)
        r("GET", "/api/user-to-user/{name}/{user-id}", self.get_user_to_user)
        r("GET", "/api/item/{item-id}/neighbors/{category}", self.get_item_neighbors)
        r("GET", "/api/item/{item-id}/neighbors", self.get_item_neighbors)
        r("GET", "/api/user/{user-id}/neighbors", self.get_user_neighbors)
        r("GET", "/api/recommend/{user-id}/{category}", self.get_recommend)
        r("GET", "/api/recommend/{user-id}", self.get_recommend)
        r("POST", "/api/session/recommend/{category}", self.session_recommend)
        r("POST", "/api/session/recommend", self.session_recommend)
        r("GET", "/api/measurements/{name}", self.get_measurements)

    def _session_ok(self, headers: dict) -> bool:
        """Cookie-session auth hook; the dashboard overrides this
        (reference: session cookie check master/rest.go:344-366)."""
        return False

    # the spec itself is public, like the reference's /apidocs (rest.go:88)
    _public_paths = ("/apidocs.json",)

    def dispatch(self, method: str, path: str, query: dict, body, headers) -> tuple[int, object]:
        headers = {k.lower(): v for k, v in headers.items()}
        # trailing-slash tolerance: the reference registers some routes with a
        # trailing slash (e.g. /item/{id}/feedback/, server/rest.go:303) and
        # go-restful treats both spellings alike
        if len(path) > 1 and path.endswith("/"):
            path = path.rstrip("/")
        if (
            self.api_key
            and headers.get("x-api-key") != self.api_key
            and path not in self._public_paths
            and not self._session_ok(headers)
        ):
            matched = any(p.match(path) for m, p, _, _ in self._routes if m == method)
            if "/health/" not in path and path != "/metrics":
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
                with tracer().span(f"{method} {template}",
                                   traceparent=headers.get("traceparent"), method=method) as span:
                    try:
                        out = 200, handler(req)
                    except HTTPError as e:
                        out = e.status, {"error": e.message}
                    except Exception as e:  # noqa: BLE001 — surface as 500 like the reference
                        logger.exception("handler error")
                        out = 500, {"error": str(e)}
                    if span is not None:
                        span.set_attribute("status_code", out[0])
                        if out[0] >= 500:
                            span.status = f"error: {out[1].get('error', '')}"
                self._observe(method, template, out[0], time.perf_counter() - t0)
                return out
        return 404, {"error": "not found"}

    def _observe(self, method: str, route: str, status: int, seconds: float) -> None:
        """Request metrics and the event recorder (reference:
        gorse_server_rest_api_request_seconds, server/metrics.go:26)."""
        get_recorder().record_api(method, route, status, seconds)
        metrics = getattr(self, "metrics", None)
        if metrics is not None:
            metrics.counter_inc(
                "rest_api_requests", labels={"method": method, "status": str(status)}
            )
            # the reference's HistogramVec keyed by route template
            # (gorse_server_rest_api_request_seconds{api=...}, server/metrics.go:23-27)
            metrics.histogram_observe(
                "server_rest_api_request_seconds", seconds, labels={"api": route}
            )

    # ------------------------------------------------------------- handlers

    def get_metrics(self, req) -> "RawResponse":
        """Prometheus scrape endpoint (reference: each node exposes promhttp;
        server metrics are gorse_server_*, server/metrics.go)."""
        return RawResponse(self.metrics.render().encode(), "text/plain; version=0.0.4")

    def check_live(self, req) -> dict:
        return {"status": "live"}

    def check_ready(self, req) -> dict:
        ready = self.data.ping() and self.cache.ping()
        if not ready:
            raise HTTPError(503, "stores not ready")
        return {"status": "ready"}

    # users

    def _touch_users(self, user_ids: list[str]) -> None:
        """Set LastModifyUserTime — drives worker staleness checks
        (reference: server/rest.go:1061,1143,1609)."""
        now = str(time.time())
        for uid in set(user_ids):
            self.cache.set(key(ck.LAST_MODIFY_USER_TIME, uid), now)

    def _touch_items(self, item_ids: list[str]) -> None:
        """Set LastModifyItemTime (reference: server/rest.go:1305,1397,1612)."""
        now = str(time.time())
        for iid in set(item_ids):
            self.cache.set(key(ck.LAST_MODIFY_ITEM_TIME, iid), now)

    def insert_user(self, req) -> dict:
        user = User.from_dict(req.body)
        if not user.user_id:
            raise HTTPError(400, "UserId is required")
        self.data.insert_users([user])
        self._touch_users([user.user_id])
        return {"RowAffected": 1}

    def insert_users(self, req) -> dict:
        users = [User.from_dict(d) for d in req.body]
        if any(not u.user_id for u in users):
            raise HTTPError(400, "UserId is required")
        self.data.insert_users(users)
        self._touch_users([u.user_id for u in users])
        return {"RowAffected": len(users)}

    def modify_user(self, req) -> dict:
        user = self.data.get_user(req.params["user_id"])
        if user is None:
            raise HTTPError(404, "user not found")
        patch = req.body
        if "Labels" in patch:
            user.labels = patch["Labels"]
        if "Comment" in patch:
            user.comment = patch["Comment"]
        if "Subscribe" in patch:
            user.subscribe = patch["Subscribe"]
        self.data.insert_users([user])
        self._touch_users([user.user_id])
        return {"RowAffected": 1}

    def get_user(self, req) -> dict:
        user = self.data.get_user(req.params["user_id"])
        if user is None:
            raise HTTPError(404, "user not found")
        return user.to_dict()

    def delete_user(self, req) -> dict:
        self.data.delete_user(req.params["user_id"])
        return {"RowAffected": 1}

    def get_users(self, req) -> dict:
        n = req.int_query("n", self.config.server.default_n)
        cursor = req.query.get("cursor", "")
        users = list(self.data.get_users(begin_id=cursor, limit=n))
        next_cursor = users[-1].user_id if users and len(users) == n else ""
        return {"Users": [u.to_dict() for u in users], "Cursor": next_cursor}

    # items

    def insert_item(self, req) -> dict:
        item = Item.from_dict(req.body)
        if not item.item_id:
            raise HTTPError(400, "ItemId is required")
        if isinstance(req.body.get("Timestamp"), str):
            item.timestamp = _parse_time(req.body["Timestamp"])
        self.data.insert_items([item])
        self._sync_item_cache(item)
        self._touch_items([item.item_id])
        return {"RowAffected": 1}

    def insert_items(self, req) -> dict:
        items = []
        for d in req.body:
            item = Item.from_dict(d)
            if not item.item_id:
                raise HTTPError(400, "ItemId is required")
            if isinstance(d.get("Timestamp"), str):
                item.timestamp = _parse_time(d["Timestamp"])
            items.append(item)
        self.data.insert_items(items)
        for item in items:
            self._sync_item_cache(item)
        self._touch_items([i.item_id for i in items])
        return {"RowAffected": len(items)}

    def _sync_item_cache(self, item: Item) -> None:
        """Propagate category/hidden changes to cached scores
        (reference: server/rest.go modifyItem cache update)."""
        self.cache.update_scores(
            [ck.RECOMMEND, ck.COLLABORATIVE, ck.ITEM_TO_ITEM, ck.NON_PERSONALIZED],
            None, item.item_id, categories=item.categories, is_hidden=item.is_hidden,
        )

    def modify_item(self, req) -> dict:
        item = self.data.get_item(req.params["item_id"])
        if item is None:
            raise HTTPError(404, "item not found")
        patch = req.body
        if "IsHidden" in patch:
            item.is_hidden = bool(patch["IsHidden"])
        if "Categories" in patch:
            item.categories = list(patch["Categories"])
        if "Labels" in patch:
            item.labels = patch["Labels"]
        if "Comment" in patch:
            item.comment = patch["Comment"]
        if "Timestamp" in patch:
            ts = patch["Timestamp"]
            item.timestamp = _parse_time(ts) if isinstance(ts, str) else float(ts)
        self.data.insert_items([item])
        self._sync_item_cache(item)
        self._touch_items([item.item_id])
        return {"RowAffected": 1}

    def get_item(self, req) -> dict:
        item = self.data.get_item(req.params["item_id"])
        if item is None:
            raise HTTPError(404, "item not found")
        return item.to_dict()

    def delete_item(self, req) -> dict:
        item_id = req.params["item_id"]
        self.data.delete_item(item_id)
        # drop the item from cached recommendations immediately (reference:
        # DeleteScores(ItemCache, Id=item), server/rest.go:1477); hiding the
        # rows keeps serving results identical and re-insert restores them
        self.cache.update_scores(
            [ck.RECOMMEND, ck.COLLABORATIVE, ck.ITEM_TO_ITEM, ck.NON_PERSONALIZED],
            None, item_id, is_hidden=True,
        )
        return {"RowAffected": 1}

    def get_items(self, req) -> dict:
        n = req.int_query("n", self.config.server.default_n)
        query = req.query.get("q", "")
        if query:
            # full-text search (reference: server/rest.go:1419-1433)
            if not self.config.recommend.search.columns:
                raise HTTPError(
                    400,
                    "item search is not supported because"
                    " [recommend.search].columns is empty",
                )
            items = self.data.search_items(
                query, n, columns=self.config.recommend.search.columns
            )
            return {"Items": [i.to_dict() for i in items], "Cursor": ""}
        cursor = req.query.get("cursor", "")
        items = list(self.data.get_items(begin_id=cursor, limit=n))
        next_cursor = items[-1].item_id if items and len(items) == n else ""
        return {"Items": [i.to_dict() for i in items], "Cursor": next_cursor}

    def insert_item_category(self, req) -> dict:
        item = self.data.get_item(req.params["item_id"])
        if item is None:
            raise HTTPError(404, "item not found")
        category = req.params["category"]
        if category not in item.categories:
            item.categories.append(category)
        self.data.insert_items([item])
        self._sync_item_cache(item)
        return {"RowAffected": 1}

    def delete_item_category(self, req) -> dict:
        item = self.data.get_item(req.params["item_id"])
        if item is None:
            raise HTTPError(404, "item not found")
        category = req.params["category"]
        item.categories = [c for c in item.categories if c != category]
        self.data.insert_items([item])
        self._sync_item_cache(item)
        return {"RowAffected": 1}

    # feedback

    def insert_feedback(self, req, overwrite: bool) -> dict:
        entities = req.body if isinstance(req.body, list) else [req.body]
        feedback = []
        clock_error = self.config.server.clock_error
        for d in entities:
            fb = Feedback.from_dict(d)
            if not fb.feedback_type or not fb.user_id or not fb.item_id:
                raise HTTPError(400, "FeedbackType, UserId and ItemId are required")
            if isinstance(d.get("Timestamp"), str):
                fb.timestamp = _parse_time(d["Timestamp"])
            elif not d.get("Timestamp"):
                fb.timestamp = time.time()
            # clock-error tolerance (reference: server/rest.go:1573)
            fb.timestamp = min(fb.timestamp, time.time() + clock_error)
            feedback.append(fb)
        self.data.insert_feedback(
            feedback,
            insert_user=self.config.server.auto_insert_user,
            insert_item=self.config.server.auto_insert_item,
            overwrite=overwrite,
        )
        self._touch_users([fb.user_id for fb in feedback])
        self._touch_items([fb.item_id for fb in feedback])
        return {"RowAffected": len(feedback)}

    def get_feedback(self, req) -> dict:
        n = req.int_query("n", self.config.server.default_n)
        out = []
        for fb in self.data.get_feedback():
            out.append(fb.to_dict())
            if len(out) >= n:
                break
        return {"Feedback": out, "Cursor": ""}

    def get_typed_feedback(self, req) -> dict:
        """Reference: getTypedFeedback server/rest.go:1649-1669."""
        n = req.int_query("n", self.config.server.default_n)
        out = []
        for fb in self.data.get_feedback(feedback_types=[req.params["feedback_type"]]):
            out.append(fb.to_dict())
            if len(out) >= n:
                break
        return {"Feedback": out, "Cursor": ""}

    def get_user_item_feedback(self, req) -> list:
        return [
            f.to_dict()
            for f in self.data.get_user_feedback(req.params["user_id"])
            if f.item_id == req.params["item_id"]
        ]

    def delete_user_item_feedback(self, req) -> dict:
        n = self.data.delete_user_item_feedback(req.params["user_id"], req.params["item_id"])
        return {"RowAffected": n}

    def get_typed_user_item_feedback(self, req) -> dict:
        out = [
            f
            for f in self.data.get_user_feedback(req.params["user_id"], feedback_types=[req.params["feedback_type"]])
            if f.item_id == req.params["item_id"]
        ]
        if not out:
            raise HTTPError(404, "feedback not found")
        return out[0].to_dict()

    def delete_typed_user_item_feedback(self, req) -> dict:
        n = self.data.delete_user_item_feedback(
            req.params["user_id"], req.params["item_id"], [req.params["feedback_type"]]
        )
        return {"RowAffected": n}

    def get_typed_feedback_by_user(self, req) -> list:
        return [
            f.to_dict()
            for f in self.data.get_user_feedback(req.params["user_id"], feedback_types=[req.params["feedback_type"]])
        ]

    def get_feedback_by_user(self, req) -> list:
        return [f.to_dict() for f in self.data.get_user_feedback(req.params["user_id"])]

    def get_typed_feedback_by_item(self, req) -> list:
        return [
            f.to_dict()
            for f in self.data.get_item_feedback(req.params["item_id"], [req.params["feedback_type"]])
        ]

    def get_feedback_by_item(self, req) -> list:
        return [f.to_dict() for f in self.data.get_item_feedback(req.params["item_id"])]

    # recommendations

    def _scores_out(self, scores: list[Score], req) -> list:
        n = req.int_query("n", self.config.server.default_n)
        offset = req.int_query("offset", 0)
        page = scores[offset : offset + n] if n > 0 else scores[offset:]
        if req.headers.get("x-api-version") == "2":
            return [{"Id": s.id, "Score": s.score} for s in page]
        return [s.id for s in page]

    def _categories(self, req) -> list[str]:
        cats = []
        if "category" in req.params:
            cats.append(req.params["category"])
        cats.extend(req.query_all("category"))
        return [c for c in cats if c]

    def _read_item_ids(self, user_id: str) -> set[str]:
        """Items the requesting user has any feedback on (reference:
        SearchDocuments' readItems pruning, server/rest.go:636-670)."""
        if not user_id:
            return set()
        return {f.item_id for f in self.data.get_user_feedback(user_id)}

    def _last_modified(self, cache_key: str) -> dict:
        """Last-Modified response header from a cache update-time key
        (reference: SetLastModified server/rest.go:784-791)."""
        v = self.cache.get(cache_key)
        if not v:
            return {}
        try:
            ts = float(v)
        except (TypeError, ValueError):
            return {}
        import email.utils

        return {"Last-Modified": email.utils.formatdate(ts, usegmt=True)}

    @staticmethod
    def _score_json(scores: list[Score]) -> list[dict]:
        """The reference's cache.Score JSON shape: only Id and Score are
        exported (storage/cache/database.go:166-172)."""
        return [{"Id": s.id, "Score": s.score} for s in scores]

    def _search_documents(
        self, req, collection: str, subset: str, categories: list[str] | None,
        headers: dict | None = None,
    ):
        """The reference's SearchDocuments (server/rest.go:615-691): paged
        cache read with optional `user-id` read-item pruning; always returns
        cache.Score objects (these endpoints ignore X-API-Version)."""
        offset = req.int_query("offset", 0)
        n = req.int_query("n", self.config.server.default_n)
        read = self._read_item_ids(req.query.get("user-id", ""))
        end = offset + n
        if end > 0 and read:
            end += len(read)
        scores = self.cache.search_scores(collection, subset, categories, offset, end)
        if read:
            scores = [s for s in scores if s.id not in read]
        if n > 0 and len(scores) > n:
            scores = scores[:n]
        payload = self._score_json(scores)
        if headers:
            return RawResponse(
                json.dumps(payload).encode(), "application/json", headers=headers
            )
        return payload

    def get_collaborative(self, req):
        """Precomputed offline recommendation for a user (reference:
        getCollaborativeFiltering server/rest.go:856-864 — reads the
        Recommend collection; 404 when collaborative filtering is off)."""
        if self.config.recommend.collaborative.type.lower() == "none":
            raise HTTPError(404, "collaborative filtering recommendation is disabled")
        user_id = req.params["user_id"]
        return self._search_documents(
            req, ck.RECOMMEND, user_id, self._categories(req),
            headers=self._last_modified(key(ck.LAST_UPDATE_USER_RECOMMEND_TIME, user_id)),
        )

    def get_latest(self, req) -> list:
        """Latest items with optional `user-id` read pruning and item TTL
        (reference: getLatest server/rest.go:693-759)."""
        offset = req.int_query("offset", 0)
        n = req.int_query("n", self.config.server.default_n)
        read = self._read_item_ids(req.query.get("user-id", ""))
        after = None
        ttl_days = self.config.recommend.data_source.item_ttl
        if ttl_days > 0:
            after = time.time() - ttl_days * 86400
        items = self.data.get_latest_items(
            offset + n + len(read), self._categories(req), after=after
        )
        if read:
            items = [i for i in items if i.item_id not in read]
        items = items[min(offset, len(items)):]
        if n > 0 and len(items) > n:
            items = items[:n]
        return [{"Id": i.item_id, "Score": float(i.timestamp)} for i in items]

    def get_non_personalized(self, req, name: str | None = None):
        name = name or req.params["name"]
        cats = self._categories(req) or [""]
        return self._search_documents(
            req, ck.NON_PERSONALIZED, name, cats,
            headers=self._last_modified(key(ck.NON_PERSONALIZED_UPDATE_TIME, name)),
        )

    def get_item_to_item(self, req, name: str | None = None):
        name = name or req.params["name"]
        # Last-Modified comes from the per-name update time (the reference
        # keys it per name+item, master keeps per-name times here)
        return self._search_documents(
            req, ck.ITEM_TO_ITEM, key(name, req.params["item_id"]), self._categories(req),
            headers=self._last_modified(key(ck.ITEM_TO_ITEM_UPDATE_TIME, name)),
        )

    def get_user_to_user(self, req, name: str | None = None):
        name = name or req.params["name"]
        return self._search_documents(
            req, ck.USER_TO_USER, key(name, req.params["user_id"]), None,
            headers=self._last_modified(key(ck.USER_TO_USER_UPDATE_TIME, name)),
        )

    def get_item_neighbors(self, req) -> list:
        """Default item-to-item recommender (reference: getItemNeighbors
        uses the first configured item-to-item)."""
        if not self.config.recommend.item_to_item:
            raise HTTPError(404, "item-to-item recommendation is not enabled")
        return self.get_item_to_item(req, name=self.config.recommend.item_to_item[0].name)

    def get_user_neighbors(self, req) -> list:
        if not self.config.recommend.user_to_user:
            raise HTTPError(404, "user-to-user recommendation is not enabled")
        return self.get_user_to_user(req, name=self.config.recommend.user_to_user[0].name)

    def get_recommend(self, req) -> list:
        """The latency path (reference: getRecommend server/rest.go:866-935)."""
        user_id = req.params["user_id"]
        recommender = Recommender(
            self.config.recommend, self.cache, self.data,
            online=True, user_id=user_id, categories=self._categories(req),
        )
        n = req.int_query("n", self.config.server.default_n)
        offset = req.int_query("offset", 0)
        results = recommender.recommend(limit=n + offset if n > 0 else 0)
        # optional write-back feedback loop (reference :910-929)
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

    def session_recommend(self, req) -> list:
        """Session-based recommendation from a posted feedback list
        (reference: sessionRecommend server/rest.go:938-1037)."""
        if not self.config.recommend.item_to_item:
            raise HTTPError(404, "item-to-item recommendation is not enabled")
        name = self.config.recommend.item_to_item[0].name
        feedbacks = [Feedback.from_dict(d) for d in req.body]
        feedbacks.sort(key=lambda f: -f.timestamp)
        exclude = {f.item_id for f in feedbacks}
        positive = [
            f
            for f in feedbacks
            if match_any(
                self.config.recommend.data_source.positive_feedback_types,
                f.feedback_type, f.value,
            )
        ]
        scores: dict[str, float] = {}
        used = 0  # only feedbacks that yielded similar items count toward
        # the context budget (reference: server/rest.go:990-1012)
        for fb in positive:
            similar = self.cache.search_scores(
                ck.ITEM_TO_ITEM, key(name, fb.item_id), self._categories(req),
                0, self.config.recommend.cache_size,
            )
            for s in similar:
                if s.id not in exclude:
                    scores[s.id] = scores.get(s.id, 0.0) + s.score
            if similar:
                used += 1
                if used >= self.config.recommend.context_size:
                    break
        n = req.int_query("n", self.config.server.default_n)
        offset = req.int_query("offset", 0)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])[offset:]
        if n > 0 and len(ranked) > n:
            ranked = ranked[:n]
        return [{"Id": i, "Score": v} for i, v in ranked]

    def get_measurements(self, req) -> list:
        n = req.int_query("n", 100)
        points = self.cache.get_time_series_points(req.params["name"], 0, time.time())
        return [
            {"Name": p.name, "Timestamp": p.timestamp, "Value": p.value}
            for p in points[-n:]
        ]

    # ------------------------------------------------------------- serving

    def cors_headers(self, origin: str) -> dict:
        """CORS response headers when ``origin`` matches one of the config's
        allowed-domain regexes (reference: master.http_cors_domains /
        http_cors_methods, config/config.go:131-132)."""
        domains = self.config.master.http_cors_domains
        if not origin or not domains:
            return {}
        for pat in domains:
            try:
                if re.fullmatch(pat, origin):
                    break
            except re.error:
                continue
        else:
            return {}
        methods = self.config.master.http_cors_methods or [
            "GET", "POST", "PUT", "DELETE", "PATCH",
        ]
        return {
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Allow-Methods": ", ".join(methods),
            "Access-Control-Allow-Headers": "Content-Type, X-API-Key, Authorization",
            "Vary": "Origin",
        }

    @staticmethod
    def render_payload(status: int, payload) -> tuple[bytes, str, dict, int]:
        """(data, content_type, extra_headers, status) for any handler
        result — shared by the threaded and asyncio front-ends."""
        extra: dict = {}
        if isinstance(payload, RawResponse):
            data, ctype = payload.body, payload.content_type
            extra = payload.headers
            if payload.status != 200:
                status = payload.status
        else:
            data, ctype = json.dumps(payload).encode(), "application/json"
        return data, ctype, extra, status

    def serve(
        self, host: str = "127.0.0.1", port: int = 8087, backend: str | None = None
    ):
        """Start the HTTP front-end. ``backend``: "async" (default — the
        event-loop server, serve/asynchttp.py) or "threaded" (the stdlib
        ThreadingHTTPServer); overridable via GORSE_TPU_HTTP_BACKEND."""
        import os

        backend = backend or os.environ.get("GORSE_TPU_HTTP_BACKEND", "async")
        if backend == "async":
            from .asynchttp import AsyncHTTPServer

            httpd = AsyncHTTPServer(self, host, port).start()
            self._httpd = httpd
            logger.info("REST server (async) listening on %s:%d", *httpd.server_address)
            return httpd
        return self._serve_threaded(host, port)

    def _serve_threaded(self, host: str = "127.0.0.1", port: int = 8087) -> ThreadingHTTPServer:
        rest = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive: one thread serves many requests
            disable_nagle_algorithm = True  # avoid 40ms delayed-ACK stalls

            def log_message(self, fmt, *args):  # quiet access log -> logger
                logger.debug("%s %s", self.address_string(), fmt % args)

            def _handle(self, method: str) -> None:
                if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
                    # unread chunked bodies would desynchronize the
                    # keep-alive stream; refuse and drop the connection
                    self.close_connection = True
                    self._reply(501, {"error": "chunked request bodies are not supported"})
                    return
                parsed = urllib.parse.urlparse(self.path)
                raw = b""
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                body, err = decode_body(raw, self.headers.get("Content-Type"))
                if err is not None:
                    self._reply(400, {"error": "invalid JSON body"})
                    return
                status, payload = rest.dispatch(
                    method, parsed.path, parse_query(parsed.query), body,
                    dict(self.headers),
                )
                self._reply(status, payload)

            def _reply(self, status: int, payload) -> None:
                data, ctype, extra, status = rest.render_payload(status, payload)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in extra.items():
                    self.send_header(k, v)
                for k, v in rest.cors_headers(self.headers.get("Origin") or "").items():
                    self.send_header(k, v)
                self.end_headers()
                if self.command != "HEAD":  # RFC 9110: headers only
                    self.wfile.write(data)

            def do_OPTIONS(self):
                # CORS preflight
                cors = rest.cors_headers(self.headers.get("Origin") or "")
                self.send_response(204 if cors else 405)
                self.send_header("Content-Length", "0")
                for k, v in cors.items():
                    self.send_header(k, v)
                self.end_headers()

            def do_GET(self):
                self._handle("GET")

            def do_HEAD(self):
                # HEAD = GET with the body suppressed (see _reply) — same
                # behavior as the asyncio front-end
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_PATCH(self):
                self._handle("PATCH")

            def do_DELETE(self):
                self._handle("DELETE")

        httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd = httpd
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        logger.info("REST server listening on %s:%d", *httpd.server_address)
        return httpd

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            if isinstance(self._httpd, ThreadingHTTPServer):
                self._httpd.server_close()  # free the listening port
            self._httpd = None


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


def _parse_time(s: str) -> float:
    """RFC3339-ish timestamp parsing."""
    import datetime

    s = s.replace("Z", "+00:00")
    return datetime.datetime.fromisoformat(s).timestamp()


def _parse_duration(s: str) -> float:
    """Go-style durations: 10s, 5m, 2h, 1d."""
    m = re.match(r"^([0-9.]+)(s|m|h|d)?$", s)
    if not m:
        raise HTTPError(400, f"invalid duration {s!r}")
    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400, None: 1}[m.group(2)]
    return float(m.group(1)) * mult
