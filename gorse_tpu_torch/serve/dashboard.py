"""The master's REST server: the public API plus the dashboard and admin
routes (port of gorse_tpu/serve/dashboard.py).

``MasterRestServer`` serves gorse's master/rest.go dashboard surface
(:81-279): cluster membership, stats, task progress, time series, the
config (GET; POST persists a recommend override as ``RECOMMEND_CONFIG`` in
the meta store, master/master.go:160-172; DELETE drops it) and its schema,
categories, schedule, the previews (users, feedback, recommendations,
latest, non-personalized, item-to-item, user-to-user), the login routes
over signed session cookies, and the node-sync routes ``POST
/api/admin/meta`` and ``/api/admin/progress`` that stand in for gorse's
gRPC Master service (GetMeta/PushProgress, master/rpc.go). The protected
prefixes take the admin API key or a login session whenever either is
configured.

Also: OIDC sign-on (``oidc.enable``: ``/login`` redirects to the provider,
``/callback/oauth2`` exchanges the code; serve/oidc.py), the dashboard's
page (``GET /``, the port's copy of dashboard.html), dump and restore
(``/api/dump``, ``/api/restore``), the CSV and JSONL import and export
(``/api/import/*``, ``/api/export/*``, ``/api/bulk/*``, a multipart
``file`` part accepted), purge (``/api/purge``, with its checklist), the
chat proxy (``/api/chat/completions``), the ``ranker/prompt`` preview
(utils/template.py) and the ``external`` preview (logics/external.py).
"""

from __future__ import annotations

import dataclasses
import html
import io
import json
import time

from .. import __version__
from ..storage import cache as ck_mod
from ..storage.cache import key
from ..storage.meta import RECOMMEND_CONFIG, Node
from ..utils.config import Config
from . import dump as dump_mod
from .metrics import MetricsRegistry
from .oidc import OIDCClient, SessionManager
from .rest import HTTPError, RawResponse, Redirect, RestServer

_LOGIN_FORM = """<!doctype html><html><body><h1>gorse-tpu dashboard</h1>
<form method="post" action="/login">
<input name="user_name" placeholder="user name">
<input name="password" type="password" placeholder="password">
<button type="submit">Login</button></form>{msg}</body></html>"""


class MasterRestServer(RestServer):
    """REST surface of the master: the public API plus dashboard/admin routes
    (the reference's master embeds the shared RestServer the same way,
    master/master.go:74)."""

    def __init__(self, master, api_key: str = "", metrics: MetricsRegistry | None = None) -> None:
        self.master = master
        # share the master's registry so task-time gauges (gorse_master_*)
        # and request histograms render from one /metrics endpoint
        self.metrics = metrics or getattr(master, "metrics", None) or MetricsRegistry(namespace="gorse")
        # login sessions and the optional OIDC sign-on (reference:
        # master/master.go:402-418, master/rest.go:271-287)
        self.sessions = SessionManager()
        oidc_cfg = master.config.oidc
        self.oidc = (
            OIDCClient(oidc_cfg.issuer, oidc_cfg.client_id, oidc_cfg.client_secret,
                       oidc_cfg.redirect_url)
            if oidc_cfg.enable
            else None
        )
        super().__init__(master.config, master.data, master.cache, api_key=api_key)

    def _register_routes(self) -> None:
        super()._register_routes()
        r = self.route
        r("GET", "/", self.get_ui)  # /metrics comes from the base RestServer
        # dashboard (reference: master/rest.go:81-279)
        r("GET", "/api/dashboard/cluster", self.get_cluster)
        r("GET", "/api/dashboard/stats", self.get_stats)
        r("GET", "/api/dashboard/tasks", self.get_tasks)
        r("GET", "/api/dashboard/timeseries/{name}", self.get_timeseries)
        r("GET", "/api/dashboard/config", self.get_config)
        r("POST", "/api/dashboard/config", self.post_config)
        r("DELETE", "/api/dashboard/config", self.delete_config)
        r("GET", "/api/dashboard/config/schema", self.get_config_schema)
        r("GET", "/api/dashboard/categories", self.get_categories)
        r("POST", "/api/dashboard/schedule", self.post_schedule)
        # node sync (replaces the gRPC Master service, master/rpc.go:29-98)
        r("POST", "/api/admin/meta", self.post_meta)
        r("POST", "/api/admin/progress", self.post_progress)
        # bulk data (reference: master/rest.go:1280-1501, 1724, 1967)
        r("GET", "/api/dump", self.get_dump)
        r("POST", "/api/restore", self.post_restore)
        r("GET", "/api/export/users", lambda req: self._export(dump_mod.export_users))
        r("GET", "/api/export/items", lambda req: self._export(dump_mod.export_items))
        r("GET", "/api/export/feedback", lambda req: self._export(dump_mod.export_feedback))
        r("POST", "/api/import/users", lambda req: self._import(req, dump_mod.import_users))
        r("POST", "/api/import/items", lambda req: self._import(req, dump_mod.import_items))
        r("POST", "/api/import/feedback", lambda req: self._import(req, dump_mod.import_feedback))
        # JSONL bulk import/export on one path, GET=export POST=import
        # (reference: master/rest.go:275-277, 1280-1501)
        for kind in ("users", "items", "feedback"):
            r("GET", f"/api/bulk/{kind}", lambda req, k=kind: self._bulk_export(k))
            r("POST", f"/api/bulk/{kind}", lambda req, k=kind: self._bulk_import(req, k))
        # destructive purge with confirmation checklist (master/rest.go:1630-1670)
        r("POST", "/api/purge", self.post_purge)
        # OpenAI chat proxy for the dashboard playground (master/rest.go:2042-2127)
        r("POST", "/api/chat/completions", self.post_chat_completions)
        # node sync (replaces the gRPC Master service, master/rpc.go:29-98)
        r("POST", "/api/admin/meta", self.post_meta)
        r("POST", "/api/admin/progress", self.post_progress)
        # dashboard previews (reference: master/rest.go:81-279 dashboard
        # routes returning entity details alongside scores)
        r("GET", "/api/dashboard/feedback", self.get_dashboard_feedback)
        r("GET", "/api/dashboard/feedback/{feedback-type}", self.get_dashboard_feedback)
        r("GET", "/api/dashboard/users", self.get_dashboard_users)
        r("GET", "/api/dashboard/user/{user-id}", self.get_dashboard_user)
        r("GET", "/api/dashboard/user/{user-id}/feedback", self.get_dashboard_user_feedback)
        r("GET", "/api/dashboard/user/{user-id}/feedback/{feedback-type}", self.get_dashboard_user_feedback)
        r("GET", "/api/dashboard/recommend/{user-id}", self.get_dashboard_recommend)
        r("GET", "/api/dashboard/recommend/{user-id}/{recommender}", self.get_dashboard_recommend)
        r("GET", "/api/dashboard/recommend/{user-id}/{recommender}/{name}", self.get_dashboard_recommend)
        r("GET", "/api/dashboard/latest", self.get_dashboard_latest)
        r("GET", "/api/dashboard/non-personalized/{name}", self.get_dashboard_non_personalized)
        r("GET", "/api/dashboard/item-to-item/{name}/{item-id}", self.get_dashboard_item_to_item)
        r("GET", "/api/dashboard/user-to-user/{name}/{user-id}", self.get_dashboard_user_to_user)
        r("GET", "/api/dashboard/external", self.get_dashboard_external)
        r("GET", "/api/dashboard/ranker/prompt", self.get_ranker_prompt)
        # login (reference: master/rest.go:271-273,369-418)
        r("GET", "/login", self.get_login)
        r("POST", "/login", self.post_login)
        r("GET", "/callback/oauth2", self.oauth2_callback)
        r("GET", "/logout", self.get_logout)
        r("GET", "/api/dashboard/userinfo", self.get_userinfo)

    # ------------------------------------------------------------- previews

    def _scored_items(self, scores) -> list[dict]:
        """Join cache scores with item details (reference: ScoredItem +
        Master.GetItem, master/rest.go:1031-1050)."""
        items = {it.item_id: it for it in self.data.batch_get_items([s.id for s in scores])}
        out = []
        for s in scores:
            it = items.get(s.id)
            d = it.to_dict() if it else {
                "ItemId": s.id, "Comment": "** This item doesn't exist **",
            }
            d["Score"] = s.score
            out.append(d)
        return out

    def _scored_users(self, scores) -> list[dict]:
        out = []
        for s in scores:
            u = self.data.get_user(s.id)
            d = u.to_dict() if u else {"UserId": s.id}
            d["Score"] = s.score
            out.append(d)
        return out

    def _page(self, req, rows: list) -> list:
        offset = req.int_query("offset", 0)
        n = req.int_query("n", self.config.server.default_n)
        return rows[offset:offset + n] if n > 0 else rows[offset:]

    def _user_detail(self, user) -> dict:
        """User + activity timestamps (reference: master/rest.go:804-831)."""

        d = user.to_dict()
        d["LastActiveTime"] = self.cache.get(key(ck_mod.LAST_MODIFY_USER_TIME, user.user_id)) or ""
        d["LastUpdateTime"] = self.cache.get(
            key(ck_mod.LAST_UPDATE_USER_RECOMMEND_TIME, user.user_id)
        ) or ""
        return d

    def get_dashboard_feedback(self, req) -> dict:
        """Paginated global feedback browser, rows joined with item details
        (reference: master/rest.go:81-279 getFeedback — cursor-paginated
        scan). The cursor is an integer offset into the type-filtered scan
        (the stores' get_feedback iterator has a stable order)."""
        import itertools

        n = req.int_query("n", self.config.server.default_n)
        n = max(1, min(n, 500))
        try:
            offset = int(req.query.get("cursor") or 0)
        except ValueError:
            raise HTTPError(400, "cursor must be an integer offset")
        types = (
            [req.params["feedback_type"]] if req.params.get("feedback_type") else None
        )
        rows = list(
            itertools.islice(
                self.data.get_feedback(feedback_types=types), offset, offset + n + 1
            )
        )
        has_more = len(rows) > n
        rows = rows[:n]
        items = {
            it.item_id: it
            for it in self.data.batch_get_items([f.item_id for f in rows])
        }
        out = []
        for f in rows:
            it = items.get(f.item_id)
            out.append({
                "FeedbackType": f.feedback_type,
                "UserId": f.user_id,
                "Item": it.to_dict() if it else {
                    "ItemId": f.item_id, "Comment": "** This item doesn't exist **",
                },
                "Timestamp": f.timestamp,
            })
        return {"Cursor": str(offset + n) if has_more else "", "Feedback": out}

    def get_dashboard_users(self, req) -> dict:
        n = req.int_query("n", self.config.server.default_n)
        cursor = req.query.get("cursor", "")
        users = list(self.data.get_users(begin_id=cursor, limit=n))
        return {
            "Cursor": users[-1].user_id if users and len(users) == n else "",
            "Users": [self._user_detail(u) for u in users],
        }

    def get_dashboard_user(self, req) -> dict:
        user = self.data.get_user(req.params["user_id"])
        if user is None:
            raise HTTPError(404, "user not found")
        return self._user_detail(user)

    def get_dashboard_user_feedback(self, req) -> list:
        """Feedback rows joined with full item details
        (reference: getTypedFeedbackByUser → Feedback{..., Item})."""
        types = [req.params["feedback_type"]] if req.params.get("feedback_type") else None
        feedback = self.data.get_user_feedback(req.params["user_id"], feedback_types=types)
        items = {it.item_id: it for it in self.data.batch_get_items([f.item_id for f in feedback])}
        out = []
        for f in feedback:
            it = items.get(f.item_id)
            out.append({
                "FeedbackType": f.feedback_type,
                "UserId": f.user_id,
                "Item": it.to_dict() if it else {
                    "ItemId": f.item_id, "Comment": "** This item doesn't exist **",
                },
                "Timestamp": f.timestamp,
                "Comment": f.comment,
            })
        return out

    def get_dashboard_recommend(self, req) -> list:
        """Recommendation preview with item details and per-source drill-down
        (reference: master/rest.go:866-1030 getRecommend)."""
        from ..logics.recommend import Recommender
        n = req.int_query("n", self.config.server.default_n)
        user_id = req.params["user_id"]
        recommender = Recommender(
            self.master.config.recommend, self.cache, self.data, online=True, user_id=user_id
        )
        rtype = req.params.get("recommender") or ""
        if rtype:
            name = f"{rtype}/{req.params['name']}" if req.params.get("name") else rtype
            scores, _ = recommender.recommend_sequential([], n, [name])
        else:
            scores = recommender.recommend(n)
        return self._scored_items(scores[:n])

    def get_dashboard_latest(self, req) -> list:
        items = self._page(req, self.data.get_latest_items(limit=10**9))
        return [dict(it.to_dict(), Score=float(it.timestamp)) for it in items]

    def get_dashboard_non_personalized(self, req) -> list:
        scores = self.cache.search_scores(ck_mod.NON_PERSONALIZED, req.params["name"])
        return self._scored_items(self._page(req, scores))

    def get_dashboard_item_to_item(self, req) -> list:

        scores = self.cache.search_scores(
            ck_mod.ITEM_TO_ITEM, key(req.params["name"], req.params["item_id"])
        )
        return self._scored_items(self._page(req, scores))

    def get_dashboard_user_to_user(self, req) -> list:

        scores = self.cache.search_scores(
            ck_mod.USER_TO_USER, key(req.params["name"], req.params["user_id"])
        )
        return self._scored_users(self._page(req, scores))

    def get_dashboard_external(self, req) -> list:
        """External recommender preview (reference: getExternal
        master/rest.go:1123-1156; script = base64-encoded JavaScript,
        evaluated with the requested user id). As gorse_tpu/serve/
        dashboard.py:271-299: a bare HTTP URL is an endpoint source, a
        registered callable's name a Python source, anything else a JS
        script (logics/external.py)."""
        import base64

        from ..logics.external import _REGISTRY, External, ExternalConfig

        spec_b64 = req.query.get("script", "")
        if not spec_b64:
            raise HTTPError(400, "script is required")
        try:
            spec = base64.b64decode(spec_b64).decode()
        except Exception:
            raise HTTPError(400, "invalid script encoding")
        stripped = spec.strip()
        if stripped.startswith(("http://", "https://")) and "\n" not in stripped:
            cfg = ExternalConfig(name="preview", type="http", url=stripped)
        elif stripped in _REGISTRY:
            cfg = ExternalConfig(name=stripped, type="python")
        else:
            cfg = ExternalConfig(name="preview", type="js", script=spec)
        try:
            return External(cfg).pull(req.query.get("user-id", ""))
        except Exception as e:  # the dashboard shows the script's error
            raise HTTPError(400, f"external script failed: {e}")

    def get_ranker_prompt(self, req) -> dict:
        """Render the reranker prompt for inspection (reference:
        getRankerPrompt master/rest.go:1157-1240): base64 templates over
        the user's history and current recommendations, rendered by
        utils/template.py."""
        import base64

        from ..utils import template
        from ..utils.expression import match_any

        q_b64 = req.query.get("query-template", "")
        d_b64 = req.query.get("document-template", "")
        user_id = req.query.get("user-id", "")
        if not q_b64 or not d_b64:
            raise HTTPError(400, "query-template and document-template are required")
        if not user_id:
            raise HTTPError(400, "user-id is required")
        user = self.data.get_user(user_id)
        if user is None:
            raise HTTPError(404, "user not found")
        try:
            query_tpl = template.from_string(base64.b64decode(q_b64).decode())
            doc_tpl = template.from_string(base64.b64decode(d_b64).decode())
        except Exception as e:  # a bad template is the client's error
            raise HTTPError(400, f"invalid template: {e}")
        cfg = self.master.config.recommend
        feedback = []
        for f in self.data.get_user_feedback(user_id):
            if len(feedback) >= cfg.context_size:
                break
            if match_any(cfg.data_source.positive_feedback_types, f.feedback_type, f.value):
                item = self.data.get_item(f.item_id)
                if item is not None:
                    feedback.append((f.feedback_type, item))
        scores = self.cache.search_scores(ck_mod.RECOMMEND, user_id)
        items = self.data.batch_get_items([s.id for s in scores])
        return {
            "query": query_tpl.render(user=user, feedback=feedback),
            "documents": [doc_tpl.render(item=it) for it in items],
        }

    def get_ui(self, req):
        """The embedded single-file dashboard UI (reference: the gorse
        dashboard frontend served by the master); the port's copy of
        gorse_tpu/serve/dashboard.html. Its first line is the summary that
        /apidocs.json gives, as in the reference."""
        from pathlib import Path

        html = (Path(__file__).parent / "dashboard.html").read_bytes()
        return RawResponse(html, "text/html; charset=utf-8")

    # ---------------------------------------------------------------- login

    _public_paths = ("/", "/login", "/callback/oauth2", "/logout", "/apidocs.json")
    _PROTECTED_PREFIXES = (
        "/api/admin",
        "/api/dashboard",
        "/api/dump",
        "/api/restore",
        "/api/import",
        "/api/export",
        "/api/bulk",
        "/api/purge",
        "/api/chat",
    )

    def dispatch(self, method, path, query, body, headers):
        # admin/dashboard routes (incl. /api/admin node sync, which carries
        # the full config with credentials) require a login session or the
        # admin API key whenever either protection is configured
        # (reference: master/rest.go:344-366 + master.admin_api_key)
        hl = {k.lower(): v for k, v in headers.items()}
        mcfg = self.master.config.master
        login_configured = bool(mcfg.dashboard_user_name) or self.oidc is not None
        admin_key = mcfg.admin_api_key
        if (login_configured or admin_key) and path.startswith(self._PROTECTED_PREFIXES):
            authed = self._session_ok(hl) or (
                bool(admin_key) and hl.get("x-api-key") == admin_key
            )
            if not authed:
                return 401, {"error": "unauthorized"}
        return super().dispatch(method, path, query, body, headers)

    def _session_ok(self, headers: dict) -> bool:
        return self.sessions.from_cookie_header(headers.get("cookie")) is not None

    @staticmethod
    def _session_cookie(token: str) -> str:
        return f"{SessionManager.COOKIE}={token}; Path=/; HttpOnly"

    def get_login(self, req):
        if self.oidc is not None:
            # OIDC enabled: send the browser to the provider (master/rest.go:355-358)
            return Redirect(self.oidc.auth_url(self.oidc.new_state()))
        msg = req.query.get("msg", "")
        return RawResponse(
            _LOGIN_FORM.format(
                msg=f"<p>{html.escape(msg)}</p>" if msg else ""
            ).encode(),
            "text/html",
        )

    def post_login(self, req):
        body = req.body or {}
        cfg = self.master.config.master
        if not cfg.dashboard_user_name:
            raise HTTPError(400, "dashboard login is not configured")
        if (
            body.get("user_name") == cfg.dashboard_user_name
            and body.get("password") == cfg.dashboard_password
        ):
            token = self.sessions.issue(
                {"Name": cfg.dashboard_user_name, "AuthType": "basic"}
            )
            return Redirect("/", set_cookie=self._session_cookie(token))
        return Redirect("/login?msg=incorrect")  # reference: master/rest.go:379

    def oauth2_callback(self, req):
        if self.oidc is None:
            raise HTTPError(404, "OIDC is not enabled")
        state = req.query.get("state", "")
        if not self.oidc.check_state(state):
            raise HTTPError(401, "invalid state")
        try:
            claims = self.oidc.exchange(req.query.get("code", ""))
        except Exception as e:  # the provider's errors answer 401
            raise HTTPError(401, f"token exchange failed: {e}")
        token = self.sessions.issue(
            {
                "Name": claims.get("name", claims.get("sub", "")),
                "Email": claims.get("email", ""),
                "AuthType": "oidc",
            }
        )
        return Redirect("/", set_cookie=self._session_cookie(token))


    def get_logout(self, req):
        expired = f"{SessionManager.COOKIE}=; Path=/; Max-Age=0"
        return Redirect("/login", set_cookie=expired)

    def get_userinfo(self, req) -> dict:
        """Reference: 'Get login user information' (master/rest.go:88)."""
        info = self.sessions.from_cookie_header(req.headers.get("cookie"))
        if info is None:
            raise HTTPError(401, "not logged in")
        return info

    # ------------------------------------------------------------ dashboard

    def get_cluster(self, req) -> list:
        nodes = self.master.meta.list_nodes()
        return [
            {
                "UUID": n.uuid,
                "Hostname": n.hostname,
                "Type": n.node_type,
                "Version": n.version,
                "UpdateTime": n.update_time,
            }
            for n in nodes
        ]

    def get_stats(self, req) -> dict:
        """Full status payload (reference: getStats master/rest.go:638-730 —
        counters come from the global_meta cache keys the task loop writes,
        falling back to live data-store counts before the first run)."""
        def meta_int(name: str, fallback: int = 0) -> int:
            raw = self.cache.get(key(ck_mod.GLOBAL_META, name))
            return int(raw) if raw else fallback

        def meta_time(name: str) -> float:
            raw = self.cache.get(key(ck_mod.GLOBAL_META, name))
            return float(raw) if raw else 0.0

        nodes = self.master.meta.list_nodes()
        cf_meta = json.loads(self.master.meta.get("CF_MODEL_META") or "null") or {}
        return {
            "Version": __version__,
            "BinaryVersion": __version__,
            "NumServers": sum(1 for n in nodes if n.node_type == "server"),
            "NumWorkers": sum(1 for n in nodes if n.node_type == "worker"),
            "NumUsers": meta_int(ck_mod.NUM_USERS, self.data.count_users()),
            "NumItems": meta_int(ck_mod.NUM_ITEMS, self.data.count_items()),
            "NumUserLabels": meta_int(ck_mod.NUM_USER_LABELS),
            "NumItemLabels": meta_int(ck_mod.NUM_ITEM_LABELS),
            "NumTotalPosFeedback": meta_int(
                ck_mod.NUM_TOTAL_POS_FEEDBACKS, self.data.count_feedback()
            ),
            "NumValidPosFeedback": meta_int(ck_mod.NUM_VALID_POS_FEEDBACKS),
            "NumValidNegFeedback": meta_int(ck_mod.NUM_VALID_NEG_FEEDBACKS),
            "PopularItemsUpdateTime": meta_time(ck_mod.LAST_UPDATE_POPULAR_ITEMS_TIME),
            "LatestItemsUpdateTime": meta_time(ck_mod.LAST_UPDATE_LATEST_ITEMS_TIME),
            "MatchingModelFitTime": float(self.cache.get(ck_mod.LAST_FIT_MATCHING_MODEL_TIME) or 0),
            "MatchingModelScore": {"NDCG": cf_meta.get("score", 0.0)},
            "RankingModelFitTime": float(self.cache.get(ck_mod.LAST_FIT_RANKING_MODEL_TIME) or 0),
            # kept for the embedded dashboard UI + CLI `stats`
            "NumTotalPos": self.data.count_feedback(),
            "CFModel": self.master.meta.get("COLLABORATIVE_FILTERING_MODEL") or "",
            "RankingModel": self.master.meta.get("CLICK_THROUGH_RATE_MODEL") or "",
        }

    def get_tasks(self, req) -> list:
        return self.master.progress.list()

    def get_timeseries(self, req) -> list:
        points = self.cache.get_time_series_points(req.params["name"], 0, time.time())
        return [{"Name": p.name, "Timestamp": p.timestamp, "Value": p.value} for p in points]

    def get_config(self, req) -> dict:
        cfg = json.loads(self.config.to_json())
        if self.config.master.dashboard_redacted:
            # hide store URLs/credentials from dashboard viewers
            # (reference: getConfig deletes "database", master/rest.go:594-601)
            cfg.pop("database", None)
        return cfg

    def post_config(self, req) -> dict:
        """Persist a recommend-config override into the meta store and apply
        it live (reference: master/master.go:160-172)."""
        override = req.body or {}
        merged = json.loads(self.config.to_json())
        merged["recommend"].update(override.get("recommend", override))
        new_cfg = Config.from_json(json.dumps(merged))
        new_cfg.validate()
        self.master.meta.put(RECOMMEND_CONFIG, json.dumps(override))
        self.config.recommend = new_cfg.recommend
        return {"status": "ok"}

    def delete_config(self, req) -> dict:
        self.master.meta.delete(RECOMMEND_CONFIG)
        return {"status": "ok"}

    def get_config_schema(self, req) -> dict:
        """JSON-schema-ish description generated from the dataclass tree
        (reference: invopop jsonschema, master/rest.go:116)."""

        def schema_of(cls):
            if not dataclasses.is_dataclass(cls):
                return {"type": "any"}
            import typing

            hints = typing.get_type_hints(cls)
            props = {}
            for f in dataclasses.fields(cls):
                t = hints.get(f.name, str)
                if dataclasses.is_dataclass(t) if isinstance(t, type) else False:
                    props[f.name] = schema_of(t)
                else:
                    props[f.name] = {"type": getattr(t, "__name__", str(t))}
            return {"type": "object", "properties": props}

        return schema_of(Config)

    def get_categories(self, req) -> list:
        cats = set()
        for item in self.data.get_items():
            cats.update(item.categories)
        return sorted(cats)

    def post_schedule(self, req) -> dict:
        self.master.trigger()
        return {"status": "scheduled"}

    # ------------------------------------------------------------ node sync

    def post_meta(self, req) -> dict:
        """Node registration + meta distribution (reference: GetMeta
        master/rpc.go:29-79). Body: {uuid, hostname, type, version}."""
        b = req.body or {}
        if b.get("uuid"):
            self.master.meta.update_node(
                Node(
                    uuid=b["uuid"],
                    hostname=b.get("hostname", ""),
                    node_type=b.get("type", "worker"),
                    version=b.get("version", ""),
                )
            )
        return self.master.get_meta()

    def post_progress(self, req) -> dict:
        """Worker progress push (reference: PushProgress master/rpc.go:81-98)."""
        b = req.body or {}
        self.master.progress.push_remote(b.get("uuid", "unknown"), b.get("spans", []))
        return {"status": "ok"}

    # -------------------------------------------------------------- metrics

    def get_metrics(self, req) -> RawResponse:
        # scrape-time refresh of the catalog gauges (the task loop also sets
        # these at load time; reference names: gorse_master_*, master/metrics.go)
        self.metrics.gauge_set("master_users_total", self.data.count_users())
        self.metrics.gauge_set("master_items_total", self.data.count_items())
        self.metrics.gauge_set("master_feedbacks_total", self.data.count_feedback())
        # memory accounting (reference: MemoryInUseBytesVec{data=...},
        # master/tasks.go:211-222) — process RSS as its own series
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        self.metrics.gauge_set(
                            "master_memory_inuse_bytes",
                            int(line.split()[1]) * 1024,
                            labels={"data": "process_rss"},
                        )
                        break
        except OSError:
            pass
        for comp, nbytes in getattr(self.master, "memory_inuse", {}).items():
            self.metrics.gauge_set(
                "master_memory_inuse_bytes", nbytes, labels={"data": comp}
            )
        return RawResponse(self.metrics.render().encode(), "text/plain; version=0.0.4")

    # ------------------------------------------------------------ bulk data

    def get_dump(self, req) -> RawResponse:
        buf = io.BytesIO()
        dump_mod.dump(self.data, buf)
        return RawResponse(buf.getvalue())

    def post_restore(self, req) -> dict:
        if not isinstance(req.body, (bytes, bytearray)):
            raise HTTPError(400, "restore expects a binary dump stream")
        counts = dump_mod.restore(self.data, io.BytesIO(bytes(req.body)))
        return counts

    def _export(self, fn) -> RawResponse:
        buf = io.StringIO()
        fn(self.data, buf)
        return RawResponse(buf.getvalue().encode(), "text/csv")

    def _import(self, req, fn) -> dict:
        if isinstance(req.body, (bytes, bytearray)):
            text = bytes(req.body).decode()
        elif isinstance(req.body, str):
            text = req.body
        else:
            raise HTTPError(400, "import expects a CSV payload")
        n = fn(self.data, io.StringIO(text))
        return {"RowAffected": n}

    _BULK = {
        "users": ("export_users_jsonl", "import_users_jsonl"),
        "items": ("export_items_jsonl", "import_items_jsonl"),
        "feedback": ("export_feedback_jsonl", "import_feedback_jsonl"),
    }

    def _bulk_export(self, kind: str) -> RawResponse:
        buf = io.StringIO()
        getattr(dump_mod, self._BULK[kind][0])(self.data, buf)
        return RawResponse(
            buf.getvalue().encode(),
            "application/jsonl",
            headers={"Content-Disposition": f"attachment;filename={kind}.jsonl"},
        )

    @staticmethod
    def _multipart_file(raw: bytes, content_type: str) -> bytes:
        """Extract the `file` part from a multipart/form-data body (the
        reference reads request.FormFile("file"), master/rest.go:1315)."""
        import email.parser
        import email.policy

        msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + raw
        )
        for part in msg.iter_parts():
            if part.get_param("name", header="content-disposition") == "file":
                return part.get_payload(decode=True) or b""
        raise HTTPError(400, "multipart body has no `file` part")

    def _bulk_import(self, req, kind: str) -> dict:
        raw = req.body
        if not isinstance(raw, (bytes, bytearray)):
            raise HTTPError(400, "import expects a JSONL payload")
        ctype = req.headers.get("content-type", "")
        if ctype.startswith("multipart/"):
            raw = self._multipart_file(bytes(raw), ctype)
        try:
            n = getattr(dump_mod, self._BULK[kind][1])(
                self.data, io.StringIO(bytes(raw).decode())
            )
        except ValueError as e:
            raise HTTPError(400, str(e))
        self.master.trigger()  # new data: re-run the task loop (rest.go:1361-1365)
        return {"RowAffected": n}

    _PURGE_CHECKLIST = frozenset(
        {"delete_users", "delete_items", "delete_feedback", "delete_cache"}
    )

    def post_purge(self, req) -> dict:
        """Wipe the data + cache stores after an explicit confirmation
        checklist (reference: master/rest.go:1630-1670)."""
        if not self.master.config.master.dashboard_password:
            raise HTTPError(401, "purge is not allowed without dashboard password")
        body = req.body if isinstance(req.body, dict) else {}
        checked = set(filter(None, str(body.get("check_list", "")).split(",")))
        if checked != self._PURGE_CHECKLIST:
            raise HTTPError(401, "please confirm by checking all")
        self.data.purge()
        self.cache.purge()
        return {"status": "ok"}

    def post_chat_completions(self, req):
        """Proxy a chat completion to the configured OpenAI endpoint
        (reference: master/rest.go:2042-2127). `stream: true` responses come
        back SSE-framed; the upstream call itself is buffered (stdlib server —
        documented divergence from the reference's incremental flush)."""
        from ..llm.client import OpenAIClient

        cfg = self.master.config.openai
        if not cfg.base_url:
            raise HTTPError(400, "OpenAI endpoint is not configured")
        body = req.body if isinstance(req.body, dict) else {}
        client = OpenAIClient.from_config(cfg)
        stream = bool(body.get("stream"))
        try:
            resp = client.chat_completion_raw(body)
        except ValueError as e:
            raise HTTPError(400, str(e))
        if not stream:
            return resp
        chunk = dict(resp, object="chat.completion.chunk")
        chunk["choices"] = [
            {
                "index": c.get("index", 0),
                "delta": c.get("message", {}),
                "finish_reason": c.get("finish_reason"),
            }
            for c in resp.get("choices", [])
        ]
        sse = f"data: {json.dumps(chunk)}\n\ndata: [DONE]\n\n"
        return RawResponse(
            sse.encode(),
            "text/event-stream",
            headers={"Cache-Control": "no-cache, no-transform"},
        )
