"""External recommenders (port of gorse_tpu/logics/external.py).

Covers gorse's logics/external.go (:29-101), which runs user-supplied
JavaScript with an injected ``fetch`` in a QuickJS VM, pulling a JSON array of
item ids per user (config.ExternalConfig{Name, Script},
config/config.go:367-370). Three source types:

- ``type = "js"`` (the reference's semantics): a JavaScript ``script`` run by
  the embedded mini-JS interpreter (utils/minijs.py) with a global ``user_id``
  and a synchronous ``fetch`` implementing the same Request/Response subset as
  the reference (method/headers/url/body in; ok/status/statusText/body/headers
  out — external.go:103-215). The script's completion value must be a JSON
  array string or an array of item ids (external.go:80-97).
- ``type = "http"``: pull item ids from an HTTP endpoint
  (``GET <url>?user_id=...`` returning a JSON array of item ids) — a shortcut
  for the dominant use of the JS hook.
- ``type = "python"``: a registered Python callable ``(user_id) -> [item_id]``
  for in-process extensions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import urllib.parse
import urllib.request
from typing import Any, Callable

from ..utils import minijs

_REGISTRY: dict[str, Callable[[str], list[str]]] = {}


def register_external(name: str, fn: Callable[[str], list[str]]) -> None:
    """Register an in-process external recommender callable."""
    _REGISTRY[name] = fn


@dataclasses.dataclass
class ExternalConfig:
    """Mirror of config.ExternalConfig (+ transport variants)."""

    name: str
    type: str = "python"  # js | python | http
    url: str = ""
    script: str = ""
    timeout: float = 5.0

    def digest(self) -> str:
        return hashlib.md5(
            f"{self.name}|{self.type}|{self.url}|{self.script}".encode()
        ).hexdigest()


def _js_fetch(timeout: float) -> Callable[..., Any]:
    """The reference's fetch host function (external.go:103-215): accepts
    ``fetch(url)``, ``fetch(request)``, or ``fetch(url, request)``; returns a
    Fetch-API-shaped Response object."""

    def fetch(*args: Any) -> Any:
        url = ""
        req: dict[str, Any] = {}
        if len(args) == 1:
            if isinstance(args[0], str):
                url = args[0]
            elif isinstance(args[0], dict):
                req = args[0]
            else:
                raise minijs.JSThrow(minijs.make_error(
                    "TypeError", "fetch requires first argument to be string or object"))
        elif len(args) == 2:
            if not isinstance(args[0], str):
                raise minijs.JSThrow(minijs.make_error(
                    "TypeError", "fetch requires first argument to be string"))
            if not isinstance(args[1], dict):
                raise minijs.JSThrow(minijs.make_error(
                    "TypeError", "fetch requires second argument to be object"))
            url, req = args[0], args[1]
        else:
            raise minijs.JSThrow(minijs.make_error(
                "TypeError", "fetch requires 1 or 2 arguments"))

        method = "GET"
        headers: dict[str, str] = {}
        body = b""
        if req:
            if isinstance(req.get("method"), str):
                method = req["method"]
            if isinstance(req.get("headers"), dict):
                headers = {str(k): minijs.js_str(v)
                           for k, v in req["headers"].items()}
            if isinstance(req.get("url"), str):
                url = req["url"]
            if req.get("body") not in (None, minijs.UNDEFINED):
                body = minijs.js_str(req["body"]).encode()

        if not url.startswith(("http://", "https://")):
            raise minijs.JSThrow(minijs.make_error(
                "TypeError", f"fetch: unsupported URL {url!r}"))
        request = urllib.request.Request(url, data=body or None, method=method)
        for k, v in headers.items():
            request.add_header(k, v)
        try:
            with urllib.request.urlopen(request, timeout=timeout) as resp:
                status = resp.status
                reason = getattr(resp, "reason", "") or ""
                resp_body = resp.read().decode(errors="replace")
                resp_headers = {k: v for k, v in resp.headers.items()}
        except urllib.error.HTTPError as e:  # non-2xx still yields a Response
            status = e.code
            reason = e.reason if isinstance(e.reason, str) else ""
            resp_body = e.read().decode(errors="replace")
            resp_headers = {k: v for k, v in e.headers.items()} if e.headers else {}
        except Exception as e:  # noqa: BLE001 — network errors throw in JS
            raise minijs.JSThrow(minijs.make_error("Error", f"fetch: {e}")) from None
        return {
            "ok": 200 <= status < 300,
            "status": float(status),
            # the reference sets resp.Status, Go's "200 OK" form
            "statusText": f"{status} {reason}".strip(),
            "body": resp_body,
            "headers": resp_headers,
        }

    return fetch


class External:
    def __init__(self, cfg: ExternalConfig) -> None:
        self.cfg = cfg

    def pull(self, user_id: str) -> list[str]:
        cfg = self.cfg
        kind = getattr(cfg, "type", "") or ("js" if getattr(cfg, "script", "") else "python")
        if kind == "js":
            return self._pull_js(user_id)
        if kind == "python":
            fn = _REGISTRY.get(cfg.name)
            if fn is None:
                return []
            out = fn(user_id)
            return [str(i) for i in out]
        if kind == "http":
            q = urllib.parse.urlencode({"user_id": user_id})
            url = f"{cfg.url}?{q}" if "?" not in cfg.url else f"{cfg.url}&{q}"
            try:
                with urllib.request.urlopen(url, timeout=cfg.timeout) as resp:
                    data = json.loads(resp.read().decode())
            except Exception:
                return []
            if isinstance(data, list):
                return [str(i) for i in data]
            return []
        raise ValueError(f"unknown external type {cfg.type!r}")

    def _pull_js(self, user_id: str) -> list[str]:
        """Run the configured script; the completion value is the item list
        (reference: External.Pull, external.go:60-101 — string or object,
        JSON-unmarshalled to []string)."""
        interp = minijs.Interpreter()
        interp.set_global("user_id", user_id)
        interp.register("fetch", _js_fetch(getattr(self.cfg, "timeout", 5.0)))
        result = interp.eval(self.cfg.script)
        if isinstance(result, str):
            data = json.loads(result)
        elif isinstance(result, (list, dict)):
            data = json.loads(minijs.js_str(
                minijs._json_stringify(interp, result)))
        else:
            raise TypeError("script must return string or object")
        if not isinstance(data, list):
            raise TypeError("script result must be a JSON array of item ids")
        return [i if isinstance(i, str) else json.dumps(i) for i in data]


def get_external(cfg: ExternalConfig) -> External:
    return External(cfg)
