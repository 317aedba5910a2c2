"""Admin CLI (copy of gorse_tpu/cmd/cli.py: it speaks only HTTP, so it
drives a node of either package).

Covers the reference's cmd/gorse-cli (main.go:97-138): get users/items/
feedback, recommendations, cluster info, task list (ps), stats, config,
schedule training, dump/restore, CSV import/export, and named endpoint
contexts (context.go:299-424) — all against a running node's HTTP API.
"""

from __future__ import annotations

import argparse
import getpass
import json
import os
import re
import sys
import urllib.request


class AdminClient:
    def __init__(self, url: str, api_key: str = "") -> None:
        self.url = url.rstrip("/")
        self.api_key = api_key

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["X-API-Key"] = self.api_key
        return h

    def get(self, path: str):
        req = urllib.request.Request(self.url + path, headers=self._headers())
        with urllib.request.urlopen(req) as resp:
            body = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return json.loads(body) if "json" in ctype else body

    def post(self, path: str, payload=None, content_type: str = "application/json"):
        data = (
            json.dumps(payload).encode()
            if isinstance(payload, (dict, list))
            else (payload or b"")
        )
        headers = self._headers()
        headers["Content-Type"] = content_type
        req = urllib.request.Request(self.url + path, data=data, headers=headers)
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read().decode())

    def delete(self, path: str):
        req = urllib.request.Request(self.url + path, method="DELETE", headers=self._headers())
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read().decode())


def _json_patch(doc: dict, patch: list[dict]) -> dict:
    """Apply RFC6902 replace/add/remove ops (the subset the reference's
    `pipeline patch` uses, cmd/gorse-cli/main.go:249-294)."""
    for op in patch:
        parts = [p.replace("~1", "/").replace("~0", "~") for p in op["path"].lstrip("/").split("/")]
        target = doc
        for key in parts[:-1]:
            target = target[int(key)] if isinstance(target, list) else target.setdefault(key, {})
        leaf = parts[-1]
        kind = op.get("op", "replace")
        if kind in ("replace", "add"):
            if isinstance(target, list):
                target[int(leaf)] = op["value"]
            else:
                target[leaf] = op["value"]
        elif kind == "remove":
            if isinstance(target, list):
                target.pop(int(leaf))
            else:
                target.pop(leaf, None)
        else:
            raise ValueError(f"unsupported json-patch op {kind!r}")
    return doc


_CONTEXT_NAME = re.compile(r"^[A-Za-z0-9_.-]+$")


class Contexts:
    """Named endpoint/API-key profiles (reference: cmd/gorse-cli/context.go).

    The reference stores contexts in the OS keyring; this build uses a
    0600-mode JSON file (``~/.config/gorse-tpu/contexts.json`` by default,
    override with GORSE_CLI_CONTEXTS) since a system keyring isn't a given on
    TPU hosts. Schema: {"current": name, "contexts": {name: {endpoint, api_key}}}.
    """

    def __init__(self, path: str | None = None) -> None:
        self.path = path or os.environ.get("GORSE_CLI_CONTEXTS") or os.path.join(
            os.path.expanduser("~"), ".config", "gorse-tpu", "contexts.json"
        )

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {"current": "", "contexts": {}}
        doc.setdefault("current", "")
        doc.setdefault("contexts", {})
        return doc

    def _store(self, doc: dict) -> None:
        dirname = os.path.dirname(self.path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)

    def save(self, name: str, endpoint: str, api_key: str) -> None:
        if not _CONTEXT_NAME.match(name):
            raise ValueError(f"context name {name!r} must match {_CONTEXT_NAME.pattern!r}")
        if not endpoint:
            raise ValueError("GORSE_ADMIN_ENDPOINT or --endpoint is required")
        doc = self._load()
        doc["contexts"][name] = {"endpoint": endpoint, "api_key": api_key}
        doc["current"] = name  # add selects, as in the reference
        self._store(doc)

    def load(self, name: str) -> dict:
        ctx = self._load()["contexts"].get(name)
        if ctx is None:
            raise KeyError(f"context {name!r} not found")
        return ctx

    def names(self) -> list[str]:
        return sorted(self._load()["contexts"])

    def current(self) -> str:
        return self._load()["current"]

    def use(self, name: str) -> None:
        doc = self._load()
        if name not in doc["contexts"]:
            raise KeyError(f"context {name!r} not found")
        doc["current"] = name
        self._store(doc)

    def delete(self, name: str) -> None:
        doc = self._load()
        if name not in doc["contexts"]:
            raise KeyError(f"context {name!r} not found")
        del doc["contexts"][name]
        if doc["current"] == name:
            names = sorted(doc["contexts"])
            doc["current"] = names[0] if names else ""
        self._store(doc)


def _resolve_endpoint(args) -> tuple[str, str]:
    """Flags > env > --context > current context > local default
    (reference: getEndpointAndKey, cmd/gorse-cli/context.go:207-258).

    The endpoint and API key resolve as a PAIR: a context's stored key is
    only used when the endpoint also came from that context — never sent to
    a host given via --url/env, which would leak the saved admin key."""
    endpoint = args.url or os.environ.get("GORSE_ADMIN_ENDPOINT", "")
    api_key = args.api_key or os.environ.get("GORSE_ADMIN_API_KEY", "")
    contexts = Contexts()
    if not endpoint:
        name = getattr(args, "context", "") or contexts.current()
        if name:
            try:
                ctx = contexts.load(name)
            except KeyError as exc:
                raise SystemExit(
                    f"Error: {exc.args[0]}.\nList available contexts:\n"
                    "  gorse-tpu-torch-cli context list"
                )
            endpoint = ctx["endpoint"]
            api_key = api_key or ctx.get("api_key", "")
    return endpoint or "http://127.0.0.1:8087", api_key


def _run_context(args) -> int:
    contexts = Contexts()
    if args.context_cmd == "add":
        endpoint = args.endpoint or os.environ.get("GORSE_ADMIN_ENDPOINT", "")
        api_key = args.key or os.environ.get("GORSE_ADMIN_API_KEY", "")
        if not api_key and not args.no_prompt:
            api_key = getpass.getpass("gorse admin API key: ")
        try:
            contexts.save(args.name, endpoint, api_key)
        except ValueError as exc:
            print(f"Error: {exc}", file=sys.stderr)
            return 1
        print(f"Context {args.name!r} saved and selected.")
    elif args.context_cmd == "list":
        names = contexts.names()
        if not names:
            print("No contexts configured.")
            return 0
        current = contexts.current()
        for name in names:
            marker = "*" if name == current else " "
            print(f"{marker} {name}\t{contexts.load(name)['endpoint']}")
    elif args.context_cmd == "use":
        try:
            contexts.use(args.name)
        except KeyError as exc:
            print(f"Error: {exc.args[0]}", file=sys.stderr)
            return 1
        print(f"Switched to context {args.name!r}.")
    elif args.context_cmd == "delete":
        try:
            contexts.delete(args.name)
        except KeyError as exc:
            print(f"Error: {exc.args[0]}", file=sys.stderr)
            return 1
        print(f"Context {args.name!r} deleted.")
    elif args.context_cmd == "current":
        name = contexts.current()
        if not name:
            print("No current context.")
        else:
            print(f"Name:\t\t{name}\nEndpoint:\t{contexts.load(name)['endpoint']}")
    return 0


def _print(obj) -> None:
    if isinstance(obj, bytes):
        sys.stdout.buffer.write(obj)
    else:
        print(json.dumps(obj, indent=2))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="gorse-tpu-torch-cli",
                                     description="gorse_tpu_torch admin CLI")
    parser.add_argument("--url", default="", help="node base URL (default: context or http://127.0.0.1:8087)")
    parser.add_argument("--api-key", default="")
    parser.add_argument("--context", default="", help="named context to use for this invocation")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("context", help="manage endpoint/API-key profiles")
    csub = p.add_subparsers(dest="context_cmd", required=True)
    pc = csub.add_parser("add", help="add or update a context (and select it)")
    pc.add_argument("name")
    pc.add_argument("--endpoint", default="")
    pc.add_argument("--key", default="", help="admin API key (prompted if omitted)")
    pc.add_argument("--no-prompt", action="store_true")
    csub.add_parser("list")
    pc = csub.add_parser("use")
    pc.add_argument("name")
    pc = csub.add_parser("delete")
    pc.add_argument("name")
    csub.add_parser("current")

    sub.add_parser("version")
    sub.add_parser("cluster-info", help="list cluster nodes")
    sub.add_parser("ps", help="list running/finished tasks")
    sub.add_parser("stats")
    sub.add_parser("config")
    sub.add_parser("schedule", help="trigger a training cycle now")
    sub.add_parser("health")

    p = sub.add_parser("get", help="get users/items/feedback/recommendations")
    p.add_argument("what", choices=["user", "item", "users", "items", "feedback", "categories"])
    p.add_argument("id", nargs="?", default="")
    p.add_argument("-n", type=int, default=10)

    # recommendation previews (reference: gorse-cli get item-to-item/...)
    for preview in ("item-to-item", "user-to-user", "non-personalized"):
        p = sub.add_parser(preview, help=f"{preview} recommendations")
        p.add_argument("name")
        if preview != "non-personalized":
            p.add_argument("id")
        p.add_argument("-n", type=int, default=10)
    p = sub.add_parser("item-to-user", help="per-recommender preview for a user")
    p.add_argument("user_id")
    p.add_argument("recommender", nargs="?", default="")
    p.add_argument("name", nargs="?", default="")
    p.add_argument("-n", type=int, default=10)

    # pipeline config management (reference: gorse-cli pipeline {schema,patch,reset})
    p = sub.add_parser("pipeline", help="recommendation pipeline configuration")
    psub = p.add_subparsers(dest="pipeline_cmd", required=True)
    psub.add_parser("show")
    psub.add_parser("schema")
    pp = psub.add_parser("patch")
    pp.add_argument("json_patch", help='RFC6902 ops, e.g. \'[{"op":"replace","path":"/cache_size","value":1000}]\'')
    pr = psub.add_parser("reset")
    pr.add_argument("-y", action="store_true", help="skip confirmation")

    p = sub.add_parser("recommend")
    p.add_argument("user_id")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--category", default="")

    p = sub.add_parser("popular")
    p.add_argument("-n", type=int, default=10)
    p = sub.add_parser("latest")
    p.add_argument("-n", type=int, default=10)

    p = sub.add_parser("dump")
    p.add_argument("path")
    p = sub.add_parser("restore")
    p.add_argument("path")

    p = sub.add_parser("export")
    p.add_argument("what", choices=["users", "items", "feedback"])
    p.add_argument("path")
    p = sub.add_parser("import")
    p.add_argument("what", choices=["users", "items", "feedback"])
    p.add_argument("path")

    args = parser.parse_args(argv)
    if args.cmd == "context":
        return _run_context(args)
    endpoint, api_key = _resolve_endpoint(args)
    client = AdminClient(endpoint, api_key)

    if args.cmd == "version":
        from .. import __version__

        print(__version__)
    elif args.cmd == "cluster-info":
        _print(client.get("/api/dashboard/cluster"))
    elif args.cmd == "ps":
        _print(client.get("/api/dashboard/tasks"))
    elif args.cmd == "stats":
        _print(client.get("/api/dashboard/stats"))
    elif args.cmd == "config":
        _print(client.get("/api/dashboard/config"))
    elif args.cmd == "schedule":
        _print(client.post("/api/dashboard/schedule", {}))
    elif args.cmd == "health":
        _print(client.get("/api/health/ready"))
    elif args.cmd == "get":
        if args.what in ("user", "item"):
            _print(client.get(f"/api/{args.what}/{args.id}"))
        elif args.what == "feedback":
            _print(client.get(f"/api/user/{args.id}/feedback" if args.id else "/api/feedback"))
        elif args.what == "categories":
            _print(client.get("/api/dashboard/categories"))
        else:
            _print(client.get(f"/api/{args.what}?n={args.n}"))
    elif args.cmd == "item-to-item":
        _print(client.get(f"/api/item-to-item/{args.name}/{args.id}?n={args.n}"))
    elif args.cmd == "user-to-user":
        _print(client.get(f"/api/user-to-user/{args.name}/{args.id}?n={args.n}"))
    elif args.cmd == "non-personalized":
        _print(client.get(f"/api/non-personalized/{args.name}?n={args.n}"))
    elif args.cmd == "item-to-user":
        path = f"/api/dashboard/recommend/{args.user_id}"
        if args.recommender:
            path += f"/{args.recommender}"
            if args.name:
                path += f"/{args.name}"
        _print(client.get(f"{path}?n={args.n}"))
    elif args.cmd == "pipeline":
        if args.pipeline_cmd == "show":
            _print(client.get("/api/dashboard/config"))
        elif args.pipeline_cmd == "schema":
            _print(client.get("/api/dashboard/config/schema"))
        elif args.pipeline_cmd == "patch":
            # patch paths are relative to the recommend section, as in the
            # reference (`/cache_size`, `/data_source/item_ttl`, ...)
            current = client.get("/api/dashboard/config")["recommend"]
            patched = _json_patch(current, json.loads(args.json_patch))
            _print(client.post("/api/dashboard/config", {"recommend": patched}))
        elif args.pipeline_cmd == "reset":
            if not args.y:
                answer = input(
                    "Reset pipeline configuration to file defaults? [y/N]: "
                )
                if answer.strip().lower() != "y":
                    print("Pipeline reset canceled")
                    return 0
            _print(client.delete("/api/dashboard/config"))
    elif args.cmd == "recommend":
        path = f"/api/recommend/{args.user_id}"
        if args.category:
            path += f"/{args.category}"
        _print(client.get(f"{path}?n={args.n}"))
    elif args.cmd in ("popular", "latest"):
        _print(client.get(f"/api/{args.cmd}?n={args.n}"))
    elif args.cmd == "dump":
        blob = client.get("/api/dump")
        with open(args.path, "wb") as f:
            f.write(blob)
        print(f"dumped to {args.path}")
    elif args.cmd == "restore":
        with open(args.path, "rb") as f:
            _print(client.post("/api/restore", f.read(), "application/octet-stream"))
    elif args.cmd == "export":
        body = client.get(f"/api/export/{args.what}")
        with open(args.path, "wb") as f:
            f.write(body)
        print(f"exported to {args.path}")
    elif args.cmd == "import":
        with open(args.path, "rb") as f:
            _print(client.post(f"/api/import/{args.what}", f.read(), "text/csv"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
