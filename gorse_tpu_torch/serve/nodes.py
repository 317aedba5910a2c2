"""The server and worker nodes as processes of their own (port of
gorse_tpu/serve/nodes.py).

Nodes register with the master, poll it for the config, the model ids and
the peer lists, and serve or compute against the stores the config names,
as gorse's cmd/gorse-server and cmd/gorse-worker do. gorse's gRPC Master
service (GetMeta, PushProgress) maps to the master's HTTP ``POST
/api/admin/meta`` and ``/api/admin/progress`` (serve/dashboard.py). A
master whose data store is node-local runs its gRPC storage proxy
(cmd/nodes_main.py) and names it in the config it hands out: the nodes
open ``proxy://host:port`` stores (storage/proxy.py), over mutual TLS with
``tls``, gorse's ``--ssl-*`` flags. A ``memory://`` store that still
arrives (a master without the proxy) would be a private, empty one in the
node's process, so a node refuses it (``UnsharedStoreError``). With
``tracing.enable`` in the config, the server node traces its requests as
gorse's server does. ``WorkerNode`` runs its pipeline on ``device``
(``None``: the card; without CUDA it raises).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import tempfile
import threading
import urllib.request
import uuid as uuid_mod

from .. import __version__, resolve_device
from ..storage.cache import open_cache_store_from_config
from ..storage.data import open_data_store_from_config
from ..storage.object import open_blob_store_from_config
from ..utils.config import Config
from ..utils.tracing import configure_from
from .rest import RestServer
from .worker import Worker

logger = logging.getLogger(__name__)


class UnsharedStoreError(RuntimeError):
    """The master names a store that lives only in its own process."""


def _shared_stores(config: Config) -> None:
    """Raise when the data or cache store the master names lives only in
    the master's process (``memory://``): this node would open a private,
    empty one, so writes acknowledged here would never reach the master's
    fit, nor the worker's lists the server."""
    for name in ("data_store", "cache_store"):
        url = getattr(config.database, name)
        if url.startswith("memory://") or url == "memory":
            raise UnsharedStoreError(
                f"the master's {name} {url!r} lives in its own process: nodes reach it "
                "through the master's gRPC storage proxy, which a master started by "
                "gorse-tpu-torch-master runs and names in the meta as proxy://host:port; "
                "this master handed out the store's own URL (give it its gRPC plane, or "
                "shared stores: mysql://, postgres://, redis://, mongodb:// or sqlite:// "
                "files on one host)")


class MasterClient:
    """HTTP client for the master's node-sync endpoints (the gRPC
    MasterClient analog, worker/worker.go:139-259)."""

    def __init__(
        self, master_url: str, node_type: str, node_id: str | None = None,
        api_key: str = "",
    ) -> None:
        self.master_url = master_url.rstrip("/")
        self.node_type = node_type
        self.node_id = node_id or f"{node_type}-{uuid_mod.uuid4().hex[:8]}"
        self.api_key = api_key

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            # master.admin_api_key gates /api/admin (reference: AdminAPIKey,
            # config/config.go:148); nodes authenticate with it
            h["X-API-Key"] = self.api_key
        return h

    def get_meta(self) -> dict:
        payload = json.dumps(
            {
                "uuid": self.node_id,
                "hostname": socket.gethostname(),
                "type": self.node_type,
                "version": __version__,
            }
        ).encode()
        req = urllib.request.Request(
            self.master_url + "/api/admin/meta", data=payload, headers=self._headers()
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read().decode())

    def push_progress(self, spans: list[dict]) -> None:
        payload = json.dumps({"uuid": self.node_id, "spans": spans}).encode()
        req = urllib.request.Request(
            self.master_url + "/api/admin/progress", data=payload, headers=self._headers()
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()


class ServerNode:
    """REST frontend node (reference: server/server.go): syncs config from
    the master each meta_timeout, serves the public API from the stores."""

    def __init__(self, master_url: str, meta_timeout: float = 10.0, api_key: str = "",
                 tls=None) -> None:
        self.client = MasterClient(master_url, "server", api_key=api_key)
        self.meta_timeout = meta_timeout
        self.tls = tls  # utils.tls.TLSConfig for proxy:// stores
        self.config: Config | None = None
        self.rest: RestServer | None = None
        self._stop = threading.Event()

    def sync(self) -> None:
        """Reference: Server.Sync server/server.go:152-247."""
        meta = self.client.get_meta()
        new_config = Config.from_json(meta["config"])
        if self.config is None or new_config.to_json() != self.config.to_json():
            _shared_stores(new_config)
            self.config = new_config
            configure_from(new_config)
            data = open_data_store_from_config(new_config.database, tls=self.tls)
            cache = open_cache_store_from_config(new_config.database, tls=self.tls)
            if self.rest is None:
                self.rest = RestServer(
                    new_config, data, cache, api_key=new_config.server.api_key
                )
            else:
                self.rest.config = new_config
                self.rest.data = data
                self.rest.cache = cache
                # api-key rotation must take effect without a restart
                self.rest.api_key = new_config.server.api_key
            logger.info("server config synced from master: data %s, cache %s",
                        new_config.database.data_store, new_config.database.cache_store)

    def serve(self, host: str = "127.0.0.1", port: int = 8087):
        self.sync()
        httpd = self.rest.serve(host, port)
        threading.Thread(target=self._sync_loop, daemon=True).start()
        return httpd

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.meta_timeout):
            try:
                self.sync()
            except Exception as e:  # noqa: BLE001
                logger.error("server sync failed: %s", e)

    def shutdown(self) -> None:
        self._stop.set()
        if self.rest:
            self.rest.shutdown()


class WorkerNode:
    """Offline-pipeline node (reference: worker/worker.go Serve :349-414):
    syncs config/models from the master, recomputes its rendezvous shard on
    ``device`` (``None``: the card, resolved here; without CUDA it raises)."""

    def __init__(
        self, master_url: str, meta_timeout: float = 10.0, node_id: str | None = None,
        api_key: str = "", device=None, tls=None,
    ) -> None:
        self.device = resolve_device(device)
        self.client = MasterClient(master_url, "worker", node_id=node_id, api_key=api_key)
        self.meta_timeout = meta_timeout
        self.tls = tls  # utils.tls.TLSConfig for proxy:// stores
        self.config: Config | None = None
        self.worker: Worker | None = None
        self._stop = threading.Event()

    def sync_once(self) -> int:
        """One sync + pipeline cycle; returns users refreshed."""
        meta = self.client.get_meta()
        new_config = Config.from_json(meta["config"])
        if self.worker is None or new_config.to_json() != self.config.to_json():
            _shared_stores(new_config)
            self.config = new_config
            data = open_data_store_from_config(new_config.database, tls=self.tls)
            cache = open_cache_store_from_config(new_config.database, tls=self.tls)
            blob = open_blob_store_from_config(
                new_config.blob,
                new_config.database.blob_store,
                os.path.join(tempfile.gettempdir(), "gorse_tpu_blobs"),
            )
            logger.info("worker config synced from master: data %s, cache %s",
                        new_config.database.data_store, new_config.database.cache_store)
            self.worker = Worker(
                new_config, data, cache, blob, node_id=self.client.node_id,
                device=self.device,
            )
        self.worker.pull_models(meta["cf_model_id"], meta["ctr_model_id"])
        peers = meta["workers"] or [self.client.node_id]
        users = self.worker.pull_users(peers)
        n = self.worker.recommend(users)
        self.client.push_progress(self.worker.progress.list())
        return n

    def serve(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except UnsharedStoreError:
                raise  # stores no node can share: no later cycle would do better
            except Exception as e:  # noqa: BLE001
                logger.error("worker cycle failed: %s", e)
            self._stop.wait(self.meta_timeout)

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve, daemon=True)
        t.start()
        return t

    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Health + metrics endpoint (reference: the worker's ServeHTTP,
        worker/worker.go:379,460-495)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from .metrics import MetricsRegistry

        node = self
        fallback_metrics = MetricsRegistry(namespace="gorse")

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/api/health/live":
                    body, ctype, status = b'{"status": "live"}', "application/json", 200
                elif self.path == "/api/health/ready":
                    ready = node.worker is not None and node.worker.data.ping()
                    status = 200 if ready else 503
                    body = json.dumps({"status": "ready" if ready else "not ready"}).encode()
                    ctype = "application/json"
                elif self.path == "/metrics":
                    # the pipeline worker (and its gorse_worker_* registry) is
                    # created lazily on first sync and replaced on config change
                    # — resolve at request time
                    worker = node.worker
                    metrics = worker.metrics if worker is not None else fallback_metrics
                    if worker is not None:
                        spans = worker.progress.list()
                        done = sum(1 for s in spans if s.get("Status") == "complete")
                        metrics.gauge_set("worker_tasks_complete", done)
                    body, ctype, status = metrics.render().encode(), "text/plain", 200
                else:
                    body, ctype, status = b'{"error": "not found"}', "application/json", 404
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        self._httpd = httpd
        return httpd

    def shutdown(self) -> None:
        self._stop.set()
        if getattr(self, "_httpd", None):
            self._httpd.shutdown()
            self._httpd.server_close()
