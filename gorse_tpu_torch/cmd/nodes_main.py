"""Entry points of the three node roles (port of gorse_tpu/cmd/nodes_main.py).

    gorse-tpu-torch-master --config config.toml
    gorse-tpu-torch-server --master http://127.0.0.1:8088 [--port 8087]
    gorse-tpu-torch-worker --master http://127.0.0.1:8088 [--http-port N]

As gorse's cmd/gorse-master, cmd/gorse-server and cmd/gorse-worker: a master
process that runs the task cycle on the card and serves the public API with
the dashboard and the node-sync routes (``MasterRestServer``), stateless
REST server processes, and worker processes that fill their shard's caches
on the card; the server and worker poll the master over HTTP and open the
stores by the URLs in its config. The reference's gRPC control plane and
storage proxy (its nodes_main.py:56-76) are not ported (ROADMAP.md, M21):
the nodes sync over the HTTP routes and ``Master.get_meta`` hands out the
store URLs as they are, so the nodes share SQLite files or remote stores
(a ``memory://`` store lives in the master's process alone: the nodes
refuse it). ``master.ssl_mode`` and ``tracing.enable`` raise.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import threading

from .. import resolve_device

logger = logging.getLogger(__name__)


def _logging():
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")


def build_master(config, device=None):
    """The master over the stores of ``config`` (the data, cache, blob,
    meta and vector stores) on ``device`` (``None``: the card; without
    CUDA it raises)."""
    from ..serve.master import Master
    from ..storage.cache import open_cache_store_from_config
    from ..storage.data import open_data_store_from_config
    from ..storage.meta import MetaStore
    from ..storage.object import open_blob_store_from_config
    from ..storage.vectors import open_vector_store

    if config.tracing.enable:
        raise NotImplementedError("tracing is not ported yet: ROADMAP.md M21")
    if config.master.ssl_mode:
        raise NotImplementedError("the master's TLS (master.ssl_mode) belongs to its gRPC "
                                  "control plane, which is not ported yet: ROADMAP.md M21")
    device = resolve_device(device)
    db = config.database
    data = open_data_store_from_config(db)
    cache = open_cache_store_from_config(db)
    blob = open_blob_store_from_config(
        config.blob, db.blob_store, os.path.join(tempfile.gettempdir(), "gorse_tpu_blobs")
    )
    meta = MetaStore(db.meta_store)
    vectors = open_vector_store(db.vector_store, device) if db.vector_store else None
    return Master(config, data, cache, blob, meta, device=device, vector_store=vectors)


def master_main() -> None:
    from .. import __version__
    from ..serve.dashboard import MasterRestServer
    from ..utils.config import ConfigWatcher, default_config, load_config

    parser = argparse.ArgumentParser(prog="gorse-tpu-torch-master")
    parser.add_argument("--version", action="version",
                        version=f"gorse-tpu-torch-master {__version__}")
    parser.add_argument("--config", help="TOML config path")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args()
    _logging()
    config = load_config(args.config) if args.config else default_config()
    master = build_master(config)
    logger.info("master on device %s", master.device)
    rest = MasterRestServer(master, api_key=config.server.api_key)
    rest.serve(args.host or config.master.http_host, args.port or config.master.http_port)
    master.serve_background()
    if args.config:
        def on_change(new_cfg):
            master.config.recommend = new_cfg.recommend
            master.trigger()

        ConfigWatcher(args.config, on_change).start()
    threading.Event().wait()


def server_main() -> None:
    from .. import __version__
    from ..serve.nodes import ServerNode

    # flag surface mirrors cmd/gorse-server (--master-host/--master-port/
    # --http-host/--http-port); --master URL kept as a shorthand
    parser = argparse.ArgumentParser(prog="gorse-tpu-torch-server")
    parser.add_argument("--version", action="version",
                        version=f"gorse-tpu-torch-server {__version__}")
    parser.add_argument("--api-key", default=os.environ.get("GORSE_ADMIN_API_KEY", ""),
                        help="master admin API key for /api/admin sync")
    parser.add_argument("--master", default="")
    parser.add_argument("--master-host", default="127.0.0.1")
    parser.add_argument("--master-port", type=int, default=8088)
    parser.add_argument("--http-host", "--host", dest="http_host", default="127.0.0.1")
    parser.add_argument("--http-port", "--port", dest="http_port", type=int, default=8087)
    args = parser.parse_args()
    _logging()
    master_url = args.master or f"http://{args.master_host}:{args.master_port}"
    node = ServerNode(master_url, api_key=args.api_key)
    node.serve(args.http_host, args.http_port)
    threading.Event().wait()


def worker_main() -> None:
    from .. import __version__
    from ..serve.nodes import WorkerNode

    parser = argparse.ArgumentParser(prog="gorse-tpu-torch-worker")
    parser.add_argument("--version", action="version",
                        version=f"gorse-tpu-torch-worker {__version__}")
    parser.add_argument("--api-key", default=os.environ.get("GORSE_ADMIN_API_KEY", ""),
                        help="master admin API key for /api/admin sync")
    parser.add_argument("--master", default="")
    parser.add_argument("--master-host", default="127.0.0.1")
    parser.add_argument("--master-port", type=int, default=8088)
    parser.add_argument("--http-host", dest="http_host", default="127.0.0.1")
    parser.add_argument("--http-port", dest="http_port", type=int, default=0)
    parser.add_argument("--meta-timeout", type=float, default=10.0)
    args = parser.parse_args()
    _logging()
    master_url = args.master or f"http://{args.master_host}:{args.master_port}"
    node = WorkerNode(master_url, meta_timeout=args.meta_timeout, api_key=args.api_key)
    logger.info("worker %s on device %s", node.client.node_id, node.device)
    if args.http_port:
        node.serve_http(args.http_host, args.http_port)
    node.serve()
