"""Entry points of the three node roles (port of gorse_tpu/cmd/nodes_main.py).

    gorse-tpu-torch-master --config config.toml
    gorse-tpu-torch-server --master http://127.0.0.1:8088 [--port 8087] [--ssl-mode ...]
    gorse-tpu-torch-worker --master http://127.0.0.1:8088 [--http-port N] [--ssl-mode ...]

As gorse's cmd/gorse-master, cmd/gorse-server and cmd/gorse-worker: a master
process that runs the task cycle on the card, serves the public API with
the dashboard and the node-sync routes (``MasterRestServer``) and its gRPC
plane on ``master.host:master.port`` (protocol/rpc.py: the Master and
BlobStore services, and the storage proxy of its data and cache stores
when the data store is node-local, ``memory://`` or ``sqlite://``; mutual
TLS with ``master.ssl_mode``); stateless REST server processes; and worker
processes that fill their shard's caches on the card. The server and worker
poll the master over HTTP and open the stores by the URLs in its config:
``proxy://`` where the master proxies them, over TLS with ``--ssl-mode``
(gorse's ``--ssl-*`` flags). The master and the server install the
config's tracer; each process, on SIGTERM or SIGINT, stops its work,
flushes the tracer, logs its kernels' launches and exits 0. Both signals
are held from the start of a process until its handlers are in place, so
one sent while its servers start (they answer at once) waits for them.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import tempfile
import threading
import time

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


def kernel_launches() -> dict:
    """Each kernel wrapper's launches in this process, by name."""
    from ..ops import bpr_kernel, topk

    names = {topk: ("block_max", "block_max_sq", "block_seeds", "block_topk", "block_topk_sq",
                    "merge_topk", "bin_max", "bin_max_sq"),
             bpr_kernel: ("bpr_sweep_sampled", "bpr_sweep_pairs", "bpr_epoch")}
    return {name: getattr(module, name).launches for module, group in names.items()
            for name in group}


_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def hold_signals() -> None:
    """Hold SIGTERM and SIGINT in the calling thread, and in every thread it
    starts from now on, until :func:`_serve_until_signal` has its handlers
    in place: a signal sent meanwhile stays pending and lands there. Only
    the main thread releases them. The threads started meanwhile (the REST
    and gRPC servers, the master's loop, the config watcher, the worker's
    cycle) keep both held for good, so the process's signals reach the main
    thread, and so do the processes such a thread starts: an ``nvcc`` build
    of the kernels at their first use ignores both until it ends."""
    signal.pthread_sigmask(signal.SIG_BLOCK, _SIGNALS)


def _serve_until_signal(stop, work: threading.Thread | None = None) -> None:
    """Install the SIGTERM and SIGINT handlers, release the signals
    :func:`hold_signals` held, wait for one, then ``stop()``, flush the
    tracer, log the kernels' launches and exit 0; exit 1 if ``work`` ends
    first. The handler only sets a plain flag (it takes no lock the main
    thread may hold); the loop reads it every 0.1 s."""
    from ..utils.tracing import tracer

    signalled = []
    for sig in _SIGNALS:
        signal.signal(sig, lambda *_: signalled.append(True))
    signal.pthread_sigmask(signal.SIG_UNBLOCK, _SIGNALS)  # a held signal lands here
    code = 0
    while not signalled:
        if work is not None and not work.is_alive():
            code = 1
            break
        time.sleep(0.1)
    try:
        stop()
        tracer().flush()
    finally:
        logger.info("kernel launches %s", json.dumps(kernel_launches()))
        logging.shutdown()
        os._exit(code)  # the daemon threads (stores, servers) end with the process


def grpc_tls(config):
    """The master's TLSConfig when ``master.ssl_mode`` is on, else None."""
    from ..utils.tls import TLSConfig

    m = config.master
    return TLSConfig(m.ssl_ca, m.ssl_cert, m.ssl_key) if m.ssl_mode else None


def serve_grpc_plane(master, config):
    """The master's gRPC plane on ``master.host:master.port``, mutual TLS
    with ``master.ssl_mode``, its data and cache stores proxied when the
    data store is node-local (the reference's rule); (server, port)."""
    from ..protocol import serve_master_grpc

    local = config.database.data_store.startswith(("memory://", "sqlite://"))
    return serve_master_grpc(
        master, master.blob, host=config.master.host, port=config.master.port,
        tls=grpc_tls(config), data_store=master.data if local else None,
        cache_store=master.cache if local else None)


def master_main() -> None:
    hold_signals()  # until _serve_until_signal's handlers are in place
    from .. import __version__
    from ..serve.dashboard import MasterRestServer
    from ..utils.config import ConfigWatcher, default_config, load_config
    from ..utils.tracing import configure_from

    parser = argparse.ArgumentParser(prog="gorse-tpu-torch-master")
    parser.add_argument("--version", action="version",
                        version=f"gorse-tpu-torch-master {__version__}")
    parser.add_argument("--config", help="TOML config path")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args()
    _logging()
    config = load_config(args.config) if args.config else default_config()
    configure_from(config)
    master = build_master(config)
    logger.info("master on device %s", master.device)
    rest = MasterRestServer(master, api_key=config.server.api_key)
    rest.serve(args.host or config.master.http_host, args.port or config.master.http_port)
    grpc_server, grpc_port = serve_grpc_plane(master, config)
    logger.info("master gRPC on %s:%d%s", config.master.host, grpc_port,
                " (mutual TLS)" if config.master.ssl_mode else "")
    master.serve_background()
    if args.config:
        def on_change(new_cfg):
            master.config.recommend = new_cfg.recommend
            master.trigger()

        ConfigWatcher(args.config, on_change).start()

    def stop():
        master.shutdown()
        grpc_server.stop(None)

    _serve_until_signal(stop)


def _tls_flags(parser) -> None:
    """gorse's node flags for the master's TLS (cmd/gorse-worker)."""
    parser.add_argument("--ssl-mode", action="store_true",
                        help="reach the master's gRPC plane over mutual TLS")
    parser.add_argument("--ssl-ca", default="", help="CA bundle of the master's certificate")
    parser.add_argument("--ssl-cert", default="", help="this node's certificate")
    parser.add_argument("--ssl-key", default="", help="this node's key")


def _tls_of(args):
    from ..utils.tls import TLSConfig

    return TLSConfig(args.ssl_ca, args.ssl_cert, args.ssl_key) if args.ssl_mode else None


def server_main() -> None:
    hold_signals()  # until _serve_until_signal's handlers are in place
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
    _tls_flags(parser)
    args = parser.parse_args()
    _logging()
    master_url = args.master or f"http://{args.master_host}:{args.master_port}"
    node = ServerNode(master_url, api_key=args.api_key, tls=_tls_of(args))
    node.serve(args.http_host, args.http_port)
    _serve_until_signal(node.shutdown)


def worker_main() -> None:
    hold_signals()  # until _serve_until_signal's handlers are in place
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
    _tls_flags(parser)
    args = parser.parse_args()
    _logging()
    master_url = args.master or f"http://{args.master_host}:{args.master_port}"
    node = WorkerNode(master_url, meta_timeout=args.meta_timeout, api_key=args.api_key,
                      tls=_tls_of(args))
    logger.info("worker %s on device %s", node.client.node_id, node.device)
    if args.http_port:
        node.serve_http(args.http_host, args.http_port)
    loop = node.serve_background()

    def stop():
        node.shutdown()
        loop.join(timeout=5.0)

    _serve_until_signal(stop, loop)
