"""The all-in-one node: master, worker and server in one process (port of
gorse_tpu/serve/in_one.py).

    python -m gorse_tpu_torch.serve.in_one --config config.toml [--port 8087]

The stores come from the config: the data and cache stores (``memory://``,
``sqlite://``, ``none://``, and the remote ``mysql://``, ``postgres://``,
``clickhouse://`` (data only), ``redis://``, ``redis+cluster://`` (cache
only) and ``mongodb://``), the meta store (a SQLite path), the blob store
(``database.blob_store``, else ``[blob].uri``, else ``<workdir>/blobs``;
``s3://``, ``gs://`` and ``azblob://`` too) and the vector store
(``open_vector_store`` on the node's device; ``hnsw://`` and the vector
databases too). ``run_once`` runs the master's task cycle on the card, the
model searches that have come due included, then the worker refreshes its
shard; ``serve`` answers REST requests and repeats the cycle every
``collaborative.fit_period`` minutes on a thread.

The REST surface is the master's, ``MasterRestServer`` (serve/dashboard.py):
the public API with the dashboard, admin and node-sync routes, as the
reference's in-one node serves it. The node installs the tracer the
config's ``[tracing]`` names (utils/tracing.py), and ``shutdown`` flushes it.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import tempfile
import threading

from .. import resolve_device
from ..storage.cache import open_cache_store_from_config
from ..storage.data import open_data_store_from_config
from ..storage.meta import MetaStore
from ..storage.object import open_blob_store_from_config
from ..storage.vectors import open_vector_store
from ..utils.config import Config, default_config, load_config
from ..utils.tracing import configure_from, tracer
from .dashboard import MasterRestServer
from .master import Master
from .worker import Worker

logger = logging.getLogger(__name__)


class InOneNode:
    """Master, worker and REST server over shared stores, on ``device``
    (``None``: the card; without CUDA it raises)."""

    def __init__(self, config: Config | None = None, workdir: str | None = None,
                 device=None) -> None:
        self.config = config or Config()
        configure_from(self.config)
        self.device = resolve_device(device)
        self.workdir = workdir or tempfile.mkdtemp(prefix="gorse_tpu_torch_")
        db = self.config.database
        self.data = open_data_store_from_config(db)
        self.cache = open_cache_store_from_config(db)
        self.blob = open_blob_store_from_config(self.config.blob, db.blob_store,
                                                f"{self.workdir}/blobs")
        self.meta = MetaStore(db.meta_store)
        self.vectors = open_vector_store(db.vector_store, self.device) if db.vector_store else None
        self.master = Master(self.config, self.data, self.cache, self.blob, self.meta,
                             device=self.device, vector_store=self.vectors)
        self.worker = Worker(self.config, self.data, self.cache, self.blob, node_id="in-one",
                             device=self.device)
        self.rest = MasterRestServer(self.master, api_key=self.config.server.api_key)
        self._httpd = None
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None

    # --------------------------------------------------------------- runs

    def seed_playground(self, n_users: int = 100, n_items: int = 200, seed: int = 0) -> None:
        """Demo data: a low-rank synthetic catalog of ``repo<i>`` items with
        ``star`` feedback. The playground exists to demo training, so it
        turns CF on when the config left it off."""
        if self.config.recommend.collaborative.type == "none":
            self.config.recommend.collaborative.type = "mf"
        import numpy as np

        from ..data.loaders import synthetic_cf
        from ..storage.types import Feedback, Item, User

        data = synthetic_cf(n_users=n_users, n_items=n_items, rank=8, density=0.06, seed=seed)
        genres = ["ai", "web", "db", "infra", "mobile"]
        rng = np.random.default_rng(seed)
        self.data.insert_items(
            [
                Item(
                    f"repo{i}",
                    categories=[genres[int(rng.integers(len(genres)))]],
                    timestamp=float(rng.integers(1, 10**6)),
                    labels=[genres[int(rng.integers(len(genres)))]],
                )
                for i in range(n_items)
            ]
        )
        self.data.insert_users([User(f"user{u}") for u in range(n_users)])
        fbs = []
        for u in range(n_users):
            for slot, i in enumerate(data.user_feedback[u]):
                fbs.append(
                    Feedback("star", f"user{u}", f"repo{i}", timestamp=float(data.timestamps[u][slot]))
                )
        self.data.insert_feedback(fbs)

    def run_once(self, search: bool = False) -> dict:
        """One offline cycle: the master's tasks, then the worker's."""
        self.master.run_tasks_once(search=search)
        refreshed = self.worker.sync_and_recommend(self.master)
        return {
            "cf_model_id": self.worker.cf_model_id,
            "ctr_model_id": self.worker.ctr_model_id,
            "users_refreshed": refreshed,
        }

    def serve(self, host: str = "127.0.0.1", port: int = 8087, background_loop: bool = True):
        """Start the REST server (``port=0`` picks a free port) and, with
        ``background_loop``, the cycle every ``fit_period`` minutes."""
        self._httpd = self.rest.serve(host, port)
        if background_loop:
            self._loop_thread = threading.Thread(target=self._loop, name="in-one-cycle",
                                                 daemon=True)
            self._loop_thread.start()
        return self._httpd

    def _loop(self) -> None:
        period = self.config.recommend.collaborative.fit_period * 60.0
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 - a failed cycle does not end the loop
                logger.exception("in-one cycle failed")
            self._stop.wait(timeout=period)

    def shutdown(self) -> bool:
        """Stop the REST server and the loop; True when no cycle is still
        running after a 5 s wait."""
        self._stop.set()
        self.rest.shutdown()
        stopped = True
        if self._loop_thread:
            self._loop_thread.join(timeout=5.0)
            stopped = not self._loop_thread.is_alive()
        tracer().flush()  # the trailing spans, fewer than a batch
        return stopped


def main() -> None:
    import argparse

    from .. import __version__

    parser = argparse.ArgumentParser(description="gorse_tpu_torch all-in-one node")
    parser.add_argument("--version", action="version",
                        version=f"gorse-tpu-torch-in-one {__version__}")
    parser.add_argument("--config", help="TOML config path")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8087)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--playground", action="store_true",
                        help="seed a synthetic demo catalog and train immediately")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    config = load_config(args.config) if args.config else default_config()
    node = InOneNode(config, workdir=args.workdir)
    if args.playground:
        config.recommend.data_source.positive_feedback_types = ["star"]
        node.seed_playground()
        node.run_once()
    # the server answers from the moment it listens, before the handler
    # below is in place: a SIGINT until then is held and raised inside it
    held = []
    signal.signal(signal.SIGINT, lambda *_: held.append(True))
    node.serve(args.host, args.port, background_loop=True)
    logger.info("in-one node ready at http://%s:%d/api/", args.host, args.port)
    try:
        signal.signal(signal.SIGINT, signal.default_int_handler)
        if held:
            raise KeyboardInterrupt
        threading.Event().wait()
    except KeyboardInterrupt:
        if not node.shutdown():
            # a cycle still running on the card is abandoned: leave without
            # tearing its daemon thread down mid-call at interpreter exit
            logger.info("in-one node stopped with a cycle running")
            logging.shutdown()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)


if __name__ == "__main__":
    main()
