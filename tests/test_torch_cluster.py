"""The port's cluster as processes on the CPU: tests/test_integration_cluster.py
with gorse_tpu_torch's master, server and worker started by ``python -c``
over ``gorse_tpu_torch.cmd._spawn`` (each process maps ``resolve_device``
to the CPU first, as tests/test_torch_in_one.py does for the in-one entry
point), driven through the server's REST API by the port's ``GorseClient``:
ingest, a scheduled training cycle on the master, the worker's offline
pipeline, online serving with the ``latest`` fallback. The master's admin
key gates its node-sync and dashboard routes (401 without it); the server
and worker sync with it. The nodes share the SQLite files (the port has no
gRPC storage proxy). The reference test's config with the admin key and
``collaborative.type = "mf"``: CF is opt-in (``type = "none"`` by default),
and without it the reference's cluster answers from the fallback alone and
trains no model. The same size as the reference test: 40 items, 15 users;
the poll has its own deadline of 120 s."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from gorse_tpu_torch.client import GorseClient
from gorse_tpu_torch.storage.types import Feedback, Item

ROOT = Path(__file__).resolve().parents[1]
ADMIN_KEY = "cluster-admin"
POLL_S = 120
PRELUDE = ("import torch, gorse_tpu_torch as g;"
           "g.resolve_device = lambda d=None: torch.device('cpu' if d is None else d);"
           "from gorse_tpu_torch.cmd._spawn import main; main()")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_http(url: str, timeout: float = 90.0) -> None:
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2):
                return
        except Exception as e:  # noqa: BLE001
            last = e
            time.sleep(0.3)
    raise TimeoutError(f"{url} not up: {last}")


def _post(url: str, body: dict, key: str = "") -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"X-API-Key": key} if key else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def cluster(tmp_path):
    http_port, grpc_port, server_port = _free_port(), _free_port(), _free_port()
    cfg_path = tmp_path / "config.toml"
    cfg_path.write_text(
        f"""
[database]
data_store = "sqlite://{tmp_path}/data.db"
cache_store = "sqlite://{tmp_path}/cache.db"
blob_store = "{tmp_path}/blobs"
meta_store = "sqlite://{tmp_path}/meta.db"

[master]
host = "127.0.0.1"
port = {grpc_port}
http_host = "127.0.0.1"
http_port = {http_port}
admin_api_key = "{ADMIN_KEY}"

[recommend.collaborative]
type = "mf"
model = "bpr"

[recommend.ranker]
type = "none"
recommenders = ["collaborative"]

[recommend.fallback]
recommenders = ["latest"]
"""
    )
    # one intra-op thread a process: three torch processes beside the test
    # runner's own workers would otherwise oversubscribe the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs: list[subprocess.Popen] = []
    logs = open(tmp_path / "cluster.log", "wb")

    def spawn(*args):
        p = subprocess.Popen([sys.executable, "-c", PRELUDE, *args], env=env, cwd=str(tmp_path),
                             stdout=logs, stderr=subprocess.STDOUT, start_new_session=True)
        procs.append(p)

    master_url = f"http://127.0.0.1:{http_port}"
    worker_port = _free_port()
    spawn("master", "--config", str(cfg_path))
    _wait_http(f"{master_url}/api/health/live")
    spawn("server", "--master", master_url, "--api-key", ADMIN_KEY, "--port", str(server_port))
    spawn("worker", "--master", master_url, "--api-key", ADMIN_KEY, "--meta-timeout", "1",
          "--http-port", str(worker_port))
    _wait_http(f"http://127.0.0.1:{server_port}/api/health/live")
    _wait_http(f"http://127.0.0.1:{worker_port}/api/health/live")
    yield master_url, f"http://127.0.0.1:{server_port}", tmp_path
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
    logs.close()


def test_cluster_end_to_end(cluster):
    master_url, server_url, tmp_path = cluster
    client = GorseClient(server_url)
    rng = np.random.default_rng(0)
    for k in range(40):
        client.insert_item(Item(f"i{k}", timestamp=float(k)))
    fbs = [
        Feedback("like", f"u{u}", f"i{i}", timestamp=1.0)
        for u in range(15)
        for i in rng.choice(40, size=6, replace=False)
    ]
    client.insert_feedback(fbs, overwrite=True)
    assert client.get_item("i3").item_id == "i3"

    # the admin key gates the master's node sync and dashboard
    assert _post(f"{master_url}/api/admin/meta", {})[0] == 401
    assert _post(f"{master_url}/api/dashboard/schedule", {})[0] == 401
    status, meta = _post(f"{master_url}/api/admin/meta", {}, ADMIN_KEY)
    assert status == 200 and json.loads(meta["config"])["master"]["admin_api_key"] == ADMIN_KEY
    assert _post(f"{master_url}/api/dashboard/schedule", {}, ADMIN_KEY) == (
        200, {"status": "scheduled"})

    deadline = time.time() + POLL_S
    recs, cf_model = [], ""
    while time.time() < deadline:
        try:
            cf_model = cf_model or _post(f"{master_url}/api/admin/meta", {},
                                         ADMIN_KEY)[1]["cf_model_id"]
            recs = client.get_recommend("u3", n=5)
            if recs and cf_model:
                break
        except Exception:  # noqa: BLE001
            pass
        time.sleep(1.0)
    log = (tmp_path / "cluster.log").read_text()[-2000:]
    assert len(recs) == 5 and cf_model, (recs, cf_model, log)
    assert (tmp_path / "blobs" / cf_model).exists()
    consumed = {f.item_id for f in client.get_user_feedback("u3")}
    assert not set(recs) & consumed
    cold = client.get_recommend("brand-new-user", n=3)
    assert len(cold) == 3
