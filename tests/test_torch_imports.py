"""The port stands alone: importing every module of gorse_tpu_torch loads
neither JAX, grpc, protobuf nor anything of gorse_tpu, and its entry points
default to the card, raising where there is none."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    import gorse_tpu_torch

    return ["gorse_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(gorse_tpu_torch.__path__, "gorse_tpu_torch.")
    ]


def test_port_imports_no_jax_and_no_reference():
    modules = _port_modules()
    assert "gorse_tpu_torch.ops.topk" in modules and "gorse_tpu_torch.serve.rest" in modules
    for name in ("data.dataset", "data.loaders", "models.als", "models.base", "models.bpr",
                 "models.params", "models.registry", "ops.bpr_kernel", "ops.metrics",
                 "ops.sampling", "ops.similarity", "logics.item_to_item",
                 "logics.user_to_user", "logics.non_personalized", "serve.master",
                 "storage.meta", "storage.vectors", "storage.none", "utils.config",
                 "utils.safe_expr", "data.ctr", "data.unified_index", "models.scaler",
                 "models.fm", "serve.worker", "storage.data", "storage.cache",
                 "storage.search", "storage.object", "models.optimize", "serve.in_one",
                 "serve.rest", "serve.asynchttp", "serve.metrics", "serve.oidc",
                 "serve.dashboard", "serve.nodes", "client", "cmd", "cmd.nodes_main",
                 "cmd._spawn", "parallel", "parallel.mesh", "parallel.sharded",
                 "parallel.catalog", "parallel.multihost", "parallel.ratelimit",
                 "utils.minijs", "logics.external", "llm", "llm.client", "llm.mock",
                 "cmd.bench", "cmd.cli", "native", "native.hnsw", "storage.bson",
                 "storage.chhttp", "storage.miniobj", "storage.minisql", "storage.mongo",
                 "storage.mongowire", "storage.mysqlwire", "storage.pgwire", "storage.redis",
                 "storage.resp", "storage.sqlstores", "storage.vectordb", "protocol",
                 "protocol.pb", "protocol.h2", "protocol.grpcwire", "protocol.rpc",
                 "storage.proxy", "utils.tls", "utils.tracing", "utils.events", "utils.log",
                 "utils.template", "utils.msgpack", "logics.chat", "serve.dump",
                 "data.registry", "storage.minimongo", "storage.minivector"):
        assert f"gorse_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] in ('jax', 'jaxlib', 'gorse_tpu', 'grpc')"
        " or n.startswith('google.protobuf'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_grpc_plane_imports_neither_grpc_nor_protobuf():
    """The gRPC plane (protocol/, storage/proxy.py, utils/tls.py,
    utils/tracing.py) stands on the port's own HTTP/2 and message
    encoding: in a fresh interpreter, importing it and opening a proxy
    store (no call made) loads none of jax, grpc, google.protobuf or
    gorse_tpu."""
    code = (
        "import json, sys\n"
        "import gorse_tpu_torch.protocol, gorse_tpu_torch.storage.proxy\n"
        "import gorse_tpu_torch.utils.tls, gorse_tpu_torch.utils.tracing\n"
        "from gorse_tpu_torch.storage.data import open_data_store\n"
        "from gorse_tpu_torch.utils.tracing import make_exporter\n"
        "open_data_store('proxy://127.0.0.1:1').close()\n"
        "make_exporter('otlp', '127.0.0.1:1')\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] in ('jax', 'jaxlib', 'gorse_tpu', 'grpc')"
        " or n.startswith('google.protobuf'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


BLOCKED = ("jax", "jinja2", "msgpack", "cryptography", "grpc", "google.protobuf",
           "gorse_tpu")


def test_new_surface_imports_with_the_reference_packages_blocked():
    """In a fresh interpreter where ``jax``, ``jinja2``, ``msgpack``,
    ``cryptography``, ``grpc``, ``google.protobuf`` and ``gorse_tpu`` cannot
    be imported (``sys.modules[name] = None``), every module of the port
    imports, so does chip_smoke.py's import graph, and the new surface
    works: a template renders, msgpack round-trips, an RSA key signs and
    verifies, a dump restores."""
    code = (
        "import importlib, io, json, random, sys\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        "sys.argv = ['chip_smoke.py']\n"
        "import chip_smoke\n"
        "import gorse_tpu_torch, pkgutil\n"
        "mods = ['gorse_tpu_torch'] + [m.name for m in pkgutil.walk_packages("
        "gorse_tpu_torch.__path__, 'gorse_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from gorse_tpu_torch.utils import msgpack, template\n"
        "from gorse_tpu_torch.serve import dump, oidc\n"
        "from gorse_tpu_torch.storage.data import MemoryDataStore\n"
        "from gorse_tpu_torch.storage.types import User\n"
        "assert template.from_string('{{ a|join(\"-\") }}').render(a=[1, 2]) == '1-2'\n"
        "assert msgpack.unpackb(msgpack.packb({'k': [1, 2.5, None]})) == {'k': [1, 2.5, None]}\n"
        "key = oidc.generate_rsa_key(1024, rng=random.Random(0))\n"
        "assert oidc.rs256_verify(key.n, key.e, b'm', key.sign(b'm'))\n"
        "a, b, buf = MemoryDataStore(), MemoryDataStore(), io.BytesIO()\n"
        "a.insert_users([User('u1')]); dump.dump(a, buf); buf.seek(0)\n"
        "assert dump.restore(b, buf) == {'users': 1, 'items': 0, 'feedback': 0}\n"
        "print(json.dumps([len(mods), sorted(n for n in sys.modules if sys.modules[n] is not None"
        " and (n.split('.')[0] in ('jax', 'jinja2', 'msgpack', 'cryptography', 'grpc',"
        " 'gorse_tpu', 'markupsafe') or n.startswith('google.protobuf')))]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    n_modules, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert n_modules > 100 and loaded == []


def test_chip_smoke_imports_no_jax_and_no_reference():
    """chip_smoke.py's own imports and every module it imports of the
    port, in a fresh interpreter (its ``main`` leaves before any phase
    here, without a card), load neither JAX nor gorse_tpu."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module and not node.level}
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "gorse_tpu")}
    port = sorted(n for n in names if n.split(".")[0] == "gorse_tpu_torch")
    assert "gorse_tpu_torch.storage.minisql" in port and "gorse_tpu_torch.native" in port
    code = (
        "import importlib, json, sys\n"
        "sys.argv = ['chip_smoke.py']\n"
        "import chip_smoke\n"
        f"for m in {port!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(n for n in sys.modules"
        " if n.split('.')[0] in ('jax', 'jaxlib', 'gorse_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _entry_points():
    import numpy as np

    from gorse_tpu_torch.logics.cf import MatrixFactorizationIndex
    from gorse_tpu_torch.logics.item_to_item import ItemToItemConfig, new_item_to_item
    from gorse_tpu_torch.logics.user_to_user import UserToUser, UserToUserConfig
    from gorse_tpu_torch.models import ALS, BPR, Params, create_mf_model
    from gorse_tpu_torch.models.fm import AFM, afm_params_from_numpy
    from gorse_tpu_torch.ops import similarity, topk
    from gorse_tpu_torch.storage import vectors

    q = np.ones((2, 4), np.float32)
    items = np.ones((8, 4), np.float32)
    codes = np.ones((8, 4), np.uint8)
    row = np.ones(8, np.float32)
    return {
        "resolve_device": lambda device: __import__("gorse_tpu_torch").resolve_device(device),
        "prepare_items": lambda device: topk.prepare_items(items, device=device),
        "dot_topk": lambda device: topk.dot_topk(q, items, 3, device=device),
        "dot_topk_xla": lambda device: topk.dot_topk_xla(q, items, 3, device=device),
        "topk_excluding": lambda device: topk.topk_excluding(q, items, 3, device=device),
        "dot_topk_approx": lambda device: topk.dot_topk_approx(q, items, 3, device=device),
        "sq_topk_approx": lambda device: topk.sq_topk_approx(
            q, topk.prepare_sq_items(codes, row, row, device="cpu"), 3,
            device=device),
        "bench_retrieval": lambda device: __import__(
            "gorse_tpu_torch.cmd.bench", fromlist=["main"]).main(
            ["retrieval", "--items", "64", "--batch", "2", "--batches", "1", "--dim", "4"]
            + ([] if device is None else ["--device", device])),
        "index": lambda device: MatrixFactorizationIndex.from_numpy(
            q, items, {"names": ["a", "b"], "freqs": [1, 1]},
            {"names": [str(i) for i in range(8)], "freqs": [1] * 8},
            device=device,
        ),
        "bpr": lambda device: BPR(Params(n_factors=4), device=device),
        "create_mf_model": lambda device: create_mf_model("bpr", device=device),
        "prepare_sq_items": lambda device: topk.prepare_sq_items(codes, row, row, device=device),
        "sq_topk": lambda device: topk.sq_topk(q, codes, row, row, 3, device=device),
        "pq_topk": lambda device: topk.pq_topk(q, codes, np.ones((4, 256, 1), np.float32), row,
                                               3, device=device),
        "rq_topk": lambda device: topk.rq_topk(q, codes, row, row, np.eye(4, dtype=np.float32),
                                               row, 3, 2, 4, device=device),
        "vector_store": lambda device: vectors.MemoryVectorStore(device=device),
        "open_vector_store": lambda device: vectors.open_vector_store("sqlite://", device=device),
        "als": lambda device: ALS(Params(n_factors=4), device=device),
        "create_als": lambda device: create_mf_model("als", device=device),
        "idf_neighbors": lambda device: similarity.idf_neighbors(codes, row[:4], 3, device=device),
        "idf_neighbors_avg": lambda device: similarity.idf_neighbors_avg(
            codes, row[:4], codes, row[:4], 3, device=device),
        "idf_distance_matrix": lambda device: similarity.idf_distance_matrix(codes, row[:4],
                                                                             device=device),
        "embedding_neighbors": lambda device: similarity.embedding_neighbors(items, 3,
                                                                             device=device),
        "embedding_query": lambda device: similarity.embedding_query(q, items, 3, device=device),
        "item_to_item": lambda device: new_item_to_item(ItemToItemConfig("t", "users"), 3,
                                                        device=device),
        "user_to_user": lambda device: UserToUser(UserToUserConfig("u", "items"), 3,
                                                  device=device),
        "afm": lambda device: AFM(Params(n_factors=4), device=device),
        "afm_params_from_numpy": lambda device: afm_params_from_numpy(
            {"b": row[0], "v": items, "w": items[:, :1]}, device=device),
        "in_one": _in_one,
        "worker_node": _worker_node,
        "master_main": _master_main,
    }


def _in_one(device):
    import tempfile

    from gorse_tpu_torch.serve.in_one import InOneNode

    with tempfile.TemporaryDirectory() as workdir:
        node = InOneNode(workdir=workdir, device=device)
        assert node.master.device == node.worker.device == node.device


def _worker_node(device):
    """``WorkerNode`` resolves its device when it is built and hands it to
    its pipeline's ``Worker`` (the master URL is not reached before its
    first sync)."""
    from gorse_tpu_torch.serve.nodes import WorkerNode

    node = WorkerNode("http://127.0.0.1:9", device=device)
    assert node.device.type == "cpu"


def _master_main(device):
    """The master that ``master_main`` builds from a config's stores."""
    import tempfile

    from gorse_tpu_torch.cmd.nodes_main import build_master
    from gorse_tpu_torch.utils.config import Config

    with tempfile.TemporaryDirectory() as tmp:
        config = Config()
        config.database.blob_store = f"{tmp}/blobs"
        master = build_master(config, device=device)
        assert master.device.type == "cpu"


@pytest.mark.parametrize("name", ["resolve_device", "prepare_items", "dot_topk",
                                  "dot_topk_xla", "topk_excluding", "index", "bpr",
                                  "create_mf_model", "prepare_sq_items", "sq_topk", "pq_topk",
                                  "rq_topk", "vector_store", "open_vector_store", "als",
                                  "create_als", "idf_neighbors", "idf_neighbors_avg",
                                  "idf_distance_matrix", "embedding_neighbors",
                                  "embedding_query", "item_to_item", "user_to_user", "afm",
                                  "afm_params_from_numpy", "in_one", "worker_node",
                                  "master_main", "dot_topk_approx", "sq_topk_approx",
                                  "bench_retrieval"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """``device=None`` means the card: without CUDA it raises; an explicit
    ``device="cpu"`` runs the plain versions."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(None)
    fn("cpu")
