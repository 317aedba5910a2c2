"""The port stands alone: importing every module of gorse_tpu_torch loads
neither JAX nor anything of gorse_tpu, and its entry points default to the
card, raising where there is none."""

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
                 "models.fm", "serve.worker"):
        assert f"gorse_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
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
    }


@pytest.mark.parametrize("name", ["resolve_device", "prepare_items", "dot_topk",
                                  "dot_topk_xla", "topk_excluding", "index", "bpr",
                                  "create_mf_model", "prepare_sq_items", "sq_topk", "pq_topk",
                                  "rq_topk", "vector_store", "open_vector_store", "als",
                                  "create_als", "idf_neighbors", "idf_neighbors_avg",
                                  "idf_distance_matrix", "embedding_neighbors",
                                  "embedding_query", "item_to_item", "user_to_user", "afm",
                                  "afm_params_from_numpy"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """``device=None`` means the card: without CUDA it raises; an explicit
    ``device="cpu"`` runs the plain versions."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(None)
    fn("cpu")
