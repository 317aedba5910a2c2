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
    for name in ("data.dataset", "data.loaders", "models.base", "models.bpr", "models.params",
                 "models.registry", "ops.bpr_kernel", "ops.metrics", "ops.sampling",
                 "serve.master", "storage.meta"):
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
    from gorse_tpu_torch.models import BPR, Params, create_mf_model
    from gorse_tpu_torch.ops import topk

    q = np.ones((2, 4), np.float32)
    items = np.ones((8, 4), np.float32)
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
    }


@pytest.mark.parametrize("name", ["resolve_device", "prepare_items", "dot_topk",
                                  "dot_topk_xla", "topk_excluding", "index", "bpr",
                                  "create_mf_model"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """``device=None`` means the card: without CUDA it raises; an explicit
    ``device="cpu"`` runs the plain versions."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(None)
    fn("cpu")
