"""MF model registry (port of gorse_tpu/models/registry.py)."""

from __future__ import annotations

from .params import Params


def create_mf_model(name: str, params: Params | dict | None = None, device=None):
    """A new model of type ``name`` on ``device`` (``None``: the card)."""
    from .bpr import BPR

    if name == "bpr":
        return BPR(params, device=device)
    if name == "als":
        raise NotImplementedError("the eALS model is not ported yet (ROADMAP.md, M8)")
    raise KeyError(f"unknown MF model {name!r}")
