"""gorse_tpu_torch: the PyTorch and CUDA port of gorse_tpu, for NVIDIA Hopper.

The port keeps gorse_tpu's layout and names (``ops/``, ``data/``,
``storage/``, ``utils/``, ``logics/``, ``serve/``) and its file formats, and
imports nothing of it. Entry points take ``device=None``, which means the
card: without CUDA they raise. Only an explicit ``device="cpu"`` runs on the
CPU, through each kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises when CUDA is absent);
    anything else is taken as given, a bare ``cuda`` with its index."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gorse_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
