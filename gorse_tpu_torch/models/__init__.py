"""gorse_tpu_torch.models (port of gorse_tpu.models): BPR on the card."""

from .base import MatrixFactorization, Score
from .bpr import BPR
from .params import FitConfig, Params
from .registry import create_mf_model

__all__ = ["BPR", "FitConfig", "MatrixFactorization", "Params", "Score", "create_mf_model"]
