"""gorse_tpu_torch.models (port of gorse_tpu.models): BPR and eALS on the card."""

from .als import ALS
from .base import MatrixFactorization, Score, evaluate_model
from .bpr import BPR
from .params import FitConfig, Params
from .registry import create_mf_model

__all__ = ["ALS", "BPR", "FitConfig", "MatrixFactorization", "Params", "Score", "create_mf_model",
           "evaluate_model"]
