"""gorse_tpu_torch.ops (port of gorse_tpu.ops): the kernels' wrappers, the
similarity ops and the ranking metrics."""

from .metrics import auc, classification_metrics, rank_metrics

__all__ = ["auc", "classification_metrics", "rank_metrics"]
