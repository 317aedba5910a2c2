"""gorse_tpu_torch.data (port of gorse_tpu.data): the dataset, its
dictionaries and the loaders."""

from .dataset import Dataset
from .dict import NOT_ID, FreqDict, Index
from .loaders import load_built_in, load_ncf, synthetic_cf, synthetic_cf_powerlaw

__all__ = [
    "Dataset",
    "FreqDict",
    "Index",
    "NOT_ID",
    "load_built_in",
    "load_ncf",
    "synthetic_cf",
    "synthetic_cf_powerlaw",
]
