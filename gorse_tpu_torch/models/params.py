"""Typed hyper-parameter map and training-loop knobs (copy of
gorse_tpu/models/params.py)."""

from __future__ import annotations

N_FACTORS = "n_factors"
N_EPOCHS = "n_epochs"
LR = "lr"
REG = "reg"
INIT_MEAN = "init_mean"
INIT_STDDEV = "init_stddev"
ALPHA = "alpha"
BATCH_SIZE = "batch_size"
OPTIMIZER = "optimizer"
AUTO_SCALE = "auto_scale"

SGD = "sgd"
ADAM = "adam"


class Params(dict):
    """Hyper-parameter map with typed getters and merge."""

    def get_int(self, name: str, default: int) -> int:
        return int(self.get(name, default))

    def get_float(self, name: str, default: float) -> float:
        return float(self.get(name, default))

    def get_bool(self, name: str, default: bool) -> bool:
        return bool(self.get(name, default))

    def get_string(self, name: str, default: str) -> str:
        return str(self.get(name, default))

    def merged(self, overrides: "Params | dict") -> "Params":
        out = Params(self)
        out.update(overrides)
        return out


class FitConfig:
    """Training-loop knobs, with the reference's defaults."""

    def __init__(
        self,
        verbose: int = 10,
        patience: int = 0,
        top_k: int = 10,
        candidates: int = 100,
        batch_size: int = 1024,
        seed: int = 0,
        checkpoint_dir: str | None = None,
        mesh=None,
        shard_table: bool = False,
        sync_every: int = 1,
    ) -> None:
        self.verbose = verbose
        self.patience = patience
        self.top_k = top_k
        self.candidates = candidates
        self.batch_size = batch_size
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        # a parallel.Mesh: train sharded over its shards (users for BPR and
        # eALS, the batch for the AFM); None or one shard trains on the
        # model's device
        self.mesh = mesh
        # with a mesh: also row-shard the item table (BPR, eALS) or the
        # feature table (AFM) over the shards (parallel/catalog.py)
        self.shard_table = shard_table
        # with a mesh: sum the BPR item deltas every this many steps
        # (bounded staleness, the reference's variant)
        self.sync_every = sync_every

    def __repr__(self) -> str:
        return (
            f"FitConfig(verbose={self.verbose}, patience={self.patience}, "
            f"top_k={self.top_k}, candidates={self.candidates}, "
            f"batch_size={self.batch_size}, seed={self.seed})"
        )
