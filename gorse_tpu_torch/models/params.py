"""Typed hyper-parameter map and training-loop knobs (copy of
gorse_tpu/models/params.py). Sharded training is not ported: a mesh or
``sync_every > 1`` raises."""

from __future__ import annotations

N_FACTORS = "n_factors"
N_EPOCHS = "n_epochs"
LR = "lr"
REG = "reg"
INIT_MEAN = "init_mean"
INIT_STDDEV = "init_stddev"


class Params(dict):
    """Hyper-parameter map with typed getters and merge."""

    def get_int(self, name: str, default: int) -> int:
        return int(self.get(name, default))

    def get_float(self, name: str, default: float) -> float:
        return float(self.get(name, default))

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
        if mesh is not None or shard_table or sync_every > 1:
            raise NotImplementedError(
                "sharded training (mesh, shard_table, sync_every) is not ported yet "
                "(ROADMAP.md, M14)"
            )
        self.verbose = verbose
        self.patience = patience
        self.top_k = top_k
        self.candidates = candidates
        self.batch_size = batch_size
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir

    def __repr__(self) -> str:
        return (
            f"FitConfig(verbose={self.verbose}, patience={self.patience}, "
            f"top_k={self.top_k}, candidates={self.candidates}, "
            f"batch_size={self.batch_size}, seed={self.seed})"
        )
