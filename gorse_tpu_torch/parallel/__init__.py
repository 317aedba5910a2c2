"""gorse_tpu_torch.parallel (port of gorse_tpu.parallel): the mesh and its
collectives, the sharded BPR, eALS and AFM epochs, catalog sharding,
sharded top-k and training over several processes."""

from .mesh import Mesh, make_mesh
from .ratelimit import RateLimiters, TokenBucket
from .sharded import (
    make_sharded_bpr_epoch,
    make_sharded_topk,
    shard_bpr_inputs,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "RateLimiters",
    "TokenBucket",
    "make_sharded_bpr_epoch",
    "make_sharded_topk",
    "shard_bpr_inputs",
]
