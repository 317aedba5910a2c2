"""gorse_tpu_torch.serve (port of gorse_tpu.serve): the master, the worker,
the REST server and the in-one node that runs all three."""

from .in_one import InOneNode
from .master import Master
from .progress import ProgressTracker
from .rest import RestServer
from .worker import Worker, rendezvous_owner

__all__ = [
    "InOneNode",
    "Master",
    "ProgressTracker",
    "RestServer",
    "Worker",
    "rendezvous_owner",
]
