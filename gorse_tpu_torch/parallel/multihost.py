"""Training over several processes or hosts (port of
gorse_tpu/parallel/multihost.py).

Every process runs the same program: :func:`init_multihost` joins the
``torch.distributed`` process group (NCCL when the process's shards are
CUDA devices, gloo on the CPU), and :func:`global_mesh` builds one mesh of
every process's shards, process ``r`` holding shards ``r * L`` up to ``r *
L + L - 1``. The sharded epochs (:mod:`.sharded`, :mod:`.catalog`) then run
unchanged: their collectives cross the processes, and sums run in global
shard order, so the result has the bits of a one-process mesh of as many
shards.
"""

from __future__ import annotations

import logging
import os

import torch

from .mesh import Mesh, cuda_devices

logger = logging.getLogger(__name__)


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, devices=None) -> dict:
    """Join the process group from the arguments or the reference's
    environment variables (``COORDINATOR_ADDRESS`` as ``host:port``,
    ``NUM_PROCESSES``, ``PROCESS_ID``). ``devices`` are this process's
    shards: every visible CUDA device by default. Returns the reference's
    info dict. A failed join raises."""
    import torch.distributed as dist

    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    world = num_processes or os.environ.get("NUM_PROCESSES")
    rank = process_id if process_id is not None else os.environ.get("PROCESS_ID")
    if not address or world is None or rank is None:
        raise ValueError("init_multihost needs the coordinator's host:port, the number of "
                         "processes and this process's id (or COORDINATOR_ADDRESS, "
                         "NUM_PROCESSES, PROCESS_ID)")
    devices = [torch.device(d) for d in devices] if devices is not None else cuda_devices()
    cuda = devices[0].type == "cuda"
    if cuda:
        torch.cuda.set_device(devices[0])
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{address}",
                            world_size=int(world), rank=int(rank))
    info = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": len(devices),
        "global_devices": len(devices) * dist.get_world_size(),
    }
    logger.info("multihost initialized: %s", info)
    return info


def global_mesh(devices=None) -> Mesh:
    """The mesh over every shard of every process of the joined group:
    ``devices`` (default every visible CUDA device) are this process's."""
    import torch.distributed as dist

    devices = list(devices) if devices is not None else cuda_devices()
    return Mesh(devices, group=dist.group.WORLD)
