"""Device meshes and their collectives (port of gorse_tpu/parallel/mesh.py).

The reference runs one controller over a ``jax.sharding.Mesh`` and lets
``shard_map`` run a function once a device. The port's :class:`Mesh` is the
same idea made explicit: an ordered list of shards, each a ``torch.device``
(one device may hold several shards: 4 shards on one card, or 8 on the
CPU), and the collectives the reference's sharded code uses, over per-shard
lists of tensors:

- :meth:`Mesh.psum`: the sum of every shard's tensor, on every shard;
- :meth:`Mesh.all_gather`: every shard's tensor in shard order, tiled
  (concatenated along the first axis) or stacked;
- :meth:`Mesh.all_to_all`: each shard sends row ``h`` of its ``[D, ...]``
  buffer to shard ``h`` and receives row ``g`` of its result from shard ``g``.

A sharded value is a list with one tensor a local shard; a replicated value
is a list of the same values, one tensor a device (shards on one device
share it, so a replicated value is never updated in place).

Sums run in global shard order (gather, then add shard 0, 1, 2 ... in turn),
never in an order a communication library picks, so a run gives the same
bits however its shards are spread over cards and processes. Between the
cards of one process the shards' tensors move by peer copies; between
processes by ``torch.distributed`` (NCCL on cards, gloo on the CPU), each
process holding the same number of consecutive shards
(:mod:`.multihost`).
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.require(np.asarray(x), requirements="W"))


class Mesh:
    """``devices``: this process's shards, in order. ``group``: the
    ``torch.distributed`` process group whose members hold the other shards
    (process ``r`` holds shards ``r * L ... r * L + L - 1``), or ``None``
    when this process holds them all. The reference's ``data`` and ``model``
    axes are not kept: its sharded epochs fold both into one shard index,
    and so do the port's."""

    def __init__(self, devices, group=None) -> None:
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.local_size = len(self.devices)
        self.home = self.devices[0]
        if group is None:
            self.n_processes, self.process_index = 1, 0
        else:
            import torch.distributed as dist

            self.n_processes = dist.get_world_size(group)
            self.process_index = dist.get_rank(group)
            counts = [torch.zeros(1, dtype=torch.int64, device=self.home)
                      for _ in range(self.n_processes)]
            dist.all_gather(counts, torch.tensor([self.local_size], device=self.home),
                            group=group)
            if any(int(c) != self.local_size for c in counts):
                raise ValueError(f"every process must hold as many shards: {counts}")
        self.size = self.local_size * self.n_processes
        self.offset = self.process_index * self.local_size

    def __repr__(self) -> str:
        return (f"Mesh(size={self.size}, local={[str(d) for d in self.devices]},"
                f" process {self.process_index} of {self.n_processes})")

    # ------------------------------------------------------------ placement

    def shard_rows(self, host) -> list[torch.Tensor]:
        """This process's shards of ``host`` (the whole array, as every
        process holds it): contiguous equal row blocks, shard ``s`` rows
        ``s * R / D`` up to ``(s + 1) * R / D``."""
        t = _tensor(host)
        if t.shape[0] % self.size:
            raise ValueError(f"{t.shape[0]} rows not divisible by the {self.size} shards")
        per = t.shape[0] // self.size
        return [t[(self.offset + j) * per:(self.offset + j + 1) * per].to(dev).contiguous()
                for j, dev in enumerate(self.devices)]

    def replicate(self, host) -> list[torch.Tensor]:
        """``host`` on every local shard, one copy a device."""
        return self._spread(_tensor(host))

    def replicated(self, fn, *parts) -> list[torch.Tensor]:
        """``fn`` of replicated values, computed once a device and shared by
        the shards on it."""
        done = {}
        out = []
        for j, dev in enumerate(self.devices):
            if dev not in done:
                done[dev] = fn(*(p[j] for p in parts))
            out.append(done[dev])
        return out

    def _spread(self, t: torch.Tensor) -> list[torch.Tensor]:
        copies = {t.device: t}
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = t.to(dev)
        return [copies[dev] for dev in self.devices]

    # ---------------------------------------------------------- collectives

    def _gather(self, parts) -> list[torch.Tensor]:
        """Every shard's tensor, in global shard order, on the home device
        (the tensors have one shape on every shard)."""
        if len(parts) != self.local_size:
            raise ValueError(f"{len(parts)} parts for {self.local_size} local shards")
        local = [t.to(self.home) for t in parts]
        if self.group is None:
            return local
        import torch.distributed as dist

        stacked = torch.stack(local).contiguous()
        blocks = [torch.empty_like(stacked) for _ in range(self.n_processes)]
        dist.all_gather(blocks, stacked, group=self.group)
        return [t for block in blocks for t in block.unbind(0)]

    def psum(self, parts) -> list[torch.Tensor]:
        """The sum over every shard of ``parts``, added in shard order
        (shard 0 + shard 1, then + shard 2, ...), on every local shard."""
        terms = self._gather(parts)
        total = terms[0].clone()
        for t in terms[1:]:
            total += t
        return self._spread(total)

    def all_gather(self, parts, tiled: bool = True) -> list[torch.Tensor]:
        """Every shard's tensor in shard order, concatenated along the first
        axis (``tiled``) or stacked on a new one, on every local shard."""
        terms = self._gather(parts)
        return self._spread(torch.cat(terms) if tiled else torch.stack(terms))

    def all_to_all(self, parts) -> list[torch.Tensor]:
        """``parts[j]`` is local shard j's ``[D, ...]`` send buffer, row h for
        shard h; returns each local shard's ``[D, ...]`` receive buffer, row
        g from shard g."""
        d, n_local = self.size, self.local_size
        if len(parts) != n_local or any(p.shape[0] != d for p in parts):
            raise ValueError(f"all_to_all takes one [{d}, ...] buffer a local shard")
        if self.group is None:
            return [torch.stack([parts[g][h].to(dev) for g in range(d)])
                    for h, dev in enumerate(self.devices)]
        import torch.distributed as dist

        local = torch.stack([p.to(self.home) for p in parts])  # [L_src, D, ...]
        send = [local[:, r * n_local:(r + 1) * n_local].contiguous()
                for r in range(self.n_processes)]  # each [L_src, L_dst, ...]
        recv = [torch.empty_like(s) for s in send]
        dist.all_to_all(recv, send, group=self.group)
        full = torch.cat(recv)  # [D_src, L_dst, ...]
        return [full[:, j].to(dev).contiguous() for j, dev in enumerate(self.devices)]


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("a mesh over the cards needs CUDA, and none is available; pass "
                           "devices=['cpu'] for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards (default: one a device) over
    ``devices`` (default: every visible CUDA device), shard ``s`` on
    ``devices[s % len(devices)]``: ``make_mesh(4, devices=["cuda:0"])`` is 4
    shards on one card, ``make_mesh(8, devices=["cpu"])`` the tests' CPU
    mesh. :func:`.multihost.global_mesh` builds one across processes."""
    devices = list(devices) if devices is not None else cuda_devices()
    n = n_devices or len(devices)
    return Mesh([devices[s % len(devices)] for s in range(n)])
