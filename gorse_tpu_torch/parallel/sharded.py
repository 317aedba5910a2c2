"""Sharded training and retrieval over a :class:`.mesh.Mesh` (port of
gorse_tpu/parallel/sharded.py).

- The BPR epoch: the user table, the padded positives and the counts are
  row-sharded, the item table replicated. Every shard draws its users'
  pairs for the whole epoch first, with the counter sampler keyed by the
  GLOBAL user id (:func:`..ops.sampling.sample_pairs`), so the pairs do
  not depend on the sharding. Then each step every shard runs the
  explicit-pairs sweep (K3, ``bpr_sweep_pairs``: the CUDA kernel on a card,
  its plain version on the CPU) on its users; and the
  shards' dense item deltas are summed (:meth:`.mesh.Mesh.psum`) into the
  replicated table, once a step or, with ``sync_every > 1``, once a block of
  steps from shard-local accumulators (the reference's bounded-staleness
  variant). An epoch launches K3 ``n_steps`` times a local shard: the
  single-card epoch (K1, one launch) cannot carry a sum across shards
  between its steps.
- The eALS epoch: each shard solves its rows (``_als_solve_rows``), then one
  tiled all-gather a half-epoch.
- The AFM's data-parallel batches (:func:`shard_afm_batches`).
- Item-sharded exact top-k (:func:`make_sharded_topk`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sampling
from ..ops.bpr_kernel import bpr_sweep_pairs
from ..ops.sampling import sample_pairs
from .mesh import Mesh

_NEG_TRIES = 4


def _pad_rows(x, multiple: int, fill) -> np.ndarray:
    """``x``'s leading axis padded up to a multiple of ``multiple`` with
    ``fill``."""
    x = np.asarray(x)
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)], axis=0)


def shard_bpr_inputs(mesh: Mesh, user_factors, item_factors, padded_pos, pos_counts):
    """Pad the user axis to a multiple of the shard count and place the
    epoch's inputs: ``(p, q, padded_pos, counts, uids, n_users)``, p, the
    rows, counts and global uids row-sharded, q replicated."""
    user_factors = _host(user_factors)
    n_users = user_factors.shape[0]
    d = mesh.size
    uids = np.arange(n_users + (-n_users) % d, dtype=np.int32)
    return (
        mesh.shard_rows(_pad_rows(user_factors, d, 0.0)),
        mesh.replicate(_host(item_factors)),
        mesh.shard_rows(_pad_rows(padded_pos, d, -1)),
        mesh.shard_rows(_pad_rows(np.asarray(pos_counts, dtype=np.int32), d, 0)),
        mesh.shard_rows(uids),
        n_users,
    )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_sharded_bpr_epoch(mesh: Mesh, n_steps: int, n_items: int, lr: float, reg: float,
                           n_tries: int = _NEG_TRIES, sync_every: int = 1, sweep=bpr_sweep_pairs):
    """The user-sharded BPR epoch (the reference's ``make_sharded_bpr_epoch``
    and ``make_sharded_bpr_epoch_fused`` in one):
    ``epoch(p, q, padded_pos, pos_counts, uids, key, pairs=None) -> (p, q,
    cost)``, the inputs as :func:`shard_bpr_inputs` places them, ``key``
    the epoch's key words (:mod:`..ops.sampling`), ``cost`` ``[1]`` on the
    home device. ``pairs``, when given, is a ``[2, n_steps, U_local]`` int32
    tensor a local shard and receives each step's pos and neg.

    ``sync_every = 1`` sums the item deltas every step: the result does not
    depend on the sharding beyond the order of the sums. ``> 1`` is the
    reference's local-SGD variant: each shard reads ``q_base + q_acc``, its
    own accumulated deltas, and the accumulators are summed once a block of
    ``sync_every`` steps. ``sweep`` is the sweep, K3 by default
    (``bpr_sweep_pairs_plain`` holds it on a card)."""
    if n_steps % sync_every:
        raise ValueError(f"n_steps {n_steps} is not a multiple of sync_every {sync_every}")

    def epoch(p, q, padded_pos, pos_counts, uids, key, pairs=None):
        keys = sampling.raw_step_keys(key, n_steps)
        active = [(c > 0).to(torch.int32) for c in pos_counts]
        costs = [torch.zeros(1, dtype=torch.float32, device=t.device) for t in p]
        p = list(p)

        drawn = [sample_pairs(padded_pos[j], pos_counts[j], uids[j], keys, n_items, n_tries)
                 for j in range(mesh.local_size)]
        if pairs is not None:
            for j, (pos, neg) in enumerate(drawn):
                pairs[j][0], pairs[j][1] = pos, neg

        def shard_step(j, q_view, step):
            """Shard j's sweep at ``step`` against ``q_view``; its item delta."""
            delta = torch.zeros_like(q_view)
            p[j] = sweep(p[j], q_view, delta, costs[j], drawn[j][0][step], drawn[j][1][step],
                         active[j], lr, reg)
            return delta

        for block in range(0, n_steps, sync_every):
            if sync_every == 1:
                deltas = [shard_step(j, q[j], block) for j in range(mesh.local_size)]
            else:
                deltas = [torch.zeros_like(t) for t in q]
                for step in range(block, block + sync_every):
                    for j in range(mesh.local_size):
                        deltas[j] = deltas[j] + shard_step(j, q[j] + deltas[j], step)
            q = mesh.replicated(torch.add, q, mesh.psum(deltas))
        return p, q, mesh.psum(costs)[0]

    return epoch


# ------------------------------------------------------------------- eALS


def _ragged(rows) -> list[list[int]]:
    """Feedback rows as lists: ragged lists as given, a ``[R, w]`` array
    padded with -1 as its non-negative entries."""
    if isinstance(rows, np.ndarray):
        return [r[r >= 0].tolist() for r in rows]
    return [list(r) for r in rows]


def _shard_blocks(mesh: Mesh, rows: list[list[int]], block: int) -> list[list[torch.Tensor]]:
    """Each local shard's contiguous rows of ``rows`` (its length a multiple
    of ``size * block``) as ``block``-row solve blocks (``padded_blocks``)."""
    from ..models.als import padded_blocks

    per = len(rows) // mesh.size
    return [padded_blocks(rows[(mesh.offset + j) * per:(mesh.offset + j + 1) * per], block, dev)
            for j, dev in enumerate(mesh.devices)]


def _padded_ragged(rows, multiple: int) -> list[list[int]]:
    rows = _ragged(rows)
    return rows + [[] for _ in range((-len(rows)) % multiple)]


def shard_als_inputs(mesh: Mesh, item_factors, user_fb, item_fb, block: int):
    """Pad both sides' rows to a multiple of ``size * block`` (so each
    shard's rows split into whole solve blocks) and place them row-sharded,
    as blocks; the item table (padded to the same multiple with zero rows)
    and the two has-feedback Gram masks replicated. ``user_fb``/``item_fb``
    are ragged lists or ``[R, w]`` arrays padded with -1. Returns ``(q,
    user_fb, item_fb, user_mask, item_mask, n_users, n_items)``."""
    multiple = mesh.size * block
    ufb, ifb = _padded_ragged(user_fb, multiple), _padded_ragged(item_fb, multiple)
    q = _pad_rows(_host(item_factors), multiple, 0.0)
    n_users, n_items = len(user_fb), len(item_fb)
    return (
        mesh.replicate(q),
        _shard_blocks(mesh, ufb, block),
        _shard_blocks(mesh, ifb, block),
        mesh.replicate(_has_feedback(ufb)),
        mesh.replicate(_has_feedback(ifb)),
        n_users,
        n_items,
    )


def _has_feedback(rows: list[list[int]]) -> np.ndarray:
    return np.fromiter((len(r) > 0 for r in rows), np.float32, len(rows))


def _masked_gram(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = t * mask[:, None]
    return m.T @ m


def make_sharded_als_epoch(mesh: Mesh, block: int, alpha: float, reg: float):
    """The sharded eALS epoch: ``epoch(q, user_fb, item_fb, user_mask,
    item_mask) -> (p, q)``, inputs from :func:`shard_als_inputs`, both
    outputs replicated at their padded lengths. Each half-epoch every shard
    solves its rows against the replicated fixed side, whose alpha Gram is
    computed from the whole table masked to rows with feedback, then one
    tiled all-gather. Padding rows solve to zero. ``block`` is the solve
    block :func:`shard_als_inputs` cut."""
    from ..models.als import _als_solve_rows

    def half(fixed, fb, fixed_mask):
        gram = mesh.replicated(_masked_gram, fixed, fixed_mask)
        solved = [_als_solve_rows(fixed[j], fb[j], alpha, reg, gram[j])
                  for j in range(mesh.local_size)]
        return mesh.all_gather(solved)

    def epoch(q, user_fb, item_fb, user_mask, item_mask):
        p = half(q, user_fb, item_mask)
        return p, half(p, item_fb, user_mask)

    return epoch


# -------------------------------------------------------------------- AFM


def shard_afm_batches(mesh: Mesh, batches: tuple):
    """An AFM epoch's ``[S, B, ...]`` batches (``AFM._batch``: indices,
    values, targets, weights, embeddings) with the batch axis B sharded:
    local shard j gets each batch's columns ``s * B / D`` up to ``(s + 1) *
    B / D``, s its global shard index. B must be a multiple of the shard
    count. Returns the same tuple of per-shard lists."""
    def put(x):
        b = x.shape[1]
        if b % mesh.size:
            raise ValueError(f"batch axis {b} not divisible by the {mesh.size} shards")
        per = b // mesh.size
        return [x[:, (mesh.offset + j) * per:(mesh.offset + j + 1) * per].to(dev).contiguous()
                for j, dev in enumerate(mesh.devices)]

    idx, val, tgt, wgt, embs = batches
    return put(idx), put(val), put(tgt), put(wgt), tuple(put(e) for e in embs)


class Replicas:
    """A module replicated over the shards' devices (the reference's
    ``replicate`` of the AFM's parameters): the module itself on its own
    device, a copy on each other device, refreshed from the module by
    :meth:`refresh` (before each step: the optimizer updates the module)."""

    def __init__(self, mesh: Mesh, module: torch.nn.Module) -> None:
        import copy

        self.module = module
        own = next(module.parameters()).device
        self.copies = {own: module}
        for dev in mesh.devices:
            if dev not in self.copies:
                self.copies[dev] = copy.deepcopy(module).to(dev)
        self.devices = mesh.devices

    def refresh(self) -> None:
        with torch.no_grad():
            for m in self.copies.values():
                if m is not self.module:
                    for a, b in zip(m.parameters(), self.module.parameters()):
                        a.copy_(b)

    def __getitem__(self, j: int) -> torch.nn.Module:
        return self.copies[self.devices[j]]


def summed_grads(mesh: Mesh, grads, params) -> list[torch.Tensor]:
    """Each shard's gradients of ``params`` (``grads[j]``, a list per
    shard, ``None`` for an unused parameter), summed over every shard in
    shard order (one psum of the flattened gradients) and laid out as
    ``params``, on their devices."""
    flat = [torch.cat([(torch.zeros_like(p, device=g_dev) if g is None else g).reshape(-1)
                       for g, p in zip(gs, params)])
            for gs, g_dev in zip(grads, mesh.devices)]
    total = mesh.psum(flat)[0]
    out, lo = [], 0
    for p in params:
        out.append(total[lo:lo + p.numel()].reshape(p.shape).to(p.device))
        lo += p.numel()
    return out


def make_data_parallel_afm_gradients(mesh: Mesh):
    """One step of the AFM's data-parallel epoch short of the optimizer:
    ``gradients(params, replicas, bi, bv, bt, bw, be, step) -> loss``,
    ``replicas`` a :class:`Replicas` of ``params``, batches from
    :func:`shard_afm_batches`. The replicas are refreshed from ``params``;
    every shard takes its share of the global loss, ``sum(bce * w) /
    max(sum over the whole batch of w, 1)`` (the denominator psum'd before
    autograd), on the parameters' copy for its device; the shards'
    gradients are summed in shard order into ``params``' ``grad``. Returns
    the step's loss (psum'd) as a 0-d tensor."""
    from ..models.fm import afm_forward, bce_terms

    def gradients(params, replicas, bi, bv, bt, bw, be, step):
        replicas.refresh()
        leaves = list(params.parameters())
        den = mesh.psum([w[step].sum() for w in bw])
        grads, parts = [], []
        for j in range(mesh.local_size):
            model = replicas[j]
            logits = afm_forward(model, bi[j][step], bv[j][step], [e[j][step] for e in be])
            loss = (bce_terms(logits, bt[j][step]) * bw[j][step]).sum() / den[j].clamp(min=1.0)
            grads.append(torch.autograd.grad(loss, list(model.parameters()), allow_unused=True))
            parts.append(loss.detach())
        for p, g in zip(leaves, summed_grads(mesh, grads, leaves)):
            p.grad = g
        return mesh.psum(parts)[0]

    return gradients


def make_data_parallel_afm_epoch(mesh: Mesh):
    """The AFM's data-parallel epoch: ``epoch(params, optimizer, bi, bv, bt,
    bw, be) -> loss``, batches from :func:`shard_afm_batches`, ``params``
    the model's ``AFMParams`` and ``optimizer`` over them (dense Adam or
    SGD, as ``fm.make_optimizer`` builds it). Each step takes
    :func:`make_data_parallel_afm_gradients`' gradients and the optimizer
    steps once. The summed loss of the epoch comes back as a 0-d tensor."""
    gradients = make_data_parallel_afm_gradients(mesh)

    def epoch(params, optimizer, bi, bv, bt, bw, be):
        replicas = Replicas(mesh, params)
        losses = []
        for step in range(bi[0].shape[0]):
            losses.append(gradients(params, replicas, bi, bv, bt, bw, be, step))
            optimizer.step()
        return torch.stack(losses).sum()

    return epoch


# ------------------------------------------------------------------ top-k


def shard_items(mesh: Mesh, items):
    """``items`` ``[N, d]`` (N a multiple of the shard count) row-sharded and
    prepared for :func:`..ops.topk.dot_topk` on each shard's device."""
    from ..ops.topk import prepare_items

    return [prepare_items(t, device=t.device) for t in mesh.shard_rows(_host(items))]


def make_sharded_topk(mesh: Mesh, k_top: int):
    """Item-sharded exact top-k: ``topk(queries, items) -> (scores [B, k],
    ids [B, k])`` on the home device, ``items`` from :func:`shard_items`.
    Each shard ranks its rows through ``dot_topk`` (K4-K6 on a card: the
    bf16 table and the tensor-core scores of the serving route; their plain
    versions on the CPU), offsets its ids by ``shard * shard_size``, the
    ``[D, B, k]`` candidates are all-gathered and merged in one
    ``merge_topk`` (ties to the lower global id, as ``lax.top_k`` over the
    shard-ordered candidates)."""
    from ..ops.topk import _keys, dot_topk, merge_topk

    def topk(queries, items):
        q = torch.as_tensor(queries).to(torch.float32)
        shard_size = items[0].n_items
        if any(it.n_items != shard_size for it in items):
            raise ValueError("every shard must hold as many items")
        k_local = min(k_top, shard_size)
        keys = []
        for j, it in enumerate(items):
            s, i = dot_topk(q.to(it.table.device), it, k_local, device=it.table.device)
            keys.append(_keys(s, i.to(torch.int64) + (mesh.offset + j) * shard_size))
        cand = mesh.all_gather(keys, tiled=False)[0]  # [D, B, k_local]
        b = q.shape[0]
        cand = cand.permute(1, 0, 2).reshape(b, mesh.size * k_local).contiguous()
        count = torch.full((b,), cand.shape[1], dtype=torch.int32, device=cand.device)
        return merge_topk(cand, count, b, k_top)

    return topk
