"""Catalog (item or feature table) sharding for training (port of
gorse_tpu/parallel/catalog.py).

- **Strided ownership**: global row ``g`` lives on shard ``g % D`` at local
  row ``g // D`` (:func:`pack_catalog`). Ids are frequency-ordered, so the
  stride spreads the popular head over every shard.
- **A fixed-shape ragged exchange**: each shard needs an arbitrary set of
  rows a step. Its requests are routed into a ``[D, C]`` buffer a
  destination (:func:`route_requests`: a stable sort by owner and the rank
  within the owner), exchanged by one :meth:`.mesh.Mesh.all_to_all` and
  answered with a ``[D, C, k]`` one back (:func:`a2a_gather`); updates ride
  the same routing into an add on the owner (:func:`a2a_scatter_add`). The
  payload is ``2 D C (4 + 4 k)`` bytes a shard and exchange, independent of
  the catalog size.
- **Bounded overflow**: ``C`` caps the requests one destination takes;
  requests past it are dropped (their pairs or samples masked out of the
  step) and counted, and every epoch reports the count.

The reference computes these epochs in XLA, outside any Pallas kernel; the
port computes them with plain PyTorch ops (sorts, gathers, ``index_add``).
Functions that exchange take and return per-shard lists, as
:mod:`.sharded`'s do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import sampling
from ..ops.sampling import sample_pairs
from .mesh import Mesh
from .sharded import (
    _NEG_TRIES,
    Replicas,
    _host,
    _masked_gram,
    _pad_rows,
    _padded_ragged,
    _shard_blocks,
    _has_feedback,
    summed_grads,
)

# ---------------------------------------------------------------- routing


def route_requests(ids: torch.Tensor, valid: torch.Tensor, n_devices: int, cap: int):
    """Route ``ids`` (``[N]`` global rows, owner ``id % D``) into a
    fixed-shape buffer a destination. Returns ``(buf, sowner, srank, order,
    kept, n_dropped)``: ``buf`` ``[D, cap]`` int32 (-1 empty); ``sowner`` and
    ``srank`` each request's owner and rank within the owner, in ``order``'s
    (stable-sorted) permutation; ``kept`` the requests routed without a drop
    (sorted order); ``n_dropped`` the valid requests past their owner's
    cap."""
    n, d = ids.shape[0], n_devices
    dev = ids.device
    owner = torch.where(valid, ids.to(torch.int64) % d, d)  # invalid: a bucket past the last
    order = torch.argsort(owner, stable=True)
    sowner = owner[order]
    sids = ids[order]
    start = torch.searchsorted(sowner, torch.arange(d, dtype=torch.int64, device=dev))
    srank = torch.arange(n, device=dev) - start[sowner.clamp(max=d - 1)]
    kept = (sowner < d) & (srank < cap)
    buf = torch.full((d, cap), -1, dtype=torch.int32, device=dev)
    buf[sowner[kept], srank[kept]] = sids[kept].to(torch.int32)
    n_dropped = valid.sum() - kept.sum()
    return buf, sowner, srank, order, kept, n_dropped


def a2a_gather(mesh: Mesh, table_shards, ids, valid, cap: int):
    """Fetch rows ``ids[j]`` of the strided sharded table for each local
    shard j. Returns per-shard lists ``(rows [N, k], got [N] bool,
    n_dropped)``; dropped and invalid requests get zero rows, ``got``
    False."""
    d = mesh.size
    routes = [route_requests(i, v, d, cap) for i, v in zip(ids, valid)]
    req = mesh.all_to_all([r[0] for r in routes])  # [D, cap]: row s from shard s
    answers = []
    for t, r in zip(table_shards, req):
        local = torch.where(r >= 0, torch.div(r, d, rounding_mode="floor"), 0).long()
        answers.append(t[local] * (r >= 0)[..., None].to(t.dtype))
    resp = mesh.all_to_all(answers)  # [D, cap, k]: row s my rows from s
    rows, got, dropped = [], [], []
    for (_, sowner, srank, order, kept, n_drop), r, i in zip(routes, resp, ids):
        vals = r[torch.where(kept, sowner, 0), torch.where(kept, srank, 0)]
        vals = vals * kept[:, None].to(r.dtype)
        out = torch.zeros((i.shape[0], r.shape[-1]), dtype=r.dtype, device=r.device)
        out[order] = vals
        ok = torch.zeros(i.shape[0], dtype=torch.bool, device=r.device)
        ok[order] = kept
        rows.append(out)
        got.append(ok)
        dropped.append(n_drop)
    return rows, got, dropped


def a2a_scatter_add(mesh: Mesh, table_shards, ids, valid, deltas, cap: int):
    """Add ``deltas[j]`` (``[N, k]``) into rows ``ids[j]`` of the strided
    sharded table, routed to their owners (:func:`a2a_gather` in reverse);
    invalid and overflowing updates are dropped. Returns the new shards."""
    d = mesh.size
    bufs, dbufs = [], []
    for i, v, dl in zip(ids, valid, deltas):
        buf, sowner, srank, order, kept, _ = route_requests(i, v, d, cap)
        dbuf = torch.zeros((d, cap) + dl.shape[1:], dtype=dl.dtype, device=dl.device)
        dbuf[sowner[kept], srank[kept]] = dl[order][kept]
        bufs.append(buf)
        dbufs.append(dbuf)
    req, rcv = mesh.all_to_all(bufs), mesh.all_to_all(dbufs)
    out = []
    for t, r, x in zip(table_shards, req, rcv):
        live = (r >= 0).reshape(-1)
        local = torch.div(r, d, rounding_mode="floor").reshape(-1)[live].long()
        out.append(t.index_add(0, local, x.reshape(-1, *x.shape[2:])[live]))
    return out


def request_cap(n_requests: int, n_devices: int, slack: float = 2.0) -> int:
    """Slots a destination: the uniform expectation times ``slack``, a
    multiple of 8; at least 512 (below that, the worst case: no drops by
    construction), never more than ``n_requests``."""
    c = int(np.ceil(n_requests / n_devices * slack))
    c = max(-(-c // 8) * 8, 8)
    return min(max(n_requests, 1), max(c, 512))


def exchange_bytes_per_step(n_requests: int, n_devices: int, k: int,
                            cap: int | None = None, slack: float = 2.0) -> int:
    """A shard's payload of one gather and one scatter exchange: 2 x (the
    ``[D, C]`` int32 ids + the ``[D, C, k]`` f32 rows), whatever the catalog
    size."""
    c = cap if cap is not None else request_cap(n_requests, n_devices, slack)
    return 2 * n_devices * c * (4 + 4 * k)


# ------------------------------------------------------ the table's layout


def pack_catalog(table, n_devices: int) -> np.ndarray:
    """``[I_pad, k]``, I_pad a multiple of D: contiguous block ``d`` holds
    the rows ``g % D == d`` ordered by ``g // D``, so a row-sharded placement
    gives shard d its strided rows, global row g at local row g // D."""
    table = _host(table)
    i_total, k = table.shape
    rows_per = -(-i_total // n_devices)
    out = np.zeros((rows_per * n_devices, k), table.dtype)
    g = np.arange(i_total)
    out[(g % n_devices) * rows_per + g // n_devices] = table
    return out


def unpack_catalog(packed, i_total: int, n_devices: int) -> np.ndarray:
    """Inverse of :func:`pack_catalog`: ``[I_total, k]`` in global row order."""
    packed = _host(packed)
    rows_per = packed.shape[0] // n_devices
    g = np.arange(i_total)
    return packed[(g % n_devices) * rows_per + g // n_devices]


# ------------------------------------------------------------------- BPR


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` with no threshold (``jax.nn.softplus``)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def make_catalog_sharded_bpr_epoch(mesh: Mesh, n_steps: int, n_items: int, lr: float,
                                   reg: float, n_tries: int = _NEG_TRIES, slack: float = 2.0,
                                   cap: int | None = None):
    """The catalog-sharded BPR epoch: users row-sharded as in the user-sharded
    epoch, and the item table row-sharded with strided ownership. Each step
    every shard gathers exactly its pairs' rows and scatter-adds their
    updates back to the owners. ``epoch(p, q_shard, padded_pos, pos_counts,
    uids, key) -> (p, q_shard, [cost, n_dropped])``, inputs from
    :func:`shard_catalog_bpr_inputs`. The pairs are the user-sharded
    epoch's (the same sampler over global uids); a pair takes part only if
    both its rows arrived. ``epoch.exchange_bytes_per_step(2 * U_local,
    k=k)`` gives the payload."""
    d = mesh.size

    def epoch(p, q_shard, padded_pos, pos_counts, uids, key):
        keys = sampling.raw_step_keys(key, n_steps)
        c = cap if cap is not None else request_cap(2 * p[0].shape[0], d, slack)
        p, q_shard = list(p), list(q_shard)
        active = [pc > 0 for pc in pos_counts]
        costs = [torch.zeros((), dtype=torch.float32, device=t.device) for t in p]
        drops = [torch.zeros((), dtype=torch.int64, device=t.device) for t in p]
        drawn = [sample_pairs(pp, pc, u, keys, n_items, n_tries)
                 for pp, pc, u in zip(padded_pos, pos_counts, uids)]
        for step in range(n_steps):
            pairs = [(pos[step], neg[step]) for pos, neg in drawn]
            ids = [torch.cat([pos, neg]).long() for pos, neg in pairs]
            valid = [torch.cat([a, a]) for a in active]
            rows, got, n_drop = a2a_gather(mesh, q_shard, ids, valid, c)
            deltas, sendable = [], []
            for j in range(mesh.local_size):
                nu = pairs[j][0].shape[0]
                qi, qj = rows[j][:nu], rows[j][nu:]
                ok = (active[j] & got[j][:nu] & got[j][nu:])[:, None]
                pj = p[j]
                diff = (pj * (qi - qj)).sum(dim=-1)
                costs[j] = costs[j] + torch.where(ok[:, 0], _softplus(-diff), 0.0).sum()
                grad = torch.where(ok, torch.sigmoid(-diff)[:, None], 0.0)
                d_qi = torch.where(ok, lr * (grad * pj - reg * qi), 0.0)
                d_qj = torch.where(ok, lr * (-grad * pj - reg * qj), 0.0)
                p[j] = pj + torch.where(ok, lr * (grad * (qi - qj) - reg * pj), 0.0)
                deltas.append(torch.cat([d_qi, d_qj]))
                sendable.append(torch.cat([ok[:, 0], ok[:, 0]]))
                drops[j] = drops[j] + n_drop[j]
            q_shard = a2a_scatter_add(mesh, q_shard, ids, sendable, deltas, c)
        total, dropped = mesh.psum(costs)[0], mesh.psum(drops)[0]
        return p, q_shard, torch.stack([total, dropped.to(total.dtype)])

    epoch.exchange_bytes_per_step = (
        lambda n_requests, k: exchange_bytes_per_step(n_requests, d, k, cap, slack))
    return epoch


def shard_catalog_bpr_inputs(mesh: Mesh, user_factors, item_factors, padded_pos, pos_counts):
    """Pad and place :func:`make_catalog_sharded_bpr_epoch`'s inputs: users
    row-sharded (contiguous), the item table strided-packed and row-sharded,
    never replicated. Returns ``(p, q_shard, padded_pos, counts, uids,
    n_users, n_items)``."""
    d = mesh.size
    user_factors, item_factors = _host(user_factors), _host(item_factors)
    n_users = user_factors.shape[0]
    return (
        mesh.shard_rows(_pad_rows(user_factors, d, 0.0)),
        mesh.shard_rows(pack_catalog(item_factors, d)),
        mesh.shard_rows(_pad_rows(padded_pos, d, -1)),
        mesh.shard_rows(_pad_rows(np.asarray(pos_counts, dtype=np.int32), d, 0)),
        mesh.shard_rows(np.arange(n_users + (-n_users) % d, dtype=np.int32)),
        n_users,
        item_factors.shape[0],
    )


# ------------------------------------------------------------------ eALS


def make_catalog_sharded_als_epoch(mesh: Mesh, block: int, alpha: float, reg: float):
    """The eALS epoch with both tables row-sharded (contiguous) between
    half-epochs: ``epoch(p, q, user_fb, item_fb, user_mask, item_mask) ->
    (p, q)``, everything from :func:`shard_catalog_als_inputs`. Each
    half-epoch the alpha Gram is the psum of the shards' partial Grams (a
    ``k x k`` exchange), and the fixed side is all-gathered for the solves
    and dropped after them."""
    from ..models.als import _als_solve_rows

    def half(fixed, fixed_mask, fb):
        gram = mesh.psum([_masked_gram(t, m) for t, m in zip(fixed, fixed_mask)])
        full = mesh.all_gather(fixed)
        return [_als_solve_rows(full[j], fb[j], alpha, reg, gram[j])
                for j in range(mesh.local_size)]

    def epoch(p, q, user_fb, item_fb, user_mask, item_mask):
        p = half(q, item_mask, user_fb)
        return p, half(p, user_mask, item_fb)

    return epoch


def shard_catalog_als_inputs(mesh: Mesh, user_factors, item_factors, user_fb, item_fb,
                             block: int):
    """Pad both sides to a multiple of ``size * block`` and place everything
    row-sharded: factors, feedback blocks, masks. Returns ``(p, q, user_fb,
    item_fb, user_mask, item_mask, n_users, n_items)``."""
    multiple = mesh.size * block
    ufb, ifb = _padded_ragged(user_fb, multiple), _padded_ragged(item_fb, multiple)
    return (
        mesh.shard_rows(_pad_rows(_host(user_factors), multiple, 0.0)),
        mesh.shard_rows(_pad_rows(_host(item_factors), multiple, 0.0)),
        _shard_blocks(mesh, ufb, block),
        _shard_blocks(mesh, ifb, block),
        mesh.shard_rows(_has_feedback(ufb)),
        mesh.shard_rows(_has_feedback(ifb)),
        len(user_fb),
        len(item_fb),
    )


# ------------------------------------------------- the AFM's feature table


class ShardedAFMParams(NamedTuple):
    """The AFM's parameters for the table-sharded epoch: ``vw``, the feature
    tables ``v`` ``[F, k]`` and ``w`` ``[F, 1]`` fused into ``[F, k + 1]``
    (one exchange a step), strided-packed and row-sharded, one tensor a
    local shard; ``rep``, the replicated rest (``b`` and the towers) as an
    ``AFMParams`` with empty ``v`` and ``w``."""

    vw: list
    rep: torch.nn.Module

    def leaves(self) -> list[torch.Tensor]:
        """What the optimizer updates: ``b``, the towers, the vw shards."""
        return [self.rep.b, *self.rep.att.parameters(), *self.vw]


def shard_afm_params(mesh: Mesh, model_params) -> ShardedAFMParams:
    """Split an ``AFMParams`` for :func:`make_sharded_afm_epoch`; ``rep`` on
    the mesh's home device."""
    from ..models.fm import AFMParams

    vw = np.concatenate([_host(model_params.v), _host(model_params.w)], axis=1)
    dims = [tower.w.shape[0] for tower in model_params.att]
    rep = AFMParams(0, model_params.v.shape[1], dims)
    with torch.no_grad():
        rep.b.copy_(model_params.b)
        for a, b in zip(rep.att.parameters(), model_params.att.parameters()):
            a.copy_(b)
    return ShardedAFMParams(mesh.shard_rows(pack_catalog(vw, mesh.size)), rep.to(mesh.home))


def unshard_afm_params(mesh: Mesh, sharded: ShardedAFMParams, n_features: int, n_factors: int,
                       device=None):
    """Back to an ``AFMParams`` on ``device`` (default: the home device)."""
    from ..models.fm import AFMParams

    vw = unpack_catalog(mesh.all_gather([t.detach() for t in sharded.vw])[0], n_features,
                        mesh.size)
    dims = [tower.w.shape[0] for tower in sharded.rep.att]
    out = AFMParams(n_features, n_factors, dims)
    with torch.no_grad():
        out.v.copy_(torch.from_numpy(vw[:, :n_factors]))
        out.w.copy_(torch.from_numpy(vw[:, n_factors:]))
        out.b.copy_(sharded.rep.b)
        for a, b in zip(out.att.parameters(), sharded.rep.att.parameters()):
            a.copy_(b)
    return out.to(device if device is not None else mesh.home)


def make_sharded_afm_epoch(mesh: Mesh, slack: float = 4.0, cap: int | None = None):
    """The AFM epoch with the feature table row-sharded and the batch axis
    data-parallel: ``epoch(params, optimizer, bi, bv, bt, bw, be) -> (loss,
    n_dropped)``, ``params`` from :func:`shard_afm_params`, ``optimizer``
    over ``params.leaves()``, batches from ``sharded.shard_afm_batches``.
    Each step every shard gathers the fused rows its batch touches (slots
    of value 0 add nothing to the forward or the gradient and are not
    requested), computes its share of the loss on them (a sample whose
    gather overflowed the cap is masked out of the loss), the gathered
    rows' gradients go back to their owners by the scatter-add, the
    replicated leaves' gradients are summed in shard order, and the
    optimizer steps once (shard-locally on the table: its update is
    elementwise)."""
    from ..models.fm import afm_forward_rows, bce_terms

    d = mesh.size

    def epoch(params: ShardedAFMParams, optimizer, bi, bv, bt, bw, be):
        k1 = params.vw[0].shape[1] - 1
        b_local, slots = bi[0].shape[1], bi[0].shape[2]
        c = cap if cap is not None else request_cap(b_local * slots, d, slack)
        replicas = Replicas(mesh, params.rep)
        rep_leaves = [params.rep.b, *params.rep.att.parameters()]
        losses = []
        drops = [torch.zeros((), dtype=torch.int64, device=t.device) for t in params.vw]
        for step in range(bi[0].shape[0]):
            replicas.refresh()
            ids = [x[step].reshape(-1) for x in bi]
            valid = [x[step].reshape(-1) != 0 for x in bv]
            rows, got, n_drop = a2a_gather(mesh, [t.detach() for t in params.vw], ids, valid, c)
            w_eff = [bw[j][step] * (got[j] | ~valid[j]).reshape(b_local, slots).all(dim=1)
                     for j in range(mesh.local_size)]
            den = mesh.psum([w.sum() for w in w_eff])
            grads, g_rows, parts = [], [], []
            for j in range(mesh.local_size):
                model = replicas[j]
                r = rows[j].reshape(b_local, slots, k1 + 1).requires_grad_()
                val = bv[j][step]
                logits = afm_forward_rows(model, r[..., :k1], r[..., k1:], val,
                                          [e[j][step] for e in be])
                loss = (bce_terms(logits, bt[j][step]) * w_eff[j]).sum() / den[j].clamp(min=1.0)
                leaves = [model.b, *model.att.parameters()]
                *g_rep, g_r = torch.autograd.grad(loss, leaves + [r], allow_unused=True)
                grads.append(g_rep)
                g_rows.append(g_r.reshape(-1, k1 + 1))
                parts.append(loss.detach())
                drops[j] = drops[j] + n_drop[j]
            for p, g in zip(rep_leaves, summed_grads(mesh, grads, rep_leaves)):
                p.grad = g
            zeros = [torch.zeros_like(t) for t in params.vw]
            for t, g in zip(params.vw, a2a_scatter_add(mesh, zeros, ids, valid, g_rows, c)):
                t.grad = g
            optimizer.step()
            losses.append(mesh.psum(parts)[0])
        return torch.stack(losses).sum(), mesh.psum(drops)[0]

    return epoch
